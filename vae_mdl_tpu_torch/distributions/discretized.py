"""Discretized logistic log-probability.

Port of ``vae_mdl_tpu/distributions/discretized.py:25-72``, the one cascade
every MoDL path shares: the plain version, and the CUDA kernel's math in
``csrc/mdl_log_prob.cu``, which follows it branch for branch.
"""
from __future__ import annotations

import math

import torch

from vae_mdl_tpu_torch.distributions.continuous import softplus


def discretized_logistic_log_prob(
    x: torch.Tensor,
    loc: torch.Tensor,
    logscale: torch.Tensor,
    *,
    low: float = -1.0,
    high: float = 1.0,
    interval_width: float | None = None,
    levels: float = 256.0,
) -> torch.Tensor:
    """Elementwise log P(bin containing x) under a discretized logistic.

    The CDF difference over the bin, floored at 1e-12; the PDF * width
    approximation where that difference is at most 1e-5; the edge bins
    ``x <= low`` / ``x >= high`` take the whole tail.
    """
    if interval_width is None:
        interval_width = (high - low) / (levels - 1.0)
    dx = interval_width / 2.0

    centered = x - loc
    inv_std = torch.exp(-logscale)

    interval_start = (centered - dx) * inv_std
    interval_stop = (centered + dx) * inv_std

    prob = torch.sigmoid(interval_stop) - torch.sigmoid(interval_start)
    prob = torch.clamp_min(prob, 1e-12)

    # edge bins: log CDF(stop) on the left, log(1 - CDF(start)) on the right
    left_edge = interval_stop - softplus(interval_stop)
    right_edge = -softplus(interval_start)

    a = centered * inv_std
    log_prob_approx = -a - logscale - 2.0 * softplus(-a) + math.log(interval_width)

    safe_log_prob = torch.where(prob > 1e-5, torch.log(prob), log_prob_approx)
    safe_log_prob = torch.where(x <= low, left_edge, safe_log_prob)
    safe_log_prob = torch.where(x >= high, right_edge, safe_log_prob)
    return safe_log_prob
