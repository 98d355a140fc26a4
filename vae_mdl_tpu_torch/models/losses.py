"""The IWAE objective for one stochastic layer.

Port of ``effective_sample_size``, ``_reduce``, ``_bits_per_dim`` and
``iwae_loss`` from ``vae_mdl_tpu/models/losses.py``. Log-probs are reduced
over each distribution's event axes; the only cross-sample op is the
logmeanexp over the leading importance-sample axis.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from vae_mdl_tpu_torch.ops.math import logmeanexp

_LOG2 = math.log(2.0)

Metrics = Dict[str, torch.Tensor]


def effective_sample_size(log_w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Normalised importance-weight ESS in [1, k]: (sum w)^2 / sum w^2."""
    lse1 = torch.logsumexp(log_w, dim=dim)
    lse2 = torch.logsumexp(2.0 * log_w, dim=dim)
    return torch.exp(2.0 * lse1 - lse2)


def _reduce(dist, value: torch.Tensor, axes=None) -> torch.Tensor:
    if axes is None:
        return dist.reduced_log_prob(value)
    return torch.sum(dist.log_prob(value), dim=tuple(axes))


def _bits_per_dim(iwae_elbo: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """-elbo / (log 2 * dims(x)) over all non-batch dims of the observation."""
    return -iwae_elbo / (_LOG2 * math.prod(x.shape[1:]))


def iwae_loss(x, z, pz, qzx, pxz, beta: float = 1.0) -> Tuple[torch.Tensor, Metrics]:
    """Importance-weighted bound for one stochastic layer.

    ``z``: latent samples ``[k, B, ...]``; ``pz``/``qzx``/``pxz``:
    distributions with ``log_prob`` and ``event_axes``. Forward only: the
    backward of the CUDA likelihood kernel is not ported yet.
    """
    lpz = _reduce(pz, z)
    lqzx = _reduce(qzx, z)
    lpxz = _reduce(pxz, x)

    log_w = lpxz + beta * (lpz - lqzx)

    # logmeanexp over importance samples, mean over the batch
    iwae_elbo = torch.mean(logmeanexp(log_w, dim=0), dim=-1)
    bpd = _bits_per_dim(iwae_elbo, x)
    kl = -torch.mean(lpz - lqzx, dim=0)

    return -iwae_elbo, {
        "iwae_elbo": iwae_elbo,
        "bpd": bpd,
        "lpxz": lpxz,
        "lqzx": lqzx,
        "lpz": lpz,
        "kl": kl,
        "ess": effective_sample_size(log_w),
    }
