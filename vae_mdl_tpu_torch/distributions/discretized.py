"""Discretized logistic likelihood.

Port of ``vae_mdl_tpu/distributions/discretized.py``: the free function
``discretized_logistic_log_prob`` is the one cascade every discretized
likelihood shares (the plain version of the CUDA kernels, whose device
functions in ``csrc/dl_cascade.cuh`` follow it branch for branch), and
``DiscretizedLogistic`` is the observation distribution of model03, model04
and model06.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from vae_mdl_tpu_torch.distributions.base import Distribution
from vae_mdl_tpu_torch.distributions.continuous import Logistic, softplus


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
    # torch.maximum: half the gradient at a tie, as jnp.maximum
    prob = torch.maximum(prob, prob.new_full((), 1e-12))

    # edge bins: log CDF(stop) on the left, log(1 - CDF(start)) on the right
    left_edge = interval_stop - softplus(interval_stop)
    right_edge = -softplus(interval_start)

    a = centered * inv_std
    log_prob_approx = -a - logscale - 2.0 * softplus(-a) + math.log(interval_width)

    safe_log_prob = torch.where(prob > 1e-5, torch.log(prob), log_prob_approx)
    safe_log_prob = torch.where(x <= low, left_edge, safe_log_prob)
    safe_log_prob = torch.where(x >= high, right_edge, safe_log_prob)
    return safe_log_prob


@dataclasses.dataclass
class DiscretizedLogistic(Distribution):
    """A logistic binned into ``levels`` values covering ``[low, high]``.

    ``use_pallas=True`` takes the hand-written CUDA kernel
    (``ops/cuda/dl_kernel.py``) and needs CUDA parameters; ``False`` takes
    the plain version. ``nn.decoders.resolve_use_pallas`` makes the choice
    from the config.

    ``head``, where given, is the tensor whose last axis loc and logscale
    are the two halves of (``make_observation`` hands on the head conv's
    output): the kernel then takes the head as its operand
    (``dl_log_prob_head``), so that autograd gets the head's gradient in one
    piece. It changes no value: loc and logscale stay the parameters.
    """

    loc: torch.Tensor
    logscale: torch.Tensor
    low: float = -1.0
    high: float = 1.0
    levels: float = 256.0
    event_axes: Tuple[int, ...] = (-1, -2, -3)
    use_pallas: bool = False
    head: Optional[torch.Tensor] = None

    @property
    def interval_width(self) -> float:
        return (self.high - self.low) / (self.levels - 1.0)

    def _halves_of_head(self) -> bool:
        """Whether loc and logscale are still the halves of ``head``."""
        head = self.head
        if head is None or head.shape[-1] != 2 * self.loc.shape[-1]:
            return False
        return (self.loc.data_ptr() == head.data_ptr()
                and self.logscale.data_ptr()
                == head.data_ptr() + self.loc.shape[-1] * head.stride(-1) * head.element_size()
                and self.loc.shape == self.logscale.shape == head.shape[:-1] + self.loc.shape[-1:])

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_pallas:
            if not self.loc.is_cuda:
                raise ValueError(
                    "use_pallas=True selects the CUDA discretized-logistic kernel, "
                    f"but the parameters lie on {self.loc.device}; pass "
                    "use_pallas=None (auto) or False for CPU tensors")
            from vae_mdl_tpu_torch.ops.cuda.dl_kernel import dl_log_prob, dl_log_prob_head

            if self._halves_of_head():
                return dl_log_prob_head(x, self.head, self.low, self.high, self.interval_width)
            return dl_log_prob(x, self.loc, self.logscale, self.low, self.high,
                               self.interval_width)
        return discretized_logistic_log_prob(
            x, self.loc, self.logscale, low=self.low, high=self.high,
            interval_width=self.interval_width)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Tuple[int, ...] = (),
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A clipped continuous logistic sample; like the reference's, it is
        not binned. ``noise`` injects the uniforms of the logistic draw."""
        s = Logistic(self.loc, torch.exp(self.logscale)).sample(generator, sample_shape,
                                                                noise=noise)
        return torch.clamp(s, self.low, self.high)

    def mean(self) -> torch.Tensor:
        return torch.broadcast_to(
            self.loc, torch.broadcast_shapes(self.loc.shape, self.logscale.shape))
