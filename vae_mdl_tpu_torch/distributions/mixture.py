"""Mixture of discretized logistics over RGB pixels, PixelCNN++ style.

Port of ``vae_mdl_tpu/distributions/mixture.py`` (``split_mixture_params``,
``autoregressive_locs``, ``mixture_log_prob``, ``MixtureDiscretizedLogistic``).
The green/blue locations are conditioned on the observed red/green values.

Parameter layout per pixel, ``n_mix * 10`` channels:
  [n_mix mixture logits | 3 x (n_mix locs, n_mix logscales, n_mix coeffs)]
the last block reshaped to ``[..., 3, 3 * n_mix]``, one row per sub-pixel.

``mixture_log_prob`` is the plain version of the CUDA kernel
(``ops/cuda/mdl_kernel.py``): CPU tensors and the tests use it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from vae_mdl_tpu_torch.distributions.base import Distribution
from vae_mdl_tpu_torch.distributions.continuous import Logistic
from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.ops.math import log_prob_from_logits

# image space is mapped [0,1] -> [-1,1]; 256 levels => bin width 2/255
_INTERVAL_WIDTH = 2.0 / 255.0
_LOW, _HIGH = -1.0, 1.0


def split_mixture_params(parameters: torch.Tensor):
    """Split ``[..., n_mix*10]`` into (loc, logscale, coeffs, mix_logits).

    loc/logscale/coeffs: ``[..., 3, n_mix]``; mix_logits: ``[..., n_mix]``.
    Logscales are clamped at -7 and coeffs tanh-squashed. The clamp is
    ``torch.maximum``, which passes half the gradient at a tie, as
    ``jnp.maximum`` does.
    """
    if parameters.shape[-1] % 10 != 0:
        raise ValueError(
            "mixture parameters need a trailing dim of n_mix*10 "
            f"(logits + 3 locs + 3 logscales + 3 coeffs per mix); got {parameters.shape[-1]}"
        )
    n_mix = parameters.shape[-1] // 10
    mix_logits = parameters[..., :n_mix]
    rest = parameters[..., n_mix:].reshape(parameters.shape[:-1] + (3, 3 * n_mix))
    loc, logscale, coeffs = torch.split(rest, n_mix, dim=-1)
    logscale = torch.maximum(logscale, logscale.new_full((), -7.0))
    coeffs = torch.tanh(coeffs)
    return loc, logscale, coeffs, mix_logits


def autoregressive_locs(loc: torch.Tensor, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Condition green/blue locs on observed red/green values (x in [-1, 1]):
    p(R,G,B) = p(R) p(G|R=r) p(B|R=r,G=g)."""
    loc_r = loc[..., 0, :]
    loc_g = loc[..., 1, :] + coeffs[..., 0, :] * x[..., 0, None]
    loc_b = (
        loc[..., 2, :]
        + coeffs[..., 1, :] * x[..., 0, None]
        + coeffs[..., 2, :] * x[..., 1, None]
    )
    return torch.stack([loc_r, loc_g, loc_b], dim=-2)


def mixture_log_prob(x01: torch.Tensor, parameters: torch.Tensor) -> torch.Tensor:
    """Per-pixel MoDL log-prob with channel autoregression.

    ``x01``: observations in [0, 1], ``[..., h, w, 3]``; ``parameters``
    ``[..., h, w, n_mix*10]``, possibly with extra leading importance-sample
    dims that broadcast against x. Returns ``[..., h, w, 1]``.
    """
    x = x01 * 2.0 - 1.0
    loc, logscale, coeffs, mix_logits = split_mixture_params(parameters)
    loc = autoregressive_locs(loc, coeffs, x)

    # [..., h, w, 3, n_mix] elementwise discretized-logistic log-probs
    sub_pixel_lp = discretized_logistic_log_prob(
        x[..., None], loc, logscale,
        low=_LOW, high=_HIGH, interval_width=_INTERVAL_WIDTH,
    )

    # sum sub-pixels, weigh by the mixture, logsumexp over mixes
    weighted = torch.sum(sub_pixel_lp, dim=-2) + log_prob_from_logits(mix_logits)
    lp = torch.logsumexp(weighted, dim=-1)
    return lp[..., None]


@dataclasses.dataclass
class MixtureDiscretizedLogistic(Distribution):
    """PixelCNN++-compatible MoDL.

    ``use_pallas=True`` takes the hand-written CUDA kernel and needs CUDA
    parameters; ``False`` takes the plain version.
    ``nn.decoders.resolve_use_pallas`` makes the choice from the config.
    """

    parameters: torch.Tensor
    event_axes: Tuple[int, ...] = (-1, -2, -3)
    use_pallas: bool = False

    @property
    def n_mix(self) -> int:
        return self.parameters.shape[-1] // 10

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in [0, 1]; returns ``[..., h, w, 1]``."""
        if self.use_pallas:
            if not self.parameters.is_cuda:
                raise ValueError(
                    "use_pallas=True selects the CUDA MoDL kernel, but the "
                    f"parameters lie on {self.parameters.device}; pass "
                    "use_pallas=None (auto) or False for CPU tensors")
            from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import mdl_log_prob

            return mdl_log_prob(x, self.parameters)
        # the math stays float32 even when the boundary tensor is quantized
        # (config.likelihood_io_dtype)
        return mixture_log_prob(x, self.parameters.float())

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Tuple[int, ...] = (),
               noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """Logistic draws autoregressed on the samples, then one mixture
        component per pixel (Gumbel-max). ``noise=(u_logistic, u_gumbel)``
        injects the uniforms, shaped ``sample_shape + [..., 3, n_mix]`` and
        ``sample_shape + [..., n_mix]``. Returns values in [0, 1]."""
        loc, logscale, coeffs, mix_logits = split_mixture_params(
            self.parameters.float())
        u_logistic, u_gumbel = noise if noise is not None else (None, None)

        ls = Logistic(loc, torch.exp(logscale)).sample(generator, sample_shape,
                                                       noise=u_logistic)
        r = torch.clamp(ls[..., 0, :], _LOW, _HIGH)
        g = torch.clamp(ls[..., 1, :] + coeffs[..., 0, :] * r, _LOW, _HIGH)
        b = torch.clamp(
            ls[..., 2, :] + coeffs[..., 1, :] * r + coeffs[..., 2, :] * g,
            _LOW, _HIGH,
        )
        auto = torch.stack([r, g, b], dim=-2)  # [..., 3, n_mix]

        if u_gumbel is None:
            shape = tuple(sample_shape) + tuple(mix_logits.shape)
            u_gumbel = torch.rand(shape, generator=generator,
                                  device=mix_logits.device).clamp_min_(
                                      torch.finfo(torch.float32).tiny)
        choice = torch.argmax(mix_logits - torch.log(-torch.log(u_gumbel)), dim=-1)
        onehot = torch.nn.functional.one_hot(choice, self.n_mix).to(auto.dtype)
        selected = torch.sum(auto * onehot[..., None, :], dim=-1)
        return selected * 0.5 + 0.5
