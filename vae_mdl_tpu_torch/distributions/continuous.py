"""Normal, Logistic and Bernoulli distributions (float32 likelihood math).

Port of ``vae_mdl_tpu/distributions/continuous.py``. ``sample`` draws from
an explicit ``torch.Generator``; ``noise=`` injects the standard draw
instead, so a test can feed the JAX package and the port the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from vae_mdl_tpu_torch.distributions.base import Distribution

_LOG_2PI = math.log(2.0 * math.pi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, max(x, 0) + log1p(exp(-|x|)).
    ``torch.nn.functional.softplus`` linearises above a threshold and is
    not the same function. ``torch.maximum`` splits the gradient at the tie
    x = 0 as ``jnp.maximum`` does (0.5 each), so the gradient there is 0.5,
    as ``jax.nn.softplus``'s; ``clamp_min`` would pass 1."""
    return torch.maximum(x, x.new_zeros(())) + torch.log1p(torch.exp(-torch.abs(x)))


def _sample_shape(sample_shape, *tensors) -> Tuple[int, ...]:
    return tuple(sample_shape) + tuple(torch.broadcast_shapes(*(t.shape for t in tensors)))


@dataclasses.dataclass
class Normal(Distribution):
    loc: torch.Tensor
    scale: torch.Tensor
    event_axes: Tuple[int, ...] = (-1,)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(self.scale)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Tuple[int, ...] = (),
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``loc + scale * eps``, eps ~ N(0, 1) from ``generator`` unless
        ``noise`` gives it (shape ``sample_shape + batch shape``)."""
        if noise is None:
            noise = torch.randn(_sample_shape(sample_shape, self.loc, self.scale),
                                generator=generator, device=self.loc.device,
                                dtype=self.loc.dtype)
        return self.loc + self.scale * noise

    def mean(self) -> torch.Tensor:
        return torch.broadcast_to(self.loc, torch.broadcast_shapes(self.loc.shape,
                                                                   self.scale.shape))

    def kl_to_standard_normal(self) -> torch.Tensor:
        """The analytic KL(N(loc, scale) || N(0, 1)), elementwise."""
        return 0.5 * (self.loc * self.loc + self.scale * self.scale - 1.0) - torch.log(self.scale)


@dataclasses.dataclass
class Logistic(Distribution):
    """Logistic(loc, scale); the base of the discretized likelihoods."""

    loc: torch.Tensor
    scale: torch.Tensor
    event_axes: Tuple[int, ...] = (-1,)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -z - 2.0 * softplus(-z) - torch.log(self.scale)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Tuple[int, ...] = (),
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inverse-CDF sampling from u ~ U[tiny, 1) (``generator``) or from
        the injected uniforms ``noise``."""
        if noise is None:
            tiny = torch.finfo(torch.float32).tiny
            noise = torch.rand(_sample_shape(sample_shape, self.loc, self.scale),
                               generator=generator, device=self.loc.device,
                               dtype=self.loc.dtype).clamp_min_(tiny)
        return self.loc + self.scale * (torch.log(noise) - torch.log1p(-noise))

    def mean(self) -> torch.Tensor:
        return torch.broadcast_to(self.loc, torch.broadcast_shapes(self.loc.shape,
                                                                   self.scale.shape))


@dataclasses.dataclass
class Bernoulli(Distribution):
    logits: torch.Tensor
    event_axes: Tuple[int, ...] = (-1, -2, -3)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        # x * logits - softplus(logits): the stable cross-entropy form
        return x * self.logits - softplus(self.logits)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Tuple[int, ...] = (),
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """1.0 where u < sigmoid(logits), u ~ U[0, 1) from ``generator``
        unless ``noise`` gives the uniforms."""
        if noise is None:
            noise = torch.rand(tuple(sample_shape) + tuple(self.logits.shape),
                               generator=generator, device=self.logits.device)
        return (noise < torch.sigmoid(self.logits)).float()

    def mean(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)
