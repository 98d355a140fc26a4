"""Distribution protocol with explicit event axes.

Port of ``vae_mdl_tpu/distributions/base.py``: every distribution carries
``event_axes``, and model code hands ``DistributionTuple``s to the losses.
Sampling takes an explicit ``torch.Generator`` (or injected noise).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

Axes = Tuple[int, ...]


class Distribution:
    """Mixin: concrete distributions expose ``log_prob(x)``, ``sample`` and
    an ``event_axes`` field."""

    event_axes: Axes

    def reduced_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """``log_prob`` summed over this distribution's event axes."""
        return torch.sum(self.log_prob(x), dim=self.event_axes)


@dataclasses.dataclass
class DistributionTuple:
    """A distribution, a sample drawn from it (or None), and reduction axes.
    ``axes`` defaults to the image event axes ``(-1, -2, -3)``."""

    dist: Any
    sample: Optional[torch.Tensor] = None
    axes: Axes = (-1, -2, -3)

    @property
    def z(self):
        return self.sample

    @property
    def x(self):
        return self.sample

    @property
    def p(self):
        return self.dist

    @property
    def q(self):
        return self.dist
