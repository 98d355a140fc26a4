"""From a VAE forward pass to the bound's terms and importance log-weights.

Port of ``bound_terms`` and ``log_weights`` from
``vae_mdl_tpu/models/objective.py``; the DReG variant (``stop_q_params``)
comes with the training slice.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal
from vae_mdl_tpu_torch.models.losses import _reduce


def bound_terms(
    prior: Normal,
    Qs: Tuple[DistributionTuple, ...],
    Ps: Tuple[DistributionTuple, ...],
    pxz: DistributionTuple,
    x: torch.Tensor,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(lpxz, [kl_top, kl_1, ..., kl_{L-1}])``, each ``[k, B]``; every KL
    term is the per-sample log-ratio ``log p - log q``."""
    top = Qs[-1]
    lpxz = _reduce(pxz.dist, x, pxz.axes)
    kls = [_reduce(prior, top.z, prior.event_axes) - _reduce(top.dist, top.z, top.axes)]
    for i in range(len(Qs) - 1):
        kls.append(_reduce(Ps[i].dist, Qs[i].z, Ps[i].axes)
                   - _reduce(Qs[i].dist, Qs[i].z, Qs[i].axes))
    return lpxz, kls


def log_weights(
    prior: Normal,
    Qs: Tuple[DistributionTuple, ...],
    Ps: Tuple[DistributionTuple, ...],
    pxz: DistributionTuple,
    x: torch.Tensor,
    beta: float = 1.0,
) -> torch.Tensor:
    """Unnormalised importance log-weights ``[k, B]``, the quantity the
    5000-IS evaluator streams over k-chunks."""
    lpxz, kls = bound_terms(prior, Qs, Ps, pxz, x)
    kl = kls[0]
    for term in kls[1:]:
        kl = kl + term
    return lpxz + beta * kl
