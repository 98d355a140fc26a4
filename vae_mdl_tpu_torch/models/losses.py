"""The IWAE and ELBO objectives: one layer, two layers and L layers.

Port of ``vae_mdl_tpu/models/losses.py`` (``effective_sample_size``,
``_reduce``, ``_bits_per_dim``, ``iwae_loss``, ``elbo_loss``,
``two_layer_iwae_loss``, ``hierarchical_iwae_loss``). Log-probs are reduced
over each distribution's event axes; the only cross-sample op is the
logmeanexp over the leading importance-sample axis.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

import torch

from vae_mdl_tpu_torch.distributions import DistributionTuple
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
    distributions with ``log_prob`` and ``event_axes``. Differentiable,
    through the CUDA likelihood kernels as through the plain version.
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


def elbo_loss(x, z, pz, qzx, pxz) -> Tuple[torch.Tensor, Metrics]:
    """Plain ELBO: the mean over samples instead of the logmeanexp."""
    lpz = _reduce(pz, z)
    lqzx = _reduce(qzx, z)
    lpxz = _reduce(pxz, x)
    log_w = lpxz + (lpz - lqzx)
    elbo = torch.mean(torch.mean(log_w, dim=0), dim=-1)
    return -elbo, {"loss": -elbo, "lpxz": lpxz}


def two_layer_iwae_loss(x, pz, qz1x, qz2z1, pz1z2, pxz1,
                        beta: float = 1.0) -> Tuple[torch.Tensor, Metrics]:
    """The two-stochastic-layer bound, spelled out, with per-layer KL
    metrics. Arguments are ``DistributionTuple``s except ``pz``, the top
    prior distribution."""
    lqz2z1 = _reduce(qz2z1.dist, qz2z1.z, qz2z1.axes)
    lqz1x = _reduce(qz1x.dist, qz1x.z, qz1x.axes)

    lpz2 = _reduce(pz, qz2z1.z)
    lpz1z2 = _reduce(pz1z2.dist, qz1x.z, qz1x.axes)
    lpxz = _reduce(pxz1.dist, x, pxz1.axes)

    log_w = lpxz + beta * ((lpz2 - lqz2z1) + (lpz1z2 - lqz1x))

    iwae_elbo = torch.mean(logmeanexp(log_w, dim=0), dim=-1)
    bpd = _bits_per_dim(iwae_elbo, x)

    kl1 = -torch.mean(lpz1z2 - lqz1x, dim=0)
    kl2 = -torch.mean(lpz2 - lqz2z1, dim=0)

    return -iwae_elbo, {
        "iwae_elbo": iwae_elbo,
        "bpd": bpd,
        "lpxz": lpxz,
        "lqz1x": lqz1x,
        "lqz2z1": lqz2z1,
        "lpz2": lpz2,
        "lpz1z2": lpz1z2,
        "kl1": kl1,
        "kl2": kl2,
        "ess": effective_sample_size(log_w),
    }


def hierarchical_iwae_loss(
    x: torch.Tensor,
    Qs: Union[Dict[int, DistributionTuple], Sequence[DistributionTuple]],
    Ps: Union[Dict[int, DistributionTuple], Sequence[DistributionTuple]],
    pxz: DistributionTuple,
    prior: DistributionTuple,
    beta: float = 1.0,
) -> Tuple[torch.Tensor, Metrics]:
    """The L-layer importance-weighted bound.

    - ``Qs[i]``, i = 1..L: inference distributions q(z_i | .) with their
      samples attached; ``Qs[L]`` is the top layer.
    - ``Ps[i]``, i = 1..L-1: generative conditionals p(z_i | z_{i+1}), each
      evaluated at ``Qs[i]``'s sample.
    - ``pxz``: p(x | z_1); ``prior``: the top prior p(z_L), both as
      ``DistributionTuple``s.

    Takes dicts keyed 1..L or plain sequences [q1, ..., qL] / [p1, ...].
    """
    if not isinstance(Qs, dict):
        Qs = {i + 1: q for i, q in enumerate(Qs)}
    if not isinstance(Ps, dict):
        Ps = {i + 1: p for i, p in enumerate(Ps)}

    top = max(Qs.keys())

    # the top layer against the prior
    zq_top = Qs[top]
    log_p = _reduce(prior.dist, zq_top.z, prior.axes)
    log_q = _reduce(zq_top.dist, zq_top.z, zq_top.axes)
    kls: List[torch.Tensor] = [log_p - log_q]

    # the layers 1 .. L-1
    for i in range(1, top):
        q = Qs[i]
        p = Ps[i]
        log_q = _reduce(q.dist, q.z, q.axes)
        log_p = _reduce(p.dist, q.z, p.axes)
        kls.append(log_p - log_q)

    lpxz = _reduce(pxz.dist, x, pxz.axes)

    log_w = lpxz + beta * sum(kls)

    iwae_elbo = torch.mean(logmeanexp(log_w, dim=0), dim=-1)
    bpd = _bits_per_dim(iwae_elbo, x)

    return -iwae_elbo, {
        "iwae_elbo": iwae_elbo,
        "bpd": bpd,
        "lpxz": lpxz,
        "kl": [-torch.mean(k, dim=0) for k in kls],
        "ess": effective_sample_size(log_w),
    }
