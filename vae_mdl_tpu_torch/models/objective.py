"""From a VAE forward pass to the bound, its training loss and gradients.

Port of ``bound_terms``, ``log_weights``, ``compute_loss``,
``_free_bits_elbo``, ``_dreg_half``, ``stop_gradient_half`` and
``training_loss_fn`` from ``vae_mdl_tpu/models/objective.py``, at any
stochastic depth: ``compute_loss`` picks ``iwae_loss`` for one layer,
``two_layer_iwae_loss`` for two and ``hierarchical_iwae_loss`` above.

Parameters are handled as ``{name: tensor}`` dicts, the model's
``named_parameters()``: ``training_loss_fn`` builds ``loss_fn(params)``,
which runs the model through ``torch.func.functional_call`` with those
tensors in place of its own, so a caller can detach some of them (the DReG
halves) or hand in another set (the EMA copy) without touching the module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal
from vae_mdl_tpu_torch.models.vae import VAE, latent_shapes
from vae_mdl_tpu_torch.models.losses import (
    Metrics,
    _bits_per_dim,
    _reduce,
    hierarchical_iwae_loss,
    iwae_loss,
    two_layer_iwae_loss,
)

Params = Dict[str, torch.Tensor]


def _detached(dist):
    """The distribution with every tensor field detached."""
    return dataclasses.replace(dist, **{
        f.name: getattr(dist, f.name).detach() for f in dataclasses.fields(dist)
        if isinstance(getattr(dist, f.name), torch.Tensor)})


def bound_terms(
    prior: Normal,
    Qs: Tuple[DistributionTuple, ...],
    Ps: Tuple[DistributionTuple, ...],
    pxz: DistributionTuple,
    x: torch.Tensor,
    stop_q_params: bool = False,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(lpxz, [kl_top, kl_1, ..., kl_{L-1}])``, each ``[k, B]``; every KL
    term is the per-sample log-ratio ``log p - log q``.

    ``stop_q_params=True`` evaluates each q's log-prob under detached
    distribution parameters while the sample z stays live: the log-weight of
    the DReG estimator for one stochastic layer (Tucker et al. 2019, eq. 12).
    With hierarchical posteriors q_i(z_i | z_{i-1}) that would sever the live
    route z_{i-1} -> q_i's parameters; ``training_loss_fn`` re-evaluates the
    inference maps on detached weights at the live latents instead
    (``VAE.posterior_at``).
    """
    def qd(q):
        return _detached(q.dist) if stop_q_params else q.dist

    top = Qs[-1]
    lpxz = _reduce(pxz.dist, x, pxz.axes)
    kls = [_reduce(prior, top.z, prior.event_axes) - _reduce(qd(top), top.z, top.axes)]
    for i in range(len(Qs) - 1):
        kls.append(_reduce(Ps[i].dist, Qs[i].z, Ps[i].axes)
                   - _reduce(qd(Qs[i]), Qs[i].z, Qs[i].axes))
    return lpxz, kls


def log_weights(
    prior: Normal,
    Qs: Tuple[DistributionTuple, ...],
    Ps: Tuple[DistributionTuple, ...],
    pxz: DistributionTuple,
    x: torch.Tensor,
    beta: float = 1.0,
    stop_q_params: bool = False,
) -> torch.Tensor:
    """Unnormalised importance log-weights ``[k, B]``, the quantity the
    5000-IS evaluator streams over k-chunks."""
    lpxz, kls = bound_terms(prior, Qs, Ps, pxz, x, stop_q_params=stop_q_params)
    kl = kls[0]
    for term in kls[1:]:
        kl = kl + term
    return lpxz + beta * kl


def _check_free_bits(objective: str, free_bits: float) -> None:
    if free_bits > 0.0 and objective != "elbo":
        raise ValueError(
            "free_bits floors per-layer EXPECTED KLs, which only decompose "
            "out of the ELBO objective (Kingma et al. 2016 §C.8); got "
            f"objective={objective!r}. Use objective='elbo' with free_bits, "
            "or free_bits=0.")


def compute_loss(
    prior: Normal,
    Qs: Tuple[DistributionTuple, ...],
    Ps: Tuple[DistributionTuple, ...],
    pxz: DistributionTuple,
    x: torch.Tensor,
    beta: float = 1.0,
    objective: str = "iwae",
    free_bits: float = 0.0,
) -> Tuple[torch.Tensor, Metrics]:
    """``(loss, metrics)`` for ``objective`` "iwae", "elbo" (with
    ``free_bits``) or "iwae_dreg", whose value is the IWAE bound: DReG only
    changes the gradient, which ``training_loss_fn`` builds."""
    _check_free_bits(objective, free_bits)
    if objective == "iwae_dreg":
        objective = "iwae"
    if objective == "elbo":
        if free_bits > 0.0:
            return _free_bits_elbo(prior, Qs, Ps, pxz, x, beta, free_bits)
        elbo = torch.mean(log_weights(prior, Qs, Ps, pxz, x, beta=beta))
        return -elbo, {"elbo": elbo, "bpd": _bits_per_dim(elbo, x), "loss": -elbo}
    if len(Qs) == 1:
        return iwae_loss(x, Qs[0].z, prior, Qs[0].dist, pxz.dist, beta=beta)
    if len(Qs) == 2:
        return two_layer_iwae_loss(x, prior, Qs[0], Qs[1], Ps[0], pxz, beta=beta)
    return hierarchical_iwae_loss(
        x, Qs, Ps, pxz, DistributionTuple(prior, None, axes=prior.event_axes), beta=beta)


def _free_bits_elbo(prior, Qs, Ps, pxz, x, beta, free_bits):
    """ELBO with per-layer free bits (Kingma et al. 2016 §C.8): each layer's
    expected KL is floored at ``free_bits`` nats inside the objective, so
    below the floor the KL term gives no gradient. Metrics report the true
    ELBO beside the floored loss."""
    lpxz, kls = bound_terms(prior, Qs, Ps, pxz, x)
    kl_means = [-torch.mean(t) for t in kls]
    # torch.maximum passes half the gradient at a tie, as jnp.maximum
    floored = [torch.maximum(m, m.new_full((), free_bits)) for m in kl_means]
    loss = -(torch.mean(lpxz) - beta * sum(floored))

    kl_sum = kls[0]
    for term in kls[1:]:
        kl_sum = kl_sum + term
    elbo = torch.mean(lpxz + beta * kl_sum)
    return loss, {
        "elbo": elbo,
        "bpd": _bits_per_dim(elbo, x),
        "loss": loss,
        "kl": kl_means,
        "kl_floored_layers": sum((m < free_bits).float() for m in kl_means),
    }


# -- DReG: doubly-reparameterized IWAE gradients ------------------------------
#
# Tucker et al. 2019 (arXiv:1810.04152). The generative half keeps the IWAE
# gradient (normalised weights w~); the inference half is pathwise only, with
# squared weights, through a log-weight whose q parameter maps run on
# detached weights while z stays live. Each half's surrogate runs the forward
# with the other half's parameters detached.


def _dreg_half(name: str) -> str:
    top = name.split(".")[0]
    if top == "encoder" or top.startswith("mlp_encoder"):
        return "inference"
    if top == "decoder" or top.startswith("mlp_decoder"):
        return "generative"
    raise ValueError(
        f"objective='iwae_dreg' cannot classify parameter {name!r} as "
        "inference or generative; DReG is implemented for the VAE family, "
        "whose parameters split cleanly.")


def stop_gradient_half(params: Params, half: str) -> Params:
    """``params`` with the ``half`` ('inference' | 'generative') leaves
    detached; the values are the same."""
    return {name: p.detach() if _dreg_half(name) == half else p
            for name, p in params.items()}


class _Method(nn.Module):
    """Runs ``model.<name>`` as ``forward``, so ``functional_call`` can reach
    a method other than the model's own ``forward``."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.name)(*args, **kwargs)


def apply(model: nn.Module, params: Params, *args, method: str = "forward", **kwargs):
    """``model.<method>(*args, **kwargs)`` with ``params`` in place of the
    module's parameters (a ``{name: tensor}`` dict of all of them)."""
    if method == "forward":
        return torch.func.functional_call(model, params, args, kwargs)
    wrapped = {f"model.{name}": p for name, p in params.items()}
    return torch.func.functional_call(_Method(model, method), wrapped, args, kwargs)


def training_loss_fn(model, cfg, prior: Normal, x: torch.Tensor, k: int,
                     generator: Optional[torch.Generator] = None, beta: float = 1.0,
                     eps=None):
    """Build ``loss_fn(params) -> (loss, metrics)`` for one train step.

    The standard-normal noise is drawn once from ``generator``, one tensor
    ``[k, B] + shape_i`` per stochastic layer, bottom up as the ``Qs`` are
    (``models.vae.latent_shapes``: ``[k, B, n_i]`` for the VAE family,
    ``[k, B, h_i, w_i, c_i]`` for the ladders), or injected as ``eps`` (z_1's
    tensor, or a sequence with one per layer in that order), so every
    forward pass of one step, as the DReG surrogates need, sees the same
    latents. For "iwae" and "elbo" the loss is the plain forward and
    ``compute_loss``. For "iwae_dreg" the loss value is the IWAE bound and
    its gradient the DReG estimator, assembled from two forward passes with
    complementary halves detached; it is defined for the VAE family only.
    ``objective`` and ``free_bits`` default to "iwae" and 0 where the model's
    config has no such field (the ladders').
    """
    objective = getattr(cfg.model, "objective", "iwae")
    free_bits = getattr(cfg.model, "free_bits", 0.0)
    _check_free_bits(objective, free_bits)
    eps = [eps] if isinstance(eps, torch.Tensor) else list(eps or ())
    # the layers given no noise draw theirs, bottom up
    eps += [torch.randn((k, x.shape[0]) + shape, generator=generator, device=x.device)
            for shape in latent_shapes(cfg.model)[len(eps):]]

    if objective != "iwae_dreg":
        def loss_fn(params: Params):
            Qs, Ps, pxz = apply(model, params, x, k, eps=eps)
            return compute_loss(prior, Qs, Ps, pxz, x, beta=beta, objective=objective,
                                free_bits=free_bits)
        return loss_fn

    if not isinstance(model, VAE):
        # the ladders share top-down parameters between inference and
        # generation, where the estimator's parameter partition is not defined
        raise ValueError("objective='iwae_dreg' is implemented for the VAE family "
                         f"(ModelConfig); got {type(model).__name__}.")

    def loss_fn(params: Params):
        # generative half: the IWAE surrogate sum_k sg(w~_k) log w_k
        Qs, Ps, pxz = apply(model, stop_gradient_half(params, "inference"), x, k, eps=eps)
        lw = log_weights(prior, Qs, Ps, pxz, x, beta=beta)
        w = torch.softmax(lw, dim=0).detach()
        dec_surr = -torch.mean(torch.sum(w * lw, dim=0))
        loss, metrics = compute_loss(prior, Qs, Ps, pxz, x, beta=beta, objective="iwae")

        # inference half: squared weights; the q maps re-run on detached
        # weights at the live latents (VAE.posterior_at)
        Qs2, Ps2, pxz2 = apply(model, stop_gradient_half(params, "generative"), x, k, eps=eps)
        detached = {name: p.detach() for name, p in params.items()}
        Qs_hat = apply(model, detached, x, tuple(q.z for q in Qs2), method="posterior_at")
        lw_hat = log_weights(prior, Qs_hat, Ps2, pxz2, x, beta=beta)
        enc_surr = -torch.mean(torch.sum(w * w * lw_hat, dim=0))

        surr = dec_surr + enc_surr
        # value = the IWAE bound; gradient = the DReG estimator
        return loss.detach() + surr - surr.detach(), metrics

    return loss_fn
