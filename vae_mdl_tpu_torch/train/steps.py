"""Train and eval steps.

Port of ``vae_mdl_tpu/train/steps.py``. A step takes a uint8 batch on the
model's device, preprocesses it there, runs
the k-sample forward pass and the bound, differentiates it with autograd
(through the MoDL kernels on a card) and applies the optimizer's update to
the parameters in place. Nothing in a step waits for the device: the
optimizer's counts and learning rate, the gradient's norm and the skip rule
stay there (the skip is a select, not a branch), and metrics come back as
0-dimensional tensors, read when the caller wants them.

The factories mirror the JAX ones: ``make_train_step`` (one step),
``make_multi_train_step`` (a Python loop of n steps per call; equal to n
single steps, since each step's generators derive from the state's seed and
step), ``make_device_data_train_step`` (a dataset on the device, batches
gathered by indices drawn there) and ``make_eval_step``. A step updates the
state in place and returns it. Over several ranks ``mesh=`` takes the
data-parallel step of ``parallel/spmd.py`` in its place; a state in the
tensor-parallel layout (``parallel/tensor.py``) trains through the plain
step too, its gradient norm summed over the ``model`` group.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from vae_mdl_tpu_torch.config import ExperimentConfig
from vae_mdl_tpu_torch.data.preprocess import binarize, dequantize, random_flip
from vae_mdl_tpu_torch.models.objective import apply, compute_loss, training_loss_fn
from vae_mdl_tpu_torch.models.vae import prior_for
from vae_mdl_tpu_torch.train.state import (
    GradientTransformation,
    Params,
    TrainState,
    ema_update,
    eval_params,
    global_norm,
    tree_map,
)

Metrics = Dict[str, torch.Tensor]


def _scalarize(metrics) -> Metrics:
    def mean(v):
        if isinstance(v, (list, tuple)):
            return [mean(u) for u in v]
        return torch.mean(v.detach().float())
    return {name: mean(v) for name, v in metrics.items()}


def skip_select(ok: torch.Tensor, new_tree, old_tree):
    """Per leaf ``where(ok, new, old)``: the branchless update-or-skip."""
    return tree_map(lambda a, b: torch.where(ok, a, b), new_tree, old_tree)


def update_ok(loss: torch.Tensor, gnorm: torch.Tensor, threshold: float) -> torch.Tensor:
    """VDVAE's skip rule: update iff the loss and the gradient's global norm
    are finite and the norm is under the threshold."""
    return torch.isfinite(loss) & torch.isfinite(gnorm) & (gnorm < threshold)


def apply_update(cfg: ExperimentConfig, tx: GradientTransformation, params: Params,
                 opt_state, grads: Params, loss: torch.Tensor, *,
                 grad_norm: Optional[torch.Tensor] = None):
    """The update policy of every train step: grad norm -> ``tx.update`` ->
    add the updates to ``params`` in place -> skip-select. Returns
    ``(new_opt_state, ok, stats)``; ``ok`` is None when the skip rule is
    off, else the device boolean the EMA must also gate on.

    ``grad_norm`` is the norm the skip rule and the ``grad_norm`` metric
    read, where the caller has it: the ZeRO-1 step passes the norm of the
    whole mean gradient, summed over the ranks' slices, since ``grads`` is
    its slice alone (and it applies the clip itself with that norm, which
    leaves the clip inside ``tx`` nothing to do). None: the norm of
    ``grads``."""
    want_gnorm = cfg.train.grad_skip_threshold > 0 or cfg.train.grad_clip_norm > 0
    stats = {}
    if want_gnorm and grad_norm is None:
        grad_norm = global_norm(grads)  # before the clip
    updates, new_opt = tx.update(grads, opt_state, params)
    ok = None
    with torch.no_grad():
        if cfg.train.grad_skip_threshold > 0:
            # skip the whole update (params, moments, EMA) on a blown-up or
            # non-finite gradient; the step counter still advances
            ok = update_ok(loss, grad_norm, cfg.train.grad_skip_threshold)
            for name, p in params.items():
                p.copy_(torch.where(ok, p + updates[name], p))
            new_opt = skip_select(ok, new_opt, opt_state)
            stats["skipped"] = (~ok).float()
        else:
            torch._foreach_add_(list(params.values()), list(updates.values()))
    if want_gnorm:
        stats["grad_norm"] = grad_norm
    return new_opt, ok, stats


def tensor_parallel_clip(cfg: ExperimentConfig, state: TrainState, grads: Params):
    """``(grads, grad_norm)`` for ``apply_update``: on a state in the
    tensor-parallel layout (``state.tp_layout``), whose sharded gradients
    are this rank's channel slices, the whole gradient's norm (a collective
    over the ``model`` group) and the clip applied with it, since ``tx``'s
    own clip would see the slices alone; else ``(grads, None)``."""
    want_gnorm = cfg.train.grad_skip_threshold > 0 or cfg.train.grad_clip_norm > 0
    if not want_gnorm or state.tp_layout is None:
        return grads, None
    gnorm = state.tp_layout.global_norm(grads)
    if cfg.train.grad_clip_norm > 0:
        scale = clip_scale(cfg.train.grad_clip_norm, gnorm)
        grads = dict(zip(grads, torch._foreach_mul(list(grads.values()), scale)))
    return grads, gnorm


def clip_scale(max_norm: float, gnorm: torch.Tensor) -> torch.Tensor:
    """``min(1, max_norm / gnorm)``: the factor that clips a gradient of
    global norm ``gnorm`` to ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-16), max=1.0)


def ema_step(cfg: ExperimentConfig, ema: Optional[Params], params: Params,
             ok: Optional[torch.Tensor]) -> Optional[Params]:
    """Fold the (post-update) params into the EMA, gated by the same ``ok``."""
    if cfg.train.ema_decay > 0 and ema is not None:
        new_ema = ema_update(cfg.train.ema_decay, ema, params)
        return skip_select(ok, new_ema, ema) if ok is not None else new_ema
    return ema


def reduce_scan_metrics(metrics: List[Metrics]) -> Metrics:
    """The metrics of a window of steps: the last step's gauges, the sum of
    ``skipped`` and the max of ``grad_norm``."""
    out = dict(metrics[-1])
    if "skipped" in out:
        out["skipped"] = torch.sum(torch.stack([m["skipped"] for m in metrics]))
    if "grad_norm" in out:
        out["grad_norm"] = torch.amax(torch.stack([m["grad_norm"] for m in metrics]))
    return out


def effective_beta(cfg: ExperimentConfig, step: int) -> float:
    """The bound's beta at a train step: ``model.beta`` times a linear 0 -> 1
    ramp over ``train.beta_warmup_steps`` applied updates (under gradient
    accumulation every micro-batch of one update sees the same beta)."""
    w = cfg.train.beta_warmup_steps
    if w <= 0:
        return cfg.model.beta
    applied = step // max(1, cfg.train.grad_accum_steps)
    return cfg.model.beta * min(1.0, (applied + 1.0) / float(w))


def preprocess(cfg: ExperimentConfig, batch: torch.Tensor,
               generator: Optional[torch.Generator],
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 batch -> model input, on the batch's device. A Bernoulli model
    on dynamically binarised data takes ``x = (u < x)``, ``u`` uniform on
    [0, 1) drawn from ``generator`` or injected."""
    x = batch if batch.is_floating_point() else dequantize(batch)
    if cfg.model.likelihood == "bernoulli" and cfg.data.dynamic_binarization:
        x = binarize(generator, x) if u is None else (u < x).float()
    return x


def preprocess_train(cfg: ExperimentConfig, batch: torch.Tensor,
                     rngs: Dict[str, torch.Generator],
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-path preprocessing: ``preprocess`` plus the train-only random
    horizontal flip. Expects the "binarize" and "flip" streams."""
    x = preprocess(cfg, batch, rngs["binarize"], u)
    if cfg.data.augment_flip:
        x = random_flip(rngs["flip"], x)
    return x


def make_train_step(model, cfg: ExperimentConfig, tx: GradientTransformation) -> Callable:
    """``(state, uint8 batch[B, H, W, C]) -> (state, metrics)``."""
    k = cfg.model.n_samples

    def step(state: TrainState, batch: torch.Tensor, eps=None, u=None):
        """One update of ``state`` (in place) on ``batch``; ``eps``, z_1's
        ``[k, B, n_latent]`` (``[k, B, h, w, c]`` for a ladder) or a sequence
        with one tensor per stochastic layer, bottom up, injects the
        standard-normal noise in place of the "sample" stream's draw, and
        ``u`` (``[B, H, W, C]``, uniform on [0, 1)) the binarisation's
        uniforms in place of the "binarize" stream's."""
        rngs = state.next_rngs("sample", "binarize", "flip", device=batch.device)
        x = preprocess_train(cfg, batch, rngs, u)
        beta = effective_beta(cfg, state.step)
        loss_fn = training_loss_fn(model, cfg, prior_for(cfg.model, x.device), x, k,
                                   rngs["sample"], beta, eps=eps)
        loss, metrics = loss_fn(state.params)
        grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
        grads, gnorm = tensor_parallel_clip(cfg, state, grads)
        state.opt_state, ok, stats = apply_update(cfg, tx, state.params, state.opt_state,
                                                  grads, loss.detach(), grad_norm=gnorm)
        state.ema_params = ema_step(cfg, state.ema_params, state.params, ok)
        state.step += 1
        out = _scalarize(metrics)
        out.update(stats)
        out["loss"] = loss.detach()
        return state, out

    return step


def make_multi_train_step(model, cfg: ExperimentConfig, tx: GradientTransformation,
                          n_steps: int, mesh=None) -> Callable:
    """``(state, batches[n, B, ...]) -> (state, metrics of the window)``:
    ``n_steps`` updates per call, equal to as many single steps (under a
    ``mesh``, of ``parallel.spmd.make_shard_map_train_step`` on this rank's
    rows)."""
    if mesh is None:
        step = make_train_step(model, cfg, tx)
    else:
        from vae_mdl_tpu_torch.parallel.spmd import make_shard_map_train_step

        step = make_shard_map_train_step(model, cfg, tx, mesh)

    def multi(state: TrainState, batches: torch.Tensor):
        if batches.shape[0] != n_steps:
            raise ValueError(f"expected {n_steps} batches, got {batches.shape[0]}")
        window = []
        for batch in batches:
            state, metrics = step(state, batch)
            window.append(metrics)
        return state, reduce_scan_metrics(window)

    return multi


def make_device_data_train_step(model, cfg: ExperimentConfig, tx: GradientTransformation,
                                n_steps: int, n_data: int, mesh=None) -> Callable:
    """``(state, data[N, H, W, C] uint8) -> (state, metrics of the window)``
    for a dataset that lives on the device: each step gathers its batch by
    indices drawn there, i.i.d. with replacement, from the "device_batch"
    stream. Under a ``mesh`` every rank holds the whole dataset, draws the
    same indices and gathers its rows of them for the data-parallel step
    (``parallel.spmd.make_shard_map_train_step``)."""
    batch_size = cfg.data.batch_size
    rows = slice(0, batch_size)
    if mesh is None:
        step = make_train_step(model, cfg, tx)
    else:
        from vae_mdl_tpu_torch.parallel.mesh import batch_sharding
        from vae_mdl_tpu_torch.parallel.spmd import make_shard_map_train_step

        step = make_shard_map_train_step(model, cfg, tx, mesh)
        index, count = batch_sharding(mesh)
        rows = slice(index * batch_size // count, (index + 1) * batch_size // count)

    def multi(state: TrainState, data: torch.Tensor):
        window = []
        for _ in range(n_steps):
            gen = state.next_rngs("device_batch", device=data.device)["device_batch"]
            idx = torch.randint(0, n_data, (batch_size,), generator=gen, device=data.device)
            state, metrics = step(state, data[idx[rows]])
            window.append(metrics)
        return state, reduce_scan_metrics(window)

    return multi


def make_eval_step(model, cfg: ExperimentConfig, n_samples: Optional[int] = None,
                   fold: Optional[int] = None) -> Callable:
    """``(state, uint8 batch) -> metrics`` on the eval weights (the EMA copy
    when enabled) with the true bound: free bits is a training-only floor.
    ``fold`` (a rank's batch shard) is folded into the generators' seeds."""
    k = n_samples or cfg.model.n_samples

    def step(state: TrainState, batch: torch.Tensor) -> Metrics:
        with torch.no_grad():
            rngs = state.next_rngs("eval_sample", "eval_binarize", device=batch.device,
                                   fold=fold)
            x = preprocess(cfg, batch, rngs["eval_binarize"])
            Qs, Ps, pxz = apply(model, eval_params(cfg.train, state), x, k,
                                generator=rngs["eval_sample"])
            loss, metrics = compute_loss(prior_for(cfg.model, x.device), Qs, Ps, pxz, x,
                                         beta=cfg.model.beta,
                                         objective=getattr(cfg.model, "objective", "iwae"),
                                         free_bits=0.0)
            out = _scalarize(metrics)
            out["loss"] = loss
            return out

    return step
