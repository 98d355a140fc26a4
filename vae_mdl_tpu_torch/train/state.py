"""The full training state, and the optimizers that update it.

Port of ``vae_mdl_tpu/train/state.py``. ``TrainState`` holds the model's own
parameters (updated in place by the train step), the optimizer state, the
step, the seed, the best validation loss and the EMA copy; ``state_dict()``
and ``load_state_dict()`` make it a full resume point.

Randomness: each step draws from generators seeded from (seed, step, crc32
of the stream's name), as ``TrainState.next_rngs`` folds its keys in the JAX
package, so a resumed run draws what an uninterrupted one draws, and
streams never share numbers. ``stream_generators`` makes them for any step;
``seed_streams`` seeds generators that already exist, which is how a step
captured in a CUDA graph (``train/capture.py``) draws afresh at every
replay: its generators are registered with the graph, which reads their
seed and offset from device memory, and are re-seeded on the host before
each replay.

The state's tensors are its own: ``load_state_dict`` copies into them in
place, so their addresses, which a captured step reads and writes, survive
a resume. ``tree_leaves`` lists a tree's tensors in a fixed order.

The optimizers follow optax's formulas, as ``(init, update)`` pairs on
``{name: tensor}`` dicts: ``adam`` (``optax.adam``), ``adamax``
(``optax.adamax``: eps added to |g| inside the max, not to the max),
``keras_adam`` (eps added to the square root of the uncorrected second
moment), ``clip_by_global_norm``, ``multi_steps`` (``optax.MultiSteps``:
running mean of the micro-batch gradients, the inner update applied every
k-th call) and ``chain``. Counts are int32 tensors on the parameters'
device and the learning rate is computed there, so an update needs no copy
to or from the host; the arithmetic runs as optax's does, in float32, with
PyTorch's multi-tensor (``_foreach``) ops.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from vae_mdl_tpu_torch.config import TrainConfig
from vae_mdl_tpu_torch.train.schedule import constant_schedule, staircase_schedule, with_warmup

Params = Dict[str, torch.Tensor]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value, *(r[key] for r in rest)) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of nested dicts and lists, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in tree_leaves(value)]
    if isinstance(tree, (list, tuple)):
        return [leaf for value in tree for leaf in tree_leaves(value)]
    return [] if tree is None else [tree]


def _stream_seed(seed: int, step: int, name: str, fold: Optional[int] = None) -> int:
    entropy = [seed, step, zlib.crc32(name.encode()) & 0x7FFFFFFF]
    if fold is not None:
        entropy.append(fold)
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


Fold = Union[None, int, Mapping[str, Optional[int]]]


def seed_streams(generators: Dict[str, torch.Generator], seed: int, step: int,
                 fold: Fold = None) -> Dict[str, torch.Generator]:
    """Seed each of ``{stream name: generator}`` for ``step`` from (seed,
    step, crc32 of the name[, fold]), in place; a generator then draws
    what a fresh one of ``stream_generators`` draws. ``fold``: one for
    every stream, or ``{stream name: fold or None}`` (a stream it does not
    name is not folded)."""
    for name, gen in generators.items():
        own = fold.get(name) if isinstance(fold, Mapping) else fold
        gen.manual_seed(_stream_seed(seed, step, name, own))
    return generators


def stream_generators(seed: int, step: int, streams: Sequence[str], device=None,
                      fold: Fold = None) -> Dict[str, torch.Generator]:
    """One generator on ``device`` per stream, seeded for ``step``."""
    return seed_streams({name: torch.Generator(device=device) for name in streams},
                        seed, step, fold)


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's own parameters, by name; the train step
    updates them in place under ``torch.no_grad``."""

    params: Params
    opt_state: Any
    step: int
    seed: int
    best_val_loss: float = math.inf
    # exponential moving average of the params (TrainConfig.ema_decay > 0)
    ema_params: Optional[Params] = None
    # the tensor-parallel layout (parallel.tensor.TPLayout) of a state whose
    # wide layers hold one rank's output channels; None: every tensor whole
    tp_layout: Optional[Any] = dataclasses.field(default=None, repr=False)

    def next_rngs(self, *streams: str, device=None,
                  fold: Optional[int] = None) -> Dict[str, torch.Generator]:
        """One generator per stream for this step, seeded from (seed, step,
        crc32 of the stream's name[, fold]); the parallel steps fold in the
        rank's batch shard, as the JAX package folds in the device index."""
        return stream_generators(self.seed, self.step, streams, device, fold)

    def state_dict(self) -> dict:
        """Everything a resume needs: tensors (detached, not copied) and
        numbers, as ``torch.save`` takes them."""
        return {
            "params": {name: p.detach() for name, p in self.params.items()},
            "opt_state": self.opt_state,
            "step": self.step,
            "seed": self.seed,
            "best_val_loss": self.best_val_loss,
            "ema_params": self.ema_params,
        }

    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict()`` into this state; tensors keep this
        state's devices, and every tensor of the same shape and dtype is
        written in place, so the state's tensors stay the ones a captured
        step reads."""
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(state["params"][name])
            self.opt_state = tree_map(_copy_into, self.opt_state, state["opt_state"])
            if state["ema_params"] is None:
                self.ema_params = None
            elif self.ema_params is not None and self.ema_params.keys() == state["ema_params"].keys():
                self.ema_params = tree_map(_copy_into, self.ema_params, state["ema_params"])
            else:
                device = next(iter(self.params.values())).device
                self.ema_params = {name: e.to(device, copy=True)
                                   for name, e in state["ema_params"].items()}
        self.step = int(state["step"])
        self.seed = int(state["seed"])
        self.best_val_loss = float(state["best_val_loss"])


def _copy_into(mine: torch.Tensor, theirs: torch.Tensor) -> torch.Tensor:
    """``theirs`` written into ``mine`` where shape and dtype agree, else a
    copy of ``theirs`` on ``mine``'s device."""
    if mine.shape == theirs.shape and mine.dtype == theirs.dtype:
        return mine.copy_(theirs)
    return theirs.to(mine.device, copy=True)


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, new_state)``."""

    init: Callable
    update: Callable


def _zeros(params: Params) -> Params:
    return {name: torch.zeros_like(p, memory_format=torch.preserve_format)
            for name, p in params.items()}


def _count0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)


def _moment(grads, moment, decay: float, order: int):
    """optax's ``(1 - decay) * g**order + decay * t``, per leaf."""
    g = list(grads.values())
    if order == 2:
        g = torch._foreach_mul(g, g)
    out = torch._foreach_mul(g, 1.0 - decay)
    torch._foreach_add_(out, torch._foreach_mul(list(moment.values()), decay))
    return dict(zip(moment, out))


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.pow(decay, count.to(torch.float32))


def _scaled(updates, scale: torch.Tensor) -> Params:
    return dict(zip(updates, torch._foreach_mul(list(updates.values()), scale)))


def adam(learning_rate: Callable, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam``: bias-corrected moments, ``eps`` added to the square
    root of the corrected second moment, scaled by ``-learning_rate(count)``."""
    def init(params):
        return {"count": _count0(params), "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params=None):
        mu = _moment(grads, state["mu"], b1, 1)
        nu = _moment(grads, state["nu"], b2, 2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(list(mu.values()), _bias_correction(b1, count))
        nu_hat = torch._foreach_div(list(nu.values()), _bias_correction(b2, count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        out = dict(zip(grads, torch._foreach_div(mu_hat, denom)))
        return _scaled(out, -learning_rate(state["count"])), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def adamax(learning_rate: Callable, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> GradientTransformation:
    """``optax.adamax``: ``nu = max(|g| + eps, b2 * nu)``, only the first
    moment bias-corrected."""
    def init(params):
        return {"count": _count0(params), "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        mu = _moment(grads, state["mu"], b1, 1)
        abs_g = torch._foreach_abs(list(grads.values()))
        torch._foreach_add_(abs_g, eps)
        nu = dict(zip(grads, torch._foreach_maximum(
            abs_g, torch._foreach_mul(list(state["nu"].values()), b2))))
        mu_hat = torch._foreach_div(list(mu.values()), _bias_correction(b1, count))
        out = dict(zip(grads, torch._foreach_div(mu_hat, list(nu.values()))))
        return _scaled(out, -learning_rate(state["count"])), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def keras_adam(learning_rate: Callable, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-7) -> GradientTransformation:
    """Adam as ``tf.keras.optimizers.Adam`` computes it, the reference's:
    ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` and
    ``w -= lr_t * m / (sqrt(v) + eps)`` with eps = 1e-7 on the uncorrected
    second moment."""
    def init(params):
        return {"count": _count0(params), "m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params=None):
        m = _moment(grads, state["m"], b1, 1)
        v = _moment(grads, state["v"], b2, 2)
        t = (state["count"] + 1).to(torch.float32)
        lr = learning_rate(state["count"])
        lr_t = lr * torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))
        denom = torch._foreach_sqrt(list(v.values()))
        torch._foreach_add_(denom, eps)
        out = torch._foreach_mul(list(m.values()), -lr_t)
        out = dict(zip(grads, torch._foreach_div(out, denom)))
        return out, {"count": state["count"] + 1, "m": m, "v": v}

    return GradientTransformation(init, update)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every element, optax's ``global_norm``."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tree.values()))))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: updates whose global norm reaches
    ``max_norm`` are scaled to it."""
    def init(params):
        return {}

    def update(grads, state, params=None):
        g_norm = global_norm(grads)
        keep = g_norm < max_norm
        clipped = torch._foreach_mul(torch._foreach_div(list(grads.values()), g_norm), max_norm)
        return {name: torch.where(keep, g, c) for (name, g), c in zip(grads.items(), clipped)}, state

    return GradientTransformation(init, update)


def multi_steps(inner: GradientTransformation, every_k: int) -> GradientTransformation:
    """``optax.MultiSteps``: a running mean of the gradients of ``every_k``
    calls; the k-th call applies the inner update to it and resets it, the
    others return zero updates and keep the inner state."""
    def init(params):
        return {"mini_step": _count0(params), "gradient_step": _count0(params),
                "inner_opt_state": inner.init(params), "acc_grads": _zeros(params)}

    def update(grads, state, params=None):
        mini = state["mini_step"]
        acc = {name: a + (grads[name] - a) / (mini + 1) for name, a in state["acc_grads"].items()}
        final, new_inner = inner.update(acc, state["inner_opt_state"], params)
        emit = mini == every_k - 1
        emit_f = emit.to(torch.float32)
        new_state = {
            "mini_step": (mini + 1) % every_k,
            "gradient_step": state["gradient_step"] + emit.to(torch.int32),
            "inner_opt_state": tree_map(lambda old, new: torch.where(emit, new, old),
                                        state["inner_opt_state"], new_inner),
            "acc_grads": {name: (1.0 - emit_f) * a for name, a in acc.items()},
        }
        return {name: emit_f * u for name, u in final.items()}, new_state

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return GradientTransformation(init, update)


def make_optimizer(cfg: TrainConfig) -> GradientTransformation:
    schedule = (
        staircase_schedule(cfg.learning_rate, cfg.lr_staircase_base, cfg.lr_staircase_levels)
        if cfg.lr_staircase else constant_schedule(cfg.learning_rate))
    schedule = with_warmup(schedule, cfg.lr_warmup_steps)
    opts = {"adam": adam, "adamax": adamax, "adam_keras": keras_adam}
    tx = opts[cfg.optimizer](schedule)
    if cfg.grad_accum_steps > 1:
        tx = multi_steps(tx, cfg.grad_accum_steps)
    if cfg.grad_clip_norm > 0:
        # clip outside the accumulation: each micro-batch's gradient is
        # clipped before it enters the running mean
        tx = chain(clip_by_global_norm(cfg.grad_clip_norm), tx)
    return tx


def create_train_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    """The state of a fresh run of ``model`` (initialised as built, on its
    device): optimizer state from ``make_optimizer(cfg)``, step 0, seed
    ``cfg.seed``."""
    params = dict(model.named_parameters())
    return TrainState(
        params=params,
        opt_state=make_optimizer(cfg).init(params),
        step=0,
        seed=cfg.seed,
        ema_params=({name: p.detach().clone() for name, p in params.items()}
                    if cfg.ema_decay > 0 else None),
    )


def ema_update(decay: float, ema_params: Params, params: Params) -> Params:
    """One EMA step: ``ema <- decay * ema + (1 - decay) * params``."""
    new = torch._foreach_mul(list(ema_params.values()), decay)
    torch._foreach_add_(new, torch._foreach_mul([p.detach() for p in params.values()],
                                                1.0 - decay))
    return dict(zip(ema_params, new))


def eval_params(cfg: TrainConfig, state: TrainState) -> Params:
    """Weights for validation, test and reports: the EMA copy when enabled."""
    if cfg.ema_decay > 0 and state.ema_params is not None:
        return state.ema_params
    return state.params


def init_output_bias(state: TrainState, train_mean: torch.Tensor) -> TrainState:
    """Set the MLP decoder's output bias to the logits of the training mean,
    in place: ``train_mean`` is the per-pixel mean of the (binarized)
    training images in [0, 1], clamped to [0.001, 0.999] as the reference
    does. The EMA copy, where there is one, gets the same values in its own
    buffer."""
    targets = [name for name in state.params
               if name.endswith(".bias") and "out" in name.split(".")]
    if not targets:
        raise ValueError("no decoder output bias ('out'/'bias') found in params")
    name = targets[0]
    bias = state.params[name]
    p = torch.clamp(torch.as_tensor(train_mean).reshape(-1), 0.001, 0.999)
    logits = (torch.log(p) - torch.log1p(-p)).to(device=bias.device, dtype=bias.dtype)
    with torch.no_grad():
        bias.copy_(logits)
    if state.ema_params is not None:
        state.ema_params = {**state.ema_params, name: logits.clone()}
    return state
