"""Data-parallel train steps with explicit collectives, ZeRO-1 and elastic
resume.

Port of ``vae_mdl_tpu/parallel/spmd.py``. Every rank holds the whole
model, runs its shard of the batch through it (through the MoDL kernels on
a card, as the single-device step does) and differentiates its loss; then:

- ``make_shard_map_train_step``: the gradients, the loss and the metrics
  go into one flat buffer and one all-reduce averages it over the batch
  shards (``parallel.mesh.mean_over_replicas``: a sum divided by the shard
  count, never the sum alone). Every rank then applies the same update to
  the same parameters, so parameters, optimizer state and EMA copy stay
  equal bit for bit across ranks;
- ``make_zero1_train_step``: ZeRO-1. The flat gradient, padded to a
  multiple of the rank count, is reduce-scattered: each rank receives the
  mean of its ``1/n`` slice, runs the optimizer on that slice against its
  ``1/n`` of the flat moments (``zero1_opt_state``), and an all-gather of
  the updated slices rebuilds the parameters. The global gradient norm is
  the square root of the all-reduced sum of the slices' squares, and the
  clip is applied with it before the optimizer, whose own clip then has
  nothing left to do;
- ``reshard_zero1_opt_state`` / ``elastic_restore_zero1``: a ZeRO-1 state
  saved under one rank count resumes under another. The pad is inert
  (zero gradients keep zero moments), so the move is exact: strip the old
  pad, pad for the new count, take this rank's slice.

The batch a step takes is this rank's rows (``parallel.mesh.shard_batch``);
injected noise (``eps``, ``u``) is the whole batch's, and each rank takes
its rows of it. Each rank's "sample", "binarize" and "flip" generators fold
in its batch shard (``TrainState.next_rngs(fold=)``), the counterpart of
``fold_in(key, axis_index)``. The flat order is ``state.params``' order with
the port's tensor layouts (``utils.convert.zero1_opt_state_from_flax`` maps
the JAX package's ``ravel_pytree`` order).
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vae_mdl_tpu_torch.config import ExperimentConfig
from vae_mdl_tpu_torch.models.objective import training_loss_fn
from vae_mdl_tpu_torch.models.vae import prior_for
from vae_mdl_tpu_torch.parallel.mesh import batch_sharding, mean_over_replicas
from vae_mdl_tpu_torch.train.state import GradientTransformation, Params, TrainState
from vae_mdl_tpu_torch.train.steps import (
    _scalarize,
    apply_update,
    clip_scale,
    effective_beta,
    ema_step,
    preprocess_train,
    tensor_parallel_clip,
)

# the one key of a ZeRO-1 optimizer state's parameter dicts: the flat slice
FLAT = "flat"


def _rows(noise, rows: slice):
    """This rank's rows (dim 1) of injected ``[k, B, ...]`` noise, a tensor
    or a sequence of them."""
    if noise is None:
        return None
    if isinstance(noise, torch.Tensor):
        return noise[:, rows]
    return [layer[:, rows] for layer in noise]


def pack_metrics(metrics: Dict[str, object]) -> Tuple[torch.Tensor, Callable]:
    """Scalar metrics (0-d tensors or lists of them) -> one 1-d tensor and
    the function that puts a tensor of that shape back into the dict."""
    layout, values = [], []
    for name, v in metrics.items():
        parts = v if isinstance(v, (list, tuple)) else [v]
        layout.append((name, len(parts) if isinstance(v, (list, tuple)) else None))
        values.extend(torch.as_tensor(p).float().reshape(1) for p in parts)

    def unpack(flat: torch.Tensor) -> Dict[str, object]:
        out, i = {}, 0
        for name, n in layout:
            if n is None:
                out[name] = flat[i]
                i += 1
            else:
                out[name] = [flat[i + j] for j in range(n)]
                i += n
        return out

    return torch.cat(values), unpack


def _local_grads(model, cfg: ExperimentConfig, state: TrainState, batch: torch.Tensor,
                 eps, u, index: int):
    """This rank's loss, scalar metrics and gradients (in ``state.params``
    order) on its rows ``batch``, shard ``index``."""
    rngs = state.next_rngs("sample", "binarize", "flip", device=batch.device, fold=index)
    rows = slice(index * batch.shape[0], (index + 1) * batch.shape[0])
    x = preprocess_train(cfg, batch, rngs, None if u is None else u[rows])
    loss_fn = training_loss_fn(model, cfg, prior_for(cfg.model, x.device), x,
                               cfg.model.n_samples, rngs["sample"],
                               effective_beta(cfg, state.step), eps=_rows(eps, rows))
    loss, metrics = loss_fn(state.params)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    return loss.detach(), _scalarize(metrics), grads


def _unflatten(flat: torch.Tensor, params: Params) -> Params:
    sizes = [p.numel() for p in params.values()]
    return {name: g.view_as(p) for (name, p), g in zip(params.items(), flat.split(sizes))}


def make_shard_map_train_step(model, cfg: ExperimentConfig, tx: GradientTransformation,
                              mesh: DeviceMesh) -> Callable:
    """``(state, this rank's uint8 rows[, eps, u]) -> (state, metrics)``,
    the state updated in place and equal on every rank.

    The batch shards over every mesh dimension but ``model`` (flattened, as
    the JAX step shards over all its axes; the ``model`` ranks of a state in
    the tensor-parallel layout, ``parallel.tensor.shard_state_tp``, share
    rows). A tensor-parallel state's global gradient norm sums its channel
    slices over the ``model`` group, and the clip is applied with it here.
    """
    index, _ = batch_sharding(mesh)

    def step(state: TrainState, batch: torch.Tensor, eps=None, u=None):
        loss, metrics, grads = _local_grads(model, cfg, state, batch, eps, u, index)
        packed, unpack = pack_metrics({**metrics, "loss": loss})
        n = sum(g.numel() for g in grads)
        buf = torch.cat([g.reshape(-1) for g in grads] + [packed.to(grads[0].dtype)])
        # THE collective: the mean over the batch shards of the gradients,
        # the loss and the metrics, in one buffer
        mean_over_replicas(buf, mesh)
        grads = _unflatten(buf[:n], state.params)
        metrics = unpack(buf[n:])
        loss = metrics.pop("loss")
        grads, gnorm = tensor_parallel_clip(cfg, state, grads)
        state.opt_state, ok, stats = apply_update(cfg, tx, state.params, state.opt_state,
                                                  grads, loss, grad_norm=gnorm)
        state.ema_params = ema_step(cfg, state.ema_params, state.params, ok)
        state.step += 1
        metrics.update(stats)
        metrics["loss"] = loss
        return state, metrics

    return step


# --- ZeRO-1: the optimizer state sharded over the ranks -----------------------


def _quiet(collective, *args, **kwargs):
    """A collective whose name newer torch releases deprecate in favour of
    another, without the warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return collective(*args, **kwargs)


def _world() -> Tuple[int, int]:
    return dist.get_world_size(), dist.get_rank()


def _padded_flat_size(params: Params, n_ranks: int) -> int:
    n = sum(p.numel() for p in params.values())
    return -(-n // n_ranks) * n_ranks


def _flat(tensors, n_pad: int) -> torch.Tensor:
    """The tensors flattened in order into a zero-padded ``[n_pad]`` buffer."""
    tensors = list(tensors)
    out = torch.zeros(n_pad, dtype=tensors[0].dtype, device=tensors[0].device)
    n = sum(t.numel() for t in tensors)
    torch.cat([t.detach().reshape(-1) for t in tensors], out=out[:n])
    return out


def _check_zero1_mesh(mesh: DeviceMesh) -> None:
    names = mesh.mesh_dim_names
    if "model" in names and mesh.size(names.index("model")) > 1:
        raise ValueError("ZeRO-1 shards the optimizer over a data-parallel mesh; a mesh with "
                         "model > 1 is the tensor-parallel layout (parallel/tensor.py)")


def zero1_opt_state(tx: GradientTransformation, params: Params, mesh: DeviceMesh):
    """The optimizer state over the flattened parameters, this rank's
    ``1/n`` slice of it: ``tx.init({"flat": slice})``, the flat length
    padded to a multiple of the rank count. Feed it to
    ``make_zero1_train_step`` in place of ``TrainState.opt_state``."""
    _check_zero1_mesh(mesh)
    world, rank = _world()
    n_pad = _padded_flat_size(params, world)
    shard = n_pad // world
    flat = _flat(params.values(), n_pad)
    return tx.init({FLAT: flat[rank * shard:(rank + 1) * shard].clone()})


def make_zero1_train_step(model, cfg: ExperimentConfig, tx: GradientTransformation,
                          mesh: DeviceMesh) -> Callable:
    """``(state with zero1_opt_state, this rank's rows[, eps, u]) ->
    (state, metrics)``: local gradients -> flatten -> reduce-scatter (this
    rank's slice of the mean) -> the optimizer on the slice -> all-gather of
    the updated slices -> the parameters, equal on every rank. The moments
    never exist whole on one rank."""
    _check_zero1_mesh(mesh)
    index, _ = batch_sharding(mesh)
    want_gnorm = cfg.train.grad_skip_threshold > 0 or cfg.train.grad_clip_norm > 0

    def step(state: TrainState, batch: torch.Tensor, eps=None, u=None):
        world, rank = _world()
        loss, metrics, grads = _local_grads(model, cfg, state, batch, eps, u, index)
        n_pad = _padded_flat_size(state.params, world)
        shard = n_pad // world
        g_mine = torch.empty(shard, dtype=grads[0].dtype, device=grads[0].device)
        # reduce-scatter: the sum of this rank's slice, then the mean
        _quiet(dist.reduce_scatter_tensor, g_mine, _flat(grads, n_pad))
        g_mine.div_(world)

        packed, unpack = pack_metrics({**metrics, "loss": loss})
        sums = [packed.to(g_mine.dtype)]
        if want_gnorm:
            # each rank holds a disjoint slice of the mean gradient (the pad
            # is zero): the global norm is one sum away
            sums.append(torch.sum(g_mine * g_mine).reshape(1))
        sums = torch.cat(sums)
        dist.all_reduce(sums)
        metrics = unpack(sums[:packed.numel()] / world)
        loss = metrics.pop("loss")
        gnorm = torch.sqrt(sums[-1]) if want_gnorm else None
        if cfg.train.grad_clip_norm > 0:
            # the clip with the collective norm: tx's own clip sees this
            # rank's slice only, whose norm is then under the threshold
            g_mine = g_mine * clip_scale(cfg.train.grad_clip_norm, gnorm)

        p_mine = {FLAT: _flat(state.params.values(), n_pad)[rank * shard:(rank + 1) * shard]}
        state.opt_state, ok, stats = apply_update(cfg, tx, p_mine, state.opt_state,
                                                  {FLAT: g_mine}, loss, grad_norm=gnorm)
        new_flat = torch.empty(n_pad, dtype=g_mine.dtype, device=g_mine.device)
        _quiet(dist.all_gather_into_tensor, new_flat, p_mine[FLAT])
        with torch.no_grad():
            n = sum(p.numel() for p in state.params.values())
            for p, new in zip(state.params.values(), _unflatten(new_flat[:n],
                                                                 state.params).values()):
                p.copy_(new)
        state.ema_params = ema_step(cfg, state.ema_params, state.params, ok)
        state.step += 1
        metrics.update(stats)
        metrics["loss"] = loss
        return state, metrics

    return step


# --- Elastic resume: ZeRO-1 states across rank counts -------------------------


def _is_flat(node) -> bool:
    return isinstance(node, dict) and set(node) == {FLAT}


def _map_flat(fn: Callable, tree):
    """``fn`` on every ZeRO-1 flat tensor of an optimizer state tree."""
    if _is_flat(tree):
        return {FLAT: fn(tree[FLAT])}
    if isinstance(tree, dict):
        return {key: _map_flat(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_flat(fn, value) for value in tree)
    return tree


def gather_zero1_opt_state(opt_state):
    """The whole ZeRO-1 optimizer state, on every rank: each flat slice
    all-gathered to its padded length (a collective: every rank calls it).
    Other leaves (the counts) are returned as they are."""
    world, _ = _world()

    def gather(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.numel() * world, dtype=t.dtype, device=t.device)
        _quiet(dist.all_gather_into_tensor, out, t.contiguous())
        return out

    return _map_flat(gather, opt_state)


def local_zero1_opt_state(opt_state, like):
    """This rank's slices of a whole ZeRO-1 optimizer state (``opt_state``,
    e.g. a checkpoint's) whose padded length fits the current rank count
    (``like``'s slices times the ranks); flat tensors of another length are
    left as they are."""
    world, rank = (_world() if dist.is_initialized() else (1, 0))
    lengths = []
    _map_flat(lambda t: lengths.append(t.numel()), like)
    if not lengths:
        return opt_state
    shard = lengths[0]

    def take(t: torch.Tensor) -> torch.Tensor:
        if t.numel() != shard * world:
            return t
        return t[rank * shard:(rank + 1) * shard].clone()

    return _map_flat(take, opt_state)


def reshard_zero1_opt_state(opt_state, params: Params, mesh: DeviceMesh):
    """A whole ZeRO-1 optimizer state (flat tensors at any padded length,
    as saved or as ``gather_zero1_opt_state`` returns it) laid out for
    ``mesh``: the old pad stripped, the flat length padded for this rank
    count, this rank's slice taken, on the parameters' device. Counts are
    kept. The pad is inert (zero gradients leave zero moments and the pad's
    parameter slots never move), so a change of rank count is exact."""
    _check_zero1_mesh(mesh)
    world, rank = _world()
    n = sum(p.numel() for p in params.values())
    n_pad = _padded_flat_size(params, world)
    shard = n_pad // world
    device = next(iter(params.values())).device

    def fix(t: torch.Tensor) -> torch.Tensor:
        if t.numel() < n:
            raise ValueError(f"a flat optimizer tensor of {t.numel()} elements is shorter "
                             f"than the {n} parameters; not a whole ZeRO-1 state")
        flat = torch.zeros(n_pad, dtype=t.dtype, device=device)
        flat[:n] = t[:n].to(device)
        return flat[rank * shard:(rank + 1) * shard].clone()

    return _map_flat(fix, opt_state)


def _sizes(tree) -> List[torch.Size]:
    """The ``torch.Size`` leaves of a ``Checkpointer.metadata_tree``."""
    if isinstance(tree, torch.Size):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [size for node in tree for size in _sizes(node)]
    return []


def elastic_restore_zero1(ckptr, state: TrainState, mesh: DeviceMesh,
                          tag: str = "latest") -> TrainState:
    """Restore a ZeRO-1 checkpoint saved under any rank count into
    ``state`` (built for ``mesh``, with ``zero1_opt_state``), in place.

    A checkpoint's flat moments have the padded length of the rank count
    that saved them. That length is read from the checkpoint's record of
    its shapes (``Checkpointer.metadata_tree``) without loading a tensor;
    under the same padded length this is a strict restore, else the saved
    state is loaded whole and ``reshard_zero1_opt_state`` lays it out for
    ``mesh``. Where the record is unreadable a strict restore is tried, and
    its failure is reported as what it means."""
    world, _ = _world()
    n = sum(p.numel() for p in state.params.values())
    n_pad_new = _padded_flat_size(state.params, world)

    meta = ckptr.metadata_tree(tag)
    if meta is None:
        try:
            return ckptr.restore(state, tag)
        except Exception as e:
            raise ValueError(
                f"checkpoint '{tag}': its record of the saved shapes is unreadable, so the "
                f"rank count it was saved under cannot be determined, and a strict restore "
                f"onto the current {world}-rank mesh failed; if the rank count changed since "
                f"the save, resume on the original one (or repair the checkpoint's "
                f"meta.json) first") from e
    saved_lens = {shape[0] for shape in _sizes(meta.get("opt_state"))
                  if len(shape) == 1 and shape[0] >= n}
    if len(saved_lens) > 1:
        raise ValueError(f"checkpoint '{tag}' has flat moments of inconsistent lengths "
                         f"{sorted(saved_lens)}; not a ZeRO-1 state")
    n_pad_old = saved_lens.pop() if saved_lens else n_pad_new
    if n_pad_old == n_pad_new:  # the same padded length (or not a ZeRO-1 state)
        return ckptr.restore(state, tag)
    saved = ckptr.load(tag, next(iter(state.params.values())).device)
    saved["opt_state"] = reshard_zero1_opt_state(saved["opt_state"], state.params, mesh)
    return ckptr.restore_state_dict(state, saved, tag)
