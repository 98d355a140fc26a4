"""The rank mesh and the data-parallel layout.

Port of ``vae_mdl_tpu/parallel/mesh.py``. A rank is one process with one
device (``parallel.distributed``), so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks with the dimension
names ``("data", "sample")``, or ``("data", "sample", "model")`` where
``model > 1``:

- ``data`` shards the batch; ``sample`` shards the evaluation's importance
  samples (``evaluation.harness.make_batch_evaluator``); in training the
  batch shards over both, flattened, as the JAX package's shard_map step
  does; ``model`` shards the wide layers' output channels
  (``parallel/tensor.py``) and sees the same rows on each of its ranks;
- parameters and optimizer state are replicated: ``shard_state`` copies
  rank 0's onto every rank, and the train steps (``parallel/spmd.py``)
  keep them equal by applying the same averaged gradient everywhere;
- several hosts: the mesh is laid out host-major on ``data`` (a host is
  the JAX package's DCN slice), so ``sample`` and ``model`` collectives
  stay inside a host and only the gradient reduction crosses hosts.

``batch_sharding``, ``sample_sharding`` and ``replicated`` name what the
JAX package's shardings of those names mean here: this rank's place among
the batch shards, its block of an evaluation's ``[k, B, ...]`` tensor, and
the process groups over which the replicas of one parameter shard are
averaged.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vae_mdl_tpu_torch.config import MeshConfig



def _host_of() -> Optional[Callable[[int], int]]:
    """rank -> host from torchrun's ``LOCAL_WORLD_SIZE`` (ranks are numbered
    host by host); None where the ranks share one host or it is not set."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not local or int(local) >= world:
        return None
    return lambda r: r // int(local)


def make_mesh(cfg: Optional[MeshConfig] = None, ranks: Optional[Sequence[int]] = None, *,
              slice_of: Optional[Callable[[int], int]] = None) -> DeviceMesh:
    """The ``(data, sample[, model])`` mesh over every rank of the process
    group (``ranks``: their order, the group's by default). ``slice_of``
    maps a rank to its host (default: torchrun's ``LOCAL_WORLD_SIZE``);
    ranks on several hosts are laid out host-major on ``data``
    (``_device_array``). ``data=-1`` takes every rank not on ``sample`` or
    ``model``; a mesh that does not cover the ranks exactly raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.init_distributed() first (torchrun sets "
                           "its environment)")
    cfg = cfg or MeshConfig()
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    sample = max(1, cfg.sample)
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else n // (sample * model)
    if data * sample * model != n:
        raise ValueError(f"mesh {data}x{sample}x{model} != {n} ranks")
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"mesh ranks {ranks} are not the process group's {world} ranks")
    arr = _device_array(ranks, data, sample, model, slice_of or _host_of())
    if model > 1:
        return DeviceMesh(device_type(), torch.as_tensor(arr),
                          mesh_dim_names=("data", "sample", "model"))
    return DeviceMesh(device_type(), torch.as_tensor(arr.reshape(data, sample)),
                      mesh_dim_names=("data", "sample"))


def device_type() -> str:
    """The DeviceMesh's device type: ``"cuda"`` where the group's backend
    carries the card's tensors over NCCL, else ``"cpu"``."""
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def _device_array(ranks, data: int, sample: int, model: int,
                  slice_of: Optional[Callable[[int], int]]) -> np.ndarray:
    """Order ``ranks`` into a ``(data, sample, model)`` array; host-major on
    ``data`` when they span several hosts (``slice_of``: rank -> host)."""
    key = slice_of or (lambda r: None)
    groups: dict = {}
    for r in ranks:
        groups.setdefault(key(r), []).append(r)
    if len(groups) <= 1 or None in groups:
        # one host (or no host information): the ranks' order
        return np.asarray(ranks).reshape(data, sample, model)
    n_slices = len(groups)
    sizes = {sid: len(g) for sid, g in groups.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"unequal DCN slice sizes: {sizes}")
    if data % n_slices != 0:
        raise ValueError(
            f"data axis ({data}) must be a multiple of the DCN slice count "
            f"({n_slices}) so each slice holds whole data-parallel rows; "
            f"sample/model axes always stay inside one slice")
    per_slice_data = data // n_slices
    blocks = [np.asarray(groups[sid]).reshape(per_slice_data, sample, model)
              for sid in sorted(groups)]
    return np.concatenate(blocks, axis=0)


def n_slices(mesh: DeviceMesh, slice_of: Optional[Callable[[int], int]] = None) -> int:
    """The number of hosts the mesh spans (``slice_of``: rank -> host, by
    default from ``LOCAL_WORLD_SIZE``; 1 without host information)."""
    key = slice_of or _host_of()
    if key is None:
        return 1
    return len({key(int(r)) for r in mesh.mesh.flatten().tolist()})


def _batch_dims(mesh: DeviceMesh) -> Tuple[int, ...]:
    """The mesh dimensions the batch shards over: all but ``model``."""
    return tuple(i for i, name in enumerate(mesh.mesh_dim_names) if name != "model")


def batch_sharding(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(index, count)``: this rank's batch shard and the number of shards,
    over every dimension but ``model``, flattened row-major; the ranks of
    one ``model`` group share a shard."""
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for dim in _batch_dims(mesh):
        index = index * mesh.size(dim) + coord[dim]
        count *= mesh.size(dim)
    return index, count


def sample_sharding(mesh: Optional[DeviceMesh]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The layout of a ``[k, B, ...]`` evaluation tensor, the JAX package's
    ``NamedSharding(mesh, P("sample", "data"))``: ``((n_data, row), (n_sample,
    col))``, this rank's block being row ``row`` of ``n_data`` along the
    batch and column ``col`` of ``n_sample`` along the samples; ``(1, 0)``
    for a dimension the mesh lacks, or where there is no mesh."""
    if mesh is None:
        return (1, 0), (1, 0)
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    return tuple((mesh.size(names.index(name)), coord[names.index(name)])
                 if name in names else (1, 0) for name in ("data", "sample"))


def replicated(mesh: DeviceMesh) -> Tuple[dist.ProcessGroup, ...]:
    """The process groups across which the replicas of one parameter shard
    sit: the whole group where there is no ``model`` dimension, else the
    other dimensions' groups of size > 1."""
    if "model" not in mesh.mesh_dim_names:
        return (dist.group.WORLD,)
    return tuple(mesh.get_group(dim) for dim in _batch_dims(mesh) if mesh.size(dim) > 1)


def mean_over_replicas(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``t`` (in place) averaged over the batch shards: one all-reduce (sum,
    then divided by the count) per group of ``replicated``."""
    for group in replicated(mesh):
        dist.all_reduce(t, group=group)
    count = batch_sharding(mesh)[1]
    if count > 1:
        t.div_(count)
    return t


def shard_batch(mesh: DeviceMesh, batch):
    """This rank's rows of a global batch ``[B, ...]`` (array or tensor)."""
    index, count = batch_sharding(mesh)
    if batch.shape[0] % count:
        raise ValueError(f"batch of {batch.shape[0]} rows does not divide over "
                         f"{count} batch shards")
    per = batch.shape[0] // count
    return batch[index * per:(index + 1) * per]


def shard_state(mesh: DeviceMesh, state):
    """Copy rank 0's training state onto every rank of the mesh, in place
    (parameters, optimizer state, EMA copy, step, seed, best validation
    loss), so the replicas start equal; returns ``state``."""
    from vae_mdl_tpu_torch.train.state import tree_map

    tensors = []
    tree_map(tensors.append, [state.params, state.opt_state, state.ema_params or {}])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    numbers = [state.step, state.seed, state.best_val_loss]
    dist.broadcast_object_list(numbers, src=0)
    state.step, state.seed, state.best_val_loss = int(numbers[0]), int(numbers[1]), \
        float(numbers[2])
    return state
