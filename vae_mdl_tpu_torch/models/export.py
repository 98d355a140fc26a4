"""Ahead-of-time export for serving: ``torch.export`` programs in a ``.pt2``.

Port of ``vae_mdl_tpu/models/export.py``. A trained model exports to one
self-contained file: the weights are stored in the program, so a serving
process needs only torch (no import of this package, no config, no
checkpoint):

    from vae_mdl_tpu_torch.models.export import export_sampler, load_exported
    export_sampler(model, cfg.model, params, n=64, path="model05_sampler.pt2")
    # ... in the serving process:
    sample = load_exported("model05_sampler.pt2")
    imgs = sample(0)                               # uint8 [64, H, W, C]

CLI: ``vae-mdl-tpu-torch export <model> --what sampler|reconstructor|encoder``.

A ``torch.Generator`` cannot be an input of an exported program, so every
program takes its randomness as tensors, before the data: the draws that
``models/inference.py`` lists (the prior's normals, each layer's normals,
then the observation's uniforms). Their names, shapes and kinds are saved
beside the program (``extra_files``, ``noise.json``), and ``load_exported``
draws them on the program's device from a generator or a seed. A program
exported on the card runs on the card; ``load_exported(path, "cpu")`` moves
it to the CPU with ``torch.export.passes.move_to_device_pass``, which takes
the place of the JAX export's ``platforms``. The sampling, reconstruction and
encoding paths evaluate no log-likelihood, so no custom kernel is in a
program: its graph holds ``aten`` operations only.

``mesh=`` (a ``parallel.mesh.make_mesh`` mesh, in a process group) exports
the batch-sharded serving layout, the counterpart of the JAX artifact's
batch-on-``data`` GSPMD layout. Every rank traces one program at its
shard's rows (``n / count``; the ranks of one ``model`` group share a
shard), whose last step all-gathers each output over the whole group along
its batch axis (a functional collective, traced into the graph as
``_c10d_functional`` all-gather and wait) and keeps one copy of each shard,
so that every rank returns the global batch. The weights stay constants,
whole on every rank, as the JAX artifact's replicated parameters. Rank 0
writes the file, with ``mesh.json`` beside ``noise.json``: the mesh's
dimensions and rank layout, the world size, the global batch and each
noise entry's batch axis. A serving process loads it in a process group of
the recorded size (``load_exported`` raises elsewhere), draws the noise at
the global shape on every rank, takes its own rows of the noise and of the
data (its shard read from the recorded rank layout), and gets what the
single-device program gives on the same seed, within the few ulps by which
a convolution at another batch may differ. Because the gather is in the
graph, a process with torch alone serves the file too: ``torch.export.load``
it, slice the inputs as ``mesh.json`` says, and its ``module()`` returns
the global batch. Over gloo on CUDA tensors ``load_exported`` runs the
traced gather as the eager collective (``_eager_gathers``).
"""
from __future__ import annotations

import io
import json
import os
from typing import Callable, Optional, Sequence

import torch

NOISE_FILE = "noise.json"
MESH_FILE = "mesh.json"

NEEDS_GROUP = ("a sharded program needs a process group: start the ranks with torchrun "
               "and call parallel.distributed.init_distributed() (then "
               "parallel.mesh.make_mesh) before exporting or loading it")
# a sharded program's gather and its wait, as the graph names them
GATHER_OP = "_c10d_functional.all_gather_into_tensor.default"
WAIT_OP = "_c10d_functional.wait_tensor.default"


class _Program(torch.nn.Module):
    """``fn(params, noise, data)`` as a module. The weights are plain tensor
    attributes, neither parameters nor buffers, so the exported program
    carries them as constants."""

    def __init__(self, fn: Callable, params, n_noise: int):
        super().__init__()
        self.fn = fn
        self.n_noise = n_noise
        self.weights = {name: p.detach() for name, p in (params or {}).items()}

    def forward(self, *inputs):
        return self.fn(self.weights, list(inputs[:self.n_noise]), list(inputs[self.n_noise:]))


def export_callable(fn: Callable, example_args: Sequence[torch.Tensor],
                    path: Optional[str] = None, params=None, noise_spec=(),
                    layout: Optional[dict] = None) -> bytes:
    """Export ``fn(params, noise, data)`` at the example arguments' shapes
    and dtypes (the first ``len(noise_spec)`` of them the noise, the rest the
    data) and serialize it; ``params`` (``{name: tensor}``) are stored in the
    program. Writes ``path`` where given; returns the ``.pt2`` bytes.

    A ``fn`` of the data alone is ``lambda params, noise, data: f(*data)``
    with ``noise_spec=()``. ``layout`` (a sharded export's record, saved as
    ``mesh.json``): only rank 0 writes ``path``, and every rank returns rank
    0's bytes."""
    program = _Program(fn, params, len(noise_spec))
    # traced with autograd off, so the graph holds no grad-mode switches
    with torch.no_grad():
        exported = torch.export.export(program, tuple(example_args))
    exported.example_inputs = None  # the file carries the weights, not the example draws
    meta = {"noise": [{"name": name, "shape": list(shape), "kind": kind}
                      for name, shape, kind in noise_spec]}
    extra = {NOISE_FILE: json.dumps(meta)}
    if layout is not None:
        extra[MESH_FILE] = json.dumps(layout)
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files=extra)
    blob = buf.getvalue()
    rank0 = layout is None or torch.distributed.get_rank() == 0
    if path is not None and rank0:
        with open(path, "wb") as f:
            f.write(blob)
    if layout is not None:
        # after rank 0's write: a process started once this returns finds the file
        shared = [blob]
        torch.distributed.broadcast_object_list(shared, src=0)
        blob = shared[0]
    return blob


def _sharded_layout(mesh, n: int, spec_of: Callable[[int], list]) -> dict:
    """The record of a sharded export of a global batch ``n`` over ``mesh``:
    its dimensions and rank layout, the world size, the global batch, the
    number of batch shards (the ranks of one ``model`` group share one) and
    each noise entry's batch axis (where ``spec_of(2)`` and ``spec_of(3)``
    differ)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"export(mesh=...): {NEEDS_GROUP}")
    dims = list(mesh.mesh_dim_names)
    count = mesh.mesh.numel() // (mesh.size(dims.index("model")) if "model" in dims else 1)
    if n % count:
        raise ValueError(f"export(mesh=...): a batch of {n} does not divide over {count} "
                         "batch shards")
    axes = [next(i for i, (a, b) in enumerate(zip(s2, s3)) if a != b)
            for (_, s2, _), (_, s3, _) in zip(spec_of(2), spec_of(3))]
    return {"dims": dims, "sizes": list(mesh.mesh.shape), "ranks": mesh.mesh.tolist(),
            "world": dist.get_world_size(), "batch": n, "shards": count,
            "noise_batch_axes": axes}


def _shard_ranks(layout: dict) -> list:
    """The ranks of each batch shard, in the batch's order: the recorded
    rank layout row-major, a row a shard (``model``, the last dimension,
    its members)."""
    import numpy as np

    return np.asarray(layout["ranks"]).reshape(layout["shards"], -1).tolist()


def _gather(t: torch.Tensor, axis: int, order: Sequence[int]) -> torch.Tensor:
    """``t`` (this rank's rows along ``axis``) all-gathered over the whole
    group, one shard a rank of ``order``, in that order."""
    import torch.distributed as dist
    from torch.distributed._functional_collectives import all_gather_tensor

    rows = t.shape[axis]
    out = all_gather_tensor(t.contiguous(), axis, dist.group.WORLD)
    if list(order) == list(range(dist.get_world_size())):
        return out
    return torch.cat([out.narrow(axis, r * rows, rows) for r in order], dim=axis)


def _gathered(fn: Callable, layout: Optional[dict],
              axis_of: Callable[[int, torch.Tensor], int]) -> Callable:
    """``fn(params, noise, data)`` with each output gathered along its batch
    axis (``axis_of(i, output_i)``) where ``layout`` shards the batch; of
    the ranks of one shard, the first's rows are kept."""
    if layout is None:
        return fn
    order = [ranks[0] for ranks in _shard_ranks(layout)]

    def sharded(weights, noise, data):
        out = fn(weights, noise, data)
        if isinstance(out, tuple):
            return tuple(_gather(t, axis_of(i, t), order) for i, t in enumerate(out))
        return _gather(out, axis_of(0, out), order)

    return sharded


def _serving_shard(program, layout: dict) -> tuple:
    """``(index, count)`` of this rank's batch shard under a sharded file's
    ``layout``; raises unless this process group has the recorded size and
    every group the graph gathers over is the whole group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    world = layout["world"]
    if not dist.is_initialized() or dist.get_world_size() != world:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(f"load_exported: the program was exported for a world of {world} "
                           f"ranks ({have} here); {NEEDS_GROUP}")
    names = {str(node.args[2]) for node in program.graph.nodes
             if node.op == "call_function" and str(node.target) == GATHER_OP}
    wrong = []
    for name in sorted(names):
        try:
            group = _resolve_process_group(name)
        except RuntimeError:  # no group of that name in this process
            wrong.append(name)
            continue
        if dist.get_process_group_ranks(group) != list(range(world)):
            wrong.append(name)
    if not names:
        raise RuntimeError("load_exported: the sharded program holds no all-gather")
    if wrong:
        raise RuntimeError(f"load_exported: the program gathers over process groups {wrong}, "
                           f"which are not this process group's whole group of {world} ranks")
    rank = dist.get_rank()
    shards = _shard_ranks(layout)
    return next(i for i, ranks in enumerate(shards) if rank in ranks), len(shards)


def _all_gather(t: torch.Tensor, world: int, group_name: str) -> torch.Tensor:
    """``_c10d_functional.all_gather_into_tensor`` (rows of every rank
    stacked along dim 0) as the eager collective."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=_resolve_process_group(group_name))
    return out


def _eager_gathers(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """``module`` with each traced functional all-gather run as the eager
    collective (``_all_gather``) and its wait dropped. Only for CUDA tensors
    on a gloo group: gloo gathers them in the eager all-gather but crashes
    in the functional one (torch 2.11 on the H100), where NCCL on the card
    and gloo on the CPU run the traced gather as it is."""
    for node in list(module.graph.nodes):
        if node.op != "call_function":
            continue
        if str(node.target) == GATHER_OP:
            node.target = _all_gather
        elif str(node.target) == WAIT_OP:
            node.replace_all_uses_with(node.args[0])
            module.graph.erase_node(node)
    module.recompile()
    return module


def _rows(t: torch.Tensor, axis: int, index: int, count: int, batch: int) -> torch.Tensor:
    """This shard's rows of the global ``t`` along ``axis``."""
    if t.shape[axis] % count:
        raise ValueError(f"load_exported: a batch of {t.shape[axis]} rows does not divide over "
                         f"{count} batch shards")
    if t.shape[axis] != batch:
        raise ValueError(f"load_exported: the program serves a batch of {batch}, not "
                         f"{t.shape[axis]}")
    per = batch // count
    return t.narrow(axis, index * per, per).contiguous()


def load_exported(path_or_bytes, device=None) -> Callable:
    """Load an exported program into ``f(generator_or_seed, *data)``.

    ``path_or_bytes``: a file path or the ``.pt2`` bytes. ``device=None``
    serves on the card (it raises where there is none); ``"cpu"`` moves the
    program there. ``f`` draws the recorded noise on that device from the
    given ``torch.Generator`` (one of that device) or from a generator seeded
    with the given int, then calls the program on the noise and ``data``.

    A sharded file (exported with ``mesh=``) needs a process group of the
    recorded world size; this rank's shard is read from the recorded rank
    layout. ``f`` then takes the global data on every rank, draws the noise
    at the global shape, runs this rank's rows of both and returns the
    global output on every rank."""
    from torch.export.passes import move_to_device_pass

    from vae_mdl_tpu_torch.data.pipeline import resolve_device

    source = path_or_bytes
    if isinstance(path_or_bytes, (bytes, bytearray)):
        source = io.BytesIO(path_or_bytes)
    elif not isinstance(path_or_bytes, (str, os.PathLike)):
        raise TypeError(f"load_exported takes a path or bytes, not {type(path_or_bytes)}")
    extra = {NOISE_FILE: "", MESH_FILE: ""}
    exported = torch.export.load(source, extra_files=extra)
    meta = json.loads(extra[NOISE_FILE])
    layout = json.loads(extra[MESH_FILE]) if extra[MESH_FILE] else None
    index, count = _serving_shard(exported, layout) if layout else (0, 1)
    target = resolve_device(device)
    module = move_to_device_pass(exported, target).module()
    if layout is not None and target.type == "cuda" and \
            "nccl" not in torch.distributed.get_backend():
        module = _eager_gathers(module)
    spec = [(n["name"], tuple(n["shape"]), n["kind"]) for n in meta["noise"]]

    def run(generator_or_seed, *data):
        from vae_mdl_tpu_torch.models.inference import draw_noise

        generator = generator_or_seed
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=target).manual_seed(int(generator_or_seed or 0))
        noise = draw_noise(spec, generator, target)
        data = [torch.as_tensor(d).to(target) for d in data]
        if layout is not None:
            batch = layout["batch"]
            noise = [_rows(t, axis, index, count, batch)
                     for t, axis in zip(noise, layout["noise_batch_axes"])]
            data = [_rows(d, 0, index, count, batch) for d in data]
        return module(*noise, *data)

    run.noise_spec = spec
    return run


def _first(i: int, out: torch.Tensor) -> int:
    """The batch axis of an output whose rows come first."""
    return 0


def export_sampler(model, config, params, n: int, path: Optional[str] = None,
                   mesh=None) -> bytes:
    """The prior sampler with the weights stored in it: ``f(*noise) -> uint8
    [n, H, W, C]``, noise as ``inference.sample_noise(config, n)``. Exported
    on the weights' device; with ``mesh``, sharded (module docstring)."""
    from vae_mdl_tpu_torch.models.inference import (
        draw_noise,
        make_sampler,
        params_device,
        sample_noise,
    )

    layout = None if mesh is None else _sharded_layout(
        mesh, n, lambda b: sample_noise(config, b))
    rows = n if layout is None else n // layout["shards"]
    sampler = make_sampler(model, config)

    def fn(weights, noise, data):
        return sampler(weights, None, rows, noise=noise)

    device = params_device(params)
    example = draw_noise(sample_noise(config, rows),
                         torch.Generator(device=device).manual_seed(0), device)
    return export_callable(_gathered(fn, layout, _first), example, path, params,
                           sample_noise(config, n), layout)


def _export_image_fn(f: Callable, spec_of: Callable[[int], list], params, image_shape,
                     path, mesh, axis_of: Callable[[int, torch.Tensor], int]) -> bytes:
    """Export ``f(params, generator, x01, noise=)`` at ``image_shape``, its
    noise ``spec_of(batch)``, output i's batch axis ``axis_of(i, output)``."""
    from vae_mdl_tpu_torch.models.inference import draw_noise, params_device

    n = image_shape[0]
    layout = None if mesh is None else _sharded_layout(mesh, n, spec_of)
    rows = n if layout is None else n // layout["shards"]
    device = params_device(params)

    def fn(weights, noise, data):
        return f(weights, None, data[0], noise=noise)

    example = draw_noise(spec_of(rows), torch.Generator(device=device).manual_seed(0), device)
    example.append(torch.zeros((rows,) + tuple(image_shape[1:]), device=device))
    return export_callable(_gathered(fn, layout, axis_of), example, path, params,
                           spec_of(n), layout)


def export_reconstructor(model, config, params, image_shape, path: Optional[str] = None,
                         mesh=None) -> bytes:
    """Posterior-mean reconstruction: ``f(*noise, x01 [B, H, W, C]) ->
    float [B, H, W, C]``, noise as ``inference.reconstruct_noise``; with
    ``mesh``, sharded (module docstring)."""
    from vae_mdl_tpu_torch.models.inference import make_reconstructor, reconstruct_noise

    return _export_image_fn(make_reconstructor(model, config),
                            lambda b: reconstruct_noise(config, b), params, image_shape,
                            path, mesh, _first)


def export_encoder(model, config, params, image_shape, path: Optional[str] = None,
                   mesh=None) -> bytes:
    """Amortized posterior means: ``f(*noise, x01) -> tuple`` of latents
    (``[B, ...]`` or ``[1, B, ...]`` each), noise as
    ``inference.encode_noise``; with ``mesh``, sharded (module docstring)."""
    from vae_mdl_tpu_torch.models.inference import encode_noise, make_encoder_fn
    from vae_mdl_tpu_torch.models.vae import latent_shapes

    shapes = latent_shapes(config)

    def axis_of(i, latent):
        # [B, ...] or [1, B, ...] over the layer's latent shape (the families differ)
        return latent.dim() - 1 - len(shapes[i])

    return _export_image_fn(make_encoder_fn(model), lambda b: encode_noise(config, b),
                            params, image_shape, path, mesh, axis_of)
