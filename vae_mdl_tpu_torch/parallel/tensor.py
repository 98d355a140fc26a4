"""Tensor parallelism: the wide layers' output channels sharded over the
``model`` ranks (Megatron's column-parallel layers).

Port of ``vae_mdl_tpu/parallel/tensor.py``. In the JAX package the layout
is a placement and GSPMD inserts the collectives; here the collectives are
explicit. ``shard_state_tp`` keeps, in each eligible layer, this rank's
``1/n`` of the output channels (parameters, EMA copy and optimizer moments
alike) and hooks the layer so that

- forward: the layer computes its channels and all-gathers its output along
  channels over the ``model`` group, so everything downstream sees the
  whole activation and runs replicated;
- backward: the gather's gradient is this rank's channel slice of the
  upstream gradient, which is already whole on every rank (the code
  downstream is replicated), never a sum over ranks; and the layer's input
  gradient, to which each rank contributes its channels' part, is
  all-reduced (summed) over the group.

The train steps then run unchanged: ``train.steps.make_train_step`` at
``data = 1``, ``parallel.spmd.make_shard_map_train_step`` (gradients
averaged over ``data``) otherwise.

Sharding rules (``tp_param_spec``), by layer type, as the JAX package's
rules by kernel layout: a ``Dense`` (weight ``[out, in]``), ``SameConv``
or ``ConvLayer`` (``[out, in, kh, kw]``) shards dim 0, a transposed
``ConvLayer`` (``[in, out, kh, kw]``) dim 1, where the output channels
divide by the ranks and number at least ``min_features``; the bias follows
its layer. Heads stay whole by path (``tp_replicated_by_path``): the
likelihood head (its output feeds the MoDL kernel, which wants whole
pixels), the latent-parameter heads, and the heads named ``out``,
``obs_head``, ``q_top``, ``p_i``, ``q_i``.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from vae_mdl_tpu_torch.nn.blocks import Dense, SameConv
from vae_mdl_tpu_torch.nn.encoders import ConvLayer
from vae_mdl_tpu_torch.parallel.mesh import device_type, shard_batch
from vae_mdl_tpu_torch.train.state import Params, TrainState, global_norm

# module names that are heads wherever they appear: the MLP decoder's
# Bernoulli head ('out', nn/decoders.py), the ladders' observation and
# per-scale Gaussian heads (models/bidirectional.py: obs_head / q_top /
# p_i / q_i)
_HEAD_NAME = re.compile(r"^(out|obs_head|q_top|p_\d+|q_\d+)$")


def _structural_head_pairs(params) -> tuple:
    """(parent, module) name pairs that are likelihood or latent heads in
    the VAE families, read off the parameter names (``{name: tensor}``):

    - the decoder's last ``conv_i`` (the likelihood head);
    - the conv encoder's ``Dense_0`` (its output is [mu, logstd]);
    - ``Dense_2`` and ``Dense_3`` of every module with exactly the four
      children ``Dense_0`` .. ``Dense_3`` (an ``MLPBlock``'s mu and std
      heads).
    """
    children: Dict[Tuple[str, ...], set] = {}
    for name in params:
        path = tuple(name.split("."))[:-1]
        for i in range(len(path)):
            children.setdefault(path[:i], set()).add(path[i])
    pairs = []
    dec = children.get(("decoder",), set())
    idx = [int(k.split("_")[1]) for k in dec if re.fullmatch(r"conv_\d+", k)]
    if idx:
        pairs.append(("decoder", f"conv_{max(idx)}"))
    enc = children.get(("encoder",), set())
    if "conv_0" in enc and "Dense_0" in enc:
        pairs.append(("encoder", "Dense_0"))
    for path, kids in sorted(children.items()):
        if {k for k in kids if k.startswith("Dense_")} == {"Dense_0", "Dense_1", "Dense_2",
                                                           "Dense_3"}:
            parent = path[-1] if path else ""
            pairs.append((parent, "Dense_2"))
            pairs.append((parent, "Dense_3"))
    return tuple(pairs)


def tp_replicated_by_path(path_names: Sequence[str], head_pairs: Sequence[tuple]) -> bool:
    """True where the parameter at this name path belongs to a head module
    that the layout keeps whole (the module names appear as a contiguous
    subpath)."""
    if any(_HEAD_NAME.match(n) for n in path_names):
        return True
    for a, b in head_pairs:
        for i in range(len(path_names) - 1):
            if path_names[i] == a and path_names[i + 1] == b:
                return True
    return False


def make_tp_mesh(n_data: int, n_model: int, ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A ``("data", "model")`` mesh: the batch over ``data``, the wide
    layers' channels over ``model``."""
    if not dist.is_initialized():
        raise RuntimeError("make_tp_mesh needs a process group: call "
                           "parallel.distributed.init_distributed() first")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if n_data * n_model != len(ranks):
        raise ValueError(f"mesh {n_data}x{n_model} != {len(ranks)} ranks")
    return DeviceMesh(device_type(), torch.as_tensor(np.asarray(ranks).reshape(n_data, n_model)),
                      mesh_dim_names=("data", "model"))


def _out_dim(layer: nn.Module) -> Optional[int]:
    """The output-channel dim of a layer's weight, by layer type; None for
    a module the layout never shards."""
    if isinstance(layer, ConvLayer):
        return 1 if layer.spec.transpose else 0
    if isinstance(layer, (Dense, SameConv)):
        return 0
    return None


def tp_param_spec(layer: nn.Module, name: str, n_model: int,
                  min_features: int = 64) -> Tuple[Optional[str], ...]:
    """The partition spec of ``layer``'s parameter ``name`` under
    output-channel tensor parallelism, as the JAX package's
    ``PartitionSpec``: ``"model"`` at the sharded dim, ``()`` where the
    parameter stays whole."""
    dim = _out_dim(layer)
    leaf = getattr(layer, name, None)
    if dim is None or leaf is None or leaf.ndim == 0:
        return ()
    out = layer.weight.shape[dim]
    if out % n_model != 0 or out < min_features:
        return ()
    dim = dim if name == "weight" else 0
    return tuple("model" if i == dim else None for i in range(leaf.ndim))


def tp_state_sharding(state: TrainState, mesh: DeviceMesh, min_features: int = 64, *,
                      model: nn.Module) -> Dict[str, tuple]:
    """``{parameter name: spec}`` for ``state``'s parameters; the EMA copy
    and the optimizer moments (dicts keyed as the parameters) follow their
    parameter, counts stay whole. Head modules (``tp_replicated_by_path``)
    stay whole whatever their width."""
    return _tp_specs(state.params, model, mesh.size(mesh.mesh_dim_names.index("model")),
                     min_features)


def _tp_specs(params, model: nn.Module, n_model: int, min_features: int) -> Dict[str, tuple]:
    """``tp_state_sharding`` for ``n_model`` ranks, without a mesh."""
    head_pairs = _structural_head_pairs(params)
    modules = dict(model.named_modules())
    specs = {}
    for name in params:
        path = name.split(".")
        if tp_replicated_by_path(path, head_pairs):
            specs[name] = ()
        else:
            specs[name] = tp_param_spec(modules[".".join(path[:-1])], path[-1], n_model,
                                        min_features)
    return specs


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input gradient summed over the ``model``
    group in backward (each rank's channels contribute their part), with
    ``dim`` (the channels) moved last, as ``_GatherChannels`` does."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.movedim(ctx.dim, -1).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad.movedim(-1, ctx.dim), None, None


class _GatherChannels(torch.autograd.Function):
    """All-gather along ``dim`` over the ``model`` group; backward takes
    this rank's slice of the (whole, replicated) upstream gradient. Both
    work on ``dim`` moved last, so a channels-last conv output (NHWC memory)
    is gathered without a copy and stays channels-last, and the layers after
    it, the likelihood head's kernel among them, see the single-rank
    layout."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        x = x.movedim(dim, -1).contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1).movedim(-1, dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.movedim(ctx.dim, -1).chunk(ctx.n, dim=-1)[ctx.index]
        return part.contiguous().movedim(-1, ctx.dim), None, None, None, None


class TPLayout:
    """Which parameters of a state are channel-sharded, over which group:
    ``dims`` maps a parameter name to its sharded dim."""

    def __init__(self, dims: Dict[str, int], group, n: int, index: int):
        self.dims, self.group, self.n, self.index = dims, group, n, index

    def __deepcopy__(self, memo):
        return self

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor of parameter ``name``."""
        dim = self.dims.get(name)
        if dim is None:
            return full
        return full.chunk(self.n, dim=dim)[self.index].clone()

    def whole(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (a collective)."""
        dim = self.dims.get(name)
        if dim is None:
            return part
        parts = [torch.empty_like(part.contiguous()) for _ in range(self.n)]
        dist.all_gather(parts, part.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def map_params(self, fn, tree, names):
        """``fn(name, tensor)`` on every dict of ``tree`` keyed as the
        parameters (``names``): params, EMA copy, moments."""
        if isinstance(tree, dict) and set(tree) == set(names):
            return {key: fn(key, value) for key, value in tree.items()}
        if isinstance(tree, dict):
            return {key: self.map_params(fn, value, names) for key, value in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.map_params(fn, value, names) for value in tree)
        return tree

    def global_norm(self, grads: Params) -> torch.Tensor:
        """The norm of the whole gradient: the sharded slices' squares
        summed over the group, plus the whole tensors'."""
        sharded = [g for name, g in grads.items() if name in self.dims]
        whole = [g for name, g in grads.items() if name not in self.dims]
        sq = torch.square(global_norm(dict(enumerate(sharded)))) if sharded else 0.0
        if sharded:
            sq = sq.reshape(1).clone()
            dist.all_reduce(sq, group=self.group)
            sq = sq[0]
        if whole:
            sq = sq + torch.square(global_norm(dict(enumerate(whole))))
        return torch.sqrt(sq)


def shard_state_tp(state: TrainState, mesh: DeviceMesh, min_features: int = 64, *,
                   model: nn.Module) -> TrainState:
    """Put ``state`` (whole, equal on every rank, whose params are
    ``model``'s own) in the tensor-parallel layout, in place: each eligible
    layer of ``model`` keeps this rank's output channels as its parameters,
    the EMA copy and the moments likewise, and the layer is hooked to gather
    its output over the ``model`` group. Returns ``state``, its
    ``tp_layout`` set."""
    specs = tp_state_sharding(state, mesh, min_features, model=model)
    names = mesh.mesh_dim_names
    layout = TPLayout({name: spec.index("model") for name, spec in specs.items() if spec},
                      mesh.get_group("model"), mesh.size(names.index("model")),
                      mesh.get_coordinate()[names.index("model")])
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name in layout.dims:
            owner, _, leaf = name.rpartition(".")
            setattr(modules[owner], leaf, nn.Parameter(layout.local(name, state.params[name])))
    hooked = {name.rpartition(".")[0] for name in layout.dims}
    for owner in sorted(hooked):
        _hook(modules[owner], layout)
    state.params = dict(model.named_parameters())
    param_names = list(state.params)
    state.opt_state = layout.map_params(layout.local, state.opt_state, param_names)
    if state.ema_params is not None:
        state.ema_params = layout.map_params(layout.local, state.ema_params, param_names)
    state.tp_layout = layout
    return state


def _hook(layer: nn.Module, layout: TPLayout) -> None:
    channel_dim = -1 if isinstance(layer, Dense) else 1  # [..., F] or NCHW

    def before(module, args):
        return (_CopyToModel.apply(args[0], channel_dim, layout.group),) + tuple(args[1:])

    def after(module, args, out):
        return _GatherChannels.apply(out, channel_dim, layout.group, layout.n, layout.index)

    layer.register_forward_pre_hook(before)
    layer.register_forward_hook(after)


def shard_batch_tp(batch, mesh: DeviceMesh):
    """This rank's rows of a global batch: sharded over ``data``, the same
    on every ``model`` rank."""
    return shard_batch(mesh, batch)
