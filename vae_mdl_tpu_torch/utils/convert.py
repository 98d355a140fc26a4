"""Weight bridge between the JAX package's Flax parameters and the port.

``params_from_flax`` turns a Flax variables tree (numpy or jax leaves,
``{"params": {"encoder": {"conv_0": {"kernel", "bias"}, ..., "Dense_0": ...},
"decoder": {...}}}``) into a ``state_dict`` for ``models.vae.VAE`` or a
ladder family's model; ``params_to_flax`` goes back. The port names its
layers as Flax does, at any depth, so a leaf ``encoder/conv_0/kernel``
becomes ``encoder.conv_0.weight``, ``decoder/glu_2/Conv_1/kernel``
``decoder.glu_2.Conv_1.weight``, ``mlp_encoder_1/Dense_3/bias``
``mlp_encoder_1.Dense_3.bias`` and a ladder's
``enc_0/EncoderBlock_0/ResidualBlock_0/gate``
``enc_0.EncoderBlock_0.ResidualBlock_0.gate``. Per leaf:

- dense kernels ``[in, out]`` are transposed to ``[out, in]``; the flatten
  and reshape around the dense layers run in NHWC order inside the modules,
  so no rows or columns are permuted here;
- conv kernels go from HWIO to OIHW;
- transposed-conv kernels go from HWIO to IOHW and are flipped in both
  spatial axes: Flax correlates the dilated input with the kernel as it is,
  ``conv_transpose2d`` with the kernel flipped (only the VAE family's
  decoders have them);
- a layer without a bias (the biladder's ``conv_h``) has none on either
  side, and a parameter that is no layer's (the rezero ``gate``, 0-d) is
  carried as it is.

``train_state_from_flax`` and ``train_state_to_flax`` carry a whole training
state across: the params as above, the optimizer state of every optimizer
``make_optimizer`` builds, the step, the best validation loss and the EMA
copy. The two optimizer states are walked side by side, the port's
structure deciding what each JAX node is:

- optax Adam's or Adamax's ``count``, ``mu`` and ``nu`` (the port's
  ``{"count", "mu", "nu"}``), and the schedule's ``count`` beside them;
- Keras Adam's ``count``, ``m`` and ``v`` (``{"count", "m", "v"}``);
- ``optax.MultiSteps``' ``mini_step``, ``gradient_step``, ``acc_grads`` and
  its inner state (``{"mini_step", "gradient_step", "inner_opt_state",
  "acc_grads"}``), ``skip_state`` kept from the JAX side;
- the ``optax.chain`` of ``clip_by_global_norm`` (an empty state) and the
  optimizer (the port's ``[{}, inner]``).

Leaves shaped as the params convert as the params do. The JAX state is read
and written through its attributes only (``params``, ``opt_state``,
``step``, ``best_val_loss``, ``ema_params``, optax's namedtuples and the
Keras state's fields), so this module needs neither jax nor optax. The port's
generators are seeded from an integer, not from a JAX key, so the seed is
given, not carried.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from vae_mdl_tpu_torch.config import ExperimentConfig, ModelConfig
from vae_mdl_tpu_torch.train.state import TrainState, create_train_state


def _is_transposed(cfg, path) -> bool:
    """Whether the layer at ``path`` (``("decoder", "conv_1")``) is a
    transposed conv: a ``conv_{i}`` or ``pre_{i}`` entry of the encoder's or
    decoder's specs says so; no other layer is, and no ladder's."""
    if not isinstance(cfg, ModelConfig) or len(path) != 2 or path[0] not in ("encoder",
                                                                            "decoder"):
        return False
    kind, _, index = path[1].partition("_")
    part = cfg.encoder if path[0] == "encoder" else cfg.decoder
    if kind == "conv":
        return part.conv_layers[int(index)][3]
    if kind == "pre" and path[0] == "decoder":
        return part.pre_layers[int(index)][3]
    return False


def kernel_from_flax(kernel: np.ndarray, transposed: bool = False) -> np.ndarray:
    """One Flax kernel (dense ``[in, out]``, conv HWIO) -> torch weight."""
    if kernel.ndim == 2:
        return np.ascontiguousarray(kernel.T)
    if transposed:
        return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    return np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))


def kernel_to_flax(weight: np.ndarray, transposed: bool = False) -> np.ndarray:
    """The inverse of :func:`kernel_from_flax`."""
    if weight.ndim == 2:
        return np.ascontiguousarray(weight.T)
    if transposed:
        return np.ascontiguousarray(weight.transpose(2, 3, 0, 1)[::-1, ::-1])
    return np.ascontiguousarray(weight.transpose(2, 3, 1, 0))


def params_from_flax(variables, cfg) -> Dict[str, torch.Tensor]:
    """Flax variables (or their ``"params"`` tree) -> torch ``state_dict``."""
    state = {}

    def walk(node, path):
        name = ".".join(path)
        if not isinstance(node, Mapping):  # a parameter of its own: the gate
            state[name] = torch.from_numpy(np.array(node))
        elif "kernel" in node:
            weight = kernel_from_flax(np.asarray(node["kernel"]), _is_transposed(cfg, path))
            state[f"{name}.weight"] = torch.from_numpy(weight)
            if "bias" in node:
                state[f"{name}.bias"] = torch.from_numpy(np.array(node["bias"]))
        else:
            for key, child in node.items():
                walk(child, path + (key,))

    walk(variables.get("params", variables), ())
    return state


def params_to_flax(state_dict: Dict[str, torch.Tensor], cfg) -> dict:
    """torch ``state_dict`` -> Flax variables ``{"params": tree}`` of numpy
    float arrays."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        array = value.detach().cpu().numpy()
        if leaf == "weight":
            array, leaf = kernel_to_flax(array, _is_transposed(cfg, tuple(path))), "kernel"
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = array.copy()
    return {"params": tree}


def _fields(node) -> tuple:
    """A namedtuple's field names (optax's states are namedtuples)."""
    return getattr(node, "_fields", ())


def _is_adam(node) -> bool:
    return all(f in _fields(node) for f in ("count", "mu", "nu"))


def _find_adam(tree):
    """The first optax state with ``count``, ``mu`` and ``nu`` in a nest of
    tuples (``optax.adam`` is a chain of scale_by_adam and the schedule)."""
    if _is_adam(tree):
        return tree
    if isinstance(tree, tuple):
        for node in tree:
            found = _find_adam(node)
            if found is not None:
                return found
    return None


def _count(value, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(value)), dtype=torch.int32, device=device)


def _opt_from_flax(node, port, placed, device):
    """The port's optimizer state ``port`` filled from the JAX ``node``."""
    if isinstance(port, list):  # chain(clip_by_global_norm, inner)
        return [_opt_from_flax(n, p, placed, device) for n, p in zip(node, port)]
    if not port:  # the clip's empty state
        return port
    if "mini_step" in port:
        return {"mini_step": _count(node.mini_step, device),
                "gradient_step": _count(node.gradient_step, device),
                "inner_opt_state": _opt_from_flax(node.inner_opt_state,
                                                  port["inner_opt_state"], placed, device),
                "acc_grads": placed(node.acc_grads)}
    if "m" in port:  # Keras Adam
        return {"count": _count(node.count, device), "m": placed(node.m), "v": placed(node.v)}
    adam = _find_adam(node)
    return {"count": _count(adam.count, device), "mu": placed(adam.mu), "nu": placed(adam.nu)}


def _opt_to_flax(port, like, cfg):
    """The JAX optimizer state shaped as ``like`` holding the port's ``port``."""
    if isinstance(port, list):
        return type(like)(_opt_to_flax(p, n, cfg) for p, n in zip(port, like))
    if not port:
        return like
    if "mini_step" in port:
        return like._replace(
            mini_step=np.asarray(int(port["mini_step"]), np.int32),
            gradient_step=np.asarray(int(port["gradient_step"]), np.int32),
            inner_opt_state=_opt_to_flax(port["inner_opt_state"], like.inner_opt_state, cfg),
            acc_grads=params_to_flax(port["acc_grads"], cfg.model))
    count = np.asarray(int(port["count"]), np.int32)
    if "m" in port:  # Keras Adam: a flax struct, not a namedtuple
        return like.replace(count=count, m=params_to_flax(port["m"], cfg.model),
                            v=params_to_flax(port["v"], cfg.model))

    def fill(node):
        if _is_adam(node):
            return node._replace(count=count, mu=params_to_flax(port["mu"], cfg.model),
                                 nu=params_to_flax(port["nu"], cfg.model))
        if "count" in _fields(node):  # the schedule's count
            return node._replace(count=count)
        if isinstance(node, tuple) and not hasattr(node, "_fields"):  # a chain
            return tuple(fill(n) for n in node)
        return node

    return fill(like)


def train_state_from_flax(jax_state, model: torch.nn.Module, cfg: ExperimentConfig,
                          seed: Optional[int] = None) -> TrainState:
    """A JAX ``TrainState`` -> the port's, with ``model``'s parameters set
    from it (on the model's device). ``seed`` defaults to ``cfg.train.seed``."""
    device = next(model.parameters()).device
    model.load_state_dict(params_from_flax(jax_state.params, cfg.model))
    state = create_train_state(model, cfg.train)
    state.seed = cfg.train.seed if seed is None else seed
    state.step = int(np.asarray(jax_state.step))
    state.best_val_loss = float(np.asarray(jax_state.best_val_loss))

    def placed(tree) -> Dict[str, torch.Tensor]:
        # in the parameters' order, not the Flax tree's: the optimizer walks
        # gradients, moments and parameters side by side
        leaves = params_from_flax(tree, cfg.model)
        return {name: leaves[name].to(device) for name in state.params}

    state.opt_state = _opt_from_flax(jax_state.opt_state, state.opt_state, placed, device)
    if jax_state.ema_params is not None:
        state.ema_params = placed(jax_state.ema_params)
    return state


def train_state_to_flax(state: TrainState, cfg: ExperimentConfig, like):
    """The port's ``TrainState`` -> a JAX ``TrainState`` shaped as ``like``
    (one built by the JAX package's ``create_train_state`` for the same
    config), with numpy leaves; ``like``'s RNG key is kept."""
    return like.replace(
        params=params_to_flax(state.params, cfg.model),
        opt_state=_opt_to_flax(state.opt_state, like.opt_state, cfg),
        step=np.asarray(state.step, np.int32),
        best_val_loss=np.asarray(state.best_val_loss, np.float32),
        ema_params=(None if state.ema_params is None
                    else params_to_flax(state.ema_params, cfg.model)),
    )
