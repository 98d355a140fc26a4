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
state across: the params as above, optax Adam's (or Adamax's) ``count``,
``mu`` and ``nu``, whose leaves are shaped as the params and convert the
same way, the step, the best validation loss and the EMA copy. The JAX
state is read and written through its attributes only (``params``,
``opt_state``, ``step``, ``best_val_loss``, ``ema_params``, optax's
namedtuples), so this module needs neither jax nor optax. The port's
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


def _port_adam(cfg: ExperimentConfig, opt_state) -> dict:
    if cfg.train.optimizer not in ("adam", "adamax") or cfg.train.grad_accum_steps > 1:
        raise NotImplementedError(
            "the train-state bridge carries optax.adam and optax.adamax states "
            f"without accumulation; got optimizer={cfg.train.optimizer!r}, "
            f"grad_accum_steps={cfg.train.grad_accum_steps}")
    return opt_state[-1] if isinstance(opt_state, list) else opt_state


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
    adam = _find_adam(jax_state.opt_state)
    port = _port_adam(cfg, state.opt_state)
    port["count"] = torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=device)

    def placed(tree) -> Dict[str, torch.Tensor]:
        # in the parameters' order, not the Flax tree's: the optimizer walks
        # gradients, moments and parameters side by side
        leaves = params_from_flax(tree, cfg.model)
        return {name: leaves[name].to(device) for name in state.params}

    for moment in ("mu", "nu"):
        port[moment] = placed(getattr(adam, moment))
    if jax_state.ema_params is not None:
        state.ema_params = placed(jax_state.ema_params)
    return state


def train_state_to_flax(state: TrainState, cfg: ExperimentConfig, like):
    """The port's ``TrainState`` -> a JAX ``TrainState`` shaped as ``like``
    (one built by the JAX package's ``create_train_state`` for the same
    config), with numpy leaves; ``like``'s RNG key is kept."""
    port = _port_adam(cfg, state.opt_state)
    count = np.asarray(int(port["count"]), np.int32)

    def fill(node):
        if _is_adam(node):
            return node._replace(count=count, mu=params_to_flax(port["mu"], cfg.model),
                                 nu=params_to_flax(port["nu"], cfg.model))
        if "count" in _fields(node):  # the schedule's count
            return node._replace(count=count)
        if isinstance(node, tuple) and not hasattr(node, "_fields"):  # a chain
            return tuple(fill(n) for n in node)
        return node

    return like.replace(
        params=params_to_flax(state.params, cfg.model),
        opt_state=fill(like.opt_state),
        step=np.asarray(state.step, np.int32),
        best_val_loss=np.asarray(state.best_val_loss, np.float32),
        ema_params=(None if state.ema_params is None
                    else params_to_flax(state.ema_params, cfg.model)),
    )
