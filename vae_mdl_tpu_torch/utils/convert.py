"""Weight bridge between the JAX package's Flax parameters and the port.

``params_from_flax`` turns a Flax variables tree (numpy or jax leaves,
``{"params": {"encoder": {"conv_0": {"kernel", "bias"}, ..., "Dense_0": ...},
"decoder": {...}}}``) into a ``state_dict`` for ``models.vae.VAE``;
``params_to_flax`` goes back. The port names its layers as Flax does, so a
leaf ``encoder/conv_0/kernel`` becomes ``encoder.conv_0.weight``. Per leaf:

- dense kernels ``[in, out]`` are transposed to ``[out, in]``; the flatten
  and reshape around the dense layers run in NHWC order inside the modules,
  so no rows or columns are permuted here;
- conv kernels go from HWIO to OIHW;
- transposed-conv kernels go from HWIO to IOHW and are flipped in both
  spatial axes: Flax correlates the dilated input with the kernel as it is,
  ``conv_transpose2d`` with the kernel flipped.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vae_mdl_tpu_torch.config import ModelConfig


def _is_transposed(cfg: ModelConfig, part: str, name: str) -> bool:
    if not name.startswith("conv_"):
        return False
    layers = cfg.encoder.conv_layers if part == "encoder" else cfg.decoder.conv_layers
    return layers[int(name.split("_")[1])][3]


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


def params_from_flax(variables, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flax variables (or their ``"params"`` tree) -> torch ``state_dict``."""
    tree = variables.get("params", variables)
    state = {}
    for part, modules in tree.items():
        for name, leaves in modules.items():
            weight = kernel_from_flax(np.asarray(leaves["kernel"]),
                                      _is_transposed(cfg, part, name))
            state[f"{part}.{name}.weight"] = torch.from_numpy(weight)
            state[f"{part}.{name}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
    return state


def params_to_flax(state_dict: Dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """torch ``state_dict`` -> Flax variables ``{"params": tree}`` of numpy
    float arrays."""
    tree: dict = {}
    for key, value in state_dict.items():
        part, name, leaf = key.split(".")
        array = value.detach().cpu().numpy()
        if leaf == "weight":
            array, leaf = kernel_to_flax(array, _is_transposed(cfg, part, name)), "kernel"
        tree.setdefault(part, {}).setdefault(name, {})[leaf] = array.copy()
    return {"params": tree}
