"""Neural building blocks: activations, leading-axis merge, dense layer, init.

Port of the parts of ``vae_mdl_tpu/nn/blocks.py`` the model05 path uses.
Parameters are float32 and initialised as Keras and the JAX package do
(glorot-uniform kernels, zero biases); a layer casts them to its compute
dtype at call time, as a Flax layer with ``dtype=`` does.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# config dtype names -> torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="none"),  # exact erf form
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "tanh": torch.tanh,
        "none": lambda x: x,
    }[name]


def merge_leading(x: torch.Tensor, n_trailing: int = 3):
    """Merge every axis before the last ``n_trailing`` into one batch axis.

    Returns ``(merged, unmerge)``; ``unmerge`` restores the leading shape on
    a tensor with possibly different trailing dims.
    """
    lead = tuple(x.shape[:-n_trailing])
    merged = x.reshape((-1,) + tuple(x.shape[-n_trailing:]))

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(lead + tuple(y.shape[1:]))

    return merged, unmerge


def glorot_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot-uniform init, the JAX package's ``_KERNEL_INIT``: U(-l, l) with
    l = sqrt(6 / (fan_in + fan_out)); a conv's fans include its taps."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-limit, limit, generator=generator)


class Dense(nn.Module):
    """``flax.linen.Dense``: weight stored ``[out, in]`` (the Flax kernel
    transposed), computed at the dtype given per call."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        glorot_uniform_(self.weight, in_features, out_features, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))
