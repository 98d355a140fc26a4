"""Neural building blocks: activations, leading-axis merge, dense layer,
init, the MLP block and the gated conv block.

Port of ``_activation``, ``merge_leading``, ``MLPBlock`` and ``GLU`` from
``vae_mdl_tpu/nn/blocks.py``; ``ResidualBlock`` and the encoder/decoder
blocks come with the ladder models. Parameters are float32 and initialised
as Keras and the JAX package do (glorot-uniform kernels, zero biases); a
layer casts them to its compute dtype at call time, as a Flax layer with
``dtype=`` does. Submodules carry the names Flax gives them (``Dense_0``,
``Conv_1``), so the weight bridge is a renaming.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vae_mdl_tpu_torch.distributions.continuous import Normal, softplus

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


class MLPBlock(nn.Module):
    """Two dense layers, then float32 ``mu`` and raw-scale heads -> Normal.

    ``Dense_0`` and ``Dense_1`` run at ``dtype``; ``Dense_2`` (mu) and
    ``Dense_3`` (raw scale) in float32 whatever the body's dtype. The scale is
    ``exp(raw)`` or ``softplus(raw)``, plus ``std_eps``.
    """

    def __init__(self, n_in: int, n_hidden: int, n_latent: int, activation: str = "tanh",
                 std_transform: str = "exp", std_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if std_transform not in ("exp", "softplus"):
            raise ValueError(f"std_transform must be 'exp' or 'softplus'; got {std_transform!r}")
        self.act = _activation(activation)
        self.std_transform = std_transform
        self.std_eps = std_eps
        self.dtype = dtype
        self.Dense_0 = Dense(n_in, n_hidden, generator)
        self.Dense_1 = Dense(n_hidden, n_hidden, generator)
        self.Dense_2 = Dense(n_hidden, n_latent, generator)
        self.Dense_3 = Dense(n_hidden, n_latent, generator)

    def forward(self, x: torch.Tensor) -> Normal:
        h = self.act(self.Dense_0(x, self.dtype))
        h = self.act(self.Dense_1(h, self.dtype)).float()
        mu, raw = self.Dense_2(h), self.Dense_3(h)
        std = torch.exp(raw) if self.std_transform == "exp" else softplus(raw)
        return Normal(mu, std + self.std_eps, event_axes=(-1,))


class _Conv3x3(nn.Module):
    """A stride-1 SAME 3x3 conv, NCHW, weight ``[out, in, 3, 3]``."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        glorot_uniform_(self.weight, in_features * 9, features * 9, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.conv2d(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype), padding=1)


class GLU(nn.Module):
    """Gated linear unit conv block, NCHW in and out: conv 3x3 + activation,
    conv 3x3 to ``2 * features``, split into (a, b), ``relu(a * sigmoid(b))``."""

    def __init__(self, in_features: int, features: int = 64, activation: str = "relu",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.dtype = dtype
        self.Conv_0 = _Conv3x3(in_features, features, generator)
        self.Conv_1 = _Conv3x3(features, 2 * features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_1(self.act(self.Conv_0(x, self.dtype)), self.dtype)
        a, b = torch.chunk(h, 2, dim=1)
        return F.relu(a * torch.sigmoid(b))
