"""Neural building blocks: activations, leading-axis merge, dense layer,
init, the MLP block, the gated conv block and the ladder families' residual,
encoder and decoder blocks.

Port of ``_activation``, ``merge_leading``, ``MLPBlock``, ``GLU``,
``ResidualBlock``, ``EncoderBlock``, ``StochasticEncoderBlock``,
``DecoderBlock`` and ``StochasticDecoderBlock`` from
``vae_mdl_tpu/nn/blocks.py``. Parameters are float32 and initialised as
Keras and the JAX package do (glorot-uniform kernels, zero biases, a zero
rezero gate); a layer casts them to its compute dtype at call time, as a
Flax layer with ``dtype=`` does, and the sums of two dtypes promote as in
JAX (a bf16 branch added to a float32 input gives float32). Submodules carry
the names Flax gives them (``Dense_0``, ``Conv_1``, ``ResidualBlock_0``,
``shortcut``, ``gate``), so the weight bridge is a renaming.

The residual, encoder and decoder blocks take and return ``[..., H, W, C]``
with any leading sample axes: they fold those into one batch
(``merge_leading``) and run their convolutions, pools and resizes on its
``[N, C, H, W]`` view, which is channels-last memory, as the port's other
convs do; so the float32 head that follows hands the likelihood a dense
channel-minor ``[..., H, W, C]`` tensor on a card.
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


class SameConv(nn.Module):
    """A stride-1 SAME conv of odd size ``kernel`` (3 by default), NCHW,
    weight ``[out, in, kernel, kernel]``; ``bias=False`` leaves the bias out,
    as Flax's ``use_bias=False``."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None, kernel: int = 3,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        glorot_uniform_(self.weight, in_features * kernel * kernel,
                        features * kernel * kernel, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), bias,
                        padding=self.weight.shape[-1] // 2)


class GLU(nn.Module):
    """Gated linear unit conv block, NCHW in and out: conv 3x3 + activation,
    conv 3x3 to ``2 * features``, split into (a, b), ``relu(a * sigmoid(b))``."""

    def __init__(self, in_features: int, features: int = 64, activation: str = "relu",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.dtype = dtype
        self.Conv_0 = SameConv(in_features, features, generator)
        self.Conv_1 = SameConv(features, 2 * features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_1(self.act(self.Conv_0(x, self.dtype)), self.dtype)
        a, b = torch.chunk(h, 2, dim=1)
        return F.relu(a * torch.sigmoid(b))


# -- the ladder families' blocks ----------------------------------------------------

# event axes of a spatial latent [..., h, w, c]
SPATIAL_AXES = (-1, -2, -3)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C]`` -> its ``[N, C, H, W]`` view."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> its ``[N, H, W, C]`` view."""
    return x.permute(0, 2, 3, 1)


def on_merged(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``fn`` (NCHW in and out) on ``x`` ``[..., H, W, C]``, every leading
    axis folded into its batch."""
    merged, unmerge = merge_leading(x)
    return unmerge(nhwc(fn(nchw(merged))))


def spatial_normal(out: torch.Tensor) -> Normal:
    """Head output ``[..., H, W, 2c]`` -> Normal(mu, softplus(logstd)) over
    the spatial latent ``[..., H, W, c]``."""
    mu, logstd = torch.chunk(out, 2, dim=-1)
    return Normal(mu, softplus(logstd), event_axes=SPATIAL_AXES)


class ResidualBlock(nn.Module):
    """VDVAE-style bottleneck: 1x1 -> 3x3 -> 3x3 -> 1x1 convs (``Conv_0`` ..
    ``Conv_3``), each followed by the activation; under ``rezero`` the branch
    is scaled by a learnable scalar ``gate`` initialised to 0; where the
    width changes, the input goes through a 1x1 ``shortcut`` conv."""

    def __init__(self, in_width: int, hidden_width: int, out_width: int, rezero: bool = False,
                 dtype: torch.dtype = torch.float32, activation: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.dtype = dtype
        self.Conv_0 = SameConv(in_width, hidden_width, generator, kernel=1)
        self.Conv_1 = SameConv(hidden_width, hidden_width, generator)
        self.Conv_2 = SameConv(hidden_width, hidden_width, generator)
        self.Conv_3 = SameConv(hidden_width, out_width, generator, kernel=1)
        self.gate = nn.Parameter(torch.zeros(())) if rezero else None
        self.shortcut = (SameConv(in_width, out_width, generator, kernel=1)
                         if in_width != out_width else None)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2, self.Conv_3):
            h = self.act(conv(h, self.dtype))
        if self.gate is not None:
            h = h * self.gate.to(h.dtype)
        if self.shortcut is not None:
            x = self.shortcut(x, self.dtype)
        return x + h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return on_merged(self.forward_nchw, x)


def _residual_stack(module: nn.Module, in_width: int, hidden_width: int, out_width: int,
                    n_blocks: int, rezero: bool, dtype: torch.dtype, activation: str,
                    generator: Optional[torch.Generator]):
    """Register ``n_blocks`` residual blocks on ``module`` as
    ``ResidualBlock_{i}`` and return them."""
    blocks = []
    for i in range(n_blocks):
        block = ResidualBlock(in_width if i == 0 else out_width, hidden_width, out_width,
                              rezero, dtype, activation, generator)
        module.add_module(f"ResidualBlock_{i}", block)
        blocks.append(block)
    return blocks


class EncoderBlock(nn.Module):
    """``n_blocks`` residual blocks, then an r x r average pool."""

    def __init__(self, in_width: int, hidden_width: int, out_width: int, n_blocks: int,
                 downscale_rate: int, rezero: bool = False, dtype: torch.dtype = torch.float32,
                 activation: str = "gelu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = downscale_rate
        self.blocks = _residual_stack(self, in_width, hidden_width, out_width, n_blocks,
                                      rezero, dtype, activation, generator)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block.forward_nchw(x)
        return F.avg_pool2d(x, self.rate, self.rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return on_merged(self.forward_nchw, x)


def upsample(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an ``[N, C, H, W]`` tensor to ``size`` with
    half-pixel centres: ``jax.image.resize(..., "bilinear")`` for an
    upscale."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


class DecoderBlock(nn.Module):
    """A bilinear r-times upsample (half-pixel centres, as
    ``jax.image.resize``), then ``n_blocks`` residual blocks."""

    def __init__(self, in_width: int, hidden_width: int, out_width: int, n_blocks: int,
                 upscale_rate: int, rezero: bool = False, dtype: torch.dtype = torch.float32,
                 activation: str = "gelu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = upscale_rate
        self.blocks = _residual_stack(self, in_width, hidden_width, out_width, n_blocks,
                                      rezero, dtype, activation, generator)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        x = upsample(x, (h * self.rate, w * self.rate))
        for block in self.blocks:
            x = block.forward_nchw(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return on_merged(self.forward_nchw, x)


class StochasticEncoderBlock(nn.Module):
    """``EncoderBlock_0``, then a float32 3x3 head conv ``Conv_0`` to twice
    the width and the activation on its output -> Normal(mu, softplus)."""

    def __init__(self, in_width: int, hidden_width: int, out_width: int, n_blocks: int,
                 downscale_rate: int, rezero: bool = False, dtype: torch.dtype = torch.float32,
                 activation: str = "gelu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.EncoderBlock_0 = EncoderBlock(in_width, hidden_width, out_width, n_blocks,
                                           downscale_rate, rezero, dtype, activation, generator)
        self.Conv_0 = SameConv(out_width, 2 * out_width, generator)

    def forward(self, x: torch.Tensor) -> Normal:
        return spatial_normal(on_merged(
            lambda h: self.act(self.Conv_0(self.EncoderBlock_0.forward_nchw(h).float(),
                                           torch.float32)), x))


class StochasticDecoderBlock(nn.Module):
    """``DecoderBlock_0``, then a float32 3x3 head conv ``Conv_0`` to twice
    the width and the activation on its output -> Normal(mu, softplus)."""

    def __init__(self, in_width: int, hidden_width: int, out_width: int, n_blocks: int,
                 upscale_rate: int, rezero: bool = False, dtype: torch.dtype = torch.float32,
                 activation: str = "gelu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.DecoderBlock_0 = DecoderBlock(in_width, hidden_width, out_width, n_blocks,
                                           upscale_rate, rezero, dtype, activation, generator)
        self.Conv_0 = SameConv(out_width, 2 * out_width, generator)

    def forward(self, x: torch.Tensor) -> Normal:
        return spatial_normal(on_merged(
            lambda h: self.act(self.Conv_0(self.DecoderBlock_0.forward_nchw(h).float(),
                                           torch.float32)), x))
