"""Encoder networks: amortized inference q(z | x).

Port of ``ConvSpec``, ``use_polyphase_deconv``, ``PolyphaseConvTranspose``,
``apply_conv_spec``, ``apply_conv_stack``, ``MLPEncoder`` and
``ConvEncoder`` (with its GLU stack) from
``vae_mdl_tpu/nn/encoders.py``. Public tensors keep the JAX layout (images
``[B, H, W, C]``); inside, convolutions take ``[B, C, H, W]`` views of that
NHWC data, which is channels-last memory.

Flax's ``padding="SAME"`` is reproduced exactly:
- a conv pads ``total = max((ceil(n/s) - 1) * s + k - n, 0)`` with the
  smaller half first, so a stride-2 3x3 conv on 32x32 pads 0 top/left and 1
  bottom/right; symmetric cases use the conv's own padding, others ``F.pad``;
- ``flax.linen.ConvTranspose`` correlates the s-dilated input, padded as
  ``lax.conv_transpose`` pads SAME, with its HWIO kernel unflipped;
  ``torch.nn.functional.conv_transpose2d`` correlates with the flipped kernel,
  so a transposed layer stores the Flax kernel spatially flipped, as
  ``[in, out, kh, kw]`` (``utils/convert.py``).

The phase route: on the card, a float32 kernel-4 stride-2 transposed layer
that autograd does not record runs as one 2x2 conv over its four output
phases plus a hand-written epilogue (``phase_conv_transpose``, chosen by
``takes_phase_route``), where ``F.conv_transpose2d`` would take cuDNN's
transposed-conv (dgrad) kernels, which on an H100 run float32 at half the
rate of its forward convs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vae_mdl_tpu_torch.distributions import Normal
from vae_mdl_tpu_torch.distributions.continuous import softplus
from vae_mdl_tpu_torch.nn.blocks import GLU, Dense, MLPBlock, _activation, glorot_uniform_
from vae_mdl_tpu_torch.ops.cuda import phase_shuffle


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv (or transposed-conv) layer: static architecture data."""

    features: int = 64
    kernel: int = 3
    stride: int = 1
    transpose: bool = False
    activation: str = "relu"


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's SAME for a strided conv."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def transpose_same_padding(kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding ``lax.conv_transpose`` gives the dilated input
    for ``padding="SAME"``."""
    pad_len = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return low, pad_len - low


class ConvLayer(nn.Module):
    """One :class:`ConvSpec` layer plus its activation, NCHW in and out.

    Weights: a conv stores ``[out, in, kh, kw]``, a transposed conv
    ``[in, out, kh, kw]`` spatially flipped against Flax; biases ``[out]``.
    """

    def __init__(self, spec: ConvSpec, in_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        k, f = spec.kernel, spec.features
        shape = (in_features, f, k, k) if spec.transpose else (f, in_features, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(f))
        glorot_uniform_(self.weight, in_features * k * k, f * k * k, generator)
        if spec.transpose:
            low, high = transpose_same_padding(k, spec.stride)
            self._padding, self._output_padding = k - 1 - low, high - low
            if self._padding < 0 or not 0 <= self._output_padding < spec.stride:
                raise NotImplementedError(
                    f"SAME transposed conv with kernel {k}, stride {spec.stride}")

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        s = self.spec
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if s.transpose:
            records = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                                   or b.requires_grad)
            if takes_phase_route(s, x.device.type, dtype, records):
                return phase_conv_transpose(x, w, b, s.activation)
            y = F.conv_transpose2d(x, w, b, stride=s.stride, padding=self._padding,
                                   output_padding=self._output_padding)
        else:
            top, bottom = same_padding(x.shape[-2], s.kernel, s.stride)
            left, right = same_padding(x.shape[-1], s.kernel, s.stride)
            if (top, left) == (bottom, right):
                y = F.conv2d(x, w, b, stride=s.stride, padding=(top, left))
            else:
                y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=s.stride)
        return _activation(s.activation)(y)


# the narrowest transposed layer the phase route takes. The zoo's one layer
# below it, model04's 6-channel head, lost on the route to the transposed
# conv alone on an H100 (its 2x2 conv, 24 channels wide, ran float32 at a
# third of the card's peak) and gained nothing in model04's decoder
PHASE_MIN_FEATURES = 8


def takes_phase_route(spec: ConvSpec, device_type: str, dtype: torch.dtype,
                      records: bool) -> bool:
    """Whether a transposed layer of ``spec`` runs as ``phase_conv_transpose``:
    kernel 4, stride 2, at least ``PHASE_MIN_FEATURES`` output channels, an
    activation the epilogue has; on the card (``device_type``), at float32,
    in a call that autograd does not record (``records``: grad mode on and
    an operand that requires grad; the backward stays on
    ``F.conv_transpose2d``) and that ``torch.export`` or ``torch.compile``
    does not trace (``torch.compiler.is_compiling()``: a traced program
    keeps ``F.conv_transpose2d``, ``aten`` operations only). bf16 stays on
    ``F.conv_transpose2d``, whose bf16 kernels run on the tensor cores."""
    return (spec.transpose and (spec.kernel, spec.stride) == (4, 2)
            and spec.features >= PHASE_MIN_FEATURES
            and spec.activation in phase_shuffle.ACTIVATIONS and device_type == "cuda"
            and dtype == torch.float32 and not records
            and not torch.compiler.is_compiling())


def phase_weight(weight: torch.Tensor) -> torch.Tensor:
    """A kernel-4 stride-2 transposed conv's weight (``[in, out, 4, 4]``,
    spatially flipped against Flax, as ``ConvLayer`` stores it) as the 2x2
    conv's contiguous ``[4 * out, in, 2, 2]`` whose output channel
    ``(2r + c) * out + o`` is output channel ``o`` at phase ``(r, c)``.
    Phase r of a row reads input rows ``i + r - 1`` and ``i + r`` (window
    taps t = 0, 1) with the Flax kernel's taps ``2t + r``
    (``polyphase_conv_transpose``'s formula), so the unflipped kernel's
    4-tap axes split into (t, r) and (u, c), and one copy places them."""
    c_in, f = weight.shape[:2]
    taps = weight.flip(2, 3).reshape(c_in, f, 2, 2, 2, 2)  # [in, out, t, r, u, c]
    return taps.permute(3, 5, 1, 0, 2, 4).reshape(4 * f, c_in, 2, 2)


def phase_conv_transpose(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         activation: str = "none") -> torch.Tensor:
    """``act(flax.linen.ConvTranspose(kernel 4, stride 2, SAME))`` on float32
    NCHW ``x`` ``[N, in, H, W]``: one stride-1 2x2 conv with padding 1
    computes the four output phases of every channel on the (H+1) x (W+1)
    grid (``phase_weight``), phase ``(r, c)`` the H x W window at offset
    ``(r, c)``; the epilogue (``ops/cuda/phase_shuffle.py``: the kernel on
    the card, its plain version on the CPU) interleaves the windows into
    ``[N, out, 2H, 2W]``, adds the bias and applies the activation. The
    grid's border is the only extra work: (H+1)(W+1) / HW of the transposed
    conv's multiply-adds.

    Memory format: ``x`` is made contiguous (NCHW) first, and the grid and
    the output are NCHW. cuDNN's float32 convs on an H100 run NCHW kernels,
    so a channels-last conv pays a layout conversion of its input and of its
    output, and their workspace; from NCHW the grid, the output and the next
    layer's conv need none."""
    grid = F.conv2d(x.contiguous(), phase_weight(weight), padding=1)
    return phase_shuffle.phase_shuffle(grid, bias, activation)


def use_polyphase_deconv() -> bool:
    """The automatic choice of the polyphase transposed conv: off, as in the
    JAX package. ``apply_conv_stack(..., polyphase=True)`` opts in."""
    return False


# phase -> {tap of the common 3-wide window: tap of the 4-wide kernel}, in
# the Flax (unflipped) kernel's order: phase 0 takes W[0], W[2], phase 1
# W[1], W[3]
_POLYPHASE_TAPS = ({0: 0, 1: 2}, {1: 1, 2: 3})


def polyphase_weight(weight: torch.Tensor) -> torch.Tensor:
    """A kernel-4 stride-2 transposed conv's weight (``[in, out, 4, 4]``,
    spatially flipped against Flax, as ``ConvLayer`` stores it) as the one
    dense 3x3 conv's weight ``[out * 4, in, 3, 3]`` whose output channel
    ``o * 4 + r * 2 + c`` is output channel ``o`` at phase ``(r, c)``, the
    order ``F.pixel_shuffle`` reads."""
    c_in, f = weight.shape[:2]
    flax = weight.flip(2, 3)  # [in, out, a, b] with Flax's tap order
    w3 = weight.new_zeros((f, 2, 2, c_in, 3, 3))
    for r in range(2):
        for c in range(2):
            for pi, ai in _POLYPHASE_TAPS[r].items():
                for pj, aj in _POLYPHASE_TAPS[c].items():
                    w3[:, r, c, :, pi, pj] = flax[:, :, ai, aj].T
    return w3.reshape(f * 4, c_in, 3, 3)


def polyphase_conv_transpose(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``flax.linen.ConvTranspose(kernel 4, stride 2, SAME)`` on NCHW ``x``
    as one dense 3x3 SAME conv producing each output channel's four phases,
    then a depth-to-space step. A phase reads two of the three taps of the
    common window ``(x[i - 1], x[i], x[i + 1])``:

        y[2i,     .] = W[0] x[i - 1] + W[2] x[i]
        y[2i + 1, .] = W[1] x[i]     + W[3] x[i + 1]      (the same in j)

    in the Flax kernel's tap order, so the stored (flipped) kernel is
    unflipped before its taps are placed (``polyphase_weight``)."""
    w3 = polyphase_weight(weight.to(dtype))
    y = F.conv2d(x.to(dtype), w3, padding=1)
    return F.pixel_shuffle(y, 2) + bias.to(dtype)[:, None, None]


class PolyphaseConvTranspose(nn.Module):
    """A kernel-4 stride-2 SAME transposed conv computed the polyphase way
    (``polyphase_conv_transpose``), NCHW in and out, no activation. Its
    parameters are those of the transposed :class:`ConvLayer` (``weight``
    ``[in, out, 4, 4]`` flipped against Flax, ``bias`` ``[out]``), so the
    two take each other's weights; the JAX package's
    ``PolyphaseConvTranspose`` holds Flax's ``nn.ConvTranspose``'s."""

    def __init__(self, in_features: int, features: int, kernel: int = 4, stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (kernel, stride) != (4, 2):
            raise ValueError("the polyphase path takes kernel 4, stride 2; got "
                             f"kernel {kernel}, stride {stride}")
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        glorot_uniform_(self.weight, in_features * kernel * kernel,
                        features * kernel * kernel, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return polyphase_conv_transpose(x, self.weight, self.bias, dtype)


def apply_conv_spec(layer: ConvLayer, x: torch.Tensor, dtype: torch.dtype,
                    polyphase: Optional[bool] = None) -> torch.Tensor:
    """One layer at the given compute dtype (NCHW). ``polyphase`` (None:
    ``use_polyphase_deconv()``) computes a kernel-4 stride-2 transposed
    layer with ``polyphase_conv_transpose``, on the same parameters."""
    if polyphase is None:
        polyphase = use_polyphase_deconv()
    s = layer.spec
    if s.transpose and polyphase and (s.kernel, s.stride) == (4, 2):
        return _activation(s.activation)(
            polyphase_conv_transpose(x, layer.weight, layer.bias, dtype))
    return layer(x, dtype)


def apply_conv_stack(layers: Sequence[ConvLayer], x: torch.Tensor,
                     dtype: torch.dtype, polyphase: Optional[bool] = None) -> torch.Tensor:
    for layer in layers:
        x = apply_conv_spec(layer, x, dtype, polyphase)
    return x


def conv_stack(specs: Sequence[ConvSpec], in_features: int, module: nn.Module,
               prefix: str = "conv", generator: Optional[torch.Generator] = None):
    """Register one :class:`ConvLayer` per spec on ``module`` as
    ``{prefix}_{i}`` (the Flax parameter names) and return them."""
    layers = []
    for i, spec in enumerate(specs):
        layer = ConvLayer(spec, in_features, generator)
        module.add_module(f"{prefix}_{i}", layer)
        layers.append(layer)
        in_features = spec.features
    return layers


def glu_stack(n_glu: int, in_features: int, features: int, activation: str,
              dtype: torch.dtype, module: nn.Module,
              generator: Optional[torch.Generator] = None):
    """Register ``n_glu`` :class:`GLU` blocks on ``module`` as ``glu_{i}`` (the
    Flax names) and return them."""
    blocks = []
    for i in range(n_glu):
        block = GLU(in_features, features, activation, dtype, generator)
        module.add_module(f"glu_{i}", block)
        blocks.append(block)
        in_features = features
    return blocks


class MLPEncoder(nn.Module):
    """Flatten the image -> ``MLPBlock`` -> Normal over the latent. The
    block is registered as ``MLPBlock_0``, its Flax name."""

    def __init__(self, image_shape: Tuple[int, int, int], n_hidden: int = 200,
                 n_latent: int = 100, activation: str = "tanh", std_transform: str = "exp",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = image_shape
        self.MLPBlock_0 = MLPBlock(h * w * c, n_hidden, n_latent, activation, std_transform,
                                   dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> Normal:
        """``x`` ``[..., H, W, C]`` -> q(z | x) over ``[..., n_latent]``."""
        return self.MLPBlock_0(x.reshape(tuple(x.shape[:-3]) + (-1,)))


class ConvEncoder(nn.Module):
    """Conv stack (+ optional GLU stack) -> flatten -> Dense(2 * n_latent) ->
    Normal(mu, softplus).

    The flatten runs in NHWC order, the order of the Flax ``Dense_0`` kernel's
    rows, so the weight bridge only transposes that kernel. The dense layer
    runs in float32 whatever the body's dtype.
    """

    def __init__(self, conv_specs: Sequence[ConvSpec], image_shape: Tuple[int, int, int],
                 n_latent: int = 20, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, n_glu: int = 0,
                 glu_features: int = 64, glu_activation: str = "relu"):
        super().__init__()
        self.dtype = dtype
        h, w, c = image_shape
        self.convs = conv_stack(conv_specs, c, self, generator=generator)
        for spec in conv_specs:
            h, w, c = -(-h // spec.stride), -(-w // spec.stride), spec.features
        self.glus = glu_stack(n_glu, c, glu_features, glu_activation, dtype, self, generator)
        if n_glu:
            c = glu_features
        self.Dense_0 = Dense(h * w * c, 2 * n_latent, generator)

    def forward(self, x: torch.Tensor) -> Normal:
        """``x`` ``[B, H, W, C]`` -> q(z | x) over ``[B, n_latent]``."""
        h = apply_conv_stack(self.convs, x.permute(0, 3, 1, 2), self.dtype)
        for block in self.glus:
            h = block(h)
        flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).float()
        mu, logstd = torch.chunk(self.Dense_0(flat), 2, dim=-1)
        return Normal(mu, softplus(logstd), event_axes=(-1,))
