"""Hand-written CUDA kernel: the depth-to-space epilogue of the phase-stacked
transposed conv.

It replaces no kernel of the JAX package, which leaves its transposed convs
to XLA; ``csrc/phase_shuffle.cu``'s header says why it was added, what
bounds it and how it is laid out. ``nn.encoders.phase_conv_transpose``
computes a float32 kernel-4 stride-2 SAME transposed conv of C output
channels as one stride-1 2x2 conv with 4C output channels on the (H+1) x
(W+1) grid, phase ``(r, c)`` of output channel ``o`` in grid channel ``(2r +
c) * C + o``; this epilogue takes the grid ``[N, 4C, H+1, W+1]`` to the
output ``[N, C, 2H, 2W]``: each phase's H x W window at offset ``(r, c)``,
interleaved, plus the bias, through the activation.

- ``phase_shuffle_plain(grid, bias, activation)``: the plain version (the
  four windows, ``pixel_shuffle``, bias, activation);
- ``phase_shuffle_cuda``: the kernel, for a contiguous (NCHW) float32 CUDA
  grid and a float32 bias on its device, raising on anything else; the
  output is contiguous;
- ``phase_shuffle``: the plain version for CPU tensors, the kernel for
  CUDA tensors; there is no fallback between them.

``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from vae_mdl_tpu_torch.ops.cuda.build import CSRC, build

SOURCE = CSRC / "phase_shuffle.cu"
ACTIVATIONS = ("none", "relu", "gelu")  # the C entry point's numbering

# kernel launches since the counter was last set to 0
launches = 0

_ACT = {
    "none": lambda y: y,
    "relu": F.relu,
    "gelu": lambda y: F.gelu(y, approximate="none"),  # the exact erf form
}


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.phase_shuffle.argtypes = [ptr] * 3 + [i32] + [i64] * 4 + [ptr]
    lib.phase_shuffle.restype = i32
    return lib


def _features(grid: torch.Tensor, bias: torch.Tensor, activation: str) -> int:
    """C, after checking the shapes and the activation."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}; got {activation!r}")
    if grid.dim() != 4 or grid.shape[1] % 4 or min(grid.shape[2:]) < 2:
        raise ValueError("the phase grid is [N, 4C, H+1, W+1] with H, W >= 1; got "
                         f"{tuple(grid.shape)}")
    c = grid.shape[1] // 4
    if tuple(bias.shape) != (c,):
        raise ValueError(f"bias of shape {tuple(bias.shape)} for {c} output channels")
    return c


def phase_shuffle_plain(grid: torch.Tensor, bias: torch.Tensor,
                        activation: str = "none") -> torch.Tensor:
    """The kernel's plain version: ``[N, 4C, H+1, W+1]`` -> contiguous ``[N,
    C, 2H, 2W]``, ``out[n, o, 2i + r, 2j + c] = act(grid[n, (2r + c) C + o,
    i + r, j + c] + bias[o])``."""
    c = _features(grid, bias, activation)
    n, _, h, w = grid.shape
    h, w = h - 1, w - 1
    phases = [grid[:, (2 * r + s) * c:(2 * r + s + 1) * c, r:r + h, s:s + w]
              for r in (0, 1) for s in (0, 1)]
    # [N, C, 4, H, W] -> channel o * 4 + 2r + s, the order pixel_shuffle reads
    stacked = torch.stack(phases, 2).reshape(n, 4 * c, h, w)
    out = _ACT[activation](F.pixel_shuffle(stacked, 2) + bias[:, None, None])
    return out.contiguous()


def phase_shuffle_cuda(grid: torch.Tensor, bias: torch.Tensor,
                       activation: str = "none") -> torch.Tensor:
    """The kernel: a contiguous float32 CUDA ``grid`` ``[N, 4C, H+1, W+1]``
    and a float32 ``bias`` ``[C]`` on its device -> contiguous ``[N, C, 2H,
    2W]``."""
    global launches
    c = _features(grid, bias, activation)
    if not (grid.is_cuda and bias.is_cuda and grid.device == bias.device):
        raise ValueError("the phase-shuffle kernel takes CUDA tensors on one device; got "
                         f"{grid.device}, {bias.device}")
    if grid.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("the phase-shuffle kernel takes a float32 grid and bias; got "
                        f"{grid.dtype}, {bias.dtype}")
    if not grid.is_contiguous():
        raise ValueError(f"the phase-shuffle kernel takes a contiguous (NCHW) grid; got "
                         f"strides {grid.stride()}")
    n, _, h, w = grid.shape
    h, w = h - 1, w - 1
    out = torch.empty((n, c, 2 * h, 2 * w), device=grid.device, dtype=grid.dtype)
    bias = bias.contiguous()
    with torch.cuda.device(grid.device):
        err = library().phase_shuffle(
            grid.data_ptr(), bias.data_ptr(), out.data_ptr(), ACTIVATIONS.index(activation),
            n, c, h, w, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"phase_shuffle kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def phase_shuffle(grid: torch.Tensor, bias: torch.Tensor,
                  activation: str = "none") -> torch.Tensor:
    """The epilogue: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if grid.device.type == "cpu":
        return phase_shuffle_plain(grid, bias, activation)
    return phase_shuffle_cuda(grid, bias, activation)
