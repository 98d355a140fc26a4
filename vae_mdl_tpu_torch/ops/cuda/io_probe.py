"""Hand-written CUDA kernel: the per-pixel channel sum of the memory-path
probes.

Port of the Pallas probes in ``scripts/kernel_isolate.py`` (``make`` with the
bodies ``dma_only`` and ``transpose_sum``: a channel-minor ``[K, P, C]``
tensor summed over C) and ``scripts/kernel_isolate2.py`` (``main``: the same
sum from a channel-first ``[K, C, P]`` tensor). Both become ``channel_sum``
in ``csrc/io_probe.cu`` (its header says what bounds them and how they are
laid out): ``path="direct"`` reads each pixel's channels straight from device
memory through the tensor's strides, ``path="staged"`` moves a tile of
``tile`` pixels through shared memory with coalesced loads (channel-minor,
contiguous only). The TPU probes return ``[K, P / bp, 1, bp]``, their block
tiling; here the result is ``[K, P]``, the same numbers.

``channel_sum`` takes the plain version ``channel_sum_plain`` for CPU tensors
and launches the kernel (``channel_sum_cuda``) for CUDA tensors, which
raises on what it does not take; there is no fallback between them.
``launches`` counts the kernel's launches, ``launches_by_path`` the same by
(layout, path).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from vae_mdl_tpu_torch.ops.cuda.build import CSRC, build

SOURCE = CSRC / "io_probe.cu"
LAYOUTS = ("channel_minor", "channel_first")
PATHS = ("direct", "staged")
# shared memory a block can use on Hopper (227 KB); a staged tile holds `tile`
# rows of C float32 values padded to an odd length
MAX_SHARED_BYTES = 232_448

# kernel launches since the counter was last set to 0, and the same by
# (layout, path): the two probes and their memory paths share the one kernel
launches = 0
launches_by_path: Dict[Tuple[str, str], int] = {}


@functools.cache
def library() -> ctypes.CDLL:
    """The built ``io_probe.cu``, with the channel sum's and the null-body
    MoDL kernels' (``ops/cuda/mdl_null.py``) entry points typed."""
    lib = ctypes.CDLL(str(build(SOURCE)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.channel_sum.argtypes = [ptr, ptr, i32, i32] + [i64] * 6 + [ptr]
    lib.channel_sum.restype = i32
    lib.mdl_null_forward.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 13 + [ptr]
    lib.mdl_null_forward.restype = i32
    lib.mdl_null_backward.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 22 + [ptr]
    lib.mdl_null_backward.restype = i32
    lib.mdl_null_backward_tile_blocks_per_sm.argtypes = [i32] * 2
    lib.mdl_null_backward_tile_blocks_per_sm.restype = i32
    return lib


def _channel_dim(layout: str) -> int:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}; got {layout!r}")
    return 2 if layout == "channel_minor" else 1


def channel_sum_plain(params: torch.Tensor, layout: str = "channel_minor") -> torch.Tensor:
    """The kernel's plain version: ``[K, P, C]`` (or ``[K, C, P]``) ->
    ``[K, P]``, the sum over the channels."""
    return params.sum(dim=_channel_dim(layout))


def channel_sum_cuda(params: torch.Tensor, layout: str = "channel_minor",
                     path: str = "direct", tile: int = 256) -> torch.Tensor:
    """The kernel: a float32 CUDA tensor ``[K, P, C]`` (channel-minor) or
    ``[K, C, P]`` (channel-first), any strides on the direct path, contiguous
    channel-minor on the staged one -> contiguous ``[K, P]`` float32."""
    global launches
    channel_dim = _channel_dim(layout)
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}; got {path!r}")
    if not params.is_cuda:
        raise ValueError(f"the channel-sum kernel takes CUDA tensors only; got {params.device}")
    if params.dtype != torch.float32 or params.dim() != 3:
        raise TypeError("the channel-sum kernel takes a float32 tensor of three dimensions; "
                        f"got {params.dtype} {tuple(params.shape)}")
    k = params.shape[0]
    p, c = params.shape[3 - channel_dim], params.shape[channel_dim]
    s_k = params.stride(0)
    s_p, s_c = params.stride(3 - channel_dim), params.stride(channel_dim)
    staged = path == "staged"
    if staged and not (layout == "channel_minor" and params.is_contiguous()):
        raise ValueError("the staged path takes a contiguous channel-minor tensor")
    if staged and (tile % 32 or not 32 <= tile <= 1024):
        raise ValueError(f"tile must be a multiple of 32 in [32, 1024]; got {tile}")
    if staged and tile * (c | 1) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"a tile of {tile} pixels x {c} channels needs {tile * (c | 1) * 4} "
                         f"bytes of shared memory; a block has {MAX_SHARED_BYTES}")
    out = torch.empty((k, p), device=params.device, dtype=torch.float32)
    if out.numel():
        with torch.cuda.device(params.device):
            err = library().channel_sum(params.data_ptr(), out.data_ptr(), int(staged), tile,
                                        k, p, c, s_k, s_p, s_c,
                                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"channel_sum kernel launch failed: CUDA error {err}")
        launches += 1
        launches_by_path[layout, path] = launches_by_path.get((layout, path), 0) + 1
    return out


def channel_sum(params: torch.Tensor, layout: str = "channel_minor", path: str = "direct",
                tile: int = 256) -> torch.Tensor:
    """Per-pixel sum over the channels: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    if params.device.type == "cpu":
        return channel_sum_plain(params, layout)
    return channel_sum_cuda(params, layout, path, tile)
