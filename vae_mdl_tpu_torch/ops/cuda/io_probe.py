"""Hand-written CUDA kernel: the per-pixel channel sum of the memory-path
probes.

Port of the Pallas probes in ``scripts/kernel_isolate.py`` (``make`` with the
bodies ``dma_only`` and ``transpose_sum``: a channel-minor ``[K, P, C]``
tensor summed over C) and ``scripts/kernel_isolate2.py`` (``main``: the same
sum from a channel-first ``[K, C, P]`` tensor). Both become ``channel_sum``
in ``csrc/io_probe.cu`` (its header says what bounds them and how they are
laid out): ``path="direct"`` reads each pixel's channels straight from device
memory through the tensor's strides; ``path="staged"`` is the read walk of
``csrc/mdl_tile.cuh``, the memory path of the shipped forwards with no math
(persistent blocks, tiles of ``SUM_TILE`` pixels brought into shared memory
by one bulk asynchronous copy each, a thread summing its row there), for a
contiguous channel-minor tensor on a 16-byte aligned base only
(``staged_takes``). The TPU probes return ``[K, P / bp, 1, bp]``, their
block tiling; here the result is ``[K, P]``, the same numbers.

The direct path has two kernels, chosen by ``direct_kernel`` from the
tensor's strides and address alone: ``"vec4"`` for a channel-first tensor
whose pixels are contiguous (rows a multiple of ``VEC4_ROW`` pixels, channel
and sample strides multiples of 4, a 16-byte aligned base, offsets within
32 bits): 16-byte loads of four pixels, a warp summing 512 pixels of a row,
so that it walks 2 KB of each channel's row with 20 loads in flight;
``"strided"``, one thread a pixel through any strides, for everything else.
The staged path's kernel is ``"tiled"``. The choice goes to the C entry
point, which refuses a kernel the tensor does not fit. Every kernel adds a
pixel's channels in channel order, so all three give the same bits.

``channel_sum`` takes the plain version ``channel_sum_plain`` for CPU tensors
and launches the kernel (``channel_sum_cuda``) for CUDA tensors, which
raises on what it does not take; there is no fallback between them.
``launches`` counts the kernel's launches, ``launches_by_path`` the same by
(layout, path) and ``launches_by_kernel`` by kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from vae_mdl_tpu_torch.ops.cuda.build import CSRC, build
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import dense_aligned

SOURCE = CSRC / "io_probe.cu"
LAYOUTS = ("channel_minor", "channel_first")
PATHS = ("direct", "staged")
KERNELS = ("strided", "tiled", "vec4")  # the C entry point's numbering
VEC4_ROW = 512  # pixels a warp of the vec4 kernel sums: its rows are whole warps' worth
# pixels a tile of the staged path's read walk: csrc/mdl_tile.cuh kTilePixels
# times csrc/io_probe.cu kSumPixels
SUM_PIXELS = 2
SUM_TILE = 128 * SUM_PIXELS
# the widest row the staged path takes: a tile of SUM_TILE float32 rows and the
# walk's 8-byte barrier within a block's 232,448 B of shared memory on Hopper
# (csrc/io_probe.cu kMaxSharedBytes)
SUM_MAX_CHANNELS = (232448 - 8) // (4 * SUM_TILE)

# kernel launches since the counter was last set to 0, and the same by
# (layout, path) and by kernel: the two probes and their memory paths share
# the one entry point
launches = 0
launches_by_path: Dict[Tuple[str, str], int] = {}
launches_by_kernel: Dict[str, int] = dict.fromkeys(KERNELS, 0)


@functools.cache
def library() -> ctypes.CDLL:
    """The built ``io_probe.cu``, with the channel sum's and the null-body
    MoDL kernels' (``ops/cuda/mdl_null.py``) entry points typed."""
    lib = ctypes.CDLL(str(build(SOURCE)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.channel_sum.argtypes = [ptr, ptr, i32] + [i64] * 6 + [ptr]
    lib.channel_sum.restype = i32
    lib.channel_sum_tile_blocks_per_sm.argtypes = [i32]
    lib.channel_sum_tile_blocks_per_sm.restype = i32
    lib.mdl_null_forward.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 13 + [ptr]
    lib.mdl_null_forward.restype = i32
    lib.mdl_null_backward.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 22 + [ptr]
    lib.mdl_null_backward.restype = i32
    lib.mdl_null_tile_blocks_per_sm.argtypes = [i32] * 3
    lib.mdl_null_tile_blocks_per_sm.restype = i32
    return lib


def _channel_dim(layout: str) -> int:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}; got {layout!r}")
    return 2 if layout == "channel_minor" else 1


def channel_sum_plain(params: torch.Tensor, layout: str = "channel_minor") -> torch.Tensor:
    """The kernel's plain version: ``[K, P, C]`` (or ``[K, C, P]``) ->
    ``[K, P]``, the sum over the channels."""
    return params.sum(dim=_channel_dim(layout))


def direct_kernel(params: torch.Tensor, layout: str = "channel_minor") -> str:
    """The direct path's kernel for this tensor, from its strides and address
    alone: ``"vec4"`` for a ``[K, C, P]`` channel-first float32 tensor with
    pixel stride 1, ``P`` a multiple of ``VEC4_ROW``, the channel and the
    sample stride multiples of 4, a 16-byte aligned base and every element
    offset below 2^31; ``"strided"`` for anything else."""
    if layout != "channel_first" or params.dim() != 3 or params.dtype != torch.float32:
        return "strided"
    k, c, p = params.shape
    s_k, s_c, s_p = params.stride()
    span = (k - 1) * s_k + (c - 1) * s_c + p
    fits = (params.numel() > 0 and s_p == 1 and p % VEC4_ROW == 0 and s_c % 4 == 0
            and s_k % 4 == 0 and params.data_ptr() % 16 == 0 and span < 2 ** 31)
    return "vec4" if fits else "strided"


def staged_takes(shape: Sequence[int], strides: Sequence[int], dtype: torch.dtype,
                 address: int) -> bool:
    """Whether the staged path takes a tensor of this description, as the C
    entry point decides: a float32 ``[K, P, C]`` that is non-empty, dense and
    contiguous on a 16-byte aligned address (``mdl_kernel.dense_aligned``),
    with at most ``SUM_MAX_CHANNELS`` channels, so that its tile fits a
    block's shared memory."""
    return (dtype == torch.float32 and len(shape) == 3 and shape[2] <= SUM_MAX_CHANNELS
            and dense_aligned(shape, strides, address))


def channel_sum_cuda(params: torch.Tensor, layout: str = "channel_minor",
                     path: str = "direct", kernel: Optional[str] = None) -> torch.Tensor:
    """The kernel: a float32 CUDA tensor ``[K, P, C]`` (channel-minor) or
    ``[K, C, P]`` (channel-first), any strides on the direct path, what
    ``staged_takes`` accepts on the staged one (anything else raises before a
    launch) -> contiguous ``[K, P]`` float32. ``kernel`` names the direct
    path's kernel; ``None`` takes ``direct_kernel``'s choice, and ``"vec4"``
    on a tensor that does not fit it raises."""
    global launches
    channel_dim = _channel_dim(layout)
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}; got {path!r}")
    if kernel is not None and (path != "direct" or kernel not in ("strided", "vec4")):
        raise ValueError(f"the direct path's kernel is 'strided' or 'vec4'; got {kernel!r} "
                         f"on the {path} path")
    staged = path == "staged"
    if staged and not (layout == "channel_minor" and staged_takes(
            params.shape, params.stride(), params.dtype, params.data_ptr())):
        raise ValueError("the staged path takes a contiguous channel-minor float32 tensor of "
                         "at most 226 channels on a 16-byte aligned address")
    if not params.is_cuda:
        raise ValueError(f"the channel-sum kernel takes CUDA tensors only; got {params.device}")
    if params.dtype != torch.float32 or params.dim() != 3:
        raise TypeError("the channel-sum kernel takes a float32 tensor of three dimensions; "
                        f"got {params.dtype} {tuple(params.shape)}")
    k = params.shape[0]
    p, c = params.shape[3 - channel_dim], params.shape[channel_dim]
    s_k = params.stride(0)
    s_p, s_c = params.stride(3 - channel_dim), params.stride(channel_dim)
    out = torch.empty((k, p), device=params.device, dtype=torch.float32)
    if out.numel():
        kernel = "tiled" if staged else kernel or direct_kernel(params, layout)
        with torch.cuda.device(params.device):
            err = library().channel_sum(
                params.data_ptr(), out.data_ptr(), KERNELS.index(kernel), k, p, c, s_k, s_p,
                s_c, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"channel_sum kernel launch ({kernel}) failed: CUDA error {err}")
        launches += 1
        launches_by_path[layout, path] = launches_by_path.get((layout, path), 0) + 1
        launches_by_kernel[kernel] += 1
    return out


def tile_blocks_per_sm(channels: int) -> int:
    """Blocks an SM of the current CUDA device holds of the staged path's
    read walk at ``channels`` channels, as the occupancy query sizes its
    persistent grid."""
    return library().channel_sum_tile_blocks_per_sm(channels)


def channel_sum(params: torch.Tensor, layout: str = "channel_minor", path: str = "direct",
                kernel: Optional[str] = None) -> torch.Tensor:
    """Per-pixel sum over the channels: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    if params.device.type == "cpu":
        return channel_sum_plain(params, layout)
    return channel_sum_cuda(params, layout, path, kernel)
