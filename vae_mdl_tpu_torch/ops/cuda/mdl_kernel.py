"""Hand-written CUDA kernels: mixture-of-discretized-logistics log-prob,
forward and backward.

Port of the Pallas kernels in ``vae_mdl_tpu/ops/pallas/mdl_kernel.py``: the
forwards ``_forward``, ``_forward_bl``, ``_forward_bl_split`` and
``_forward_bl_kgrid`` become one kernel, and their backwards
``_backward_params``, ``_backward_params_bl``, ``_backward_params_bl_split``
and ``_backward_params_bl_kgrid`` another, both in ``csrc/mdl_log_prob.cu``,
reading the head's output where it lies. The source's header says what
bounds them and how they are laid out.

Each direction has two memory paths, chosen by ``forward_path`` and
``backward_path`` from the operands' strides, dtype and addresses alone.
``"tiled"``: parameters (and gradient) dense and channel-minor (what the
model's channels-last head hands on) and 16-byte aligned; a tile of
``TILE_PIXELS`` pixels is then one run of bytes, which persistent blocks
bring into shared memory with a bulk asynchronous copy (``csrc/mdl_tile.cuh``;
``tiles_of`` is the blocks' schedule); the forward stores one float a pixel
from there, the backward writes the gradient over the tile and sends it back
with one bulk store. ``"direct"``: any other strides (NCHW, a sliced or
misaligned view), one thread a pixel through the strides, coalesced in NCHW.
The choice goes to the C entry point as an argument, and asking for
``"tiled"`` on operands that do not fit raises: nothing tries one path after
the other. Each direction runs one body on both paths (the backward's
evaluates each cascade once for its value and its derivatives), so the two
paths give the same bits.

- ``mdl_log_prob(x01, parameters)`` is the drop-in for
  ``distributions.mixture.mixture_log_prob``: CPU tensors take that plain
  version, CUDA tensors launch the forward kernel (``mdl_log_prob_cuda``),
  which raises on anything it does not take. There is no fallback between
  them. Differentiating ``mdl_log_prob_cuda`` launches the backward kernel
  for the parameters' gradient; the images' gradient, which no training
  path asks for, goes through the plain version's autograd.
- ``mdl_backward_plain(x01, parameters, g)`` is the backward kernel's plain
  version: the analytic gradient of the Pallas backward (``_bwd_math``, with
  ``dl_kernel.dl_grads_plain`` for its ``_dl_grads``) in plain PyTorch, with
  its tie rules. ``mdl_backward`` takes it for CPU tensors and launches the
  kernel (``mdl_backward_cuda``) for CUDA tensors.
- The library is built with ``nvcc`` for ``sm_90a`` at first use into
  ``vae_mdl_tpu_torch/_build/`` (``ops/cuda/build.py``: keyed by a hash of the
  source, the shared header and the flags) and loaded with ``ctypes``; nothing
  is built or loaded at import.
- ``launches`` and ``backward_launches`` count the two kernels' launches,
  ``launches_by_path`` and ``backward_launches_by_path`` the same by memory
  path; callers reset them to 0 and read them to show that a run went
  through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.ops.cuda import build as _build
from vae_mdl_tpu_torch.ops.cuda.build import BUILD_DIR  # noqa: F401  (where builds live)
from vae_mdl_tpu_torch.ops.cuda.dl_kernel import dl_grads_plain

SOURCE = _build.CSRC / "mdl_log_prob.cu"
MAX_MIX = 10
_INTERVAL_WIDTH = 2.0 / 255.0  # 256 levels on [-1, 1]

PATHS = ("tiled", "direct")
TILE_PIXELS = 128  # csrc/mdl_tile.cuh kTilePixels: pixels a tile, threads a block

# kernel launches since the counter was last set to 0: forward, backward, and
# each by memory path
launches = 0
backward_launches = 0
launches_by_path: Dict[str, int] = dict.fromkeys(PATHS, 0)
backward_launches_by_path: Dict[str, int] = dict.fromkeys(PATHS, 0)


def library_path() -> Path:
    """Where the build of the current source, headers and flags lives."""
    return _build.library_path(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mdl_log_prob_forward.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 13 + [ptr]
    lib.mdl_log_prob_forward.restype = i32
    lib.mdl_log_prob_forward_tile_blocks_per_sm.argtypes = [i32] * 2
    lib.mdl_log_prob_forward_tile_blocks_per_sm.restype = i32
    lib.mdl_log_prob_backward.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 22 + [ptr]
    lib.mdl_log_prob_backward.restype = i32
    lib.mdl_log_prob_backward_tile_blocks_per_sm.argtypes = [i32] * 2
    lib.mdl_log_prob_backward_tile_blocks_per_sm.restype = i32
    return lib


def _check(x01: torch.Tensor, parameters: torch.Tensor) -> None:
    if not (x01.is_cuda and parameters.is_cuda):
        raise ValueError(
            "the MoDL kernel takes CUDA tensors only; got x on "
            f"{x01.device} and parameters on {parameters.device}")
    if x01.device != parameters.device:
        raise ValueError(f"x on {x01.device}, parameters on {parameters.device}")
    if x01.dtype != torch.float32:
        raise TypeError(f"x must be float32 in [0, 1]; got {x01.dtype}")
    if parameters.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"parameters must be float32 or bfloat16; got {parameters.dtype}")
    if x01.dim() != 4 or x01.shape[-1] != 3:
        raise ValueError(f"x must be [B, H, W, 3]; got {tuple(x01.shape)}")
    if parameters.dim() != 5:
        raise ValueError(f"parameters must be [k, B, H, W, 10n]; got {tuple(parameters.shape)}")
    c = parameters.shape[-1]
    if c % 10 or not 1 <= c // 10 <= MAX_MIX:
        raise ValueError(f"parameters need 10 * n_mix channels, 1 <= n_mix <= {MAX_MIX}; got {c}")
    if tuple(parameters.shape[1:4]) != tuple(x01.shape[:3]):
        raise ValueError(
            f"parameters' [B, H, W] {tuple(parameters.shape[1:4])} do not "
            f"match x's {tuple(x01.shape[:3])}")


def _launch(x01: torch.Tensor, parameters: torch.Tensor,
            path: Optional[str] = None) -> torch.Tensor:
    global launches
    _check_path(path)
    _check(x01, parameters)
    k, b, h, w, c = parameters.shape
    out = torch.empty((k, b, h, w), device=parameters.device, dtype=torch.float32)
    if out.numel():
        path = path or forward_path(parameters)
        with torch.cuda.device(parameters.device):
            err = _library().mdl_log_prob_forward(
                x01.data_ptr(), parameters.data_ptr(), out.data_ptr(),
                int(parameters.dtype == torch.bfloat16), c // 10,
                int(path == "tiled"),
                k, b, h, w, *x01.stride(), *parameters.stride(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mdl_log_prob kernel launch ({path} path) failed: "
                               f"CUDA error {err}")
        launches += 1
        launches_by_path[path] += 1
    return out.unsqueeze(-1)


def dense_aligned(shape: Sequence[int], strides: Sequence[int], address: int) -> bool:
    """Whether a tensor of this shape, these element strides and this address
    is non-empty and dense in row-major order (channel-minor: ``is_contiguous``'s
    rule, under which the stride of a dimension of one element does not
    matter, as for ``mdlt::channel_minor_dense``) on a 16-byte aligned
    address: what a bulk copy moves as one run of bytes a tile."""
    if 0 in tuple(shape):
        return False
    want = 1
    for n, stride in zip(reversed(tuple(shape)), reversed(tuple(strides))):
        if n != 1 and stride != want:
            return False
        want *= n
    return address % 16 == 0


def path_for(shape: Sequence[int], strides: Sequence[int], dtype: torch.dtype,
             address: int) -> str:
    """``forward_path`` from the parameters' description alone: ``"tiled"``
    for a dense channel-minor float32 or bfloat16 tensor on a 16-byte aligned
    address (``dense_aligned``), ``"direct"`` for anything else."""
    fits = dtype in (torch.float32, torch.bfloat16) and dense_aligned(shape, strides, address)
    return "tiled" if fits else "direct"


def _tile_operand(t: torch.Tensor) -> bool:
    """What the tile path takes of one operand (``path_for``)."""
    return path_for(t.shape, t.stride(), t.dtype, t.data_ptr()) == "tiled"


def forward_path(parameters: torch.Tensor) -> str:
    """The memory path the forward kernel takes for these parameters, from
    their strides, dtype and address alone (``path_for``): ``"tiled"`` where
    they are a dense channel-minor ``[k, B, H, W, C]`` float32 or bfloat16
    tensor on a 16-byte aligned address, so that ``TILE_PIXELS`` consecutive
    pixels are one run of bytes a bulk copy can move; ``"direct"`` for
    anything else (NCHW strides, a sliced or misaligned view) and for empty
    parameters, which launch nothing."""
    return path_for(parameters.shape, parameters.stride(), parameters.dtype,
                    parameters.data_ptr())


def backward_path(parameters: torch.Tensor, dp: torch.Tensor) -> str:
    """The memory path the backward kernel takes for these parameters and
    this gradient buffer: ``"tiled"`` where both take the forward's tile path
    and have one dtype and shape, ``"direct"`` for anything else."""
    fits = (parameters.dtype == dp.dtype and tuple(parameters.shape) == tuple(dp.shape)
            and _tile_operand(parameters) and _tile_operand(dp))
    return "tiled" if fits else "direct"


def tiles_of(total: int, tile: int, blocks: int) -> List[List[Tuple[int, int]]]:
    """The tile path's schedule, as ``mdlt::for_each_tile`` walks it: ``total``
    pixels cut into tiles of ``tile``, block ``b`` of ``blocks`` taking tiles
    ``b, b + blocks, ...``. Returns, per block, its ``(first pixel, pixels)``
    in order; only the last tile of all can be short."""
    n_tiles = -(-total // tile)
    return [[(t * tile, min(tile, total - t * tile)) for t in range(b, n_tiles, blocks)]
            for b in range(blocks)]


def tile_blocks_per_sm(dtype: torch.dtype, n_mix: int, forward: bool = False) -> int:
    """Blocks an SM of the current CUDA device holds of the backward's (or,
    with ``forward``, the forward's) tile path for parameters of ``dtype``
    with ``n_mix`` mixtures, as the CUDA occupancy query sizes its
    persistent grid."""
    bf16 = int(dtype == torch.bfloat16)
    if forward:
        return _library().mdl_log_prob_forward_tile_blocks_per_sm(bf16, n_mix)
    return _library().mdl_log_prob_backward_tile_blocks_per_sm(bf16, n_mix)


def _check_cotangent(parameters: torch.Tensor, g: torch.Tensor) -> None:
    if not g.is_cuda or g.device != parameters.device:
        raise ValueError(f"g on {g.device}, parameters on {parameters.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32; got {g.dtype}")
    k, b, h, w, _ = parameters.shape
    if tuple(g.shape) != (k, b, h, w, 1):
        raise ValueError(f"g must be [k, B, H, W, 1] = {(k, b, h, w, 1)}; got {tuple(g.shape)}")


def _check_path(path: Optional[str]) -> None:
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None; got {path!r}")


def mdl_backward_cuda(x01: torch.Tensor, parameters: torch.Tensor, g: torch.Tensor,
                      path: Optional[str] = None) -> torch.Tensor:
    """The backward kernel: d(sum g * mdl_log_prob(x01, parameters)) /
    d parameters. ``g`` ``[k, B, H, W, 1]`` float32, any strides (an
    expanded cotangent is read in place). The gradient has the parameters'
    dtype and, as ``torch.empty_like`` gives it, their strides: the
    channels-last head's output gets a channel-minor gradient, an NCHW view
    an NCHW one. ``path`` names the memory path; ``None`` takes
    ``backward_path``'s choice, and ``"tiled"`` on operands that do not fit
    it raises."""
    global backward_launches
    _check_path(path)
    _check(x01, parameters)
    _check_cotangent(parameters, g)
    k, b, h, w, c = parameters.shape
    dp = torch.empty_like(parameters)
    if dp.numel():
        path = path or backward_path(parameters, dp)
        with torch.cuda.device(parameters.device):
            err = _library().mdl_log_prob_backward(
                x01.data_ptr(), parameters.data_ptr(), g.data_ptr(), dp.data_ptr(),
                int(parameters.dtype == torch.bfloat16), c // 10,
                int(path == "tiled"),
                k, b, h, w, *x01.stride(), *parameters.stride(), *g.stride()[:4],
                *dp.stride(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mdl_log_prob backward kernel launch ({path} path) failed: "
                               f"CUDA error {err}")
        backward_launches += 1
        backward_launches_by_path[path] += 1
    return dp


def mdl_backward_plain(x01: torch.Tensor, parameters: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's plain version, ``_bwd_math`` of the Pallas
    kernel over all pixels at once: x ``[..., H, W, 3]`` in [0, 1],
    parameters ``[..., H, W, 10n]``, cotangent g ``[..., H, W, 1]`` ->
    d(sum g * mdl_log_prob)/d parameters in the parameters' dtype, float32
    math (float64 for float64 parameters). With s = softmax(w) over mixtures and gw = g * s:

      d logits = g * (s - softmax(logits))
      d loc_c  = gw * dL_c                  (the autoregression is additive)
      d ls_c   = gw * dS_c * [ls_raw > -7]  (clamp mask: 0 at the tie)
      d cf_r   = gw * dL_g * x_r * (1 - tanh(cf_r)^2)
      d cf_g   = gw * dL_b * x_r * (1 - tanh(cf_g)^2)
      d cf_b   = gw * dL_b * x_g * (1 - tanh(cf_b)^2)

    with (dL_c, dS_c) from ``dl_grads_plain`` per channel. Autograd of
    ``mixture_log_prob`` differs from this only at ties (it passes half the
    gradient where a clamp is at its bound) and in rounding.
    """
    dtype = torch.promote_types(parameters.dtype, torch.float32)
    with torch.no_grad():
        p = parameters.to(dtype)
        n = p.shape[-1] // 10
        x = x01.to(dtype) * 2.0 - 1.0
        xr, xg, xb = x[..., 0:1], x[..., 1:2], x[..., 2:3]
        g = g.to(dtype)
        logits = p[..., 0:n]
        loc_r, ls_r, cf_r = p[..., n:2 * n], p[..., 2 * n:3 * n], p[..., 3 * n:4 * n]
        loc_g, ls_g, cf_g = p[..., 4 * n:5 * n], p[..., 5 * n:6 * n], p[..., 6 * n:7 * n]
        loc_b, ls_b, cf_b = p[..., 7 * n:8 * n], p[..., 8 * n:9 * n], p[..., 9 * n:10 * n]

        cf_r, cf_g, cf_b = torch.tanh(torch.cat([cf_r, cf_g, cf_b], dim=-1)).split(n, dim=-1)
        ls_raw = torch.cat([ls_r, ls_g, ls_b], dim=-1)
        ls_all = torch.clamp_min(ls_raw, -7.0)
        loc_all = torch.cat([loc_r, loc_g + cf_r * xr, loc_b + cf_g * xr + cf_b * xg], dim=-1)
        lead = loc_r.shape
        x_all = torch.cat([xr.expand(lead), xg.expand(lead), xb.expand(lead)], dim=-1)

        lp_all = discretized_logistic_log_prob(x_all, loc_all, ls_all,
                                               interval_width=_INTERVAL_WIDTH)
        lp = lp_all[..., 0:n] + lp_all[..., n:2 * n] + lp_all[..., 2 * n:3 * n]
        w = lp + (logits - torch.logsumexp(logits, dim=-1, keepdim=True))
        s = torch.softmax(w, dim=-1)
        gw = g * s
        d_logits = g * (s - torch.softmax(logits, dim=-1))

        dL_all, dS_all = dl_grads_plain(x_all, loc_all, ls_all, -1.0, 1.0,
                                        _INTERVAL_WIDTH)
        gw3 = torch.cat([gw, gw, gw], dim=-1)
        gL_r, gL_g, gL_b = (gw3 * dL_all).split(n, dim=-1)
        dS_r, dS_g, dS_b = torch.where(ls_raw > -7.0, gw3 * dS_all,
                                       p.new_zeros(())).split(n, dim=-1)
        d_cf_r = gL_g * xr * (1.0 - cf_r * cf_r)
        d_cf_g = gL_b * xr * (1.0 - cf_g * cf_g)
        d_cf_b = gL_b * xg * (1.0 - cf_b * cf_b)
        grad = torch.cat([d_logits, gL_r, dS_r, d_cf_r, gL_g, dS_g, d_cf_g,
                          gL_b, dS_b, d_cf_b], dim=-1)
        return grad.to(parameters.dtype)


def mdl_backward(x01: torch.Tensor, parameters: torch.Tensor, g: torch.Tensor,
                 path: Optional[str] = None) -> torch.Tensor:
    """d(sum g * mdl_log_prob)/d parameters: the plain version for CPU
    tensors, the backward kernel (on ``path``, see ``mdl_backward_cuda``) for
    CUDA tensors."""
    if x01.device.type == "cpu" and parameters.device.type == "cpu":
        _check_path(path)
        return mdl_backward_plain(x01, parameters, g)
    return mdl_backward_cuda(x01, parameters, g, path)


def _plain_x_grad(x01, parameters, g):
    """The images' gradient through the plain version's autograd."""
    with torch.enable_grad():
        x = x01.detach().requires_grad_(True)
        out = mixture_log_prob(x, parameters.detach().float())
        (dx,) = torch.autograd.grad(out, x, g)
    return dx


class _MDLLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, parameters, path):
        ctx.save_for_backward(x01, parameters)
        return _launch(x01, parameters, path)

    @staticmethod
    def backward(ctx, grad_out):
        x01, parameters = ctx.saved_tensors
        d_x = d_params = None
        if ctx.needs_input_grad[1]:
            d_params = mdl_backward_cuda(x01, parameters, grad_out)
        if ctx.needs_input_grad[0]:
            d_x = _plain_x_grad(x01, parameters, grad_out)
        return d_x, d_params, None


def mdl_log_prob_cuda(x01: torch.Tensor, parameters: torch.Tensor,
                      path: Optional[str] = None) -> torch.Tensor:
    """The kernel: x ``[B, H, W, 3]`` float32 in [0, 1], parameters
    ``[k, B, H, W, 10n]`` float32 or bfloat16, any strides, on one CUDA
    device -> ``[k, B, H, W, 1]`` float32. ``path`` names the memory path;
    ``None`` takes ``forward_path``'s choice, and ``"tiled"`` on parameters
    that do not fit it raises. Differentiable: the parameters' gradient
    comes from the backward kernel."""
    return _MDLLogProb.apply(x01, parameters, path)


def mdl_log_prob(x01: torch.Tensor, parameters: torch.Tensor,
                 path: Optional[str] = None) -> torch.Tensor:
    """Per-pixel MoDL log-prob ``[..., H, W, 1]``: the plain version for CPU
    tensors (whatever the path), the kernel (on ``path``, see
    ``mdl_log_prob_cuda``) for CUDA tensors."""
    if x01.device.type == "cpu" and parameters.device.type == "cpu":
        _check_path(path)
        return mixture_log_prob(x01, parameters.float())
    return mdl_log_prob_cuda(x01, parameters, path)
