"""Hand-written CUDA kernels: discretized-logistic log-prob, forward and
backward.

Port of ``vae_mdl_tpu/ops/pallas/dl_kernel.py``: the Pallas ``_forward``
becomes the forward kernel of ``csrc/dl_log_prob.cu``; its ``_bwd``, the jnp
vjp that XLA fuses into one pass, becomes the backward kernel there, since
eager autograd of the plain version is some forty launches. The source's
header says what bounds them and how they are laid out.

Each direction has two memory paths, chosen by ``forward_path`` and
``backward_path`` from the operands' shapes, strides, dtypes and addresses
alone. ``"tiled"``: loc and logscale are the two channel halves of one dense
channel-minor float32 head ``[K, B, H, W, 6]`` on a 16-byte aligned address
(what ``nn.decoders.make_observation("dl")`` makes of the channels-last head
conv's output) and x ``[B, H, W, 3]`` is broadcast over K; persistent blocks
bring tiles of the head's rows into shared memory by bulk asynchronous
copies (``csrc/mdl_tile.cuh``, the MoDL kernels' walk). ``"direct"``: any
other operands (contiguous ones, NCHW halves, a sliced or misaligned head, a
logscale that went through ``tanh``, x not broadcast over K, other ranks),
one thread an element through each operand's strides. The choice goes to the
C entry point, and asking for ``"tiled"`` on operands that do not fit raises:
nothing tries one path after the other. Both paths run the same device
functions, so they give the same bits.

- ``dl_log_prob(x, loc, logscale, low, high, interval_width)`` is the
  drop-in for ``distributions.discretized.discretized_logistic_log_prob``,
  the plain version: CPU tensors take it, CUDA tensors launch the forward
  kernel (``dl_log_prob_cuda``), which raises on anything it does not take.
  There is no fallback between them. The three operands broadcast; none is
  copied or expanded in memory. Differentiating ``dl_log_prob_cuda``
  launches the backward kernel for loc's and logscale's gradients (an
  operand that was broadcast gets its gradient summed back in plain
  PyTorch); x's gradient, which no training path asks for, goes through the
  plain version's autograd.
- ``dl_log_prob_head(x, head, low, high, interval_width)`` is the same
  log-prob with loc and logscale the two halves of ``head``'s last axis, as
  ``DiscretizedLogistic`` evaluates it when ``make_observation`` hands it
  the head: differentiating it gives the head's gradient in one tensor,
  written by the backward kernel on the tile path, where autograd of the two
  halves would join two gradients with a ``cat`` after the kernel.
- ``dl_backward_plain(x, loc, logscale, g, low, high, interval_width)`` is
  the backward kernel's plain version, the analytic ``g * d/d(loc,
  logscale)`` (``dl_grads_plain``: ``_dl_grads`` of the Pallas MoDL kernel
  with the bin as arguments). It equals the jnp vjp everywhere: an edge
  bin's softplus at 0 gives 0.5 in both, and the CDF difference's floor is
  never active where the log branch is selected. ``dl_backward`` takes it
  for CPU tensors and launches the kernel (``dl_backward_cuda``) for CUDA
  tensors.
- The result of a forward launch is dense: on the tile path contiguous
  ``[K, B, H, W, 3]``; on the direct path in the order the kernel walks,
  which follows loc's strides (contiguous for the halves of a channels-last
  head, NCHW strides under the ``[..., H, W, C]`` shape for the halves of an
  NCHW one). The backward's tile path writes the head's gradient ``[K, B, H,
  W, 6]``, contiguous, and hands loc's and logscale's as its halves.
- ``launches`` and ``backward_launches`` count the two kernels' launches,
  ``launches_by_path`` and ``backward_launches_by_path`` the same by memory
  path; callers reset them to 0 and read them to show that a run went
  through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vae_mdl_tpu_torch.distributions.continuous import softplus
from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.ops.cuda.build import CSRC, build

SOURCE = CSRC / "dl_log_prob.cu"
MAX_DIMS = 6
PATHS = ("tiled", "direct")
CHANNELS = 3  # the tile path's loc and logscale channels: halves of a 6-channel row
TILE_THREADS = 128  # csrc/mdl_tile.cuh kTilePixels: threads a block

# kernel launches since the counter was last set to 0: forward, backward, and
# each by memory path
launches = 0
backward_launches = 0
launches_by_path: Dict[str, int] = dict.fromkeys(PATHS, 0)
backward_launches_by_path: Dict[str, int] = dict.fromkeys(PATHS, 0)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    dims = ctypes.POINTER(ctypes.c_int64)
    lib.dl_log_prob_forward.argtypes = [ptr] * 4 + [i32] + [dims] * 4 + [f32] * 4 + [ptr]
    lib.dl_log_prob_forward.restype = i32
    lib.dl_log_prob_backward.argtypes = [ptr] * 6 + [i32] + [dims] * 5 + [f32] * 4 + [ptr]
    lib.dl_log_prob_backward.restype = i32
    lib.dl_log_prob_forward_tiled.argtypes = [ptr] * 4 + [i64] * 19 + [f32] * 4 + [ptr]
    lib.dl_log_prob_forward_tiled.restype = i32
    lib.dl_log_prob_backward_tiled.argtypes = [ptr] * 5 + [i64] * 24 + [f32] * 4 + [ptr]
    lib.dl_log_prob_backward_tiled.restype = i32
    lib.dl_log_prob_tile_blocks_per_sm.argtypes = [i32]
    lib.dl_log_prob_tile_blocks_per_sm.restype = i32
    return lib


def kernel_layout(shape: Sequence[int], strides: Sequence[Sequence[int]]
                  ) -> Tuple[List[int], List[int], List[List[int]]]:
    """The dimensions as the direct kernels walk them.

    ``shape`` is the broadcast shape and ``strides`` each operand's element
    strides over it (0 where it broadcasts), the first operand's deciding
    the order. Returns ``(order, merged_shape, merged_strides)``: ``order``
    lists the dimensions of more than one element by the first operand's
    stride, largest first, so the last is the one neighbouring threads
    walk; neighbours in that order which every operand steps through as one
    run are merged. An output dense over ``shape`` permuted by ``order`` is
    addressed by a thread's linear index.
    """
    order = [d for d in range(len(shape)) if shape[d] != 1]
    order.sort(key=lambda d: -strides[0][d])  # stable: ties keep their order
    merged_shape: List[int] = []
    merged: List[List[int]] = [[] for _ in strides]
    for d in order:
        if merged_shape and all(m[-1] == st[d] * shape[d] for m, st in zip(merged, strides)):
            # the dimension before steps over exactly this one's run
            merged_shape[-1] *= shape[d]
            for m, st in zip(merged, strides):
                m[-1] = st[d]
        else:
            merged_shape.append(shape[d])
            for m, st in zip(merged, strides):
                m.append(st[d])
    if not merged_shape:  # one element
        merged_shape, merged = [1], [[0] for _ in strides]
    return order, merged_shape, merged


def _check(x, loc, logscale, *more) -> None:
    tensors = (x, loc, logscale) + more
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the discretized-logistic kernel takes CUDA tensors only; got "
                         + ", ".join(str(t.device) for t in tensors))
    if any(t.device != loc.device for t in tensors):
        raise ValueError("operands on different devices: "
                         + ", ".join(str(t.device) for t in tensors))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the discretized-logistic kernel takes float32 only; got "
                        + ", ".join(str(t.dtype) for t in tensors))


def _check_path(path: Optional[str]) -> None:
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None; got {path!r}")


# -- the choice of memory path -----------------------------------------------------


def _dense_rows(shape, strides, row: int) -> bool:
    """Whether ``strides`` walk ``[K, B, H, W, C]`` as the first C channels of
    dense rows of ``row`` elements (a dimension of one element may have any
    stride, as ``mdlt::channel_minor_dense`` allows)."""
    _, b, h, w, _ = shape
    dense = (b * h * w * row, h * w * row, w * row, row, 1)
    return tuple(strides) == dense or all(n == 1 or s == d
                                          for n, s, d in zip(shape, strides, dense))


def _head_halves(loc: torch.Tensor, logscale: torch.Tensor) -> bool:
    """Whether loc and logscale are the two channel halves of one dense,
    channel-minor float32 ``[K, B, H, W, 6]`` tensor on a 16-byte aligned
    address: ``[K, B, H, W, 3]`` views with its strides, logscale three
    floats after loc."""
    shape = loc.shape
    if (len(shape) != 5 or shape[-1] != CHANNELS or logscale.shape != shape
            or loc.dtype != torch.float32 or logscale.dtype != torch.float32
            or loc.numel() == 0):
        return False
    base = loc.data_ptr()
    return (base % 16 == 0 and logscale.data_ptr() == base + 4 * CHANNELS
            and _dense_rows(shape, loc.stride(), 2 * CHANNELS)
            and _dense_rows(shape, logscale.stride(), 2 * CHANNELS)
            and loc.device == logscale.device
            and loc.untyped_storage().data_ptr() == logscale.untyped_storage().data_ptr())


def _x_strides(x: torch.Tensor, shape) -> Optional[Tuple[int, ...]]:
    """x's element strides broadcast to ``shape`` (0 where it broadcasts), or
    None where it does not broadcast to it: ``x.expand(shape).stride()``
    without making a view, which a launch would pay for in host time."""
    lead = len(shape) - x.dim()
    if lead < 0:
        return None
    strides = [0] * lead
    for n, s, want in zip(x.shape, x.stride(), shape[lead:]):
        if n == want:
            strides.append(s if n != 1 else 0)
        elif n == 1:
            strides.append(0)
        else:
            return None
    return tuple(strides)


def _tile_fit(x: torch.Tensor, loc: torch.Tensor,
              logscale: torch.Tensor) -> Optional[Tuple[int, ...]]:
    """x's strides over loc's shape where the tile path takes these operands
    (``forward_path``), else None."""
    if not (_head_halves(loc, logscale) and x.dtype == torch.float32
            and x.device == loc.device):
        return None
    xs = _x_strides(x, loc.shape)
    return xs if xs is not None and (loc.shape[0] == 1 or xs[0] == 0) else None


def forward_path(x: torch.Tensor, loc: torch.Tensor, logscale: torch.Tensor) -> str:
    """The memory path the forward kernel takes for these operands, from
    their shapes, strides, dtypes and addresses alone: ``"tiled"`` where loc
    and logscale are the two channel halves of one dense channel-minor
    float32 ``[K, B, H, W, 6]`` head on a 16-byte aligned address and x, a
    float32 tensor on their device, broadcasts to ``[K, B, H, W, 3]`` with
    stride 0 over K (or K = 1); ``"direct"`` for anything else and for empty
    operands, which launch nothing."""
    return "direct" if _tile_fit(x, loc, logscale) is None else "tiled"


def backward_path(x: torch.Tensor, loc: torch.Tensor, logscale: torch.Tensor,
                  g: torch.Tensor) -> str:
    """The memory path the backward kernel takes: the forward's, where the
    cotangent ``g`` is a float32 tensor of loc's shape on its device (any
    strides: the event sum's expansion is read in place); ``"direct"`` for
    anything else."""
    return "direct" if _backward_fit(x, loc, logscale, g) is None else "tiled"


def _backward_fit(x, loc, logscale, g) -> Optional[Tuple[int, ...]]:
    """``_tile_fit`` for the backward: x's strides where the tile path takes
    these operands and this cotangent, else None."""
    fits = g.dtype == torch.float32 and g.device == loc.device and g.shape == loc.shape
    return _tile_fit(x, loc, logscale) if fits else None


def _choose(path: Optional[str], fit) -> Tuple[bool, Optional[Tuple[int, ...]]]:
    """Whether a launch on ``path`` takes the tile path, and x's strides for
    it: ``fit()`` (``_tile_fit`` or ``_backward_fit`` of the operands) is
    asked unless the path is ``"direct"``; ``None`` takes the tile path
    where they fit, ``"tiled"`` takes it whatever they are (and the entry
    point refuses what does not fit)."""
    xs = fit() if path != "direct" else None
    return path == "tiled" or (path is None and xs is not None), xs


def tile_blocks_per_sm(backward: bool = False) -> int:
    """Blocks an SM of the current CUDA device holds of the forward's (or,
    with ``backward``, the backward's) tile path, as the occupancy query
    sizes its persistent grid."""
    return _library().dl_log_prob_tile_blocks_per_sm(int(backward))


# -- launches ----------------------------------------------------------------------


def _stream_call(device: torch.device, call):
    """``call(stream)`` with the current stream of ``device``, made the
    current device only where it is not already."""
    if device.index == torch.cuda.current_device():
        return call(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return call(torch.cuda.current_stream().cuda_stream)


def _tile_shape(x, loc, logscale) -> Tuple[int, ...]:
    """The tile entry points' x strides over loc's shape; raises where the
    operands cannot even be described to them (the entry point refuses the
    rest)."""
    if loc.dim() != 5 or loc.shape[-1] != CHANNELS or loc.shape != logscale.shape:
        raise ValueError(f"the tile path takes loc and logscale [K, B, H, W, {CHANNELS}]; "
                         f"got {tuple(loc.shape)} and {tuple(logscale.shape)}")
    xs = _x_strides(x, loc.shape)
    if xs is None:
        raise ValueError(f"x {tuple(x.shape)} does not broadcast to {tuple(loc.shape)}")
    return xs


def _forward_tiled(x, loc, logscale, bin_args, xs=None) -> torch.Tensor:
    global launches
    xs = xs or _tile_shape(x, loc, logscale)
    k, b, h, w, c = loc.shape
    out = torch.empty((k, b, h, w, c), device=loc.device, dtype=torch.float32)
    if out.numel():
        err = _stream_call(loc.device, lambda stream: _library().dl_log_prob_forward_tiled(
            x.data_ptr(), loc.data_ptr(), logscale.data_ptr(), out.data_ptr(), k, b, h, w,
            *xs, *loc.stride(), *logscale.stride(), *bin_args, stream))
        if err:
            raise RuntimeError(f"dl_log_prob kernel launch (tiled path) failed: CUDA error {err}")
        launches += 1
        launches_by_path["tiled"] += 1
    return out


def _backward_tiled(x, loc, logscale, g, bin_args, xs=None) -> torch.Tensor:
    """The backward's tile path: the gradient of the head loc and logscale
    are the halves of, ``[K, B, H, W, 6]``, contiguous."""
    global backward_launches
    xs = xs or _tile_shape(x, loc, logscale)
    if tuple(g.shape) != tuple(loc.shape):
        raise ValueError(f"g must have loc's shape {tuple(loc.shape)}; got {tuple(g.shape)}")
    k, b, h, w, c = loc.shape
    d_head = torch.empty((k, b, h, w, 2 * c), device=loc.device, dtype=torch.float32)
    if d_head.numel():
        err = _stream_call(loc.device, lambda stream: _library().dl_log_prob_backward_tiled(
            x.data_ptr(), loc.data_ptr(), logscale.data_ptr(), g.data_ptr(), d_head.data_ptr(),
            k, b, h, w, *xs, *loc.stride(), *logscale.stride(), *g.stride(), *bin_args,
            stream))
        if err:
            raise RuntimeError(f"dl_log_prob backward kernel launch (tiled path) failed: "
                               f"CUDA error {err}")
        backward_launches += 1
        backward_launches_by_path["tiled"] += 1
    return d_head


def _plan(loc, others):
    """Broadcast the operands (views, no copy) and lay them out for the
    direct kernels: ``(shape, order, ndim, dims, stride arrays)`` with the
    strides as ctypes int64 arrays, loc's first."""
    shape = torch.broadcast_shapes(loc.shape, *(t.shape for t in others))
    views = [t.expand(shape) for t in (loc, *others)]
    strides = [v.stride() for v in views]
    if any(s < 0 for st in strides for s in st):
        raise ValueError("the discretized-logistic kernel takes no negative strides")
    order, merged_shape, merged = kernel_layout(shape, strides)
    if len(merged_shape) > MAX_DIMS:
        raise ValueError(f"operands of {len(merged_shape)} unmergeable dimensions; the "
                         f"kernel takes at most {MAX_DIMS}")
    array = ctypes.c_int64 * len(merged_shape)
    return shape, order, len(merged_shape), array(*merged_shape), [array(*m) for m in merged]


def _dense_like(shape, order, device) -> torch.Tensor:
    """An uninitialised float32 tensor of ``shape`` that is dense in the
    kernels' order: dimensions ``order`` outermost to innermost (those of
    one element anywhere)."""
    walk = [d for d in range(len(shape)) if d not in order] + list(order)
    out = torch.empty([shape[d] for d in walk], device=device, dtype=torch.float32)
    inverse = [0] * len(walk)
    for position, d in enumerate(walk):
        inverse[d] = position
    return out.permute(inverse)


def _bin_args(low: float, high: float, interval_width: float) -> Tuple[float, float, float, float]:
    """The bin as the kernel takes it; ctypes rounds each to float32, as the
    plain version's Python constants are rounded where they meet a tensor."""
    return float(low), float(high), interval_width / 2.0, math.log(interval_width)


def _launch(x, loc, logscale, low, high, interval_width, path=None) -> torch.Tensor:
    global launches
    _check_path(path)
    _check(x, loc, logscale)
    bin_args = _bin_args(low, high, interval_width)
    tiled, xs = _choose(path, lambda: _tile_fit(x, loc, logscale))
    if tiled:
        return _forward_tiled(x, loc, logscale, bin_args, xs)
    shape, order, ndim, dims, (loc_s, x_s, ls_s) = _plan(loc, (x, logscale))
    out = _dense_like(shape, order, loc.device)
    if out.numel():
        err = _stream_call(loc.device, lambda stream: _library().dl_log_prob_forward(
            x.data_ptr(), loc.data_ptr(), logscale.data_ptr(), out.data_ptr(),
            ndim, dims, x_s, loc_s, ls_s, *bin_args, stream))
        if err:
            raise RuntimeError(f"dl_log_prob kernel launch (direct path) failed: CUDA error {err}")
        launches += 1
        launches_by_path["direct"] += 1
    return out


def dl_backward_cuda(x, loc, logscale, g, low: float = -1.0, high: float = 1.0,
                     interval_width: float = 2.0 / 255.0, path: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: ``(g * d/d loc, g * d/d logscale)`` of
    ``dl_log_prob`` at every element of the operands' broadcast shape, which
    is ``g``'s shape (any strides: an expanded cotangent is read in place).
    Float32 CUDA tensors. ``path`` names the memory path; ``None`` takes
    ``backward_path``'s choice, and ``"tiled"`` on operands that do not fit
    it raises. On the tile path the two results are the halves of one
    contiguous ``[K, B, H, W, 6]`` gradient; on the direct path each is
    dense in the kernel's order."""
    global backward_launches
    _check_path(path)
    _check(x, loc, logscale, g)
    bin_args = _bin_args(low, high, interval_width)
    tiled, xs = _choose(path, lambda: _backward_fit(x, loc, logscale, g))
    if tiled:
        return _backward_tiled(x, loc, logscale, g, bin_args, xs).chunk(2, dim=-1)
    shape, order, ndim, dims, (loc_s, x_s, ls_s, g_s) = _plan(loc, (x, logscale, g))
    if tuple(g.shape) != tuple(shape):
        raise ValueError(f"g must have the operands' broadcast shape {tuple(shape)}; "
                         f"got {tuple(g.shape)}")
    d_loc = _dense_like(shape, order, loc.device)
    d_ls = _dense_like(shape, order, loc.device)
    if d_loc.numel():
        err = _stream_call(loc.device, lambda stream: _library().dl_log_prob_backward(
            x.data_ptr(), loc.data_ptr(), logscale.data_ptr(), g.data_ptr(),
            d_loc.data_ptr(), d_ls.data_ptr(), ndim, dims, x_s, loc_s, ls_s, g_s,
            *bin_args, stream))
        if err:
            raise RuntimeError(f"dl_log_prob backward kernel launch (direct path) failed: "
                               f"CUDA error {err}")
        backward_launches += 1
        backward_launches_by_path["direct"] += 1
    return d_loc, d_ls


def dl_grads_plain(x, loc, logscale, low: float = -1.0, high: float = 1.0,
                   interval_width: float = 2.0 / 255.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """d(discretized_logistic_log_prob)/d(loc, logscale), elementwise over
    the broadcast shape: ``_dl_grads`` of the Pallas MoDL kernel with the
    bin as arguments. The CDF difference's floor passes no gradient
    (``live``); the edge conditions compare x only."""
    half = interval_width / 2.0
    inv_std = torch.exp(-logscale)
    centered = x - loc
    start = (centered - half) * inv_std
    stop = (centered + half) * inv_std
    sg_stop = torch.sigmoid(stop)
    sg_start = torch.sigmoid(start)
    diff = sg_stop - sg_start
    prob = torch.clamp_min(diff, 1e-12)
    live = diff > 1e-12
    zero = diff.new_zeros(())
    ds = torch.where(live, sg_stop * (1.0 - sg_stop) / prob, zero)
    da = torch.where(live, sg_start * (1.0 - sg_start) / prob, zero)
    d_loc = inv_std * (da - ds)
    d_ls = da * start - ds * stop

    a = centered * inv_std
    c_ap = 2.0 * torch.sigmoid(-a) - 1.0
    use_log = prob > 1e-5
    d_loc = torch.where(use_log, d_loc, -c_ap * inv_std)
    d_ls = torch.where(use_log, d_ls, -c_ap * a - 1.0)

    left = x <= low
    le = torch.sigmoid(-stop)
    d_loc = torch.where(left, -le * inv_std, d_loc)
    d_ls = torch.where(left, -le * stop, d_ls)

    right = x >= high
    d_loc = torch.where(right, sg_start * inv_std, d_loc)
    d_ls = torch.where(right, sg_start * start, d_ls)
    return d_loc, d_ls


def dl_value_and_grads_plain(x, loc, logscale, low: float = -1.0, high: float = 1.0,
                             interval_width: float = 2.0 / 255.0
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(log_prob, d/d loc, d/d logscale)`` in one sweep: the plain version
    of ``csrc/dl_cascade.cuh``'s ``dl_value_and_grads``, which the MoDL
    backward's tile path evaluates once a cascade. The value and the
    derivatives come from the sub-expressions they share (inv_std, start,
    stop, the two sigmoids, prob, a), each product and sum in the order
    ``discretized_logistic_log_prob`` and ``dl_grads_plain`` take it, so the
    three results equal theirs exactly."""
    half = interval_width / 2.0
    centered = x - loc
    inv_std = torch.exp(-logscale)
    start = (centered - half) * inv_std
    stop = (centered + half) * inv_std
    sg_stop = torch.sigmoid(stop)
    sg_start = torch.sigmoid(start)
    prob = torch.clamp_min(sg_stop - sg_start, 1e-12)

    # the CDF-difference branch, and below 1e-5 the PDF * bin width
    ds = sg_stop * (1.0 - sg_stop) / prob
    da = sg_start * (1.0 - sg_start) / prob
    a = centered * inv_std
    c_ap = 2.0 * torch.sigmoid(-a) - 1.0
    use_log = prob > 1e-5
    lp = torch.where(use_log, torch.log(prob),
                     -a - logscale - 2.0 * softplus(-a) + math.log(interval_width))
    d_loc = torch.where(use_log, inv_std * (da - ds), -c_ap * inv_std)
    d_ls = torch.where(use_log, da * start - ds * stop, -c_ap * a - 1.0)

    left = x <= low
    le = torch.sigmoid(-stop)
    lp = torch.where(left, stop - softplus(stop), lp)
    d_loc = torch.where(left, -le * inv_std, d_loc)
    d_ls = torch.where(left, -le * stop, d_ls)

    right = x >= high
    lp = torch.where(right, -softplus(start), lp)
    d_loc = torch.where(right, sg_start * inv_std, d_loc)
    d_ls = torch.where(right, sg_start * start, d_ls)
    return lp, d_loc, d_ls


def dl_backward_plain(x, loc, logscale, g, low: float = -1.0, high: float = 1.0,
                      interval_width: float = 2.0 / 255.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's plain version: ``(g * d/d loc, g * d/d
    logscale)`` at the broadcast shape, in the operands' dtype."""
    with torch.no_grad():
        d_loc, d_ls = dl_grads_plain(x, loc, logscale, low, high, interval_width)
        return g * d_loc, g * d_ls


def _all_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _differentiated(*tensors) -> bool:
    """Whether autograd records a call on these operands; where it does not
    (inference, the evaluator), the wrappers launch without an autograd
    Function around the kernel, which saves its host time."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def dl_backward(x, loc, logscale, g, low: float = -1.0, high: float = 1.0,
                interval_width: float = 2.0 / 255.0, path: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(g * d/d loc, g * d/d logscale)``: the plain version for CPU
    tensors (whatever the path), the backward kernel (on ``path``, see
    ``dl_backward_cuda``) for CUDA tensors."""
    if _all_cpu(x, loc, logscale, g):
        _check_path(path)
        return dl_backward_plain(x, loc, logscale, g, low, high, interval_width)
    return dl_backward_cuda(x, loc, logscale, g, low, high, interval_width, path)


def _plain_x_grad(x, loc, logscale, g, low, high, interval_width):
    """x's gradient through the plain version's autograd."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        out = discretized_logistic_log_prob(leaf, loc.detach(), logscale.detach(), low=low,
                                            high=high, interval_width=interval_width)
        (dx,) = torch.autograd.grad(out, leaf, g)
    return dx


class _DLLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, loc, logscale, low, high, interval_width, path):
        ctx.save_for_backward(x, loc, logscale)
        ctx.bin = (low, high, interval_width)
        ctx.path = path
        return _launch(x, loc, logscale, low, high, interval_width, path)

    @staticmethod
    def backward(ctx, grad_out):
        x, loc, logscale = ctx.saved_tensors
        d_x = d_loc = d_ls = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_loc, d_ls = dl_backward_cuda(x, loc, logscale, grad_out, *ctx.bin, ctx.path)
            # an operand that was broadcast: its gradient summed back
            d_loc = d_loc.sum_to_size(loc.shape) if ctx.needs_input_grad[1] else None
            d_ls = d_ls.sum_to_size(logscale.shape) if ctx.needs_input_grad[2] else None
        if ctx.needs_input_grad[0]:
            d_x = _plain_x_grad(x, loc, logscale, grad_out, *ctx.bin)
        return d_x, d_loc, d_ls, None, None, None, None


def dl_log_prob_cuda(x, loc, logscale, low: float = -1.0, high: float = 1.0,
                     interval_width: float = 2.0 / 255.0,
                     path: Optional[str] = None) -> torch.Tensor:
    """The kernel: float32 CUDA tensors that broadcast, any non-negative
    strides -> float32 log P(bin(x)) of the broadcast shape. ``path`` names
    the memory path of the forward and the backward; ``None`` takes
    ``forward_path``'s and ``backward_path``'s choice, and ``"tiled"`` on
    operands that do not fit it raises. Differentiable: loc's and logscale's
    gradients come from the backward kernel."""
    if _differentiated(x, loc, logscale):
        return _DLLogProb.apply(x, loc, logscale, low, high, interval_width, path)
    return _launch(x, loc, logscale, low, high, interval_width, path)


def dl_log_prob(x, loc, logscale, low: float = -1.0, high: float = 1.0,
                interval_width: float = 2.0 / 255.0, path: Optional[str] = None) -> torch.Tensor:
    """Elementwise discretized-logistic log P(bin(x)): the plain version for
    CPU tensors (whatever the path), the kernel (on ``path``, see
    ``dl_log_prob_cuda``) for CUDA tensors."""
    if _all_cpu(x, loc, logscale):
        _check_path(path)
        return discretized_logistic_log_prob(x, loc, logscale, low=low, high=high,
                                             interval_width=interval_width)
    return dl_log_prob_cuda(x, loc, logscale, low, high, interval_width, path)


# -- the head as one operand ---------------------------------------------------------


def _halves(head: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if head.dim() < 1 or head.shape[-1] % 2:
        raise ValueError(f"the head needs an even number of channels; got {tuple(head.shape)}")
    loc, logscale = torch.chunk(head, 2, dim=-1)
    return loc, logscale


def _head_grad(x, head, g, bin_, path) -> torch.Tensor:
    """The head's gradient: on the tile path the backward kernel's own
    output; on the direct path loc's and logscale's, summed back to their
    shape where they were broadcast, and joined."""
    loc, logscale = _halves(head)
    _check_path(path)
    _check(x, loc, logscale, g)
    tiled, xs = _choose(path, lambda: _backward_fit(x, loc, logscale, g))
    if tiled:
        return _backward_tiled(x, loc, logscale, g, _bin_args(*bin_), xs)
    d_loc, d_ls = dl_backward_cuda(x, loc, logscale, g, *bin_, "direct")
    return torch.cat([d_loc.sum_to_size(loc.shape), d_ls.sum_to_size(logscale.shape)], dim=-1)


class _DLLogProbHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head, low, high, interval_width, path):
        ctx.save_for_backward(x, head)
        ctx.bin = (low, high, interval_width)
        ctx.path = path
        return _launch(x, *_halves(head), low, high, interval_width, path)

    @staticmethod
    def backward(ctx, grad_out):
        x, head = ctx.saved_tensors
        d_x = d_head = None
        if ctx.needs_input_grad[1]:
            d_head = _head_grad(x, head, grad_out, ctx.bin, ctx.path)
        if ctx.needs_input_grad[0]:
            d_x = _plain_x_grad(x, *_halves(head), grad_out, *ctx.bin)
        return d_x, d_head, None, None, None, None


def dl_log_prob_head(x, head, low: float = -1.0, high: float = 1.0,
                     interval_width: float = 2.0 / 255.0,
                     path: Optional[str] = None) -> torch.Tensor:
    """``dl_log_prob(x, loc, logscale)`` with loc and logscale the two halves
    of ``head``'s last axis (``torch.chunk(head, 2, dim=-1)``): the plain
    version for CPU tensors (whatever the path); for CUDA tensors the kernels
    (on ``path``, as ``dl_log_prob_cuda`` takes it), differentiable with
    ``head`` as the operand, so that its gradient is one tensor: the backward
    kernel's output on the tile path, loc's and logscale's joined on the
    direct path."""
    if _all_cpu(x, head):
        _check_path(path)
        return discretized_logistic_log_prob(x, *_halves(head), low=low, high=high,
                                             interval_width=interval_width)
    if _differentiated(x, head):
        return _DLLogProbHead.apply(x, head, low, high, interval_width, path)
    return _launch(x, *_halves(head), low, high, interval_width, path)
