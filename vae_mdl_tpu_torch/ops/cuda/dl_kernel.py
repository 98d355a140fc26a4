"""Hand-written CUDA kernels: discretized-logistic log-prob, forward and
backward.

Port of ``vae_mdl_tpu/ops/pallas/dl_kernel.py``: the Pallas ``_forward``
becomes the forward kernel of ``csrc/dl_log_prob.cu``; its ``_bwd``, the jnp
vjp that XLA fuses into one pass, becomes the backward kernel there, since
eager autograd of the plain version is some forty launches. The source's
header says what bounds them and how they are laid out.

- ``dl_log_prob(x, loc, logscale, low, high, interval_width)`` is the
  drop-in for ``distributions.discretized.discretized_logistic_log_prob``,
  the plain version: CPU tensors take it, CUDA tensors launch the forward
  kernel (``dl_log_prob_cuda``), which raises on anything it does not take.
  There is no fallback between them. The three operands broadcast; none is
  copied or expanded in memory: the kernel reads each through its own
  strides. Differentiating ``dl_log_prob_cuda`` launches the backward kernel
  for loc's and logscale's gradients (an operand that was broadcast gets its
  gradient summed back in plain PyTorch); x's gradient, which no training
  path asks for, goes through the plain version's autograd.
- ``dl_backward_plain(x, loc, logscale, g, low, high, interval_width)`` is
  the backward kernel's plain version, the analytic ``g * d/d(loc,
  logscale)`` (``dl_grads_plain``: ``_dl_grads`` of the Pallas MoDL kernel
  with the bin as arguments). It equals the jnp vjp everywhere: an edge
  bin's softplus at 0 gives 0.5 in both, and the CDF difference's floor is
  never active where the log branch is selected. ``dl_backward`` takes it
  for CPU tensors and launches the kernel (``dl_backward_cuda``) for CUDA
  tensors.
- The result of a launch is dense in the order the kernel walks, which
  follows loc's strides: for channel slices of an NCHW head it has NCHW
  strides under its ``[..., H, W, C]`` shape.
- ``launches`` and ``backward_launches`` count the two kernels' launches;
  callers reset them to 0 and read them to show that a run went through the
  kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from vae_mdl_tpu_torch.distributions.continuous import softplus
from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.ops.cuda.build import CSRC, build

SOURCE = CSRC / "dl_log_prob.cu"
MAX_DIMS = 6

# kernel launches since the counter was last set to 0: forward, backward
launches = 0
backward_launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = ctypes.POINTER(ctypes.c_int64)
    lib.dl_log_prob_forward.argtypes = [ptr] * 4 + [i32] + [dims] * 4 + [f32] * 4 + [ptr]
    lib.dl_log_prob_forward.restype = i32
    lib.dl_log_prob_backward.argtypes = [ptr] * 6 + [i32] + [dims] * 5 + [f32] * 4 + [ptr]
    lib.dl_log_prob_backward.restype = i32
    return lib


def kernel_layout(shape: Sequence[int], strides: Sequence[Sequence[int]]
                  ) -> Tuple[List[int], List[int], List[List[int]]]:
    """The dimensions as the kernels walk them.

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


def _plan(loc, others):
    """Broadcast the operands (views, no copy) and lay them out for the
    kernels: ``(shape, order, ndim, dims, stride arrays)`` with the strides
    as ctypes int64 arrays, loc's first."""
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


def _launch(x, loc, logscale, low, high, interval_width) -> torch.Tensor:
    global launches
    _check(x, loc, logscale)
    shape, order, ndim, dims, (loc_s, x_s, ls_s) = _plan(loc, (x, logscale))
    out = _dense_like(shape, order, loc.device)
    if out.numel():
        with torch.cuda.device(loc.device):
            err = _library().dl_log_prob_forward(
                x.data_ptr(), loc.data_ptr(), logscale.data_ptr(), out.data_ptr(),
                ndim, dims, x_s, loc_s, ls_s, *_bin_args(low, high, interval_width),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dl_log_prob kernel launch failed: CUDA error {err}")
        launches += 1
    return out


def dl_backward_cuda(x, loc, logscale, g, low: float = -1.0, high: float = 1.0,
                     interval_width: float = 2.0 / 255.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: ``(g * d/d loc, g * d/d logscale)`` of
    ``dl_log_prob`` at every element of the operands' broadcast shape, which
    is ``g``'s shape (any strides: an expanded cotangent is read in place).
    Float32 CUDA tensors; the results are dense in the kernel's order."""
    global backward_launches
    _check(x, loc, logscale, g)
    shape, order, ndim, dims, (loc_s, x_s, ls_s, g_s) = _plan(loc, (x, logscale, g))
    if tuple(g.shape) != tuple(shape):
        raise ValueError(f"g must have the operands' broadcast shape {tuple(shape)}; "
                         f"got {tuple(g.shape)}")
    d_loc = _dense_like(shape, order, loc.device)
    d_ls = _dense_like(shape, order, loc.device)
    if d_loc.numel():
        with torch.cuda.device(loc.device):
            err = _library().dl_log_prob_backward(
                x.data_ptr(), loc.data_ptr(), logscale.data_ptr(), g.data_ptr(),
                d_loc.data_ptr(), d_ls.data_ptr(), ndim, dims, x_s, loc_s, ls_s, g_s,
                *_bin_args(low, high, interval_width),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dl_log_prob backward kernel launch failed: CUDA error {err}")
        backward_launches += 1
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


def dl_backward(x, loc, logscale, g, low: float = -1.0, high: float = 1.0,
                interval_width: float = 2.0 / 255.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(g * d/d loc, g * d/d logscale)``: the plain version for CPU
    tensors, the backward kernel for CUDA tensors."""
    if _all_cpu(x, loc, logscale, g):
        return dl_backward_plain(x, loc, logscale, g, low, high, interval_width)
    return dl_backward_cuda(x, loc, logscale, g, low, high, interval_width)


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
    def forward(ctx, x, loc, logscale, low, high, interval_width):
        ctx.save_for_backward(x, loc, logscale)
        ctx.bin = (low, high, interval_width)
        return _launch(x, loc, logscale, low, high, interval_width)

    @staticmethod
    def backward(ctx, grad_out):
        x, loc, logscale = ctx.saved_tensors
        d_x = d_loc = d_ls = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_loc, d_ls = dl_backward_cuda(x, loc, logscale, grad_out, *ctx.bin)
            # an operand that was broadcast: its gradient summed back
            d_loc = d_loc.sum_to_size(loc.shape) if ctx.needs_input_grad[1] else None
            d_ls = d_ls.sum_to_size(logscale.shape) if ctx.needs_input_grad[2] else None
        if ctx.needs_input_grad[0]:
            d_x = _plain_x_grad(x, loc, logscale, grad_out, *ctx.bin)
        return d_x, d_loc, d_ls, None, None, None


def dl_log_prob_cuda(x, loc, logscale, low: float = -1.0, high: float = 1.0,
                     interval_width: float = 2.0 / 255.0) -> torch.Tensor:
    """The kernel: float32 CUDA tensors that broadcast, any non-negative
    strides -> float32 log P(bin(x)) of the broadcast shape. Differentiable:
    loc's and logscale's gradients come from the backward kernel."""
    return _DLLogProb.apply(x, loc, logscale, low, high, interval_width)


def dl_log_prob(x, loc, logscale, low: float = -1.0, high: float = 1.0,
                interval_width: float = 2.0 / 255.0) -> torch.Tensor:
    """Elementwise discretized-logistic log P(bin(x)): the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if _all_cpu(x, loc, logscale):
        return discretized_logistic_log_prob(x, loc, logscale, low=low, high=high,
                                             interval_width=interval_width)
    return dl_log_prob_cuda(x, loc, logscale, low, high, interval_width)
