"""Hand-written CUDA kernels: the ladder residual block's pointwise epilogues,
forward and backward.

They replace no kernel of the JAX package, which leaves a conv's bias and
activation, the rezero gate and the residual sum to XLA, and XLA fuses them
into the conv's epilogue; ``csrc/block_epilogue.cu``'s header says why they
were added, what bounds them and how they are laid out. For ``c``, a conv's
output computed without its bias, ``[N, C, H, W]`` dense channels-last at
float32 or bfloat16, and that conv's float32 bias ``b``:

- an inner conv of a block: ``act(c + b)``;
- its last conv: ``(s + sb) + g * act(c + b)``, ``s`` the block's input or
  its shortcut conv's output without bias (``c``'s shape, dtype and layout),
  ``sb`` the shortcut's float32 bias (none: 0), ``g`` the float32 rezero
  gate (none: 1);

in float32, rounded once to ``c``'s dtype, ``act`` the tanh or the exact
gelu (``ACTIVATIONS``).

- ``block_epilogue(c, bias, activation, residual=None, residual_bias=None,
  gate=None)``: the differentiable epilogue. Autograd saves ``c``, the bias
  and the gate alone; the backward recomputes ``act(c + b)`` and gives
  ``c``'s gradient, float32 sums over the pixels for the bias, the
  shortcut bias and the gate, and the residual's gradient, which is the
  output's gradient itself.
- ``epilogue_plain`` and ``epilogue_backward_plain``: the plain versions;
  ``epilogue_cuda`` and ``epilogue_backward_cuda``: the kernels, which
  raise on anything they do not take; ``epilogue`` and
  ``epilogue_backward``: the plain version for CPU tensors, the kernel for
  CUDA tensors, with no fallback between them.

``launches`` counts the forward kernel's launches, ``backward_launches`` the
backward's, two a call (the pass, then the sum of its blocks' partial sums).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vae_mdl_tpu_torch.ops.cuda.build import CSRC, build

SOURCE = CSRC / "block_epilogue.cu"
ACTIVATIONS = ("gelu_tanh", "gelu")  # the C entry points' numbering
DTYPES = (torch.float32, torch.bfloat16)  # the same
# channels a thread moves (16 bytes)
_VECTOR = {torch.float32: 4, torch.bfloat16: 8}
# threads a block (the most vectors a pixel's row may hold) and the blocks an
# SM holds at once: csrc/block_epilogue.cu's kThreads and kBlocksPerSm
_THREADS = 256
BLOCKS_PER_SM = 4

# kernel launches since the counters were last set to 0
launches = 0
backward_launches = 0

Grads = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.block_epilogue_forward.argtypes = [ptr] * 6 + [i32] * 2 + [i64] * 3 + [ptr]
    lib.block_epilogue_forward.restype = i32
    lib.block_epilogue_backward.argtypes = [ptr] * 7 + [i32] * 3 + [i64] * 3 + [ptr]
    lib.block_epilogue_backward.restype = i32
    return lib


def takes_width(channels: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take ``channels`` channels at ``dtype``: whole
    16-byte vectors, at most 256 of them a pixel."""
    vector = _VECTOR.get(dtype)
    return vector is not None and channels % vector == 0 and 0 < channels // vector <= _THREADS


def fits(t: torch.Tensor) -> bool:
    """Whether ``t`` is 4-d, dense channels-last and on a 16-byte boundary:
    the layout the kernels read and write."""
    return (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
            and t.data_ptr() % 16 == 0)


def _act(y: torch.Tensor, activation: str) -> torch.Tensor:
    return F.gelu(y, approximate="tanh" if activation == "gelu_tanh" else "none")


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.float()[:, None, None]


def epilogue_plain(c: torch.Tensor, bias: torch.Tensor, activation: str,
                   residual: Optional[torch.Tensor] = None,
                   residual_bias: Optional[torch.Tensor] = None,
                   gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel's plain version: ``act(c + b)``, or with a
    ``residual`` ``(s + sb) + g * act(c + b)``, in float32, rounded once to
    ``c``'s dtype."""
    y = _act(c.float() + _per_channel(bias), activation)
    if residual is None:
        return y.to(c.dtype)
    base = residual.float()
    if residual_bias is not None:
        base = base + _per_channel(residual_bias)
    if gate is not None:
        y = gate.float() * y
    return (base + y).to(c.dtype)


def epilogue_backward_plain(grad: torch.Tensor, c: torch.Tensor, bias: torch.Tensor,
                            activation: str, gate: Optional[torch.Tensor] = None,
                            residual: bool = False) -> Grads:
    """The backward kernel's plain version -> ``(grad_c, grad_bias,
    grad_residual_bias, grad_gate)``: ``grad_c = (grad g) act'(c + b)`` in
    ``c``'s dtype, the float32 sums over N, H, W of ``grad_c`` (unrounded),
    and with ``residual`` of ``grad`` and of ``grad act(c + b)`` (else
    None)."""
    y = c.float() + _per_channel(bias)
    dy = grad.float()
    scaled = dy if gate is None else dy * gate.float()
    approximate = "tanh" if activation == "gelu_tanh" else "none"
    gc = torch.ops.aten.gelu_backward(scaled, y, approximate=approximate)
    grad_c, grad_b = gc.to(c.dtype), gc.sum((0, 2, 3))
    if not residual:
        return grad_c, grad_b, None, None
    return grad_c, grad_b, dy.sum((0, 2, 3)), (dy * _act(y, activation)).sum()


def _check(c: torch.Tensor, bias: torch.Tensor, activation: str,
           residual: Optional[torch.Tensor] = None,
           residual_bias: Optional[torch.Tensor] = None,
           gate: Optional[torch.Tensor] = None) -> None:
    """Raise unless the kernels take these operands."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}; got {activation!r}")
    if not c.is_cuda:
        raise ValueError(f"the block epilogue kernels take CUDA tensors; got {c.device}")
    if c.dtype not in DTYPES:
        raise TypeError(f"the block epilogue kernels take float32 or bfloat16; got {c.dtype}")
    if not fits(c):
        raise ValueError("the block epilogue kernels take a 4-d dense channels-last tensor on a "
                         f"16-byte boundary; got shape {tuple(c.shape)}, strides {c.stride()}")
    if not takes_width(c.shape[1], c.dtype):
        raise ValueError(f"{c.shape[1]} channels at {c.dtype}: not whole 16-byte vectors")
    if residual is not None and (residual.device != c.device or residual.dtype != c.dtype
                                 or residual.shape != c.shape or not fits(residual)):
        raise ValueError("the residual must be the conv output's shape, dtype, device and "
                         f"layout; got {tuple(residual.shape)}, {residual.dtype}, "
                         f"{residual.device}, strides {residual.stride()}")
    for name, t, shape in (("bias", bias, (c.shape[1],)),
                           ("residual_bias", residual_bias, (c.shape[1],)),
                           ("gate", gate, ())):
        if t is None:
            continue
        if t.device != c.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be a float32 tensor of shape {shape} on {c.device}; "
                            f"got {t.dtype}, {tuple(t.shape)}, {t.device}")


def grid(m: int, channels: int, dtype: torch.dtype, device: torch.device) -> int:
    """The blocks a call launches at ``m`` pixels of ``channels``: one a
    ``256 / (channels / vector)`` pixels, at most ``BLOCKS_PER_SM`` an SM
    of the card; the backward's partial sums have this many rows."""
    rows = _THREADS // (channels // _VECTOR[dtype])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-m // rows), BLOCKS_PER_SM * sms)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def epilogue_cuda(c: torch.Tensor, bias: torch.Tensor, activation: str,
                  residual: Optional[torch.Tensor] = None,
                  residual_bias: Optional[torch.Tensor] = None,
                  gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel: ``epilogue_plain`` for dense channels-last CUDA
    tensors; the output in ``c``'s layout."""
    global launches
    if residual is None and (residual_bias is not None or gate is not None):
        raise ValueError("residual_bias and gate go with a residual")
    _check(c, bias, activation, residual, residual_bias, gate)
    bias = bias.contiguous()
    residual_bias = None if residual_bias is None else residual_bias.contiguous()
    out = torch.empty_like(c)
    n, channels, h, w = c.shape
    m = n * h * w
    if m == 0:
        return out
    codes = DTYPES.index(c.dtype), ACTIVATIONS.index(activation)
    blocks = grid(m, channels, c.dtype, c.device)
    with torch.cuda.device(c.device):
        err = library().block_epilogue_forward(
            c.data_ptr(), bias.data_ptr(), _ptr(residual), _ptr(residual_bias), _ptr(gate),
            out.data_ptr(), *codes, m, channels, blocks, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"block_epilogue_forward kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def epilogue_backward_cuda(grad: torch.Tensor, c: torch.Tensor, bias: torch.Tensor,
                           activation: str, gate: Optional[torch.Tensor] = None,
                           residual: bool = False) -> Grads:
    """The backward kernel: ``epilogue_backward_plain`` for dense
    channels-last CUDA tensors. A ``grad`` in another layout is copied into
    ``c``'s first; the sums are one float32 tensor's views."""
    global backward_launches
    _check(c, bias, activation, gate=gate)
    bias = bias.contiguous()
    if grad.shape != c.shape or grad.dtype != c.dtype or grad.device != c.device:
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} {grad.device} for the conv "
                         f"output {tuple(c.shape)} {c.dtype} {c.device}")
    if not fits(grad):
        grad = torch.empty_like(c).copy_(grad)
    n, channels, h, w = c.shape
    m = n * h * w
    k = 2 * channels + 1 if residual else channels
    grad_c = torch.empty_like(c)
    if m == 0:
        sums = torch.zeros(k, device=c.device)
    else:
        codes = DTYPES.index(c.dtype), ACTIVATIONS.index(activation)
        blocks = grid(m, channels, c.dtype, c.device)
        partials = torch.empty((blocks, k), device=c.device)
        sums = torch.empty(k, device=c.device)
        with torch.cuda.device(c.device):
            err = library().block_epilogue_backward(
                grad.data_ptr(), c.data_ptr(), bias.data_ptr(), _ptr(gate), grad_c.data_ptr(),
                partials.data_ptr(), sums.data_ptr(), int(residual), *codes, m, channels, blocks,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"block_epilogue_backward kernel launch failed: CUDA error {err}")
        backward_launches += 2
    if not residual:
        return grad_c, sums, None, None
    return grad_c, sums[:channels], sums[channels:2 * channels], sums[2 * channels]


def epilogue(c: torch.Tensor, bias: torch.Tensor, activation: str,
             residual: Optional[torch.Tensor] = None,
             residual_bias: Optional[torch.Tensor] = None,
             gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if c.device.type == "cpu":
        return epilogue_plain(c, bias, activation, residual, residual_bias, gate)
    return epilogue_cuda(c, bias, activation, residual, residual_bias, gate)


def epilogue_backward(grad: torch.Tensor, c: torch.Tensor, bias: torch.Tensor, activation: str,
                      gate: Optional[torch.Tensor] = None, residual: bool = False) -> Grads:
    """The backward: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if c.device.type == "cpu":
        return epilogue_backward_plain(grad, c, bias, activation, gate, residual)
    return epilogue_backward_cuda(grad, c, bias, activation, gate, residual)


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, bias, activation, residual, residual_bias, gate):
        ctx.save_for_backward(c, bias, gate)
        ctx.activation, ctx.residual = activation, residual is not None
        return epilogue(c, bias, activation, residual, residual_bias, gate)

    @staticmethod
    def backward(ctx, grad):
        c, bias, gate = ctx.saved_tensors
        grad_c, grad_b, grad_sb, grad_g = epilogue_backward(grad, c, bias, ctx.activation, gate,
                                                            ctx.residual)
        needs = ctx.needs_input_grad
        return (grad_c if needs[0] else None, grad_b if needs[1] else None, None,
                grad if needs[3] else None, grad_sb if needs[4] else None,
                grad_g if needs[5] else None)


def block_epilogue(c: torch.Tensor, bias: torch.Tensor, activation: str,
                   residual: Optional[torch.Tensor] = None,
                   residual_bias: Optional[torch.Tensor] = None,
                   gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The differentiable epilogue: ``act(c + b)``, or with a ``residual``
    ``(s + sb) + g * act(c + b)`` (``residual_bias`` sb and ``gate`` g
    optional); see the module's docstring."""
    return _Epilogue.apply(c, bias, activation, residual, residual_bias, gate)
