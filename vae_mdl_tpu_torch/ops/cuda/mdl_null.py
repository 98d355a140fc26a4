"""Hand-written CUDA kernels: null-body MoDL forward and backward.

Port of ``scripts/kernel_structure_probe.py`` ``make_variant`` (the Pallas
scaffolding of ``mdl_log_prob`` with the reduced bodies ``fwd_dma``/``bwd_dma``
and ``fwd_tr``/``bwd_tr``): kernels in ``csrc/io_probe.cu`` with the
arguments, strides, dtypes and launch shape of the MoDL kernels
(``ops/cuda/mdl_kernel.py``) that read every input element, write every
output element and do no likelihood math:

    forward   out[..., 0] = sum_c parameters + sum_c x
    backward  d parameters = 0.5 * parameters + g      (d x = 0)

``variant="dma"`` reads and writes device memory directly through the
operands' strides, as the MoDL kernels do; ``variant="staged"`` moves each
block's tile through shared memory. Put in place of the MoDL likelihood in a
timed train step (``probes/kernel_structure.py``), they split the step's cost
into launch + traffic, staging and math. The numbers mean nothing as a
likelihood.

``mdl_null_forward`` and ``mdl_null_backward`` take the plain versions for
CPU tensors and launch the kernels for CUDA tensors; ``mdl_null_log_prob`` is
the differentiable pair behind a ``torch.autograd.Function`` with the
signature of ``mdl_kernel.mdl_log_prob``. ``launches`` and
``backward_launches`` count the kernels' launches.
"""
from __future__ import annotations

import torch

from vae_mdl_tpu_torch.ops.cuda import io_probe
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import _check

VARIANTS = ("dma", "staged")

# kernel launches since the counter was last set to 0: forward, backward
launches = 0
backward_launches = 0


def _staged(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    return int(variant == "staged")


def mdl_null_forward_plain(x01: torch.Tensor, parameters: torch.Tensor) -> torch.Tensor:
    """The forward kernels' plain version: x ``[..., H, W, 3]``, parameters
    ``[..., H, W, 10n]`` -> ``[..., H, W, 1]`` float32."""
    return (parameters.float().sum(dim=-1, keepdim=True)
            + x01.float().sum(dim=-1, keepdim=True))


def mdl_null_backward_plain(x01: torch.Tensor, parameters: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """The backward kernels' plain version: ``0.5 * parameters + g`` in
    float32, rounded to the parameters' dtype."""
    return (parameters.float() * 0.5 + g.float()).to(parameters.dtype)


def mdl_null_forward_cuda(x01: torch.Tensor, parameters: torch.Tensor,
                          variant: str = "dma") -> torch.Tensor:
    """The forward kernel, on what ``mdl_kernel.mdl_log_prob_cuda`` takes."""
    global launches
    staged = _staged(variant)
    _check(x01, parameters)
    k, b, h, w, c = parameters.shape
    out = torch.empty((k, b, h, w), device=parameters.device, dtype=torch.float32)
    if out.numel():
        with torch.cuda.device(parameters.device):
            err = io_probe.library().mdl_null_forward(
                x01.data_ptr(), parameters.data_ptr(), out.data_ptr(),
                int(parameters.dtype == torch.bfloat16), c // 10, staged,
                k, b, h, w, *x01.stride(), *parameters.stride(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mdl_null_forward kernel launch failed: CUDA error {err}")
        launches += 1
    return out.unsqueeze(-1)


def mdl_null_backward_cuda(x01: torch.Tensor, parameters: torch.Tensor, g: torch.Tensor,
                           variant: str = "dma") -> torch.Tensor:
    """The backward kernel, on what ``mdl_kernel.mdl_backward_cuda`` takes:
    the result has the parameters' dtype and strides."""
    global backward_launches
    staged = _staged(variant)
    _check(x01, parameters)
    if not g.is_cuda or g.device != parameters.device:
        raise ValueError(f"g on {g.device}, parameters on {parameters.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32; got {g.dtype}")
    k, b, h, w, c = parameters.shape
    if tuple(g.shape) != (k, b, h, w, 1):
        raise ValueError(f"g must be [k, B, H, W, 1] = {(k, b, h, w, 1)}; got {tuple(g.shape)}")
    dp = torch.empty_like(parameters)
    if dp.numel():
        with torch.cuda.device(parameters.device):
            err = io_probe.library().mdl_null_backward(
                x01.data_ptr(), parameters.data_ptr(), g.data_ptr(), dp.data_ptr(),
                int(parameters.dtype == torch.bfloat16), c // 10, staged,
                k, b, h, w, *x01.stride(), *parameters.stride(), *g.stride()[:4],
                *dp.stride(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mdl_null_backward kernel launch failed: CUDA error {err}")
        backward_launches += 1
    return dp


def _all_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def mdl_null_forward(x01: torch.Tensor, parameters: torch.Tensor,
                     variant: str = "dma") -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if _all_cpu(x01, parameters):
        _staged(variant)
        return mdl_null_forward_plain(x01, parameters)
    return mdl_null_forward_cuda(x01, parameters, variant)


def mdl_null_backward(x01: torch.Tensor, parameters: torch.Tensor, g: torch.Tensor,
                      variant: str = "dma") -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if _all_cpu(x01, parameters, g):
        _staged(variant)
        return mdl_null_backward_plain(x01, parameters, g)
    return mdl_null_backward_cuda(x01, parameters, g, variant)


class _MDLNull(torch.autograd.Function):
    """``_MDLLogProb``'s contract with null bodies: the parameters' gradient
    comes from the null backward, the images' gradient is zero."""

    @staticmethod
    def forward(ctx, x01, parameters, variant):
        ctx.save_for_backward(x01, parameters)
        ctx.variant = variant
        return mdl_null_forward(x01, parameters, variant)

    @staticmethod
    def backward(ctx, grad_out):
        x01, parameters = ctx.saved_tensors
        d_x = d_params = None
        if ctx.needs_input_grad[1]:
            d_params = mdl_null_backward(x01, parameters, grad_out, ctx.variant)
        if ctx.needs_input_grad[0]:
            d_x = torch.zeros_like(x01)
        return d_x, d_params, None


def mdl_null_log_prob(x01: torch.Tensor, parameters: torch.Tensor,
                      variant: str = "dma") -> torch.Tensor:
    """Drop-in for ``mdl_kernel.mdl_log_prob`` with null bodies:
    ``[k, B, H, W, 1]`` float32, differentiable through the null backward."""
    return _MDLNull.apply(x01, parameters, variant)
