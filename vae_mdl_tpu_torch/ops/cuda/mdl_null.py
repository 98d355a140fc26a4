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
operands' strides, one thread a pixel: in the model's channel-minor layout
its gradient write is uncoalesced, so it is slow there by construction; it is
the control whose distance from ``"staged"`` is the staging term.
``variant="staged"`` takes the shipped MoDL kernels' own memory paths and
dispatch in both directions (``forward_path``, ``backward_path``): for dense
channel-minor operands on 16-byte aligned addresses the tile path of
``csrc/mdl_tile.cuh`` (persistent blocks, a bulk asynchronous copy of each
tile into shared memory; the forward sums each row there on the MoDL
forward's read walk, the backward writes its result over the tile and sends
it back with one bulk store), the direct path for any other layout. So it
prices exactly the I/O of the kernels it mirrors. Each sum adds a pixel's
channels in order on every path, so both variants give the same bits. Put
in place of the MoDL likelihood in a timed train step
(``probes/kernel_structure.py``), they split the step's cost into launch +
traffic, staging and math. The numbers mean nothing as a likelihood.

``mdl_null_forward`` and ``mdl_null_backward`` take the plain versions for
CPU tensors and launch the kernels for CUDA tensors; ``mdl_null_log_prob`` is
the differentiable pair behind a ``torch.autograd.Function`` with the
signature of ``mdl_kernel.mdl_log_prob``. ``launches`` and
``backward_launches`` count the kernels' launches, ``launches_by_path`` and
``backward_launches_by_path`` the same by memory path.
"""
from __future__ import annotations

from typing import Dict

import torch

from vae_mdl_tpu_torch.ops.cuda import io_probe
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import PATHS, _check, _check_cotangent

VARIANTS = ("dma", "staged")

# kernel launches since the counter was last set to 0: forward, backward, and
# each by memory path
launches = 0
backward_launches = 0
launches_by_path: Dict[str, int] = dict.fromkeys(PATHS, 0)
backward_launches_by_path: Dict[str, int] = dict.fromkeys(PATHS, 0)


def _staged(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    return int(variant == "staged")


def forward_path(parameters: torch.Tensor, variant: str) -> str:
    """The forward's memory path: ``"direct"`` for ``"dma"`` whatever the
    layout; for ``"staged"`` the MoDL forward's own choice,
    ``mdl_kernel.forward_path`` (``mdl_kernel.path_for`` on the parameters'
    strides, dtype and address)."""
    return mdl_kernel.forward_path(parameters) if _staged(variant) else "direct"


def backward_path(parameters: torch.Tensor, dp: torch.Tensor, variant: str) -> str:
    """The backward's memory path: ``"direct"`` for ``"dma"``; for
    ``"staged"`` the MoDL backward's own choice, ``mdl_kernel.backward_path``."""
    return mdl_kernel.backward_path(parameters, dp) if _staged(variant) else "direct"


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
    """The forward kernel, on what ``mdl_kernel.mdl_log_prob_cuda`` takes,
    on the path ``forward_path`` names."""
    global launches
    _staged(variant)
    _check(x01, parameters)
    k, b, h, w, c = parameters.shape
    out = torch.empty((k, b, h, w), device=parameters.device, dtype=torch.float32)
    if out.numel():
        path = forward_path(parameters, variant)
        with torch.cuda.device(parameters.device):
            err = io_probe.library().mdl_null_forward(
                x01.data_ptr(), parameters.data_ptr(), out.data_ptr(),
                int(parameters.dtype == torch.bfloat16), c // 10, int(path == "tiled"),
                k, b, h, w, *x01.stride(), *parameters.stride(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mdl_null_forward kernel launch ({path} path) failed: "
                               f"CUDA error {err}")
        launches += 1
        launches_by_path[path] += 1
    return out.unsqueeze(-1)


def mdl_null_backward_cuda(x01: torch.Tensor, parameters: torch.Tensor, g: torch.Tensor,
                           variant: str = "dma") -> torch.Tensor:
    """The backward kernel, on what ``mdl_kernel.mdl_backward_cuda`` takes:
    the result has the parameters' dtype and strides, on the path
    ``backward_path`` names."""
    global backward_launches
    _staged(variant)
    _check(x01, parameters)
    _check_cotangent(parameters, g)
    k, b, h, w, c = parameters.shape
    dp = torch.empty_like(parameters)
    if dp.numel():
        path = backward_path(parameters, dp, variant)
        with torch.cuda.device(parameters.device):
            err = io_probe.library().mdl_null_backward(
                x01.data_ptr(), parameters.data_ptr(), g.data_ptr(), dp.data_ptr(),
                int(parameters.dtype == torch.bfloat16), c // 10,
                int(path == "tiled"),
                k, b, h, w, *x01.stride(), *parameters.stride(), *g.stride()[:4],
                *dp.stride(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mdl_null_backward kernel launch ({path} path) failed: "
                               f"CUDA error {err}")
        backward_launches += 1
        backward_launches_by_path[path] += 1
    return dp


def tile_blocks_per_sm(dtype: torch.dtype, n_mix: int, forward: bool = False) -> int:
    """Blocks an SM of the current CUDA device holds of the null backward's
    (or, with ``forward``, the null forward's) tile path for parameters of
    ``dtype`` with ``n_mix`` mixtures, as the occupancy query sizes its
    persistent grid."""
    return io_probe.library().mdl_null_tile_blocks_per_sm(
        int(dtype == torch.bfloat16), n_mix, int(not forward))


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
