"""Differential attribution of biladder_celeba's train step.

Port of ``scripts/biladder_ablation.py``: the 64x64 bidirectional ladder's
multi step (bf16 body, DL head, batch 128, 5 steps a call) against steps
that differ from it by one component:

  full      the step as configured
  nearest   nearest-neighbour upsampling in every DecoderBlock (not the
            reference's bilinear: it prices the bilinear resize)
  manual2x  the 2x bilinear upsample as shifts and fixed (0.25, 0.75) taps,
            equal to the blocks' resize (``check_manual_exact``)
  f32       float32 conv bodies
  k1        one importance sample instead of 5
  fwd_only  the forward pass and the bound only (``fwd_only_step``)
  remat     every residual block recomputed in the backward pass
            (``torch.utils.checkpoint``): prices the activations' memory
            traffic against the recompute
  tanhgelu  tanh-approximate gelu wherever the exact one is configured;
            the ladders' own default is already ``gelu_tanh``
            (``models/bidirectional.py``), so on biladder_celeba this is the
            same program as ``full``

nearest, manual2x, remat and tanhgelu are patches of ``nn/blocks.py`` (and
of the ladders' imports of ``_activation``) that ``patched`` applies for the
variant's build and timing and puts back whatever happens; no config gains
a field.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.biladder_ablation
[variant ...]`` (all without an argument).
"""
from __future__ import annotations

import contextlib
import json
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vae_mdl_tpu_torch.models import bidirectional, ladder
from vae_mdl_tpu_torch.nn import blocks
from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.timing import (
    float32_convolutions,
    ms_per_step,
    resolve_device,
    train_rates,
)

SPC = 5
VARIANTS = ("full", "nearest", "manual2x", "f32", "k1", "fwd_only", "remat", "tanhgelu")
_SETUP = {"f32": dict(compute_dtype="float32"), "k1": dict(model_over={"n_samples": 1}),
          "fwd_only": dict(fwd_only=True)}

_real_upsample = blocks.upsample
_real_activation = blocks._activation
_real_residual = blocks.ResidualBlock.forward_nchw


def _upsample2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The bilinear resize (half-pixel centres) by 2 along one axis: out[2i]
    samples i - 1/4 and out[2i + 1] samples i + 1/4, so the taps are (0.25,
    0.75); at an edge the clamped neighbour is the pixel itself."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    shape = list(x.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def manual_resize(x: torch.Tensor, size) -> torch.Tensor:
    """``blocks.upsample`` for an ``[N, C, H, W]`` tensor: by shifts where
    ``size`` doubles both sides, else the blocks' own resize. A channels-last
    input is resized on its NHWC view, so the output keeps that layout (the
    heads' kernels take their tile paths on it)."""
    if tuple(size) != (2 * x.shape[-2], 2 * x.shape[-1]):
        return _real_upsample(x, size)
    if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
        nhwc = x.permute(0, 2, 3, 1)
        return _upsample2x_axis(_upsample2x_axis(nhwc, 1), 2).permute(0, 3, 1, 2)
    return _upsample2x_axis(_upsample2x_axis(x, 2), 3)


def nearest_resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="nearest-exact")


def _tanh_activation(name: str):
    return _real_activation("gelu_tanh" if name == "gelu" else name)


def _remat_residual(self, x: torch.Tensor) -> torch.Tensor:
    # a residual block draws nothing, so no generator state is kept for the
    # recomputation (reading it would stop the step's CUDA-graph capture)
    return checkpoint(_real_residual, self, x, use_reentrant=False, preserve_rng_state=False)


@contextlib.contextmanager
def patched(variant: str):
    """Within the block, the variant's replacement of the blocks' resize,
    activation or residual forward; the originals are put back on the way
    out, whatever happened inside. Variants with no patch change nothing."""
    saved = []

    def put(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    try:
        if variant == "nearest":
            put(blocks, "upsample", nearest_resize)
        elif variant == "manual2x":
            put(blocks, "upsample", manual_resize)
        elif variant == "tanhgelu":
            for module in (blocks, bidirectional, ladder):
                put(module, "_activation", _tanh_activation)
        elif variant == "remat":
            put(blocks.ResidualBlock, "forward_nchw", _remat_residual)
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def check_manual_exact(say: Callable[[str], None] = print) -> float:
    """max |manual2x - the blocks' bilinear resize| on a seeded float32
    ``[2, 3, 8, 8]``; raises above 1e-6."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2)
    err = float((_real_upsample(x, (16, 16)) - manual_resize(x, (16, 16))).abs().max())
    say(f"manual2x max |err| vs the bilinear resize: {err:.2e}")
    if err >= 1e-6:
        raise AssertionError(f"manual2x is not the bilinear resize: {err}")
    return err


def run(variants=VARIANTS, spc: int = SPC, n_iters: int = 5, n_repeats: int = 2, device=None,
        data_over: Optional[dict] = None, say: Callable[[str], None] = print) -> dict:
    """ms a step of each of ``variants``, and each one's launches."""
    device = resolve_device(device)
    check_manual_exact(say)
    out, launches = {}, {}
    for name in variants:
        kernel_structure.reset_counts()
        with patched(name):
            rates, cfg, _ = train_rates("biladder_celeba", spc, n_iters, n_repeats, device,
                                        **{"compute_dtype": None, "data_over": data_over,
                                           **_SETUP.get(name, {})})
        out[name] = round(ms_per_step(rates, cfg), 3)
        launches[name] = kernel_structure.launched()
        say(f"{name:10s} {out[name]:8.3f} ms/step  {cfg.data.batch_size / out[name] * 1e3:8.0f} "
            f"imgs/s; launches {launches[name]}")
    say(json.dumps(out))
    return {"ms": out, "launches": launches}


def main() -> None:
    float32_convolutions()
    run(tuple(sys.argv[1:]) or VARIANTS)


if __name__ == "__main__":
    main()
