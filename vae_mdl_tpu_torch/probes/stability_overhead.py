"""The cost of the gradient stability kit on the hot path.

Port of ``scripts/stability_overhead.py``: model05's multi step (batch 128,
k = 5, 10 steps a call, float32) with both knobs off, with the global-norm
clip at 200, with the skip rule at 400 and with both; each timed as the JAX
script times it, two warm-up calls and one block of 5 calls (the harness's
first block, which it throws away, before it).

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.stability_overhead``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.timing import float32_convolutions, resolve_device, train_rates

VARIANTS = (("baseline (no clip/skip)", 0.0, 0.0), ("clip=200", 200.0, 0.0),
            ("skip=400", 0.0, 400.0), ("clip+skip", 200.0, 400.0))


def throughput(grad_clip: float, grad_skip: float, device, spc: int = 10, n_iters: int = 5,
               n_repeats: int = 2, data_over=None) -> float:
    rates, _, _ = train_rates("model05", spc, n_iters, n_repeats, device, data_over=data_over,
                              train_over=dict(grad_clip_norm=grad_clip,
                                              grad_skip_threshold=grad_skip))
    return float(np.median(rates))


def run(device=None, say: Callable[[str], None] = print, **harness) -> dict:
    device = resolve_device(device)
    out = {}
    kernel_structure.reset_counts()
    for label, clip, skip in VARIANTS:
        out[label] = t = throughput(clip, skip, device, **harness)
        base = out[VARIANTS[0][0]]
        say(f"{label}: {t:.0f} imgs/s ({100 * (t / base - 1):+.1f}%)")
    launches = kernel_structure.launched()
    return {"imgs_per_sec": out, "launches": launches}


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
