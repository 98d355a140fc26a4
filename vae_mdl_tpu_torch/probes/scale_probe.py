"""Throughput at other batch sizes and dtypes: biladder_celeba's body in
float32 and bf16, model05 at batch 512.

Port of ``scripts/scale_probe.py``: each config's multi step (5 steps a call;
two warm-up calls, then one block of 3 calls) and its MFU over the card's
bf16 peak (``train_step_flops`` a image).

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.scale_probe``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.flops import device_peaks, train_step_flops
from vae_mdl_tpu_torch.utils.timing import float32_convolutions, resolve_device, train_rates

PROBES = (("biladder_celeba", None, "float32"), ("biladder_celeba", None, "bfloat16"),
          ("model05", 512, "float32"), ("model05", 512, "bfloat16"),
          ("biladder_celeba", 256, "bfloat16"))


def probe(name: str, batch_size: Optional[int], dtype: str, device, spc: int = 5, n: int = 3,
          n_repeats: int = 2) -> dict:
    data_over = {"batch_size": batch_size} if batch_size else None
    rates, cfg, _ = train_rates(name, spc, n, n_repeats, device, compute_dtype=dtype,
                                data_over=data_over)
    ips = float(np.median(rates))
    peak = device_peaks()["bfloat16"] if device.type == "cuda" else None
    return {"batch_size": cfg.data.batch_size, "imgs_per_s": ips,
            "mfu": ips * train_step_flops(cfg.model, 1) / peak if peak else None,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if peak else None}


def run(probes=PROBES, device=None, say: Callable[[str], None] = print, **harness) -> dict:
    device = resolve_device(device)
    out = {}
    kernel_structure.reset_counts()
    for name, batch_size, dtype in probes:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        r = probe(name, batch_size, dtype, device, **harness)
        out[f"{name} bs={r['batch_size']} {dtype}"] = r
        say(f"{name:18s} bs={r['batch_size']:4d} {dtype:9s}: {r['imgs_per_s']:9.1f} imgs/s  "
            f"mfu={r['mfu'] if r['mfu'] is None else round(r['mfu'], 3)}")
    launches = kernel_structure.launched()
    return {"probes": out, "launches": launches}


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
