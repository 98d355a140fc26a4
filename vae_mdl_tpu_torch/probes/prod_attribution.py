"""Differential attribution of model05's production train step.

Port of ``scripts/prod_attribution.py``: steps that differ from the
production mode (bf16 body, bf16 likelihood boundary) by one component,
timed through ``utils/timing.py``'s ``setup_scanned_step`` and
``time_scanned_step`` (the bench's own harness), so that the differences
attribute each component's marginal cost:

  full         the production step (the MoDL kernel pair)
  jnp_modl     the plain PyTorch likelihood (``use_pallas=False``)
  dl_head      a discretized-logistic head (the bf16 body only: the boundary
               dtype is the MoDL head's): the mixture and its boundary
  k1           one importance sample (the share of the other four)
  fwd_only     the forward pass and the bound only (``fwd_only_step``): the
               backward pass and Adam are the rest
  fwd_only_dl  the same with the DL head: splits the mixture into forward
               and backward
  full_recheck the opening config again, last (the drift control)

Each variant's kernel launches, by memory path, are counted from 0. The
forward and backward MFU are over the card's bf16 peak.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.prod_attribution``.
"""
from __future__ import annotations

import json
from typing import Callable, Optional

from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.flops import device_peaks, forward_flops
from vae_mdl_tpu_torch.utils.timing import (
    float32_convolutions,
    ms_per_step,
    resolve_device,
    train_rates,
)

SPC = 10
PROD_MODEL = {"likelihood_io_dtype": "bfloat16"}
VARIANTS = (
    ("full", dict(model_over=PROD_MODEL)),
    ("jnp_modl", dict(model_over={**PROD_MODEL, "use_pallas": False})),
    ("dl_head", dict(model_over={"likelihood": "dl"})),
    ("k1", dict(model_over={**PROD_MODEL, "n_samples": 1})),
    ("fwd_only", dict(model_over=PROD_MODEL, fwd_only=True)),
    ("fwd_only_dl", dict(model_over={"likelihood": "dl"}, fwd_only=True)),
    ("full_recheck", dict(model_over=PROD_MODEL)),
)


def time_variants(variants, compute_dtype: str, spc: int, n_iters: int, n_repeats: int,
                  device, data_over: Optional[dict], say: Callable[[str], None]):
    """model05 under each ``(label, setup)`` of ``variants`` -> ({label: ms a
    step}, {label: launches by memory path}, the cfg of the first)."""
    ms, launches, first = {}, {}, None
    for label, setup in variants:
        kernel_structure.reset_counts()
        rates, cfg, _ = train_rates("model05", spc, n_iters, n_repeats, device,
                                    compute_dtype=compute_dtype, data_over=data_over, **setup)
        ms[label] = round(ms_per_step(rates, cfg), 3)
        launches[label] = kernel_structure.launched()
        first = first or cfg
        say(f"{label} {ms[label]} ms/step; launches {launches[label]}")
    return ms, launches, first


def run(spc: int = SPC, n_iters: int = 5, n_repeats: int = 6, device=None,
        data_over: Optional[dict] = None, say: Callable[[str], None] = print) -> dict:
    device = resolve_device(device)
    out, launches, cfg = time_variants(VARIANTS, "bfloat16", spc, n_iters, n_repeats, device,
                                       data_over, say)
    batch = cfg.data.batch_size
    full = out["full"]
    drift = abs(out["full_recheck"] - full) / full
    peak = device_peaks()["bfloat16"] if device.type == "cuda" else None
    fwd_flops = forward_flops(cfg.model, batch=batch, n_samples=cfg.model.n_samples)
    fwd_s, bwd_s = out["fwd_only"] / 1e3, (full - out["fwd_only"]) / 1e3
    out["attribution"] = {
        "backward_plus_adam_ms": round(full - out["fwd_only"], 3),
        "fwd_mfu": round(fwd_flops / fwd_s / peak, 4) if peak else None,
        "bwd_mfu": round(2 * fwd_flops / bwd_s / peak, 4) if peak and bwd_s > 0 else None,
        "mixture_plus_boundary_ms": round(full - out["dl_head"], 3),
        "mixture_fwd_ms": round(out["fwd_only"] - out["fwd_only_dl"], 3),
        "kernel_vs_plain_gain_ms": round(out["jnp_modl"] - full, 3),
        "k_scaling_4x_samples_ms": round(full - out["k1"], 3),
        "imgs_per_sec_full": round(batch / full * 1e3, 1),
        "session_drift_frac": round(drift, 4),
        "session_stable": bool(drift <= 0.05),
    }
    out["launches"] = launches
    say(json.dumps(out))
    return out


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
