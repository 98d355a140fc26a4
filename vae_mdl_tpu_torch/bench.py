"""The benchmark line: ``bench.py``'s measurement on a CUDA card.

Port of ``bench.py``'s ``main``, ``_train_throughput``,
``_resident_throughput``, ``_eval_throughput`` and ``_vpu_floor``. It prints
one JSON line, the last line on stdout, with every key ``bench.py`` prints
and its meaning (progress goes to stderr; nothing is written to a file):

- the headline: model05's train throughput (batch 128, k = 5, 10 steps a
  call), its FLOPs a image, sustained TFLOP/s and MFU;
- ``*_imgs_per_sec`` with ``_min`` and ``_sd`` (``rate_stats``) for model05
  f32, bf16 body, bf16 likelihood boundary, both, trained from a dataset on
  the device, model01 (100 steps a call), model04, the 5000-IS eval of
  model05 (bf16 body, bf16 boundary, the MoDL kernel, batch 128, k-chunks of
  200), biladder_celeba (5 steps a call) and the f32 recheck at the end;
- ``mfu``, ``eval_mfu``, ``model04_mfu``, ``model05_resident_mfu`` and
  ``biladder_celeba64_mfu`` over one denominator, the card's published bf16
  peak (``utils/flops.py`` ``device_peaks()["bfloat16"]``), as ``bench.py``
  uses one (``V5E_PEAK_FLOPS``) for every config; ``peak_tflops`` is it;
- ``session_drift_frac`` and ``session_stable``: the recheck against the
  opening measurement (stable within 5%).

What differs from ``bench.py``:

- ``model05_vpu_floor_ms`` / ``model05_vpu_bound_frac`` (the TPU's vector
  unit) become ``model05_sfu_floor_ms`` / ``model05_sfu_bound_frac``: the
  same census priced at the special-function rates the loop kernel measures
  (``probes/roofline.py`` ``train_sfu_floor``);
- ``model05_bf16_full_imgs_per_sec`` is the bf16 body with the bf16
  boundary: the card has one MoDL kernel pair and no batch-lanes dispatch to
  add;
- ``device`` and ``power_limit_w``: the card's name and power limit, as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
  them, so that every number stands beside them;
- the eval config leaves ``use_pallas`` at None, which takes the MoDL kernel
  for the card's tensors as ``True`` does in ``bench.py``;
- a timed block is bracketed by CUDA events (``utils/timing.py``).

On the CPU (``run(device="cpu")``, as the tests run it) the device-only
numbers (the peak and every MFU, the SFU floor, the power limit) are null.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.bench``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from typing import Callable, Optional

import numpy as np
import torch

from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.probes.roofline import train_sfu_floor
from vae_mdl_tpu_torch.utils.flops import device_peaks, forward_flops
from vae_mdl_tpu_torch.utils.timing import (
    eval_batch,
    eval_rates,
    float32_convolutions,
    rate_stats,
    resident_step,
    resolve_device,
    scanned_config,
    seeded_model,
    time_scanned_step,
    train_rates,
)

BF16_IO = {"likelihood_io_dtype": "bfloat16"}

# (rate_stats prefix, setup_scanned_step's arguments, time_scanned_step's),
# in bench.py's order; the eval and the resident run sit between model04 and
# biladder_celeba, the recheck closes the run
TRAIN_RUNS = (
    ("model05_imgs_per_sec", dict(name="model05"), {}),
    ("model05_bf16_imgs_per_sec", dict(name="model05", compute_dtype="bfloat16"), {}),
    ("model05_bf16io_imgs_per_sec", dict(name="model05", model_over=BF16_IO), {}),
    ("model05_bf16_full_imgs_per_sec",
     dict(name="model05", compute_dtype="bfloat16", model_over=BF16_IO), {}),
    ("model01_imgs_per_sec", dict(name="model01", spc=100), {}),
    ("model04_imgs_per_sec", dict(name="model04"), {}),
    ("biladder_celeba64_imgs_per_sec",
     dict(name="biladder_celeba", spc=5, compute_dtype=None), dict(n_iters=3)),
    ("model05_f32_recheck_imgs_per_sec", dict(name="model05"), dict(n_repeats=4)),
)
RESIDENT = dict(name="model05", spc=20, n_data=10000)
# batch 128 and k-chunks of 200: bench.py's eval (bench.py:185-197)
EVAL = dict(batch_size=128, k_chunk=200, n_samples=5000, n_timed=3)


def _stats_keys(prefix: str) -> tuple:
    return (prefix, f"{prefix}_min", f"{prefix}_sd")


# the line's keys, in order: bench.py's, with the vpu pair as the sfu pair
# and the card's name and power limit added
KEYS = (
    "metric", "value", "unit", "vs_baseline", "vs_baseline_is", "timing", "flops_per_img",
    "flops_per_img_unit", "tflops_sustained", "mfu", "peak_tflops",
    *_stats_keys("model05_imgs_per_sec"), *_stats_keys("model05_bf16_imgs_per_sec"),
    *_stats_keys("model05_bf16io_imgs_per_sec"), *_stats_keys("model05_bf16_full_imgs_per_sec"),
    *_stats_keys("model05_resident_imgs_per_sec"), "model05_resident_mfu",
    *_stats_keys("model01_imgs_per_sec"), *_stats_keys("model04_imgs_per_sec"), "model04_mfu",
    *_stats_keys("model05_eval5000_imgs_per_sec"), "eval_mfu",
    "model05_sfu_floor_ms", "model05_sfu_bound_frac",
    *_stats_keys("biladder_celeba64_imgs_per_sec"), "biladder_celeba64_mfu",
    *_stats_keys("model05_f32_recheck_imgs_per_sec"), "session_drift_frac", "session_stable",
    "device", "power_limit_w",
)


def eval_config(model_over: Optional[dict] = None):
    """The bench's 5000-IS eval experiment: model05 with a bf16 body and a
    bf16 likelihood boundary (``bench.py:204-212``); ``model_over`` in place
    of the boundary dtype, as the eval probes set it."""
    over = BF16_IO if model_over is None else model_over
    return scanned_config("model05", compute_dtype="bfloat16",
                          model_over=dict(use_pallas=None, **over))


def card() -> tuple:
    """(name, power limit in W) of the current card from ``nvidia-smi``."""
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    name, limit = lines[min(torch.cuda.current_device(), len(lines) - 1)].rsplit(",", 1)
    return name.strip(), float(limit.strip().split()[0])


def _train_throughput(setup: dict, timing: dict, device, spc: Optional[int] = None,
                      data_over: Optional[dict] = None, **repeats):
    """-> (imgs/s per timed block, flops a step, batch size) of one of
    ``TRAIN_RUNS``; ``spc``, ``data_over`` and ``repeats`` (``n_iters``,
    ``n_repeats``) override the run's own."""
    setup = dict(setup, **({"spc": spc} if spc else {}))
    rates, cfg, flops = train_rates(device=device, data_over=data_over,
                                    **setup, **{**timing, **repeats})
    return rates, flops, cfg.data.batch_size


def _resident_throughput(device, spc: Optional[int] = None, data_over: Optional[dict] = None,
                         **repeats):
    step, state, data, cfg = resident_step(RESIDENT["name"], spc or RESIDENT["spc"],
                                           RESIDENT["n_data"], device, data_over)
    return time_scanned_step(step, state, data, spc or RESIDENT["spc"], cfg.data.batch_size,
                             **repeats)


def _eval_throughput(device, batch_size: int = 128, k_chunk: int = 200, n_samples: int = 5000,
                     n_timed: int = 3, model_over: Optional[dict] = None):
    """imgs/s per timed call of the 5000-IS eval of ``eval_config(model_over)``
    (one warm-up call, the first timed call thrown away)."""
    cfg = eval_config(model_over)
    batch = eval_batch(cfg, batch_size, device)
    rates, _ = eval_rates(seeded_model(cfg, device), cfg, batch, n_samples, k_chunk, n_timed)
    return rates


def run(device=None, spc: Optional[int] = None, data_over: Optional[dict] = None,
        eval_over: Optional[dict] = None, say: Callable[[str], None] = None,
        **repeats) -> dict:
    """The whole bench; prints its line and returns it. ``spc`` (steps a
    call), ``data_over`` (say a smaller batch), ``eval_over`` (``EVAL``'s
    keys) and ``repeats`` (``n_iters``, ``n_repeats``) cut it down; with none
    of them it runs at ``bench.py``'s settings."""
    device = resolve_device(device)
    say = say or (lambda line: print(line, file=sys.stderr, flush=True))
    on_card = device.type == "cuda"
    peak = device_peaks()["bfloat16"] if on_card else None
    kernel_structure.reset_counts()
    rates, flops = {}, {}
    for prefix, setup, timing in TRAIN_RUNS[:6]:
        rates[prefix], flops[prefix], batch = _train_throughput(setup, timing, device, spc,
                                                                data_over, **repeats)
        say(f"{prefix}: {float(np.median(rates[prefix])):.1f}")
    rates["model05_resident_imgs_per_sec"] = _resident_throughput(device, spc, data_over,
                                                                    **repeats)
    say(f"model05_resident_imgs_per_sec: "
        f"{float(np.median(rates['model05_resident_imgs_per_sec'])):.1f}")
    ev = dict(EVAL, **(eval_over or {}))
    rates["model05_eval5000_imgs_per_sec"] = _eval_throughput(device, **ev)
    say(f"model05_eval5000_imgs_per_sec: "
        f"{float(np.median(rates['model05_eval5000_imgs_per_sec'])):.2f}")

    imgs05 = float(np.median(rates["model05_imgs_per_sec"]))
    flops_per_img = flops["model05_imgs_per_sec"] / batch
    tflops = imgs05 * flops_per_img / 1e12

    def mfu(imgs_per_s: float, flops_img: float):
        return round(imgs_per_s * flops_img / peak, 4) if peak else None

    eval_flops_img = forward_flops(experiment("model05").model, batch=1, n_samples=5000)
    floor_s, frac = None, None
    if on_card:
        floor_s, frac = train_sfu_floor(batch / imgs05)

    prefix, setup, timing = TRAIN_RUNS[6]
    rates[prefix], flops_bl, batch_bl = _train_throughput(setup, timing, device, spc,
                                                          data_over, **repeats)
    say(f"{prefix}: {float(np.median(rates[prefix])):.1f}")

    out = {
        "metric": "model05_train_throughput",
        "value": round(imgs05, 1),
        "unit": "imgs/sec",
        # MFU against the card's bf16 peak: vs_baseline is the mfu key
        "vs_baseline": mfu(imgs05, flops_per_img),
        "vs_baseline_is": "mfu",
        "timing": "median of repeats; see *_min/*_sd per metric",
        "flops_per_img": round(flops_per_img / 1e6, 2),
        "flops_per_img_unit": "MFLOP",
        "tflops_sustained": round(tflops, 2),
        "mfu": mfu(imgs05, flops_per_img),
        "peak_tflops": peak / 1e12 if peak else None,
    }
    for prefix in ("model05_imgs_per_sec", "model05_bf16_imgs_per_sec",
                   "model05_bf16io_imgs_per_sec", "model05_bf16_full_imgs_per_sec",
                   "model05_resident_imgs_per_sec"):
        out.update(rate_stats(prefix, rates[prefix]))
    out["model05_resident_mfu"] = mfu(float(np.median(rates["model05_resident_imgs_per_sec"])),
                                      flops_per_img)
    out.update(rate_stats("model01_imgs_per_sec", rates["model01_imgs_per_sec"]))
    out.update(rate_stats("model04_imgs_per_sec", rates["model04_imgs_per_sec"]))
    out["model04_mfu"] = mfu(float(np.median(rates["model04_imgs_per_sec"])),
                             flops["model04_imgs_per_sec"] / batch)
    out.update(rate_stats("model05_eval5000_imgs_per_sec",
                          rates["model05_eval5000_imgs_per_sec"]))
    out["eval_mfu"] = mfu(float(np.median(rates["model05_eval5000_imgs_per_sec"])),
                          eval_flops_img)
    out["model05_sfu_floor_ms"] = round(floor_s * 1e3, 3) if floor_s is not None else None
    out["model05_sfu_bound_frac"] = round(frac, 4) if frac is not None else None
    out.update(rate_stats("biladder_celeba64_imgs_per_sec",
                          rates["biladder_celeba64_imgs_per_sec"]))
    out["biladder_celeba64_mfu"] = mfu(float(np.median(rates["biladder_celeba64_imgs_per_sec"])),
                                       flops_bl / batch_bl)

    # the drift sentinel: the opening config again, after everything else
    prefix, setup, timing = TRAIN_RUNS[7]
    rates[prefix], _, _ = _train_throughput(setup, timing, device, spc, data_over, **repeats)
    out.update(rate_stats(prefix, rates[prefix]))
    drift = abs(float(np.median(rates[prefix])) - imgs05) / imgs05
    out["session_drift_frac"] = round(drift, 4)
    out["session_stable"] = bool(drift <= 0.05)
    out["device"], out["power_limit_w"] = card() if on_card else ("cpu", None)
    say("launches: " + json.dumps(kernel_structure.counts_by_path()))
    line = {key: out[key] for key in KEYS}
    print(json.dumps(line), flush=True)
    return line


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
