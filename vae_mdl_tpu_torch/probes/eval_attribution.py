"""Differential attribution of the production 5000-IS evaluator.

Port of ``scripts/eval_attribution.py``: how much of model05's production
eval (bf16 body, bf16 boundary, the MoDL kernel, batch 128, k-chunks of 200)
is the mixture's log-prob, from the same loop as ``bench.py``'s eval:

  full          the production eval
  dl            a discretized-logistic head (the bf16 body; the decoder
                keeps its 50-channel conv and adds a 6-channel head conv),
                whose log-prob runs the DL kernel (K5) on the card
  full_recheck  the opening config again (the drift control)

The boundary floor is the ``[k_chunk * B, 32, 32, 50]`` bf16 parameter
tensor written by the head conv and read by the kernel, each chunk, over
the card's memory rate (``device_peaks()["bytes_per_s"]``); the conv body's
MFU is over its bf16 peak. On the TPU the DL control read below the full
eval, since its likelihood fell to an unfused path there; here the DL head
has a kernel of its own.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.eval_attribution``.
"""
from __future__ import annotations

import json
from typing import Callable

import numpy as np

from vae_mdl_tpu_torch.bench import BF16_IO, _eval_throughput
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.flops import device_peaks, forward_flops
from vae_mdl_tpu_torch.utils.timing import float32_convolutions, resolve_device

BATCH = 128
K_CHUNK = 200
N_SAMPLES = 5000
VARIANTS = (("full", BF16_IO, 3), ("dl", {"likelihood": "dl"}, 3),
            ("full_recheck", BF16_IO, 2))


def run(n_samples: int = N_SAMPLES, batch_size: int = BATCH, k_chunk: int = K_CHUNK,
        n_timed: int = None, device=None, say: Callable[[str], None] = print) -> dict:
    device = resolve_device(device)
    out, launches = {}, {}
    for label, over, timed in VARIANTS:
        kernel_structure.reset_counts()
        rates = _eval_throughput(device, batch_size, k_chunk, n_samples, n_timed or timed, over)
        out[f"{label}_imgs_per_sec"] = round(float(np.median(rates)), 1)
        launches[label] = kernel_structure.launched()
        say(f"{label} {out[f'{label}_imgs_per_sec']} imgs/s; launches {launches[label]}")

    t_full = batch_size / out["full_imgs_per_sec"]
    t_dl = batch_size / out["dl_imgs_per_sec"]
    on_card = device.type == "cuda"
    peaks = device_peaks() if on_card else None
    eval_flops = forward_flops(experiment("model05").model, batch=batch_size,
                               n_samples=n_samples)
    chunk_bytes = k_chunk * batch_size * 32 * 32 * 50 * 2
    boundary_s = (2 * chunk_bytes * (n_samples // k_chunk) / peaks["bytes_per_s"]
                  if on_card else None)
    drift = abs(out["full_recheck_imgs_per_sec"] - out["full_imgs_per_sec"]) \
        / out["full_imgs_per_sec"]
    out["attribution"] = {
        "mixture_share_s_per_batch": round(t_full - t_dl, 4),
        "mixture_share_frac": round((t_full - t_dl) / t_full, 4),
        "conv_body_mfu": round(eval_flops / t_dl / peaks["bfloat16"], 4) if on_card else None,
        "boundary_floor_s_per_batch": round(boundary_s, 4) if on_card else None,
        "mixture_vs_boundary_floor": round((t_full - t_dl) / boundary_s, 2) if on_card else None,
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
