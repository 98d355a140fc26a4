"""model05's 5000-IS eval throughput across its shapes.

Port of ``scripts/eval_sweep.py`` and ``scripts/eval_kchunk_sweep.py``, two
modes:

- ``grid``: ``make_batch_evaluator`` at the bf16 body with the MoDL kernel
  (``use_pallas`` None, the kernel for the card's tensors) across batch
  (100, 250, 500) x k-chunk (100, 250), the weights of the float32 config's
  initialisation, each point timed once after a warm-up. A point that does
  not fit in device memory is reported as ``FAILED`` with the allocator's
  numbers, and the sweep goes on, as the JAX script does;
- ``kchunk``: the bench's eval (bf16 body, bf16 boundary, batch 128) at
  k-chunks of 50, 100, 200 and 250: median, min and sd of 3 timed calls.

Each point's MoDL launches are counted by memory path.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.eval_sweep [grid|kchunk]``
(both without an argument).
"""
from __future__ import annotations

import json
import sys
from typing import Callable

import numpy as np
import torch

from vae_mdl_tpu_torch.bench import _eval_throughput
from vae_mdl_tpu_torch.evaluation.harness import clear_cache
from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.timing import (
    eval_rates,
    float32_convolutions,
    resolve_device,
    scanned_config,
    seeded_model,
)

DTYPES = (("bfloat16", None),)  # (compute_dtype, use_pallas): the kernel
BATCHES = (100, 250, 500)
K_CHUNKS = (100, 250)
KCHUNK_SWEEP = (50, 100, 200, 250)
MODES = ("grid", "kchunk")


def _memory(device) -> dict:
    if device.type != "cuda":
        return {}
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}


def grid(n_samples: int = 5000, batches=BATCHES, k_chunks=K_CHUNKS, device=None,
         say: Callable[[str], None] = print) -> dict:
    """{"dtype=.. bs=.. k_chunk=..": imgs/s, s a batch, llh[0], launches; or
    the error and the allocator's numbers}."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    out = {}
    for dtype, use_pallas in DTYPES:
        cfg = scanned_config("model05", compute_dtype=dtype,
                             model_over={"use_pallas": use_pallas})
        model = seeded_model(cfg, device)  # the float32 config's weights: one seed
        for bs in batches:
            batch = torch.as_tensor(rng.integers(0, 256, (bs, 32, 32, 3), dtype=np.uint8),
                                    device=device)
            for k_chunk in k_chunks:
                label = f"dtype={dtype} pallas={int(use_pallas is not False)} bs={bs} " \
                        f"k_chunk={k_chunk}"
                kernel_structure.reset_counts()
                try:
                    rates, llh = eval_rates(model, cfg, batch, n_samples, k_chunk, n_timed=1,
                                            discard=0)
                except torch.OutOfMemoryError as e:
                    out[label] = {"failed": f"{type(e).__name__}: {str(e)[:200]}",
                                  **_memory(device)}
                    say(f"{label} FAILED: {out[label]}")
                    del e
                    clear_cache(model)
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
                    continue
                out[label] = {"imgs_per_s": float(rates[0]), "s_per_batch": bs / float(rates[0]),
                              "llh0": float(llh[0]), "launches": kernel_structure.launched(),
                              **_memory(device)}
                say(f"{label} -> {rates[0]:7.1f} imgs/s ({bs / rates[0]:.2f} s/batch, "
                    f"llh[0]={float(llh[0]):.1f}); launches {out[label]['launches']}")
                # each point's graph holds its batch's peak: drop it before the next
                clear_cache(model)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
    return out


def kchunk(n_samples: int = 5000, k_chunks=KCHUNK_SWEEP, batch_size: int = 128,
           n_timed: int = 3, device=None, say: Callable[[str], None] = print) -> dict:
    """{"k50": {"median", "min", "sd", "launches"}, ...} of the bench's eval."""
    device = resolve_device(device)
    out = {}
    for kc in k_chunks:
        kernel_structure.reset_counts()
        rates = _eval_throughput(device, batch_size, kc, n_samples, n_timed)
        out[f"k{kc}"] = {"median": round(float(np.median(rates)), 1),
                         "min": round(float(rates.min()), 1),
                         "sd": round(float(rates.std(ddof=1)) if rates.size > 1 else 0.0, 1),
                         "launches": kernel_structure.launched()}
        say(json.dumps({f"k{kc}": out[f"k{kc}"]}))
    return out


def run(modes=MODES, device=None, say: Callable[[str], None] = print, **kw) -> dict:
    """Each of ``modes``; ``kw`` (``n_samples``) goes to both."""
    out = {}
    if "grid" in modes:
        out["grid"] = grid(device=device, say=say, **kw)
    if "kchunk" in modes:
        out["kchunk"] = kchunk(device=device, say=say, **kw)
    say("FINAL " + json.dumps(out))
    return out


def main() -> None:
    float32_convolutions()
    run(tuple(sys.argv[1:]) or MODES)


if __name__ == "__main__":
    main()
