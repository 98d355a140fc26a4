"""A per-op device-time table of model05's hot paths, from ``torch.profiler``.

Port of ``scripts/trace_profile.py``: 12 single train steps of model05
(float32, batch 128, k = 5) and one 500-sample eval of 100 images (bf16 body,
the MoDL kernel, k-chunks of 100), warmed up outside the trace, then traced;
the table sums each kernel's device time over the trace: the top 40 by time
with their launches and share of the device's busy time, and the traced
span on the host's clock.

On the CPU (``device="cpu"``, as the tests run it) the table is of the host's
operators and says so.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.trace_profile``.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vae_mdl_tpu_torch.evaluation.harness import make_batch_evaluator
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step
from vae_mdl_tpu_torch.utils.timing import (
    float32_convolutions,
    resolve_device,
    scanned_config,
    seeded_model,
)


def run_traced_workload(n_steps: int = 12, batch_size: int = 128, eval_batch: int = 100,
                        n_samples: int = 500, k_chunk: int = 100, device=None):
    """-> (the profiler, the traced span in ms, the last train loss)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    cfg = scanned_config("model05")
    model = seeded_model(cfg, device)
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    rng = np.random.default_rng(0)
    batch = torch.as_tensor(rng.integers(0, 256, (batch_size, 32, 32, 3), dtype=np.uint8),
                            device=device)
    # the eval path: bf16 body and the MoDL kernel
    ecfg = scanned_config("model05", compute_dtype="bfloat16", model_over={"use_pallas": None})
    emodel = seeded_model(ecfg, device)
    evaluator = make_batch_evaluator(emodel, ecfg, n_samples=n_samples, k_chunk=k_chunk)
    ebatch = torch.as_tensor(rng.integers(0, 256, (eval_batch, 32, 32, 3), dtype=np.uint8),
                             device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    state, metrics = step(state, batch)  # warm up outside the trace
    evaluator(ebatch, torch.Generator(device).manual_seed(0))
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, metrics = step(state, batch)
        evaluator(ebatch, torch.Generator(device).manual_seed(1))
        sync()
        span_ms = (time.perf_counter() - t0) * 1e3
    return prof, span_ms, float(metrics["loss"])


def summarize(prof, on_card: bool, top: int = 40) -> dict:
    """{"clock": "device" or "host", "busy_ms", "ops": [(name, ms, count,
    share of busy)]}: device kernels' self time on the card, host operators'
    self time on the CPU."""
    rows = []
    for evt in prof.key_averages():
        if on_card and evt.device_type == DeviceType.CUDA:
            rows.append((evt.key, evt.self_device_time_total / 1e3, evt.count))
        elif not on_card and evt.device_type == DeviceType.CPU and evt.self_cpu_time_total > 0:
            rows.append((evt.key, evt.self_cpu_time_total / 1e3, evt.count))
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no time")
    rows.sort(key=lambda r: -r[1])
    return {"clock": "device" if on_card else "host", "busy_ms": busy,
            "ops": [(name, ms, n, ms / busy) for name, ms, n in rows[:top]]}


def run(device=None, top: int = 40, say: Callable[[str], None] = print, **workload) -> dict:
    device = resolve_device(device)
    prof, span_ms, loss = run_traced_workload(device=device, **workload)
    table = summarize(prof, device.type == "cuda", top)
    say(f"[trace] train loss {loss:.1f}; {table['clock']} busy (sum of {table['clock']} "
        f"events) {table['busy_ms']:.3f} ms, traced span {span_ms:.3f} ms")
    say(f"{'op':<64} {'total ms':>10} {'n':>6} {'%busy':>7}")
    for name, ms, n, share in table["ops"]:
        say(f"{name[:64]:<64} {ms:>10.3f} {n:>6} {100 * share:>6.1f}%")
    return dict(table, span_ms=span_ms, loss=loss)


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
