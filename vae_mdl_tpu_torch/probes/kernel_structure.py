"""Step-level structural decomposition of the MoDL kernels' cost.

Port of ``scripts/kernel_structure_probe.py``. The MoDL likelihood is swapped
for null-body kernels with the same arguments, strides, launch shape and
autograd contract (``ops/cuda/mdl_null.py``) inside the real model05 train
step, and the components are read off the differences between four steps:

  dl_head : no mixture kernels at all: a discretized-logistic head
  dma     : kernels that only read and write what the MoDL kernels read and
            write, straight from device memory -> launch + traffic
  staged  : the same on the shipped kernels' memory paths in both directions
            (the MoDL forward's read walk and the MoDL backward's tile path,
            by the MoDL kernels' own dispatch) -> what staging costs
  full    : the shipped kernels -> the math (full - staged prices the MoDL
            kernels' math alone: the two steps share every memory path)

A train step here is held by the host, so each step is timed twice: the wall
time through ``utils/timing.py`` and the device's busy time from
``torch.profiler``; the decomposition is read from the device times, for the
likelihood kernels alone and for everything else, because the dl-head step
carries a head conv of its own and the rest of a step need not stand still.
The swap is the context manager ``likelihood_swapped``: the model's own path has
no switch for it.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.kernel_structure``.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict

import torch

from vae_mdl_tpu_torch.ops.cuda import dl_kernel, mdl_kernel, mdl_null
from vae_mdl_tpu_torch.utils.timing import LIKELIHOOD_CLASSES, timed_train_step

STEPS = ("full", "dma", "staged", "dl_head")


@contextlib.contextmanager
def likelihood_swapped(variant: str):
    """Within the block, ``mdl_kernel.mdl_log_prob`` is the null-body pair of
    ``variant`` ("dma" or "staged"); the real function is put back on the way
    out, whatever happened inside."""
    real = mdl_kernel.mdl_log_prob
    mdl_kernel.mdl_log_prob = functools.partial(mdl_null.mdl_null_log_prob, variant=variant)
    try:
        yield
    finally:
        mdl_kernel.mdl_log_prob = real


def launch_counts() -> Dict[str, int]:
    return {"mdl_log_prob": mdl_kernel.launches,
            "mdl_log_prob_backward": mdl_kernel.backward_launches,
            "mdl_null_forward": mdl_null.launches,
            "mdl_null_backward": mdl_null.backward_launches,
            "dl_log_prob": dl_kernel.launches,
            "dl_log_prob_backward": dl_kernel.backward_launches}


def reset_counts() -> None:
    for kernels in (mdl_kernel, mdl_null, dl_kernel):
        kernels.launches = kernels.backward_launches = 0
    for kernels in (mdl_kernel, mdl_null, dl_kernel):
        kernels.backward_launches_by_path.update(dict.fromkeys(kernels.PATHS, 0))
    for kernels in (mdl_kernel, mdl_null, dl_kernel):
        kernels.launches_by_path.update(dict.fromkeys(kernels.PATHS, 0))


def measure(label: str, spc: int = 10, n_iters: int = 5, n_repeats: int = 6) -> dict:
    """One of the four steps: wall ms per step (median of the harness's
    blocks), device-busy ms per step (one traced call of ``spc`` steps) and
    the launches of every likelihood kernel, counted from 0, and each
    kernel's also by memory path."""
    over = {"likelihood": "dl"} if label == "dl_head" else None
    swap = likelihood_swapped(label) if label in mdl_null.VARIANTS else contextlib.nullcontext()
    reset_counts()
    with swap:
        r = timed_train_step("model05", spc, n_iters, n_repeats, model_over=over)
    likelihood = sum(ms for cls, ms in r["by_class"].items() if cls in LIKELIHOOD_CLASSES)
    return {"ms": r["ms"], "imgs_per_s": r["imgs_per_s"], "busy_ms": r["busy_ms"],
            "likelihood_ms": likelihood, "rest_ms": r["busy_ms"] - likelihood,
            "by_class": r["by_class"], "traced_wall_ms": r["traced_wall_ms"],
            "launches": launch_counts(),
            "forward_paths": {"mdl_log_prob": dict(mdl_kernel.launches_by_path),
                              "mdl_null_forward": dict(mdl_null.launches_by_path),
                              "dl_log_prob": dict(dl_kernel.launches_by_path)},
            "backward_paths": {"mdl_log_prob_backward": dict(mdl_kernel.backward_launches_by_path),
                               "mdl_null_backward": dict(mdl_null.backward_launches_by_path),
                               "dl_log_prob_backward": dict(dl_kernel.backward_launches_by_path)}}


def decomposition(results: Dict[str, dict], key: str) -> Dict[str, float]:
    """The four differences, in milliseconds per step, from the steps'
    ``key``: "likelihood_ms" (the likelihood kernels' own device time),
    "rest_ms" (all other device kernels: what the swap should leave alone),
    "busy_ms" (their sum) or "ms" (wall)."""
    t = {label: results[label][key] for label in STEPS}
    return {"launch + traffic": t["dma"] - t["dl_head"], "staging": t["staged"] - t["dma"],
            "math": t["full"] - t["staged"], "total mixture": t["full"] - t["dl_head"]}


def run(spc: int = 10, n_iters: int = 5, n_repeats: int = 6,
        say: Callable[[str], None] = print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA card; torch.cuda.is_available() is False")
    results = {}
    for label in STEPS:
        results[label] = r = measure(label, spc, n_iters, n_repeats)
        launched = {name: n for name, n in r["launches"].items() if n}
        classes = ", ".join(f"{cls} {ms:.3f}" for cls, ms in sorted(r["by_class"].items()))
        say(f"{label:8s} {r['ms']:.3f} ms/step wall ({r['imgs_per_s']:.0f} imgs/s), "
            f"{r['busy_ms']:.3f} ms/step device busy ({classes}); launches {launched}")
    out: dict = {"steps": results}
    for key, name in (("likelihood_ms", "device, likelihood kernels alone"),
                      ("rest_ms", "device, everything else"),
                      ("busy_ms", "device busy"), ("ms", "wall")):
        out[key] = parts = decomposition(results, key)
        say(f"{name}: " + ", ".join(f"{what} {ms:+.3f} ms" for what, ms in parts.items()))
    return out


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False  # the float32 config means float32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    run()


if __name__ == "__main__":
    main()
