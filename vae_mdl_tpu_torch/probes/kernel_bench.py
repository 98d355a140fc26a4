"""The MoDL forward kernel against its plain version, eager and compiled.

Port of ``scripts/kernel_bench.py``: the MoDL log-prob, summed over each
image's pixels (``[k, b]``), of ``[100, 100, 32, 32, 50]`` float32 standard-normal
parameters on binned images, three ways: the plain PyTorch version
(``mixture_log_prob``) eager, the same under ``torch.compile`` (the
counterpart of the JAX script's XLA-fused arm; a comparison only, on no
path) and the kernel (``ops/cuda/mdl_kernel.py``, which takes its tile path
on these dense operands). CUDA-event times per call after a warm-up, the
compile's seconds, the largest difference from the eager plain version and
the kernel's effective rate over the parameters' bytes.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.kernel_bench``.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel
from vae_mdl_tpu_torch.utils.timing import float32_convolutions, resolve_device, seconds_of

K, B, N_MIX = 100, 100, 5
ARMS = ("plain", "compiled", "kernel")


def inputs(k: int = K, b: int = B, n_mix: int = N_MIX, side: int = 32, device=None):
    """(x in [0, 1] on the 256 bins ``[b, side, side, 3]``, standard-normal
    parameters ``[k, b, side, side, 10 n_mix]``), seeded, made on the device."""
    gen = torch.Generator(device).manual_seed(0)
    x01 = torch.randint(0, 256, (b, side, side, 3), generator=gen, device=device) / 255.0
    params = torch.randn((k, b, side, side, 10 * n_mix), generator=gen, device=device)
    return x01, params


def _plain(x, p):
    return mixture_log_prob(x, p).sum(dim=(-1, -2, -3))


def _kernel(x, p):
    return mdl_kernel.mdl_log_prob(x, p).sum(dim=(-1, -2, -3))


def run(arms=ARMS, k: int = K, b: int = B, reps: int = 5, device=None,
        say: Callable[[str], None] = print) -> dict:
    """{arm: {"ms", "max_abs_diff", "rel"}}, the compile's seconds, the
    kernel's path and effective GB/s."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if not on_card and set(arms) - {"plain"}:
        raise ValueError("on the CPU only the plain arm runs")
    x, p = inputs(k, b, device=device)
    fns = {"plain": _plain, "kernel": _kernel}
    out = {}
    if "compiled" in arms:
        fns["compiled"] = torch.compile(_plain)
        t0 = time.perf_counter()
        fns["compiled"](x, p)
        torch.cuda.synchronize()
        out["compile_s"] = time.perf_counter() - t0
    want = _plain(x, p)
    for arm in arms:
        fn = fns[arm]
        fn(x, p)  # warm-up
        ms = seconds_of(lambda: [fn(x, p) for _ in range(reps)], on_card) * 1e3 / reps
        got = fn(x, p)
        err = float((got - want).abs().max())
        out[arm] = {"ms": ms, "max_abs_diff": err, "rel": err / float(want.abs().max())}
        say(f"{arm:10s} {ms:9.3f} ms   max abs diff {err:.3e} (rel {out[arm]['rel']:.2e})")
    gb = p.numel() * 4 / 1e9
    if "kernel" in arms:
        out["path"] = mdl_kernel.forward_path(p)
        out["kernel_gb_per_s"] = gb / out["kernel"]["ms"] * 1e3
        say(f"kernel on the {out['path']} path: {out['kernel_gb_per_s']:.0f} GB/s over "
            f"{gb:.2f} GB of parameters; plain / kernel "
            f"{out['plain']['ms'] / out['kernel']['ms']:.2f}x"
            + (f", compiled / kernel {out['compiled']['ms'] / out['kernel']['ms']:.2f}x "
               f"(compile {out['compile_s']:.1f} s)" if "compiled" in arms else ""))
    return out


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
