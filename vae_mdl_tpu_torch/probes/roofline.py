"""Special-function roofline of the MoDL likelihood kernels.

Port of ``scripts/vpu_roofline.py`` and ``bench.py``'s ``_vpu_floor``. What
share of the card's transcendental throughput do the MoDL kernels reach?

1. per-op rates (exp, log, tanh, sigmoid, softplus) from the loop kernel
   ``ops/cuda/sfu_probe.py`` at the MoDL kernels' geometry and at a grid
   eight times larger, with the re-ranging's time taken off, and a sweep
   over the independent chains per thread that shows the plateau;
2. the additive model checked on the fused discretized-logistic cascade
   measured as one op: the re-ranged chain stays inside the bins, where the
   CUDA cascade evaluates 1 exp, 2 sigmoid and 1 log;
3. the census of the MoDL forward and backward priced at those rates: the
   floor of the forward at k = 5 and k = 100 and of forward + backward at
   k = 5, batch 128. That floor is what these instruction sequences attain,
   not a bound of the card: beside it stands the bound, the fewest MUFU
   instructions of the same calls over the card's special-function results
   per second at the measured clock. Two counts are priced: the Pallas kernels'
   (``mdl_transcendental_census``, every branch evaluated) and what the CUDA
   kernels evaluate on this model's own data
   (``mdl_cuda_transcendentals`` from the branches model05's head output
   takes on the timing batch at initialisation);
4. the mixture's cost inside the real train step, full model05 step minus
   the same step with a discretized-logistic head, in wall time and in
   device-busy time;
5. the kernels' device time per launch against their floors.

``train_sfu_floor`` prices model05's train step the way ``bench.py``'s
``_vpu_floor`` does, for the bench's ``model05_sfu_floor_ms``.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.roofline``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel, sfu_probe
from vae_mdl_tpu_torch.utils.flops import (
    cascade_transcendentals,
    mdl_cuda_transcendentals,
    mdl_train_transcendentals,
    mdl_transcendental_census,
    modl_branch_counts,
    mufu_instructions,
)
from vae_mdl_tpu_torch.utils.timing import device_times, timed_train_step

CASCADE_ITERS = (100, 600)


def measured_rates(blocks: int = sfu_probe.DEFAULT_BLOCKS,
                   chains: int = sfu_probe.DEFAULT_CHAINS, repeats: int = 5):
    """-> (raw, rates): evaluations per second per op with the re-ranging
    (and of the re-ranging alone, ``"none"``), and with its time taken off."""
    raw = sfu_probe.measure_raw_rates(blocks=blocks, chains=chains, repeats=repeats)
    return raw, sfu_probe.subtract_identity(raw)


def plateau_sweep(ops=("exp", "sigmoid"), repeats: int = 3) -> Dict[str, Dict[int, float]]:
    """Raw rate of each op by independent chains per thread."""
    return {op: {c: sfu_probe.measure_op_rate(op, chains=c, repeats=repeats)
                 for c in sfu_probe.CHAINS} for op in ops}


def additive_check(raw: Dict[str, float], repeats: int = 5) -> dict:
    """The fused cascade as one measured op against the rate predicted by
    adding the times of the calls its branch makes. -> measured and
    predicted evaluations per second (re-ranging taken off) and their
    ratio (> 1: the fused cascade overlaps work the additive model charges
    one after the other)."""
    rates = sfu_probe.subtract_identity(raw)
    cascade_raw = sfu_probe.measure_op_rate("cascade", iters=CASCADE_ITERS, repeats=repeats)
    measured = 1.0 / (1.0 / cascade_raw - 1.0 / raw["none"])
    calls = {op: n for op, n in cascade_transcendentals({"cdf": 1}).items() if n}
    predicted = 1.0 / sfu_probe.sfu_floor_seconds(calls, rates)
    return {"calls": calls, "measured": measured, "predicted": predicted,
            "ratio": measured / predicted}


def pallas_counts(n_mix: int, pixels: int, backward: bool) -> Dict[str, float]:
    """The Pallas census over ``pixels`` pixels: the forward, or with
    ``backward`` forward + backward."""
    census = mdl_transcendental_census(n_mix)
    return {op: float((n + (census["bwd"][op] if backward else 0)) * pixels)
            for op, n in census["fwd"].items()}


def cuda_counts(branches: Dict[str, int], pixels: int, n_mix: int, backward: bool,
                scale: float = 1.0) -> Dict[str, float]:
    """What the CUDA kernels evaluate: the forward, or with ``backward`` the
    forward kernel plus the backward kernel; ``scale`` multiplies the pixels
    and the branch counts alike (k = 100 from a k = 5 run's branch mix)."""
    branches = {b: n * scale for b, n in branches.items()}
    pixels = int(pixels * scale)
    counts = mdl_cuda_transcendentals(branches, pixels, n_mix)
    if backward:
        for op, n in mdl_cuda_transcendentals(branches, pixels, n_mix, backward=True).items():
            counts[op] += n
    return counts


def head_parameters(cfg, batch: torch.Tensor, n_samples: int):
    """model05's head output on ``batch`` at initialisation: (x in [0, 1],
    the MoDL parameters ``[k, B, H, W, 10n]`` as the decoder hands them on)."""
    model = build_model(cfg.model, torch.Generator().manual_seed(cfg.train.seed),
                        batch.device)
    x = batch.float() / 255.0
    with torch.no_grad():
        _, _, pxz = model(x, n_samples, generator=torch.Generator(batch.device).manual_seed(0))
    return x, pxz.dist.parameters


def kernel_device_ms(fn: Callable[[], object], reps: int = 10) -> Dict[str, float]:
    """Device milliseconds per launch of each MoDL kernel that ``fn()``
    launches, from the profiler over ``reps`` calls after a warm-up."""
    fn()
    _, kernels = device_times(lambda: [fn() for _ in range(reps)])
    out = {}
    for name, (count, ms) in kernels.items():
        if "mdl_log_prob_backward_kernel" in name:
            out["backward"] = ms / count
        elif "mdl_log_prob_kernel" in name:
            out["forward"] = ms / count
    return out


def in_step_mixture_cost(spc: int = 10, n_iters: int = 5, n_repeats: int = 6) -> dict:
    """The step-level differential: the full model05 train step against the
    same step with the likelihood swapped for a single discretized logistic
    (whose decoder ends in the 50-channel conv plus a 6-channel head conv).
    The difference is the MoDL forward + backward inside the real program."""
    full = timed_train_step("model05", spc, n_iters, n_repeats)
    dl = timed_train_step("model05", spc, n_iters, n_repeats, model_over={"likelihood": "dl"})
    return {"full": full, "dl": dl, "mixture_ms": full["ms"] - dl["ms"],
            "mixture_busy_ms": full["busy_ms"] - dl["busy_ms"]}


def train_sfu_floor(step_seconds: float, repeats: int = 5):
    """(floor seconds, floor / step): model05's MoDL likelihood per optimizer
    step (``mdl_train_transcendentals``, the Pallas census at batch 128, k =
    5) priced at the loop kernel's measured per-op rates
    (``sfu_probe.measure_rates``), against a measured step time: the
    counterpart of ``bench.py``'s ``_vpu_floor``."""
    cfg = experiment("model05")
    counts = mdl_train_transcendentals(cfg.model, cfg.data.batch_size)
    floor = sfu_probe.sfu_floor_seconds(counts, sfu_probe.measure_rates(repeats=repeats))
    return floor, floor / step_seconds


def run(repeats: int = 5, spc: int = 10, n_iters: int = 5, n_repeats: int = 6,
        say: Callable[[str], None] = print) -> dict:
    """The whole roofline; prints as it goes and returns the numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline measures a CUDA card; torch.cuda.is_available() is False")
    out: dict = {}
    clock = sfu_probe.sm_clock_under_load()
    mufu = sfu_probe.mufu_per_eval()
    raw, rates = measured_rates(repeats=repeats)
    raw_big, rates_big = measured_rates(blocks=sfu_probe.CONTROL_BLOCKS, repeats=repeats)
    peak = sfu_probe.sfu_peak_per_second(clock) if clock else None
    say(f"probe geometry: {sfu_probe.DEFAULT_BLOCKS} blocks x {sfu_probe.BLOCK_THREADS} threads "
        f"x {sfu_probe.DEFAULT_CHAINS} chains (control {sfu_probe.CONTROL_BLOCKS} blocks); "
        f"SM clock under load {clock} MHz, special-function peak "
        f"{peak / 1e9 if peak else float('nan'):.1f} G results/s; re-ranging alone "
        f"{raw['none'] / 1e9:.1f} Geval/s")
    for op in sfu_probe.OPS:
        kinds = mufu.get(op) if mufu else None
        per_eval = sum(kinds.values()) if kinds is not None else None
        share = (f"{rates[op] * per_eval / peak:.1%} of the special-function peak at "
                 f"{per_eval:g} MUFU per evaluation {kinds}"
                 if peak and per_eval is not None else "MUFU count not measured")
        say(f"  {op:9s} {rates[op] / 1e9:8.2f} Geval/s (with re-ranging {raw[op] / 1e9:.2f}; "
            f"control {rates_big[op] / 1e9:.2f}); {share}")
    out.update(clock_mhz=clock, sfu_peak=peak, raw=raw, rates=rates, rates_control=rates_big,
               mufu_per_eval=mufu)

    out["sweep"] = plateau_sweep()
    for op, by_chains in out["sweep"].items():
        say(f"  {op} with re-ranging by chains per thread: "
            + ", ".join(f"{c}: {r / 1e9:.2f}" for c, r in by_chains.items()) + " Geval/s")

    check = additive_check(raw, repeats)
    say(f"  cascade (CDF-difference branch, {check['calls']}) measured "
        f"{check['measured'] / 1e9:.2f} Geval/s vs additive-model prediction "
        f"{check['predicted'] / 1e9:.2f} Geval/s: {check['ratio']:.0%} of predicted")
    out["additive"] = check

    cost = in_step_mixture_cost(spc, n_iters, n_repeats)
    cfg = cost["full"]["cfg"]
    batch_size, k, n_mix = cfg.data.batch_size, cfg.model.n_samples, cfg.model.n_mix
    h, w, _ = cfg.model.image_shape
    pixels = batch_size * k * h * w
    x, params = head_parameters(cfg, cost["full"]["batch"][0], k)
    branches = modl_branch_counts(x, params)
    say(f"model05 head at initialisation, batch {batch_size}, k = {k}: cascades by branch "
        f"{branches}")
    floors = {}
    for label, backward, scale in (("fwd k=5", False, 1.0), ("fwd k=100", False, 100.0 / k),
                                   ("fwd+bwd k=5", True, 1.0)):
        calls = cuda_counts(branches, pixels, n_mix, backward, scale)
        floors[label] = {
            "cuda": sfu_probe.sfu_floor_seconds(calls, rates) * 1e3,
            "pallas_census": sfu_probe.sfu_floor_seconds(
                pallas_counts(n_mix, int(pixels * scale), backward), rates) * 1e3,
            "mufu_bound": mufu_instructions(calls) / peak * 1e3 if peak else None}
        say(f"special-function floor {label}, B = {batch_size}: {floors[label]['cuda']:.4f} ms "
            f"at the measured rates for what the CUDA kernels evaluate (attainable with these "
            f"instruction sequences); {floors[label]['pallas_census']:.4f} ms for the Pallas "
            f"census (every branch evaluated); bound of the card "
            f"{floors[label]['mufu_bound'] if peak else float('nan'):.4f} ms "
            f"({mufu_instructions(calls):.4g} MUFU instructions over the special-function peak)")
    out.update(branches=branches, floors=floors)

    g = torch.ones(params.shape[:-1] + (1,), device=params.device)
    kernel_ms = kernel_device_ms(
        lambda: (mdl_kernel.mdl_log_prob(x, params), mdl_kernel.mdl_backward(x, params, g)))
    x100, params100 = head_parameters(cfg, cost["full"]["batch"][0], 100)
    kernel_ms["forward k=100"] = kernel_device_ms(
        lambda: mdl_kernel.mdl_log_prob(x100, params100), reps=5)["forward"]
    del params100
    fwd_bwd = kernel_ms["forward"] + kernel_ms["backward"]
    say(f"MoDL kernels on the device: forward k=5 {kernel_ms['forward']:.4f} ms "
        f"({floors['fwd k=5']['cuda'] / kernel_ms['forward']:.0%} of its floor reached), "
        f"forward k=100 {kernel_ms['forward k=100']:.4f} ms "
        f"({floors['fwd k=100']['cuda'] / kernel_ms['forward k=100']:.0%}), forward + backward "
        f"k=5 {fwd_bwd:.4f} ms ({floors['fwd+bwd k=5']['cuda'] / fwd_bwd:.0%})")
    out["kernel_ms"] = kernel_ms

    full, dl = cost["full"], cost["dl"]
    floor_step = floors["fwd+bwd k=5"]["cuda"]
    in_step = full["by_class"]["MoDL forward"] + full["by_class"]["MoDL backward"]

    def classes(part):
        return ", ".join(f"{cls} {ms:.3f}" for cls, ms in sorted(part["by_class"].items()))

    say(f"step-level ablation: full step {full['ms']:.3f} ms wall, {full['busy_ms']:.3f} ms "
        f"device busy ({full['imgs_per_s']:.0f} imgs/s; {classes(full)}); dl-head step "
        f"{dl['ms']:.3f} ms wall, {dl['busy_ms']:.3f} ms busy ({classes(dl)}); mixture "
        f"(full - dl_head) {cost['mixture_ms']:+.3f} ms wall, {cost['mixture_busy_ms']:+.3f} ms "
        f"busy, the dl-head step carrying a head conv of its own; the MoDL kernels take "
        f"{in_step:.4f} ms of the full step's device time: the floor {floor_step:.4f} ms is "
        f"{floor_step / in_step:.0%} of that and {floor_step / full['busy_ms']:.4f} of the step")
    out["step"] = {label: {key: value for key, value in part.items()
                           if key not in ("cfg", "batch")}
                   for label, part in (("full", full), ("dl", dl))}
    out["step"].update(mixture_ms=cost["mixture_ms"], mixture_busy_ms=cost["mixture_busy_ms"])
    return out


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False  # the float32 config means float32 convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    run()


if __name__ == "__main__":
    main()
