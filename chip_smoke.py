"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It uses ``vae_mdl_tpu_torch``, torch and numpy only, and fails (exit code
not 0, no result line) on the first phase that fails; there is no CPU path
and nothing falls back to a plain version.

1. device: prints ``nvidia-smi``'s name and power limit; needs CUDA;
2. build: compiles ``vae_mdl_tpu_torch/csrc/mdl_log_prob.cu`` with nvcc and
   prints ptxas's registers and spills of the forward and the backward
   kernel at n_mix = 5;
3. the forward kernel against its plain PyTorch version on the card, at the
   four forward contracts of the TPU kernels it replaces (f32 and bf16
   parameters at k = 5 and k = 100 samples of a batch of 128), each in the
   NHWC-contiguous and the NCHW (conv output) layout, with kernel and plain
   times from CUDA events;
4. the backward kernel at the three backward contracts (f32 and bf16 at
   k = 5, bf16 at k = 100; batch 128), both layouts: against the analytic
   plain version element by element, and against autograd of the plain
   forward by the float64-accuracy rule; CUDA-event times of the backward
   alone (kernel vs plain) and of forward + backward (through the kernels vs
   autograd of the plain version);
5. model05, float32 config, batch 128, k = 5: the IWAE bound through the
   kernel (``use_pallas=None``) and through the plain version
   (``use_pallas=False``) on the same weights and noise;
6. one model05 train step's loss and gradients through the kernels and
   through the plain version, from one state, batch and noise;
7. the main paths, each with the launch counts set to 0 just before it and
   read just after: (a) model05's 5000-importance-sample ``evaluate_llh`` on
   one batch of 128 images (k-chunks of 100), in the float32 config and the
   bfloat16 production config, timed with CUDA events, and a 200-sample
   evaluation through the kernel and the plain version agreeing per image;
   (b) model05 training at batch 128, k = 5, through
   ``make_multi_train_step`` with 10 steps per call on seeded synthetic
   uint8 images, in both configs through the kernels and in float32 through
   the plain version: the median imgs/s of 5 timed calls after a warm-up,
   the peak memory, and a finite loss that falls;
8. a ``torch.profiler`` breakdown of device time by kernel class over 5
   train steps of each config.

The last three lines: the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. In the record, the backward's
``max_abs_err`` is over its float32 contract; ``max_abs_err_bf16`` (one bf16
ulp of gradients of a few hundred) is over the bf16 ones, and
``tolerance_excess``, the largest |kernel - plain| less its per-element
tolerance over all cases, is at most 0. Weights are the port's own
glorot-uniform init from a seed; no checkpoint or dataset is read.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
from vae_mdl_tpu_torch.models.losses import iwae_loss
from vae_mdl_tpu_torch.models.objective import training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_multi_train_step, make_train_step

SEED = 0
BATCH = 128
N_MIX = 5
# Kernel vs plain version, per pixel: |kernel - plain| <= ATOL + RTOL * |plain|.
# Both evaluate the same float32 formula with the same libdevice functions
# and no fused multiply-adds; they differ in the order of the two
# logsumexps' sums, which moves an O(1) value by a few ulps (ATOL), and
# far-off locations give values up to ~1e4 nats whose float32 spacing is
# ~1e-3 (RTOL).
ATOL, RTOL = 2e-4, 1e-5
# The model05 bound and per-image log-likelihoods sum 3072 such per-pixel
# terms: relative tolerance on the sum.
SUM_RTOL = 1e-5
# Backward kernel vs its analytic plain version, per element:
# |kernel - plain| <= BWD_ATOL + BWD_RTOL[dtype] * |plain|. Same float32
# formula, same libdevice functions, no fused multiply-adds; the two
# softmaxes sum in another order, which moves each gradient by a few float32
# ulps (RTOL f32) and d logits = g * (s - softmax(logits)), a difference of
# O(1) terms, by a few ulps of 1 (ATOL). A bf16 gradient rounds once more:
# one bf16 ulp is 2^-8 of the value (RTOL bf16).
BWD_ATOL = 2e-5
BWD_RTOL = {torch.float32: 2e-4, torch.bfloat16: 8e-3}
# Against autograd of the plain forward (different formulas, so no
# per-element bound): the kernel's RMS error against a float64 autograd
# truth is at most 1.2x that of float32 autograd rounded to the same dtype,
# elements at a clamp's tie (raw logscale exactly -7) left out: there the
# kernel passes 0 and autograd half the gradient.
F64_RATIO = 1.2
# One train step, kernel vs plain: the loss within SUM_RTOL, each parameter
# gradient within GRAD_RTOL of the plain one in norm. The analytic and the
# autograd MoDL gradients differ in float32 rounding, most where a CDF
# difference cancels; summed through the decoder's backward this measured
# 6.6e-5 on decoder.Dense_0.weight (H100, cuDNN deterministic), the largest
# of all leaves; the bound is 3x that.
GRAD_RTOL = 2e-4
REPLACES = "vae_mdl_tpu/ops/pallas/mdl_kernel.py:227"
REPLACES_BACKWARD = "vae_mdl_tpu/ops/pallas/mdl_kernel.py:334"
TRAIN_STEPS_PER_CALL = 10
TRAIN_BLOCKS = 5


def say(line: str) -> None:
    print(line, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events around the whole run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")
    # the float32 config means float32 convolutions: cuDNN defaults to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build() -> None:
    fresh = not mdl_kernel.library_path().exists()
    t0 = time.perf_counter()
    lib = mdl_kernel.build()
    seconds = time.perf_counter() - t0
    say(f"build: {seconds:.1f} s ({'compiled' if fresh else 'found'} {lib.name})")
    lines = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "Li5E" in line:
            entry = "backward" if "backward_kernel" in line else "forward"
            dtype = "bf16" if "bfloat16" in line else "f32"
            used = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                    if "Used" in ln or "spill" in ln]
            say(f"ptxas {entry} n_mix=5 {dtype}: {'; '.join(used)}")


def modl_inputs(k: int, dtype: torch.dtype, nchw: bool, gen: torch.Generator):
    """x ``[B, 32, 32, 3]`` with 0 and 255 in it; MoDL parameters hitting
    every branch: logscales below the -7 clamp, far-off locations (the PDF *
    width approximation), edge bins."""
    dev = gen.device
    x = torch.randint(0, 256, (BATCH, 32, 32, 3), generator=gen, device=dev).float() / 255.0
    x[:, 0, :, :] = 0.0
    x[:, -1, :, :] = 1.0
    sub = (k, BATCH, 32, 32, N_MIX)

    def normal(mean, std):
        return torch.randn(sub, generator=gen, device=dev) * std + mean

    groups = [normal(0.0, 2.0)]  # mixture logits
    for _ in range(3):
        far = (torch.rand(sub, generator=gen, device=dev) < 0.2).float()
        low = torch.rand(sub, generator=gen, device=dev) < 0.1
        loc = normal(0.0, 0.5) + 4.0 * far
        logscale = torch.where(low, torch.full(sub, -9.0, device=dev), normal(-3.0, 1.0))
        groups += [loc, logscale, normal(0.0, 1.0)]
    p = torch.cat(groups, dim=-1).to(dtype)  # [k, B, H, W, 10n] contiguous
    if nchw:  # the head conv's layout: channels before H, W
        p = p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    return x, p


def phase_kernel_vs_plain():
    """-> (max |kernel - plain| over all cases, {case: (ms, plain_ms)})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, times = 0.0, {}
    for contract, k, dtype in (("K1f", 5, torch.float32), ("K2f", 5, torch.bfloat16),
                               ("K3f/K1f eval", 100, torch.float32),
                               ("K4f", 100, torch.bfloat16)):
        for nchw in (False, True):
            x, p = modl_inputs(k, dtype, nchw, gen)
            with torch.inference_mode():
                got = mdl_kernel.mdl_log_prob(x, p)
                want = mixture_log_prob(x, p.float())
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.float32:
                    raise AssertionError(f"{contract}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{contract}: non-finite kernel output")
                err = (got - want).abs()
                excess = float((err - (ATOL + RTOL * want.abs())).max())
                max_err = float(err.max())
                ms = cuda_ms(lambda: mdl_kernel.mdl_log_prob(x, p), 20)
                plain_ms = cuda_ms(lambda: mixture_log_prob(x, p.float()), 5)
            layout = "nchw" if nchw else "nhwc"
            name = f"{contract} {str(dtype).split('.')[1]} k={k} B={BATCH} {layout}"
            say(f"kernel {name}: max|d|={max_err:.3e} (tolerance excess {excess:.3e}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if excess > 0:
                raise AssertionError(f"{name}: kernel and plain version differ beyond tolerance")
            worst = max(worst, max_err)
            times[name] = (ms, plain_ms)
            del x, p, got, want, err
    return worst, times


def _autograd_grad(x, p, g, dtype):
    """Autograd of the plain forward: d(sum g * mixture_log_prob(x, p))/dp,
    all in ``dtype``."""
    leaf = p.detach().to(dtype).requires_grad_(True)
    (grad,) = torch.autograd.grad(mixture_log_prob(x.to(dtype), leaf), leaf, g.to(dtype))
    return grad


def _at_ties(p):
    """Parameters at a clamp's tie: raw logscales of exactly -7."""
    n = p.shape[-1] // 10
    tie = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    for lo in (2 * n, 5 * n, 8 * n):
        tie[..., lo:lo + n] = p[..., lo:lo + n].float() == -7.0
    return tie


def phase_backward():
    """-> ({dtype: max |kernel - plain|}, the largest excess over the
    per-element tolerance (at most 0), {case: (ms, plain_ms)})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, worst_excess, times = {}, -float("inf"), {}
    for contract, k, dtype in (("K1b/K3b", 5, torch.float32), ("K2b", 5, torch.bfloat16),
                               ("K4b", 100, torch.bfloat16)):
        for nchw in (False, True):
            layout = "nchw" if nchw else "nhwc"
            name = f"{contract} {str(dtype).split('.')[1]} k={k} B={BATCH} {layout}"
            x, p = modl_inputs(k, dtype, nchw, gen)
            g = torch.randn((k, BATCH, 32, 32, 1), generator=gen, device="cuda")
            got = mdl_kernel.mdl_backward(x, p, g)
            want = mdl_kernel.mdl_backward_plain(x, p, g)
            torch.cuda.synchronize()
            if got.dtype != p.dtype or got.shape != p.shape or got.stride() != p.stride():
                raise AssertionError(f"{name}: gradient {got.dtype} {tuple(got.stride())}, "
                                     f"parameters {p.dtype} {tuple(p.stride())}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite gradient")
            err = (got.float() - want.float()).abs()
            excess = float((err - (BWD_ATOL + BWD_RTOL[dtype] * want.float().abs())).max())
            max_err = float(err.max())
            del want, err

            # the float64-accuracy rule, on at most 10 samples of k
            ks = slice(0, min(k, 10))
            truth = _autograd_grad(x, p[ks], g[ks], torch.float64)
            ref = _autograd_grad(x, p[ks], g[ks], torch.float32).to(dtype)
            keep = ~_at_ties(p[ks])

            def rms(grad):
                return float(((grad.double() - truth)[keep] ** 2).mean().sqrt())

            rms_kernel, rms_ref = rms(got[ks]), rms(ref)
            del truth, ref

            def fwd_bwd_kernel():
                leaf = p.detach().requires_grad_(True)
                return torch.autograd.grad(mdl_kernel.mdl_log_prob(x, leaf), leaf, g)

            def fwd_bwd_plain():
                leaf = p.detach().requires_grad_(True)
                return torch.autograd.grad(mixture_log_prob(x, leaf.float()), leaf, g)

            reps = 3 if k > 5 else 10
            ms = cuda_ms(lambda: mdl_kernel.mdl_backward(x, p, g), 20)
            plain_ms = cuda_ms(lambda: mdl_kernel.mdl_backward_plain(x, p, g), reps)
            fb_ms = cuda_ms(fwd_bwd_kernel, 20)
            fb_plain_ms = cuda_ms(fwd_bwd_plain, reps)
            say(f"backward {name}: max|d|={max_err:.3e} (tolerance excess {excess:.3e}); "
                f"rms vs f64 kernel {rms_kernel:.3e} autograd {rms_ref:.3e} "
                f"({int((~keep).sum())} ties left out); backward kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms; fwd+bwd kernels {fb_ms:.4f} ms, "
                f"autograd of plain {fb_plain_ms:.4f} ms")
            if excess > 0:
                raise AssertionError(f"{name}: backward kernel and plain version differ beyond tolerance")
            if rms_kernel > F64_RATIO * rms_ref + 1e-9:
                raise AssertionError(f"{name}: backward kernel less accurate than autograd")
            key = str(dtype).split('.')[1]
            worst[key] = max(worst.get(key, 0.0), max_err)
            worst_excess = max(worst_excess, excess)
            times[name] = (ms, plain_ms)
            del x, p, g, got
    torch.cuda.empty_cache()
    return worst, worst_excess, times


def seeded_model(cfg):
    model = build_model(cfg, torch.Generator().manual_seed(SEED))
    return model.to("cuda").eval()


def images(n: int) -> np.ndarray:
    return np.random.default_rng(SEED).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def phase_bound() -> None:
    cfg = MODELS["model05"]
    kernel_model = seeded_model(cfg)
    plain_model = seeded_model(dataclasses.replace(cfg, use_pallas=False))
    x = torch.as_tensor(images(BATCH), device="cuda").float() / 255.0
    eps = torch.randn((cfg.n_samples, BATCH, cfg.n_latent),
                      generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    results = {}
    for name, model in (("kernel", kernel_model), ("plain", plain_model)):
        before = mdl_kernel.launches
        with torch.inference_mode():
            Qs, _, pxz = model(x, cfg.n_samples, eps=eps)
            loss, metrics = iwae_loss(x, Qs[0].z, prior_for(cfg, "cuda"), Qs[0].dist, pxz.dist)
        results[name] = (float(loss), metrics["lpxz"].double(), mdl_kernel.launches - before)
    (loss_k, lpxz_k, n_k), (loss_p, lpxz_p, n_p) = results["kernel"], results["plain"]
    lpxz_rel = float(((lpxz_k - lpxz_p).abs() / lpxz_p.abs()).max())
    say(f"model05 f32 bound k={cfg.n_samples} B={BATCH}: -iwae kernel {loss_k:.6f}, "
        f"plain {loss_p:.6f}, max rel lpxz diff {lpxz_rel:.3e}, kernel launches {n_k}/{n_p}")
    if not np.isfinite(loss_k) or abs(loss_k - loss_p) > SUM_RTOL * abs(loss_p) or lpxz_rel > SUM_RTOL:
        raise AssertionError("model05 bound: kernel and plain version disagree")
    if n_k < 1 or n_p != 0:
        raise AssertionError(f"model05 bound: kernel launched {n_k} times, plain path {n_p}")


def phase_train_step_check() -> None:
    """One model05 f32 train step, through the kernels and through the plain
    version, from one state, batch and noise: the loss and each parameter's
    gradient, then the whole step."""
    base = MODELS["model05"]
    batch = torch.as_tensor(images(BATCH), device="cuda")
    x = batch.float() / 255.0
    eps = torch.randn((base.n_samples, BATCH, base.n_latent),
                      generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same conv algorithms in both runs
    results = {}
    for name, use in (("kernel", None), ("plain", False)):
        cfg = experiment("model05", model=dataclasses.replace(base, use_pallas=use))
        model = seeded_model(cfg.model)
        state = create_train_state(model, cfg.train)
        before = mdl_kernel.backward_launches
        loss_fn = training_loss_fn(model, cfg, prior_for(cfg.model, "cuda"), x,
                                   cfg.model.n_samples, eps=eps)
        loss, _ = loss_fn(state.params)
        grads = torch.autograd.grad(loss, list(state.params.values()))
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        state, metrics = step(state, batch, eps=eps)
        torch.cuda.synchronize()
        results[name] = (float(loss.detach()), dict(zip(state.params, grads)),
                         float(metrics["loss"]),
                         mdl_kernel.backward_launches - before)
    torch.backends.cudnn.deterministic = deterministic
    (loss_k, grads_k, step_k, n_k), (loss_p, grads_p, step_p, n_p) = results["kernel"], results["plain"]
    rel = {name: float((grads_k[name] - grads_p[name]).norm() / grads_p[name].norm())
           for name in grads_p}
    leaf = max(rel, key=rel.get)
    say(f"model05 f32 train step k=5 B={BATCH}: loss kernel {loss_k:.6f}, plain {loss_p:.6f} "
        f"(step {step_k:.6f} / {step_p:.6f}); max norm-relative gradient diff {rel[leaf]:.3e} "
        f"({leaf}); backward kernel launches {n_k}/{n_p}")
    for a, b in ((loss_k, loss_p), (step_k, step_p), (loss_k, step_k)):
        if not np.isfinite(a) or abs(a - b) > SUM_RTOL * abs(b):
            raise AssertionError("model05 train step: kernel and plain losses disagree")
    if rel[leaf] > GRAD_RTOL:
        raise AssertionError(f"model05 train step: {leaf} gradients differ beyond tolerance")
    if n_k < 1 or n_p != 0:
        raise AssertionError(f"model05 train step: backward kernel launched {n_k} times, plain {n_p}")


def train_configs():
    base = MODELS["model05"]
    return {
        "f32": base,
        "bf16": dataclasses.replace(base, compute_dtype="bfloat16",
                                    likelihood_io_dtype="bfloat16"),
        "f32 plain": dataclasses.replace(base, use_pallas=False),
    }


def train_pool() -> torch.Tensor:
    """One call's worth of seeded synthetic uint8 batches, on the card."""
    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.integers(0, 256, (TRAIN_STEPS_PER_CALL, BATCH, 32, 32, 3),
                                        dtype=np.uint8), device="cuda")


def phase_train(smi: str):
    """The main path of training. -> {config: imgs/s}."""
    pool = train_pool()
    rates = {}
    for name, mcfg in train_configs().items():
        cfg = experiment("model05", model=mcfg)
        model = seeded_model(mcfg)
        state = create_train_state(model, cfg.train)
        multi = make_multi_train_step(model, cfg, make_optimizer(cfg.train), TRAIN_STEPS_PER_CALL)
        state, metrics = multi(state, pool)  # warm-up
        first = float(metrics["loss"])
        torch.cuda.reset_peak_memory_stats()
        block_ms = []
        for _ in range(TRAIN_BLOCKS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = multi(state, pool)
            end.record()
            end.synchronize()
            block_ms.append(start.elapsed_time(end))
        last = float(metrics["loss"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        rates[name] = TRAIN_STEPS_PER_CALL * BATCH / (float(np.median(block_ms)) / 1e3)
        say(f"model05 train {name} k=5 B={BATCH}: {rates[name]:.1f} imgs/s (median of "
            f"{TRAIN_BLOCKS} calls of {TRAIN_STEPS_PER_CALL} steps: "
            f"{', '.join(f'{ms:.2f}' for ms in block_ms)} ms; peak {peak:.2f} GiB); "
            f"loss {first:.4f} after {TRAIN_STEPS_PER_CALL} steps, {last:.4f} after "
            f"{(TRAIN_BLOCKS + 1) * TRAIN_STEPS_PER_CALL} on {smi}")
        if not (np.isfinite(first) and np.isfinite(last)) or last >= first:
            raise AssertionError(f"model05 train {name}: loss {first} -> {last} is not finite and falling")
        if state.step != (TRAIN_BLOCKS + 1) * TRAIN_STEPS_PER_CALL:
            raise AssertionError(f"model05 train {name}: state at step {state.step}")
    return rates


def _kernel_class(name: str) -> str:
    if "mdl_log_prob_backward_kernel" in name:
        return "MoDL backward"
    if "mdl_log_prob_kernel" in name:
        return "MoDL forward"
    lowered = name.lower()
    # cuDNN's algorithms include FFTs, filter flips and layout transposes
    if any(t in lowered for t in ("conv", "gemm", "cudnn", "xmma", "cutlass", "wgrad", "dgrad",
                                  "fft", "flip_filter", "region_transform")):
        return "conv/gemm"
    if "multi_tensor" in lowered or "foreach" in lowered:
        return "optimizer"
    return "elementwise"


def phase_profile() -> None:
    """Device time by kernel class over 5 train steps of each config."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pool = train_pool()
    for name, mcfg in train_configs().items():
        if name == "f32 plain":
            continue
        cfg = experiment("model05", model=mcfg)
        model = seeded_model(mcfg)
        state = create_train_state(model, cfg.train)
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        for batch in pool[:2]:
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in pool[:5]:
                state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_class: dict = {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                cls = _kernel_class(evt.key)
                by_class[cls] = by_class.get(cls, 0.0) + evt.self_device_time_total / 1e3
        busy = sum(by_class.values())
        if busy <= 0:
            raise AssertionError(f"profile {name}: no device time recorded")
        shares = ", ".join(f"{cls} {ms:.3f} ms ({ms / busy:.1%})"
                           for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]))
        say(f"profile model05 train {name}, 5 steps: wall {wall_ms:.3f} ms (traced), "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}; {shares}")


def phase_eval(smi: str):
    """The main path. -> {config: imgs/s}."""
    batch = images(BATCH)
    rates = {}
    base = MODELS["model05"]
    configs = {
        "f32": base,
        "bf16": dataclasses.replace(base, compute_dtype="bfloat16",
                                    likelihood_io_dtype="bfloat16"),
    }
    for name, cfg in configs.items():
        model = seeded_model(cfg)
        ecfg = experiment("model05", model=cfg)
        llh, per_image, metrics = evaluate_llh(model, ecfg, batch, n_samples=5000,
                                               k_chunk=100, batch_size=BATCH, seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        llh2, _, metrics2 = evaluate_llh(model, ecfg, batch, n_samples=5000, k_chunk=100,
                                         batch_size=BATCH, seed=SEED + 1)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        rates[name] = BATCH / seconds
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"model05 5000-IS {name}: llh {llh:.4f} nats, bpd {metrics['bpd']:.6f} "
            f"(seed {SEED + 1}: llh {llh2:.4f}); {rates[name]:.2f} imgs/s "
            f"({seconds:.3f} s per batch of {BATCH}, peak {peak:.1f} GiB) on {smi}")
        values = [llh, metrics["bpd"], llh2, metrics2["bpd"]]
        if not (np.isfinite(values).all() and np.isfinite(per_image).all()):
            raise AssertionError(f"model05 5000-IS {name}: non-finite result")
        if per_image.shape != (BATCH,):
            raise AssertionError(f"model05 5000-IS {name}: per-image shape {per_image.shape}")

    # the same 200-sample evaluation through the kernel and the plain version
    plain_cfg = dataclasses.replace(base, use_pallas=False)
    got = evaluate_llh(seeded_model(base), experiment("model05"), batch, n_samples=200,
                       k_chunk=100, batch_size=BATCH, seed=SEED)[1]
    want = evaluate_llh(seeded_model(plain_cfg), experiment("model05", model=plain_cfg),
                        batch, n_samples=200, k_chunk=100, batch_size=BATCH, seed=SEED)[1]
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    say(f"model05 200-IS f32 kernel vs plain: max rel per-image diff {rel:.3e}")
    if rel > SUM_RTOL:
        raise AssertionError("model05 evaluator: kernel and plain version disagree")
    return rates


def main() -> None:
    smi = phase_device()
    phase_build()
    max_err, times = phase_kernel_vs_plain()
    bwd_err, bwd_excess, bwd_times = phase_backward()
    phase_bound()
    phase_train_step_check()

    mdl_kernel.launches = mdl_kernel.backward_launches = 0
    phase_eval(smi)
    say(f"eval main path: forward kernel launches {mdl_kernel.launches}")
    if mdl_kernel.launches < 1:
        raise AssertionError("the eval path never launched the MoDL forward kernel")

    mdl_kernel.launches = mdl_kernel.backward_launches = 0
    phase_train(smi)
    launches, backward_launches = mdl_kernel.launches, mdl_kernel.backward_launches
    say(f"train main path: forward kernel launches {launches}, backward {backward_launches}")
    if launches < 1 or backward_launches < 1:
        raise AssertionError("the train path did not launch both MoDL kernels")
    phase_profile()

    ms, plain_ms = times[f"K3f/K1f eval float32 k=100 B={BATCH} nchw"]
    bwd_ms, bwd_plain_ms = bwd_times[f"K1b/K3b float32 k=5 B={BATCH} nchw"]
    say(json.dumps({"kernels": [
        {"name": "mdl_log_prob", "route": "cuda",
         "source": "vae_mdl_tpu_torch/csrc/mdl_log_prob.cu", "replaces": REPLACES,
         "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms},
        {"name": "mdl_log_prob_backward", "route": "cuda",
         "source": "vae_mdl_tpu_torch/csrc/mdl_log_prob.cu", "replaces": REPLACES_BACKWARD,
         "launches": backward_launches, "max_abs_err": bwd_err["float32"],
         "max_abs_err_bf16": bwd_err["bfloat16"], "tolerance_excess": bwd_excess,
         "ms": bwd_ms, "plain_ms": bwd_plain_ms},
    ]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
