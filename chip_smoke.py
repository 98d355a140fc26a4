"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It uses ``vae_mdl_tpu_torch``, torch and numpy only, and fails (exit code
not 0, no result line) on the first phase that fails; there is no CPU path.

1. device: prints ``nvidia-smi``'s name and power limit; needs CUDA;
2. build: compiles ``vae_mdl_tpu_torch/csrc/mdl_log_prob.cu`` with nvcc;
3. the MoDL kernel against its plain PyTorch version on the card, at the
   four forward contracts of the TPU kernels it replaces (f32 and bf16
   parameters at k = 5 and k = 100 samples of a batch of 128), each in the
   NHWC-contiguous and the NCHW (conv output) layout, with kernel and plain
   times from CUDA events;
4. model05, float32 config, batch 128, k = 5: the IWAE bound through the
   kernel (``use_pallas=None``) and through the plain version
   (``use_pallas=False``) on the same weights and noise;
5. the main path: model05's 5000-importance-sample ``evaluate_llh`` on one
   batch of 128 images (k-chunks of 100), in the float32 config and in the
   bfloat16 production config, timed with CUDA events; a 200-sample
   evaluation through the kernel and through the plain version agrees per
   image. The kernel's launch count is set to 0 before this phase and read
   after it.

The last three lines: the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Weights are the port's own
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
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel

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
REPLACES = "vae_mdl_tpu/ops/pallas/mdl_kernel.py:227"


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
            dtype = "bf16" if "bfloat16" in line else "f32"
            used = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                    if "Used" in ln or "spill" in ln]
            say(f"ptxas n_mix=5 {dtype}: {'; '.join(used)}")


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
    phase_bound()

    mdl_kernel.launches = 0
    phase_eval(smi)
    launches = mdl_kernel.launches
    if launches < 1:
        raise AssertionError("the main path never launched the MoDL kernel")

    ms, plain_ms = times[f"K3f/K1f eval float32 k=100 B={BATCH} nchw"]
    say(json.dumps({"kernels": [{
        "name": "mdl_log_prob", "route": "cuda",
        "source": "vae_mdl_tpu_torch/csrc/mdl_log_prob.cu", "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
