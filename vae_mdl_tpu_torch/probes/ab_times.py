"""Times of the likelihood kernels, the channel sums and the 5000-IS
evaluations through the public wrappers alone, for comparing two checkouts
on one card.

What a change to the kernels is held to is often "no slower than the parent
commit": that comparison is only fair in one call, on one card, in turns.
This module calls nothing a checkout of the port since its MoDL backward got
a tile path lacks, so this file runs against whichever checkout's package
``PYTHONPATH`` names (run as a file, the current directory is not searched):

    PYTHONPATH=<old checkout> python vae_mdl_tpu_torch/probes/ab_times.py old
    PYTHONPATH=. python vae_mdl_tpu_torch/probes/ab_times.py new
    PYTHONPATH=. python vae_mdl_tpu_torch/probes/ab_times.py new
    PYTHONPATH=<old checkout> python vae_mdl_tpu_torch/probes/ab_times.py old

Each run prints one line a measurement and, last, one JSON object
``{"label": ..., "package": ..., "ms": {case: ms}, "imgs_per_s": {eval:
imgs/s}}``. Every case uses each checkout's own default memory path.
Measured:

- the MoDL forward at its four contracts (f32 / bf16, k = 5 / 100, batch 128,
  32 x 32, n_mix = 5), NHWC (the model's layout) and NCHW;
- the MoDL backward at its three contracts (f32 / bf16 at k = 5, bf16 at
  k = 100), NHWC and NCHW;
- the MoDL kernels' device time a launch on model05's own head output at
  initialisation, f32 and with the bf16 boundary (forward at k = 5 and 100,
  backward at k = 5), from the profiler;
- the channel sums of ``probes/kernel_isolate.py`` (P1 direct, P1 staged at
  a tile of 256) and ``kernel_isolate2.py`` (P2), with the library's sums;
- ``evaluate_llh`` at 5000 samples in k-chunks of 100 on one batch of 128
  of model05 and model03, float32 and bfloat16 configs, after a 200-sample
  warm-up: imgs/s from CUDA events.

Inputs come from seeded generators on the card, so two checkouts see the
same values.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

import vae_mdl_tpu_torch
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.ops.cuda import io_probe, mdl_kernel
from vae_mdl_tpu_torch.probes.kernel_isolate import probe_params
from vae_mdl_tpu_torch.probes.roofline import head_parameters, kernel_device_ms
from vae_mdl_tpu_torch.utils.timing import cuda_ms as _cuda_ms

BATCH, SIDE, N_MIX = 128, 32, 5
CONTRACTS = (("K1f/K1b", 5, torch.float32), ("K2f/K2b", 5, torch.bfloat16),
             ("K3f", 100, torch.float32), ("K4f/K4b", 100, torch.bfloat16))
BACKWARD = ("K1b", "K2b", "K4b")  # the backward's contracts among them


def cuda_ms(fn, reps: int) -> float:
    """The median of three ``cuda_ms`` runs: a process's first runs on a
    large operand can take many times as long."""
    return float(np.median([_cuda_ms(fn, reps) for _ in range(3)]))


def modl_inputs(k: int, dtype: torch.dtype, gen: torch.Generator):
    """x with 0 and 255 in it, MoDL parameters hitting every branch of the
    cascade (logscales below the -7 clamp, far-off locations, edge bins), a
    cotangent; parameters dense channel-minor."""
    x = torch.randint(0, 256, (BATCH, SIDE, SIDE, 3), generator=gen, device="cuda") / 255.0
    x[:, 0] = 0.0
    x[:, -1] = 1.0
    sub = (k, BATCH, SIDE, SIDE, N_MIX)

    def normal(mean, std):
        return torch.randn(sub, generator=gen, device="cuda") * std + mean

    groups = [normal(0.0, 2.0)]
    for _ in range(3):
        far = (torch.rand(sub, generator=gen, device="cuda") < 0.2).float()
        low = torch.rand(sub, generator=gen, device="cuda") < 0.1
        logscale = torch.where(low, torch.full(sub, -9.0, device="cuda"), normal(-3.0, 1.0))
        groups += [normal(0.0, 0.5) + 4.0 * far, logscale, normal(0.0, 1.0)]
    p = torch.cat(groups, dim=-1).to(dtype)
    g = torch.randn((k, BATCH, SIDE, SIDE, 1), generator=gen, device="cuda")
    return x.float(), p, g


def nchw(p: torch.Tensor) -> torch.Tensor:
    """``[k, B, H, W, C]`` with the strides of an NCHW conv output."""
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def kernel_times(say) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {}
    for contract, k, dtype in CONTRACTS:
        x, p, g = modl_inputs(k, dtype, gen)
        for layout, params in (("nhwc", p), ("nchw", nchw(p))):
            tag = f"{dtype}".split(".")[1] + f" k={k} {layout}"
            with torch.inference_mode():
                ms[f"forward {tag}"] = cuda_ms(lambda: mdl_kernel.mdl_log_prob(x, params), 20)
            if any(c in contract for c in BACKWARD):
                ms[f"backward {tag}"] = cuda_ms(lambda: mdl_kernel.mdl_backward(x, params, g),
                                                5 if k > 5 else 20)
            # a checkout without a forward tile path takes the direct one
            paths = (getattr(mdl_kernel, "forward_path", lambda _: "direct")(params),
                     mdl_kernel.backward_path(params, torch.empty_like(params)))
            say(f"{tag}: forward {ms[f'forward {tag}']:.4f} ms" +
                (f", backward {ms[f'backward {tag}']:.4f} ms" if f"backward {tag}" in ms else "")
                + f" (paths: forward {paths[0]}, backward {paths[1]})")
            del params
        del x, p, g
    torch.cuda.empty_cache()

    params = probe_params("channel_minor")
    ms["P1 direct"] = cuda_ms(lambda: io_probe.channel_sum(params, path="direct"), 5)
    ms["P1 staged tile=256"] = cuda_ms(lambda: io_probe.channel_sum(params, path="staged"), 5)
    ms["library sum(-1)"] = cuda_ms(lambda: params.sum(-1), 5)
    del params
    params = probe_params("channel_first")
    ms["P2 direct"] = cuda_ms(lambda: io_probe.channel_sum(params, "channel_first"), 5)
    ms["library sum(1)"] = cuda_ms(lambda: params.sum(1), 5)
    del params
    torch.cuda.empty_cache()
    say(", ".join(f"{case} {t:.4f} ms" for case, t in ms.items() if "P" in case or "sum" in case))
    return ms


def model_device_ms(say) -> dict:
    """Device milliseconds a launch of the MoDL kernels on model05's own head
    output at initialisation (batch 128; ``probes/roofline.py``), float32 and
    with the bf16 boundary: the forward at k = 5 and 100, the backward at
    k = 5."""
    batch = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (BATCH, 32, 32, 3), dtype=np.uint8), device="cuda")
    ms = {}
    base = MODELS["model05"]
    for which, cfg in (("f32", base), ("bf16", dataclasses.replace(
            base, compute_dtype="bfloat16", likelihood_io_dtype="bfloat16"))):
        for k in (5, 100):
            x, params = head_parameters(experiment("model05", model=cfg), batch, k)
            g = torch.ones(params.shape[:-1] + (1,), device="cuda")
            if k == 5:
                got = kernel_device_ms(lambda: (mdl_kernel.mdl_log_prob(x, params),
                                                mdl_kernel.mdl_backward(x, params, g)))
                ms[f"device backward model05 {which} k={k}"] = got["backward"]
            else:
                got = kernel_device_ms(lambda: mdl_kernel.mdl_log_prob(x, params), reps=5)
            ms[f"device forward model05 {which} k={k}"] = got["forward"]
            say(f"model05 head {which} {params.dtype} k={k} strides {params.stride()}: device "
                + ", ".join(f"{kind} {t:.4f} ms" for kind, t in got.items()))
            del x, params, g
    return ms


def eval_rates(say) -> dict:
    images = np.random.default_rng(0).integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    rates = {}
    for name in ("model05", "model03"):
        base = MODELS[name]
        io_dtype = "bfloat16" if base.likelihood == "mdl" else None
        for which, cfg in (("f32", base), ("bf16", dataclasses.replace(
                base, compute_dtype="bfloat16", likelihood_io_dtype=io_dtype))):
            model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
            ecfg = experiment(name, model=cfg)
            evaluate_llh(model, ecfg, images, n_samples=200, k_chunk=100, batch_size=BATCH)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            llh, _, _ = evaluate_llh(model, ecfg, images, n_samples=5000, k_chunk=100,
                                     batch_size=BATCH, seed=1)
            end.record()
            end.synchronize()
            rates[f"{name} {which}"] = BATCH / (start.elapsed_time(end) / 1e3)
            say(f"{name} 5000-IS {which}: {rates[f'{name} {which}']:.2f} imgs/s (llh {llh:.4f})")
            del model
    return rates


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        raise RuntimeError("the probe times a CUDA card; torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    package = str(vae_mdl_tpu_torch.__path__[0])
    print(f"{argv[1]}: {package} on {torch.cuda.get_device_name(0)}", flush=True)
    ms = kernel_times(lambda line: print(f"{argv[1]}: {line}", flush=True))
    ms.update(model_device_ms(lambda line: print(f"{argv[1]}: {line}", flush=True)))
    rates = eval_rates(lambda line: print(f"{argv[1]}: {line}", flush=True))
    print(json.dumps({"label": argv[1], "package": package, "ms": ms, "imgs_per_s": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
