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
  backward at k = 5), from the profiler and from a replayed CUDA graph (the
  steadier of the two);
- the channel sums of ``probes/kernel_isolate.py`` (P1 direct, P1 staged)
  and ``kernel_isolate2.py`` (P2), with the library's sums;
- the null-body MoDL forward (P3 fwd, ``ops/cuda/mdl_null.py``), both
  variants, f32 and bf16 at k = 5 and 100, NHWC, on the device (a replayed
  CUDA graph);
- the discretized-logistic pair on the halves of a channels-last head (the
  model's layout): the forward at k = 5 and 100 and the backward at k = 5,
  on branch-heavy inputs (``chip_smoke.py``'s) and on model03's own head
  output at initialisation, per wrapper call (CUDA events) and on the device
  (a replayed CUDA graph); forward + backward with the head as the leaf, as
  the model differentiates it: device kernels a call and their device ms;
- five model03 float32 train steps under the profiler: device kernels,
  device busy and the DL kernels' device ms a step;
- the train step as users take it (``train_rates``): ``make_multi_train_step``
  through ``utils/timing.py``'s ``setup_scanned_step`` and
  ``time_scanned_step`` for model05 and model03 in float32 and bfloat16 (batch
  128, k = 5, 10 steps a call) and model01 at 100 steps a call: imgs/s
  (median, min and sd of the timed blocks), and one traced call for the
  device's busy ms a step, its idle share and the host's calls that put work
  on the card (kernel launches, graph launches, copies, fills) a step; and
  ``Trainer(cfg).fit()`` on model05 float32 at 1 and 10 steps a call: the
  imgs/s of its throughput windows (``Perf`` in ``metrics.jsonl``) after the
  first;
- ``evaluate_llh`` at 5000 samples in k-chunks of 100 on one batch of 128
  of model05 and model03, float32 and bfloat16 configs, and model03's
  through the plain likelihood too (``use_pallas=False``, the control of
  what the kernels buy there), after a 200-sample warm-up: imgs/s from CUDA
  events.

Inputs come from seeded generators on the card, so two checkouts see the
same values. A third argument ``train`` measures the train step alone:

    PYTHONPATH=<old checkout> python vae_mdl_tpu_torch/probes/ab_times.py old train
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
from vae_mdl_tpu_torch.ops.cuda import dl_kernel, io_probe, mdl_kernel, mdl_null
from vae_mdl_tpu_torch.probes.kernel_isolate import probe_params
from vae_mdl_tpu_torch.probes.roofline import head_parameters, kernel_device_ms
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step
from vae_mdl_tpu_torch.utils.timing import cuda_ms as _cuda_ms
from vae_mdl_tpu_torch.utils.timing import device_times, graph_ms, kernel_class

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
    ms["P1 staged"] = cuda_ms(lambda: io_probe.channel_sum(params, path="staged"), 5)
    ms["library sum(-1)"] = cuda_ms(lambda: params.sum(-1), 5)
    del params
    params = probe_params("channel_first")
    ms["P2 direct"] = cuda_ms(lambda: io_probe.channel_sum(params, "channel_first"), 5)
    ms["library sum(1)"] = cuda_ms(lambda: params.sum(1), 5)
    del params
    torch.cuda.empty_cache()
    say(", ".join(f"{case} {t:.4f} ms" for case, t in ms.items() if "P" in case or "sum" in case))
    return ms


def null_forward_ms(say) -> dict:
    """P3's null forward, ``dma`` and ``staged``, on the device at the MoDL
    forward's contracts (f32 and bf16, k = 5 and 100), NHWC."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    ms = {}
    for _, k, dtype in CONTRACTS:
        x, p, _ = modl_inputs(k, dtype, gen)
        tag = f"{dtype}".split(".")[1] + f" k={k} nhwc"
        for variant in ("dma", "staged"):
            ms[f"P3 forward {variant} device {tag}"] = float(np.median([graph_ms(
                lambda: mdl_null.mdl_null_forward(x, p, variant), 20) for _ in range(3)]))
        say(f"P3 forward {tag}: device " + ", ".join(
            f"{v} {ms[f'P3 forward {v} device {tag}']:.4f} ms" for v in ("dma", "staged")))
        del x, p
    torch.cuda.empty_cache()
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
                got["backward, graph"] = ms[f"graph backward model05 {which} k={k}"] = float(
                    np.median([graph_ms(lambda: mdl_kernel.mdl_backward(x, params, g), 20)
                               for _ in range(3)]))
            else:
                got = kernel_device_ms(lambda: mdl_kernel.mdl_log_prob(x, params), reps=5)
            ms[f"device forward model05 {which} k={k}"] = got["forward"]
            with torch.inference_mode():
                got["forward, graph"] = ms[f"graph forward model05 {which} k={k}"] = float(
                    np.median([graph_ms(lambda: mdl_kernel.mdl_log_prob(x, params),
                                        20 if k == 5 else 5) for _ in range(3)]))
            say(f"model05 head {which} {params.dtype} k={k} strides {params.stride()}: device "
                + ", ".join(f"{kind} {t:.4f} ms" for kind, t in got.items()))
            del x, params, g
    return ms


DL_BIN = (0.0, 1.0, 1.0 / 255.0)  # model03's head: 256 levels on [0, 1]


def dl_head_inputs(k: int, gen: torch.Generator):
    """``chip_smoke.py``'s branch-heavy DL inputs (x with 0 and 1 in it,
    20% far-off locations, 10% logscales of -9) as the halves of a head conv
    output ``[k * B, 6, 32, 32]`` in channels-last memory: (x, the head
    ``[k, B, 32, 32, 6]``)."""
    x = torch.randint(0, 256, (BATCH, SIDE, SIDE, 3), generator=gen, device="cuda") / 255.0
    x[:, 0] = 0.0
    x[:, -1] = 1.0
    half = (k * BATCH, 3, SIDE, SIDE)
    far = (torch.rand(half, generator=gen, device="cuda") < 0.2).float()
    low = torch.rand(half, generator=gen, device="cuda") < 0.1
    loc = torch.randn(half, generator=gen, device="cuda") * 0.25 + 0.5 + 2.0 * far
    logscale = torch.where(low, torch.full(half, -9.0, device="cuda"),
                           torch.randn(half, generator=gen, device="cuda") - 3.0)
    conv = torch.cat([loc, logscale], dim=1).contiguous(memory_format=torch.channels_last)
    return x.float(), conv.reshape(k, BATCH, 6, SIDE, SIDE).permute(0, 1, 3, 4, 2)


def model03_head(k: int):
    """model03's head output at initialisation on one seeded batch: (x, the
    head ``[k, B, 32, 32, 6]`` whose halves loc and logscale are)."""
    batch = np.random.default_rng(0).integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    x = torch.as_tensor(batch, device="cuda").float() / 255.0
    model = build_model(MODELS["model03"], torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        dist = model(x, k, generator=torch.Generator("cuda").manual_seed(0))[2].dist
    loc = dist.loc
    return x, loc.as_strided(loc.shape[:-1] + (6,), loc.stride()[:-1] + (1,))


def _dl_log_prob_of_head(x, head):
    """The log-prob with the head as the operand: through the head-level
    entry where the checkout has one, else through its halves."""
    if hasattr(dl_kernel, "dl_log_prob_head"):
        return dl_kernel.dl_log_prob_head(x, head, *DL_BIN)
    return dl_kernel.dl_log_prob(x, *torch.chunk(head, 2, dim=-1), *DL_BIN)


def dl_times(say) -> dict:
    """The DL pair on the halves of a channels-last head, each checkout on
    its own default path: ms a wrapper call and on the device, and forward +
    backward with the head as the leaf."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ms = {}
    for source in ("inputs", "model03"):
        for k in (5, 100):
            x, head = dl_head_inputs(k, gen) if source == "inputs" else model03_head(k)
            loc, logscale = torch.chunk(head, 2, dim=-1)
            tag = f"{source} k={k}"
            reps = 20 if k == 5 else 10
            with torch.inference_mode():
                fwd = lambda: dl_kernel.dl_log_prob(x, loc, logscale, *DL_BIN)  # noqa: E731
                ms[f"DL forward {tag}"] = cuda_ms(fwd, reps)
                ms[f"DL forward device {tag}"] = float(np.median([graph_ms(fwd, reps)
                                                                  for _ in range(3)]))
            line = (f"DL {tag}: forward {ms[f'DL forward {tag}']:.4f} ms, device "
                    f"{ms[f'DL forward device {tag}']:.4f}")
            if k == 5:
                g = torch.randn((k, BATCH, 1, 1, 1), generator=gen, device="cuda").expand(
                    loc.shape)
                bwd = lambda: dl_kernel.dl_backward(x, loc, logscale, g, *DL_BIN)  # noqa: E731
                ms[f"DL backward {tag}"] = cuda_ms(bwd, reps)
                ms[f"DL backward device {tag}"] = float(np.median([graph_ms(bwd, reps)
                                                                   for _ in range(3)]))

                def fwd_bwd():
                    leaf = head.detach().requires_grad_(True)
                    return torch.autograd.grad(_dl_log_prob_of_head(x, leaf), [leaf], g)

                fwd_bwd()
                _, kernels = device_times(lambda: [fwd_bwd() for _ in range(10)])
                n = sum(count for count, _ in kernels.values()) / 10
                device = sum(t for _, t in kernels.values()) / 10
                ms[f"DL fwd+bwd kernels {tag}"] = n
                ms[f"DL fwd+bwd device {tag}"] = device
                line += (f"; backward {ms[f'DL backward {tag}']:.4f} ms, device "
                         f"{ms[f'DL backward device {tag}']:.4f}; fwd+bwd on the head leaf: "
                         f"{n:.1f} kernels a call, {device:.4f} ms on the device ("
                         + ", ".join(f"{name[:40]} x{count / 10:.1f}"
                                     for name, (count, _) in sorted(kernels.items())) + ")")
                del g
            say(line)
            del x, head, loc, logscale
    torch.cuda.empty_cache()
    return ms


def train_step_profile(say) -> dict:
    """Five model03 float32 train steps (batch 128, k = 5) under the
    profiler after two warm-up steps: device kernels, device busy and the DL
    kernels' device ms, each a step."""
    pool = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (7, BATCH, 32, 32, 3), dtype=np.uint8), device="cuda")
    cfg = experiment("model03")
    model = build_model(cfg.model, torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    for batch in pool[:2]:
        state, _ = step(state, batch)

    def five_steps():
        nonlocal state
        for batch in pool[2:]:
            state, _ = step(state, batch)

    wall, kernels = device_times(five_steps)
    by_class: dict = {}
    for name, (_, t) in kernels.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0.0) + t / 5
    out = {"train model03 f32 kernels a step": sum(c for c, _ in kernels.values()) / 5,
           "train model03 f32 device busy a step": sum(by_class.values()),
           "train model03 f32 traced wall a step": wall / 5,
           "train model03 f32 DL forward a step": by_class.get("DL forward", 0.0),
           "train model03 f32 DL backward a step": by_class.get("DL backward", 0.0)}
    say("model03 train step f32: " + ", ".join(f"{key[len('train model03 f32 '):]} {v:.4f}" for key, v in out.items()))
    return out


# the host's calls that put work on the card
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchKernelExC", "cuLaunchKernelEx")
# (label, zoo name, setup_scanned_step's keywords, steps a call)
TRAIN_CASES = (
    ("model05 f32", "model05", {}, 10),
    ("model05 bf16", "model05", dict(compute_dtype="bfloat16",
                                     model_over={"likelihood_io_dtype": "bfloat16"}), 10),
    ("model03 f32", "model03", {}, 10),
    ("model03 bf16", "model03", dict(compute_dtype="bfloat16"), 10),
    ("model01", "model01", {}, 100),
)


def traced_call(fn):
    """``fn()`` under the profiler -> (host ms, device busy ms, device
    kernels, the host's calls that put work on the card)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, kernels, host = 0.0, 0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            busy += evt.self_device_time_total / 1e3
            kernels += evt.count
        elif evt.key in HOST_LAUNCHES:
            host += evt.count
    return wall, busy, kernels, host


def train_rates(say) -> dict:
    """The train step as users take it, and the trainer's windows."""
    import os
    import tempfile

    from vae_mdl_tpu_torch.config import DataConfig, TrainConfig
    from vae_mdl_tpu_torch.train.trainer import Trainer
    from vae_mdl_tpu_torch.utils.timing import setup_scanned_step, time_scanned_step

    out = {}
    for label, name, setup, spc in TRAIN_CASES:
        step, state, batch, cfg, _ = setup_scanned_step(name, spc=spc, **setup)
        rates = time_scanned_step(step, state, batch, spc, cfg.data.batch_size)
        holder = {"state": state}

        def call():
            holder["state"], _ = step(holder["state"], batch)

        wall, busy, kernels, host = traced_call(call)
        row = {"imgs_per_s": float(np.median(rates)), "imgs_per_s_min": float(rates.min()),
               "imgs_per_s_sd": float(rates.std(ddof=1)), "busy_ms_a_step": busy / spc,
               "idle_share": 1.0 - busy / wall, "device_kernels_a_step": kernels / spc,
               "host_launches_a_step": host / spc}
        out[f"train {label}"] = row
        say(f"train {label} ({spc} steps a call, batch {cfg.data.batch_size}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
        del step, state, batch, holder
        torch.cuda.empty_cache()
    for spc in (1, 10):
        with tempfile.TemporaryDirectory() as root:
            cfg = dataclasses.replace(
                experiment("model05"),
                data=DataConfig(dataset="synthetic:svhn_cropped", batch_size=BATCH,
                                val_batch_size=500),
                train=TrainConfig(n_updates=60, eval_interval=20, steps_per_call=spc,
                                  report_images=False, checkpoint_dir=f"{root}/ckpt",
                                  log_dir=f"{root}/tb"))
            trainer = Trainer(cfg)
            trainer.fit(progress=False)
            with open(os.path.join(trainer.logger.dir, "metrics.jsonl")) as f:
                windows = [r["imgs_per_sec"] for r in map(json.loads, f)
                           if r.get("prefix") == "Perf"][1:]
            out[f"trainer model05 f32 spc={spc}"] = {"imgs_per_s": windows}
            say(f"trainer model05 f32, {spc} steps a call: window imgs/s {windows}")
            del trainer
        torch.cuda.empty_cache()
    return out


def eval_rates(say) -> dict:
    images = np.random.default_rng(0).integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    rates = {}
    for name in ("model05", "model03"):
        base = MODELS[name]
        io_dtype = "bfloat16" if base.likelihood == "mdl" else None
        configs = [("f32", base), ("bf16", dataclasses.replace(
            base, compute_dtype="bfloat16", likelihood_io_dtype=io_dtype))]
        if name == "model03":  # the plain likelihood on the same weights: the control
            configs += [(f"{which} plain", dataclasses.replace(cfg, use_pallas=False))
                        for which, cfg in configs]
        for which, cfg in configs:
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
    if len(argv) not in (2, 3) or argv[2:] not in ([], ["train"]):
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        raise RuntimeError("the probe times a CUDA card; torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    package = str(vae_mdl_tpu_torch.__path__[0])
    print(f"{argv[1]}: {package} on {torch.cuda.get_device_name(0)}", flush=True)
    if argv[2:] == ["train"]:
        train = train_rates(lambda line: print(f"{argv[1]}: {line}", flush=True))
        print(json.dumps({"label": argv[1], "package": package, "train": train}))
        return 0
    ms = kernel_times(lambda line: print(f"{argv[1]}: {line}", flush=True))
    ms.update(null_forward_ms(lambda line: print(f"{argv[1]}: {line}", flush=True)))
    ms.update(model_device_ms(lambda line: print(f"{argv[1]}: {line}", flush=True)))
    ms.update(dl_times(lambda line: print(f"{argv[1]}: {line}", flush=True)))
    ms.update(train_step_profile(lambda line: print(f"{argv[1]}: {line}", flush=True)))
    rates = eval_rates(lambda line: print(f"{argv[1]}: {line}", flush=True))
    print(json.dumps({"label": argv[1], "package": package, "ms": ms, "imgs_per_s": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
