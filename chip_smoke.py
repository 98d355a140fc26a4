"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It uses ``vae_mdl_tpu_torch``, torch and numpy only, and fails (exit code
not 0, no result line) on the first phase that fails; there is no CPU path
and nothing falls back to a plain version.

1. device: prints ``nvidia-smi``'s name and power limit; needs CUDA and a
   card whose published peaks ``utils/flops.py`` knows;
2. build: compiles the four sources under ``vae_mdl_tpu_torch/csrc/``
   (``mdl_log_prob.cu``, ``dl_log_prob.cu``, ``sfu_probe.cu``,
   ``io_probe.cu``) with nvcc, all at once, and prints ptxas's registers and
   spills of the kernels the paths launch; then reads off the strides in
   which layout model05's and model03's heads hand their output to the
   likelihood kernels (that layout's case goes into the kernels line);
3. the special-function probe kernel (K6) against its plain version at a
   depth of 2 and 3 iterations, inputs in [0.5, 1.5], for the five ops, the
   cascade and the re-ranging alone, with and without re-ranging, at every
   shape the roofline launches it at (2560 blocks x 256 threads x 1, 2, 4, 8
   and 16 chains; 20480 blocks x 8 chains); then the first part of this
   slice's main path, ``probes.roofline`` on model05, batch 128, k = 5, f32,
   through ``utils/timing.py``, with all launch counts set to 0 just before
   it and read just after (rates at the kernel geometry and at the larger
   grid, the sweep over chains, the additive-model check on the cascade, the
   floors of the MoDL forward at k = 5 and k = 100 and of forward + backward
   at k = 5, the mixture's cost in the step, the kernels' share of their
   floor): its SM clock under load and per-op rates price every later bound
   and attainable time, and the MUFU instructions per evaluation in the SASS
   are held against what the bound charges;
4. the MoDL forward kernel against its plain PyTorch version on the card, at
   the four forward contracts of the TPU kernels it replaces (f32 and bf16
   parameters at k = 5 and k = 100 samples of a batch of 128), each in the
   NHWC-contiguous layout (what the model's head hands on: its convs run
   channels-last) and the NCHW layout, with kernel and plain times from
   CUDA events;
5. the MoDL backward kernel at the three backward contracts (f32 and bf16 at
   k = 5, bf16 at k = 100; batch 128), both layouts: against the analytic
   plain version element by element, and against autograd of the plain
   forward by the float64-accuracy rule; CUDA-event times of the backward
   alone (kernel vs plain) and of forward + backward (through the kernels vs
   autograd of the plain version);
6. the discretized-logistic (DL) forward kernel against its plain version at
   the model's train shape (k = 5, batch 128, 32x32x3) and eval-chunk shape
   (k = 100), x broadcast over k, for contiguous operands and for the two
   channel halves of a head tensor in NCHW and in channels-last memory (the
   model's), every branch hit; the DL backward
   kernel at k = 5 against its analytic plain version element by element
   and against float64 autograd by the accuracy rule, with the times of the
   backward alone and of forward + backward through the kernels against
   autograd of the plain version;
7. the memory-path probes at full size: the channel sum (P1, P2) of a
   ``[100, 102400, 50]`` and a ``[100, 50, 102400]`` float32 tensor (2.05 GB
   each) through the direct and the staged path against ``sum`` (tolerance
   stated at ``SUM_ATOL``; timed in phase 10c), and the null-body MoDL kernels (P3), forward and
   backward, direct and staged, at the model05 train shape (k = 5) and
   eval-chunk shape (k = 100), f32 and bf16, both layouts, against their
   plain versions (the sums within tolerance, ``0.5 p + g`` exactly);
8. model05 and model03, float32 config, batch 128, k = 5: the IWAE bound
   through the kernel (``use_pallas=None``) and through the plain version
   (``use_pallas=False``) on the same weights and noise;
9. one train step's loss and every gradient leaf through the kernels and
   through the plain version, from one state, batch and noise: model05,
   model03, model04 (GLU stacks) and model06 (two stochastic layers); a
   train step of model01 (MLP, Bernoulli) and model02 (Gaussian head) with a
   finite, falling loss, and model01's rate through the timing harness at
   100 steps per call;
10. the main paths, each with all launch counts set to 0 just before it and
   read just after: (a) the 5000-importance-sample ``evaluate_llh`` on one
   batch of 128 images (k-chunks of 100) of model05 and of model03, in the
   float32 config and the bfloat16 config, timed with CUDA events, and a
   200-sample evaluation through the kernel and the plain version agreeing
   per image; (b) training of model05 and of model03 at batch 128, k = 5,
   through ``make_multi_train_step`` with 10 steps per call on seeded
   synthetic uint8 images, in both configs through the kernels and in
   float32 through the plain version: the median imgs/s of 5 timed calls
   after a warm-up, the peak memory, and a finite loss that falls; (c) the
   rest of the measurement path on model05, batch 128, k = 5, f32, through
   ``utils/timing.py``: ``probes.kernel_structure`` (the four-way step:
   the null kernels must launch in ``dma`` and ``staged``, the DL pair in
   ``dl_head``, the MoDL pair in ``full``, and no other) and
   ``probes.kernel_isolate`` / ``kernel_isolate2``;
11. a ``torch.profiler`` breakdown of device time by kernel class over 5
   train steps of each config of model05 and model03, with each kernel's
   device time per launch.

The last three lines: the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. In the record, ``launches``
counts the main paths' launches (``launches_by_path`` splits them), ``ms``
and ``plain_ms`` are CUDA-event times per call through the wrapper at the
shape named in ``shape``, ``bound_ms`` is the least time the card could take
for that call: the largest of its bytes, each input read and each output
written once, over 3.35 TB/s; its float32 operations, counted per cascade by
the branch this run's data takes, over 67 TFLOP/s; and, for the likelihood
kernels and the probe kernel, the special-function bound ("sfu"): the fewest
MUFU instructions the transcendental calls that the CUDA source makes on this
run's data need (``utils/flops.py`` ``MUFU_PER_CALL``) over the card's 16
results a clock and SM at the clock phase 3 measured under load.
``attainable_ms`` stands beside it and is no bound: the same calls priced at
the rates phase 3 measured for the accurate functions the kernels call,
which another instruction sequence could beat. ``library_ms`` is the
time of the one PyTorch call that computes the same function where there is
one (``sum`` for the channel sums, ``torch.add(g, p, alpha=0.5)`` for the
null backward), else null: no single PyTorch call computes a discretized
logistic's or a MoDL's log-prob or its gradient. The MoDL backward's
``max_abs_err`` is over its float32 contract; ``max_abs_err_bf16`` (one bf16
ulp of gradients of a few hundred) is over the bf16 ones, and
``tolerance_excess``, the largest |kernel - plain| less its per-element
tolerance over all cases, is at most 0. Weights are the port's own
glorot-uniform init from a seed; no checkpoint or dataset is read.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import time

import numpy as np
import torch

from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
from vae_mdl_tpu_torch.models.objective import compute_loss, training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.ops.cuda import build, dl_kernel, io_probe, mdl_kernel, mdl_null, sfu_probe
from vae_mdl_tpu_torch.probes import kernel_isolate, kernel_isolate2, kernel_structure, roofline
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_multi_train_step, make_train_step
from vae_mdl_tpu_torch.utils.flops import (
    branch_counts,
    cascade_transcendentals,
    device_peaks,
    MUFU_PER_CALL,
    mdl_cuda_transcendentals,
    modl_branch_counts,
    mufu_instructions,
)
from vae_mdl_tpu_torch.utils.timing import (
    cuda_ms,
    device_times,
    kernel_class,
    setup_scanned_step,
    time_scanned_step,
)

SEED = 0
BATCH = 128
N_MIX = 5
# Kernel vs plain version, per pixel: |kernel - plain| <= ATOL + RTOL * |plain|.
# Both evaluate the same float32 formula with the same libdevice functions
# and no fused multiply-adds; they differ in the order of the two
# logsumexps' sums, which moves an O(1) value by a few ulps (ATOL), and
# far-off locations give values up to ~1e4 nats whose float32 spacing is
# ~1e-3 (RTOL). The DL forward kernel has no sums and is held to the same.
ATOL, RTOL = 2e-4, 1e-5
# The bound and per-image log-likelihoods sum 3072 such per-pixel terms:
# relative tolerance on the sum.
SUM_RTOL = 1e-5
# Backward kernel vs its analytic plain version, per element:
# |kernel - plain| <= BWD_ATOL + BWD_RTOL[dtype] * |plain|. Same float32
# formula, same libdevice functions, no fused multiply-adds; the MoDL's two
# softmaxes sum in another order, which moves each gradient by a few float32
# ulps (RTOL f32) and d logits = g * (s - softmax(logits)), a difference of
# O(1) terms, by a few ulps of 1 (ATOL). A bf16 gradient rounds once more:
# one bf16 ulp is 2^-8 of the value (RTOL bf16). The DL backward kernel
# (float32 only) is held to the float32 pair.
BWD_ATOL = 2e-5
BWD_RTOL = {torch.float32: 2e-4, torch.bfloat16: 8e-3}
# Against autograd of the plain forward (different formulas, so no
# per-element bound): the kernel's RMS error against a float64 autograd
# truth is at most 1.2x that of float32 autograd rounded to the same dtype,
# elements at a clamp's tie (raw MoDL logscale exactly -7) left out: there
# the kernel passes 0 and autograd half the gradient.
F64_RATIO = 1.2
# One train step, kernel vs plain: the loss within SUM_RTOL, each parameter
# gradient within GRAD_RTOL of the plain one in norm. The analytic and the
# autograd likelihood gradients differ in float32 rounding, most where a CDF
# difference cancels; summed through the decoder's backward this measured
# 6.6e-5 on model05's decoder.Dense_0.weight (H100, cuDNN deterministic), the
# largest of all leaves; the bound is 3x that.
GRAD_RTOL = 2e-4
MODL_SOURCE = "vae_mdl_tpu_torch/csrc/mdl_log_prob.cu"
DL_SOURCE = "vae_mdl_tpu_torch/csrc/dl_log_prob.cu"
REPLACES = "vae_mdl_tpu/ops/pallas/mdl_kernel.py:227"
REPLACES_BACKWARD = "vae_mdl_tpu/ops/pallas/mdl_kernel.py:334"
# the DL backward replaces no Pallas kernel: the jnp vjp (_bwd) of this one
REPLACES_DL = "vae_mdl_tpu/ops/pallas/dl_kernel.py:61"
REPLACES_DL_BACKWARD_NOTE = "the jnp vjp _bwd at vae_mdl_tpu/ops/pallas/dl_kernel.py:96"
TRAIN_STEPS_PER_CALL = 10
TRAIN_BLOCKS = 5
# the model's discretized-logistic head: 256 levels on [0, 1]
DL_BIN = (0.0, 1.0, 1.0 / 255.0)

SFU_SOURCE = "vae_mdl_tpu_torch/csrc/sfu_probe.cu"
IO_SOURCE = "vae_mdl_tpu_torch/csrc/io_probe.cu"
REPLACES_K6 = "vae_mdl_tpu/ops/pallas/vpu_probe.py:57"
REPLACES_P1 = "scripts/kernel_isolate.py:31"
REPLACES_P2 = "scripts/kernel_isolate2.py:29"
REPLACES_P3 = "scripts/kernel_structure_probe.py:38"
# The probe kernel against its plain version: the same libdevice functions on
# the same float32 values with no fused multiply-adds, so they agree to the
# last bit on this card; the tolerance leaves room for a toolkit whose expf or
# logf differs from PyTorch's by an ulp, compounded over 3 iterations.
PROBE_RTOL, PROBE_ATOL = 1e-5, 1e-6
# A channel sum of 50 (or 53) standard-normal float32 values in another order
# than the library's: each partial sum is O(10) and rounds to 1e-6 of itself.
SUM_ATOL = 1e-4
# The card's published peaks (device memory, float32 outside the tensor
# cores): set by phase_device from utils/flops.py's table. The measured
# special-function rates and ceiling: set by roofline_path.
PEAKS: dict = {}
SFU: dict = {}
# Float32 operations of one cascade by the branch it takes, each add,
# multiply, compare and each exp, log, log1p or divide counted once (the
# cascade of csrc/dl_cascade.cuh read line by line); the backward's include
# the two multiplies by the cotangent.
DL_FWD_OPS = {"right": 14, "left": 14, "cdf": 19, "pdf": 31}
DL_BWD_OPS = {"right": 15, "left": 18, "cdf": 31, "pdf": 33}


def say(line: str) -> None:
    print(line, flush=True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


# -- the least time the card could take ------------------------------------------


def distinct_bytes(*tensors: torch.Tensor) -> int:
    """Bytes of the distinct elements the tensors address: a dimension
    expanded with stride 0 counts once."""
    total = 0
    for t in tensors:
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        total += n * t.element_size()
    return total


def modl_ops(counts: dict, pixels: int, n_mix: int, backward: bool) -> int:
    """Float32 operations of a MoDL kernel call: the cascades by branch,
    and per pixel the rescaling of x (6), per mixture the clamps, tanh and
    autoregression (11), the weight's sums (4) and the two logsumexps
    (8 n + 4). The backward runs the forward's weights again, then each
    cascade's derivative and per mixture the softmax weights and the nine
    gradients' products (30)."""
    forward = sum(DL_FWD_OPS[b] * n for b, n in counts.items()) + pixels * (10 + 23 * n_mix)
    if not backward:
        return forward
    return forward + sum(DL_BWD_OPS[b] * n for b, n in counts.items()) + pixels * 30 * n_mix


def bound(n_bytes: int, n_ops: int = 0, calls: dict = None):
    """(bound_ms, bound_by, {"bytes", "operations", "sfu": ms}): the largest
    of bytes over the memory rate, operations over the float32 rate and, where
    the transcendental ``calls`` by op are given, the fewest MUFU instructions
    they need over the card's special-function results per second at the
    clock the roofline measured under load."""
    by = {"bytes": n_bytes / PEAKS["bytes_per_s"] * 1e3,
          "operations": n_ops / PEAKS["float32"] * 1e3}
    if calls is not None:
        by["sfu"] = mufu_instructions(calls) / SFU["peak"] * 1e3
    which = max(by, key=by.get)
    return by[which], which, by


def attainable(calls: dict) -> float:
    """Milliseconds the transcendental ``calls`` take at the rates the probe
    kernel measured for the accurate functions the kernels call: what these
    instruction sequences attain, beside the bound and not one itself."""
    return sfu_probe.sfu_floor_seconds({op: n for op, n in calls.items() if n},
                                       SFU["rates"]) * 1e3


def bounds_text(by: dict) -> str:
    return ", ".join(f"{which} {ms:.4f}" for which, ms in by.items())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")
    PEAKS.update(device_peaks())  # raises on a part whose peaks it does not know
    # the float32 config means float32 convolutions: cuDNN defaults to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build() -> None:
    sources = [mdl_kernel.SOURCE, dl_kernel.SOURCE, sfu_probe.SOURCE, io_probe.SOURCE]
    fresh = [not build.library_path(source).exists() for source in sources]
    t0 = time.perf_counter()
    libs = build.build_all(sources)  # one nvcc per source, started together
    seconds = time.perf_counter() - t0
    for lib, new in zip(libs, fresh):
        say(f"build: {'compiled' if new else 'found'} {lib.name}")
    say(f"build: {seconds:.1f} s for the {len(sources)} sources")
    # the instantiations the paths launch: MoDL at n_mix = 5, the DL kernels
    # at four merged dimensions with 32-bit indices, the probe at the default
    # chains, every kernel of io_probe.cu
    wanted = ("Li5E", "IjLi4E", f"Li{sfu_probe.DEFAULT_CHAINS}EE", "")
    for lib, family, want in zip(libs, ("MoDL n_mix=5", "DL", "probe", "io"), wanted):
        lines = lib.with_suffix(".log").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and want in line:
                mangled = line.split("'")[1]
                if family in ("MoDL n_mix=5", "DL"):
                    entry = "backward" if "backward_kernel" in line else "forward"
                    dtype = "" if family == "DL" else (" bf16" if "bfloat16" in line else " f32")
                    what = f"{family}{dtype} {entry}"
                else:  # the kernel's name and template arguments, unmangled by eye
                    what = f"{family} {re.search(r'_cu_[0-9a-f]{8}[0-9]+([A-Za-z_0-9]+)', mangled).group(1)[:48]}"
                used = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                        if "Used" in ln or "spill" in ln]
                say(f"ptxas {what}: {'; '.join(used)}")


def phase_sfu_check() -> float:
    """K6 against its plain version at every shape the roofline launches it
    at: the kernel geometry with each number of chains a thread, and the
    larger grid with the default chains. -> max |kernel - plain|."""
    worst = 0.0
    shapes = [(sfu_probe.DEFAULT_BLOCKS, chains) for chains in sfu_probe.CHAINS]
    shapes.append((sfu_probe.CONTROL_BLOCKS, sfu_probe.DEFAULT_CHAINS))
    for blocks, chains in shapes:
        x = sfu_probe.probe_input(blocks, chains, "cuda")
        for op in ("none", *sfu_probe.OPS, "cascade"):
            for iters, (scale, shift) in ((2, (1.0, 0.0)), (3, (1.0, 0.0)),
                                          (3, sfu_probe.RERANGE[op])):
                got = sfu_probe.loop_probe(x, op, iters, chains, scale, shift)
                want = sfu_probe.loop_probe_plain(x, op, iters, scale, shift)
                # log(log(x)) is nan below 1 in both; nan must meet nan
                torch.testing.assert_close(got, want, rtol=PROBE_RTOL, atol=PROBE_ATOL,
                                           equal_nan=True)
                err = torch.where(torch.isfinite(want), (got - want).abs(), 0.0)
                worst = max(worst, float(err.max()))
        say(f"kernel K6 probe, {blocks} blocks x {sfu_probe.BLOCK_THREADS} threads x {chains} "
            f"chains: 7 ops x 3 depths agree with the plain version, max|d| so far "
            f"{worst:.3e} (rtol {PROBE_RTOL}, atol {PROBE_ATOL})")
    return worst


def roofline_path(smi: str) -> dict:
    """This slice's main path, first part: ``probes.roofline`` on model05,
    batch 128, k = 5, f32, with every count set to 0 just before it and read
    just after. Its clock, rates and MUFU counts price every later bound.
    -> the path's launch counts."""
    say(f"-- probes.roofline on {smi}")
    reset_probe_counts()
    roof = roofline.run(repeats=3, n_iters=3, n_repeats=4, say=say)
    counts = probe_counts()
    say(f"roofline main path: kernel launches {counts}")
    _only(counts, ("sfu_probe", "mdl_log_prob", "mdl_log_prob_backward", "dl_log_prob",
                   "dl_log_prob_backward"), "the roofline")
    for value in (*roof["rates"].values(), roof["additive"]["measured"],
                  *(f["cuda"] for f in roof["floors"].values())):
        if not np.isfinite(value) or value <= 0:
            raise AssertionError(f"the roofline gave a rate or floor of {value}")
    if roof["sfu_peak"] is None:
        raise RuntimeError("nvidia-smi gave no SM clock")
    SFU.update(clock_mhz=roof["clock_mhz"], peak=roof["sfu_peak"], rates=roof["rates"])

    # the bound's MUFU per call against the SASS, which lists every path of a
    # function once and so can only show more
    for op, kinds in (roof["mufu_per_eval"] or {}).items():
        if op in MUFU_PER_CALL and sum(kinds.values()) < MUFU_PER_CALL[op]:
            raise AssertionError(f"the SASS of {op} holds {kinds} MUFU an evaluation, fewer "
                                 f"than the {MUFU_PER_CALL[op]} the bound charges")
    say(f"MUFU per evaluation in the probe's SASS, every path counted once: "
        f"{roof['mufu_per_eval']}; the bound charges {MUFU_PER_CALL}")
    modl = build.mufu_counts(build.library_path(mdl_kernel.SOURCE)) or {}
    for kernel, kinds in modl.items():
        if "Li5E" in kernel and "IfL" in kernel:  # float32, n_mix = 5
            entry = "backward" if "backward_kernel" in kernel else "forward"
            say(f"SASS MoDL f32 n_mix=5 {entry}: MUFU instructions {kinds} "
                f"(every branch of every cascade counted once)")
    return counts


def k6_record(worst: float) -> dict:
    """The kernels-line record of the probe kernel: one launch of exp (one
    MUFU.EX2 an evaluation) at the kernel geometry and the deeper of the two
    timed depths, one of the shapes ``phase_sfu_check`` held."""
    x = sfu_probe.probe_input(sfu_probe.DEFAULT_BLOCKS, sfu_probe.DEFAULT_CHAINS, "cuda")
    iters, (scale, shift) = 2200, sfu_probe.RERANGE["exp"]
    ms = cuda_ms(lambda: sfu_probe.loop_probe(x, "exp", iters, scale=scale, shift=shift), 5)
    plain_ms = cuda_ms(lambda: sfu_probe.loop_probe_plain(x, "exp", iters, scale, shift), 1)
    by = {"bytes": 2 * x.numel() * 4 / PEAKS["bytes_per_s"] * 1e3,
          # exp, multiply, add per evaluation, a transcendental as one
          "operations": 3 * x.numel() * iters / PEAKS["float32"] * 1e3,
          "sfu": x.numel() * iters * MUFU_PER_CALL["exp"] / SFU["peak"] * 1e3}
    which = max(by, key=by.get)
    name = f"K6 exp x{iters}, {sfu_probe.DEFAULT_BLOCKS} blocks x 256 x {sfu_probe.DEFAULT_CHAINS}"
    say(f"kernel {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {by[which]:.4f} ms "
        f"({which}; {bounds_text(by)})")
    return dict(max_abs_err=worst, shape=name, ms=ms, plain_ms=plain_ms, bound_ms=by[which],
                bound_by=which,
                bound_note="special-function results at 16 a clock and SM, measured clock",
                bounds=by)


def _nchw(p: torch.Tensor) -> torch.Tensor:
    """``[k, B, H, W, C]`` with the strides of an NCHW conv output."""
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


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
    if nchw:
        p = _nchw(p)
    return x, p


def phase_kernel_vs_plain():
    """-> (max |kernel - plain| over all cases, {case: record})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, {}
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
            counts = modl_branch_counts(x, p)
            calls = mdl_cuda_transcendentals(counts, got.numel(), N_MIX)
            bound_ms, bound_by, by = bound(
                distinct_bytes(x, p, got), modl_ops(counts, got.numel(), N_MIX, backward=False),
                calls)
            layout = "nchw" if nchw else "nhwc"
            name = f"{contract} {dtype_name(dtype)} k={k} B={BATCH} {layout}"
            say(f"kernel {name}: max|d|={max_err:.3e} (tolerance excess {excess:.3e}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {bounds_text(by)}); attainable at the measured rates "
                f"{attainable(calls):.4f} ms")
            if excess > 0:
                raise AssertionError(f"{name}: kernel and plain version differ beyond tolerance")
            worst = max(worst, max_err)
            cases[name] = dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bounds=by, attainable_ms=attainable(calls))
            del x, p, got, want, err
    return worst, cases


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
    per-element tolerance (at most 0), {case: record})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, worst_excess, cases = {}, -float("inf"), {}
    for contract, k, dtype in (("K1b/K3b", 5, torch.float32), ("K2b", 5, torch.bfloat16),
                               ("K4b", 100, torch.bfloat16)):
        for nchw in (False, True):
            layout = "nchw" if nchw else "nhwc"
            name = f"{contract} {dtype_name(dtype)} k={k} B={BATCH} {layout}"
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
            counts = modl_branch_counts(x, p)
            calls = mdl_cuda_transcendentals(counts, g.numel(), N_MIX, backward=True)
            bound_ms, bound_by, by = bound(
                distinct_bytes(x, p, g, got), modl_ops(counts, g.numel(), N_MIX, backward=True),
                calls)
            say(f"backward {name}: max|d|={max_err:.3e} (tolerance excess {excess:.3e}); "
                f"rms vs f64 kernel {rms_kernel:.3e} autograd {rms_ref:.3e} "
                f"({int((~keep).sum())} ties left out); backward kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{bounds_text(by)}); attainable at the measured rates {attainable(calls):.4f} ms; "
                f"fwd+bwd kernels {fb_ms:.4f} ms, autograd of plain {fb_plain_ms:.4f} ms")
            if excess > 0:
                raise AssertionError(f"{name}: backward kernel and plain version differ beyond tolerance")
            if rms_kernel > F64_RATIO * rms_ref + 1e-9:
                raise AssertionError(f"{name}: backward kernel less accurate than autograd")
            key = dtype_name(dtype)
            worst[key] = max(worst.get(key, 0.0), max_err)
            worst_excess = max(worst_excess, excess)
            cases[name] = dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bounds=by, attainable_ms=attainable(calls))
            del x, p, g, got
    torch.cuda.empty_cache()
    return worst, worst_excess, cases


DL_LAYOUTS = ("contiguous", "nchw halves", "nhwc halves")


def dl_inputs(k: int, layout: str, gen: torch.Generator):
    """The DL head's operands at the model's shapes: x ``[B, 32, 32, 3]`` in
    [0, 1] with 0 and 1 in it, loc and logscale ``[k, B, 32, 32, 3]`` hitting
    every branch (logscales down to -9, far-off locations): contiguous, or
    the two channel halves of a head tensor ``[k * B, 6, 32, 32]`` in NCHW or
    in channels-last (NHWC) memory."""
    dev = gen.device
    x = torch.randint(0, 256, (BATCH, 32, 32, 3), generator=gen, device=dev).float() / 255.0
    x[:, 0, :, :] = 0.0
    x[:, -1, :, :] = 1.0
    half = (k * BATCH, 3, 32, 32)
    far = (torch.rand(half, generator=gen, device=dev) < 0.2).float()
    low = torch.rand(half, generator=gen, device=dev) < 0.1
    loc = torch.randn(half, generator=gen, device=dev) * 0.25 + 0.5 + 2.0 * far
    logscale = torch.where(low, torch.full(half, -9.0, device=dev),
                           torch.randn(half, generator=gen, device=dev) - 3.0)
    head = torch.cat([loc, logscale], dim=1)  # NCHW
    if layout == "nhwc halves":  # as cuDNN writes it for a channels-last input
        head = head.contiguous(memory_format=torch.channels_last)
    del far, low, loc, logscale
    loc, logscale = head_halves(head, k)
    if layout == "contiguous":
        loc, logscale = loc.contiguous(), logscale.contiguous()
    return x, loc, logscale, head


def head_halves(head: torch.Tensor, k: int):
    """The head conv's output ``[k * B, 6, 32, 32]`` as the decoder hands it
    to the likelihood: an ``[k, B, 32, 32, 6]`` view, split in two."""
    view = head.reshape(k, BATCH, 6, 32, 32).permute(0, 1, 3, 4, 2)
    return torch.chunk(view, 2, dim=-1)


def phase_dl_kernels():
    """The DL kernels against their plain versions. -> (max |kernel - plain|
    forward, the same backward, {case: record} forward, the same backward)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    low, high, width = DL_BIN
    fwd_err = bwd_err = 0.0
    fwd_cases, bwd_cases = {}, {}

    def plain(x, loc, logscale):
        return discretized_logistic_log_prob(x, loc, logscale, low=low, high=high,
                                             interval_width=width)

    for k in (5, 100):
        for layout in DL_LAYOUTS:
            name = f"K5 f32 k={k} B={BATCH} {layout}"
            x, loc, logscale, head = dl_inputs(k, layout, gen)
            counts = branch_counts(x, loc, logscale, low, high, width)
            if min(counts.values()) == 0:
                raise AssertionError(f"{name}: a branch is not hit: {counts}")
            with torch.inference_mode():
                got = dl_kernel.dl_log_prob(x, loc, logscale, low, high, width)
                want = plain(x, loc, logscale)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.float32:
                    raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name}: non-finite kernel output")
                err = (got - want).abs()
                excess = float((err - (ATOL + RTOL * want.abs())).max())
                max_err = float(err.max())
                ms = cuda_ms(lambda: dl_kernel.dl_log_prob(x, loc, logscale, low, high, width), 20)
                plain_ms = cuda_ms(lambda: plain(x, loc, logscale), 5)
            calls = cascade_transcendentals(counts)
            bound_ms, bound_by, by = bound(distinct_bytes(x, loc, logscale, got),
                                           sum(DL_FWD_OPS[b] * n for b, n in counts.items()),
                                           calls)
            say(f"kernel {name}: max|d|={max_err:.3e} (tolerance excess {excess:.3e}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {bounds_text(by)}); attainable at the measured rates "
                f"{attainable(calls):.4f} ms; branches {counts}")
            if excess > 0:
                raise AssertionError(f"{name}: kernel and plain version differ beyond tolerance")
            fwd_err = max(fwd_err, max_err)
            fwd_cases[name] = dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, bounds=by, attainable_ms=attainable(calls))
            del got, want, err
            if k > 5:
                continue

            # the backward, at the train shape: the cotangent as the sum over
            # the image's axes expands it
            g = torch.randn((k, BATCH, 1, 1, 1), generator=gen, device="cuda").expand(loc.shape)
            got = dl_kernel.dl_backward(x, loc, logscale, g, low, high, width)
            want = dl_kernel.dl_backward_plain(x, loc, logscale, g, low, high, width)
            torch.cuda.synchronize()
            excess = -float("inf")
            for a, b in zip(got, want):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise AssertionError(f"{name}: gradient of shape {tuple(a.shape)}, finite "
                                         f"{bool(torch.isfinite(a).all())}")
                err = (a - b).abs()
                excess = max(excess, float((err - (BWD_ATOL + BWD_RTOL[torch.float32] * b.abs())).max()))
                bwd_err = max(bwd_err, float(err.max()))
            max_err = max(float((a - b).abs().max()) for a, b in zip(got, want))

            def autograd(dtype):
                leaves = [loc.detach().to(dtype).requires_grad_(True),
                          logscale.detach().to(dtype).requires_grad_(True)]
                out = plain(x.to(dtype), *leaves)
                return torch.cat(torch.autograd.grad(out, leaves, g.to(dtype)), dim=-1)

            truth = autograd(torch.float64)
            rms_ref = float(((autograd(torch.float32).double() - truth) ** 2).mean().sqrt())
            rms_kernel = float(((torch.cat(got, dim=-1).double() - truth) ** 2).mean().sqrt())
            del truth, want

            def leaves_of():
                """(leaves, loc, logscale): the head tensor as the one leaf
                where the operands are its halves, as in the model."""
                if layout != "contiguous":
                    leaf = head.detach().requires_grad_(True)
                    return [leaf], *head_halves(leaf, k)
                pair = [loc.detach().requires_grad_(True), logscale.detach().requires_grad_(True)]
                return pair, *pair

            def fwd_bwd_kernel():
                leaves, a, b = leaves_of()
                return torch.autograd.grad(dl_kernel.dl_log_prob(x, a, b, low, high, width),
                                           leaves, g)

            def fwd_bwd_plain():
                leaves, a, b = leaves_of()
                return torch.autograd.grad(plain(x, a, b), leaves, g)

            ms = cuda_ms(lambda: dl_kernel.dl_backward(x, loc, logscale, g, low, high, width), 20)
            plain_ms = cuda_ms(
                lambda: dl_kernel.dl_backward_plain(x, loc, logscale, g, low, high, width), 10)
            fb_ms = cuda_ms(fwd_bwd_kernel, 20)
            fb_plain_ms = cuda_ms(fwd_bwd_plain, 10)
            n_kernels, by_class = device_profile(fwd_bwd_kernel, 10)
            n_plain, by_class_plain = device_profile(fwd_bwd_plain, 10)
            calls = cascade_transcendentals(counts, backward=True)
            bound_ms, bound_by, by = bound(distinct_bytes(x, loc, logscale, g, *got),
                                           sum(DL_BWD_OPS[b] * n for b, n in counts.items()),
                                           calls)
            say(f"backward {name}: max|d|={max_err:.3e} (tolerance excess {excess:.3e}); "
                f"rms vs f64 kernel {rms_kernel:.3e} autograd {rms_ref:.3e}; backward kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{bounds_text(by)}); attainable at the measured rates {attainable(calls):.4f} ms; "
                f"fwd+bwd kernels {fb_ms:.4f} ms, autograd of plain {fb_plain_ms:.4f} ms")
            # device time of the same forward + backward, from the profiler:
            # what autograd adds around the two kernels (with the head tensor
            # as the leaf: the halves' gradients on their way back into it)
            say(f"fwd+bwd {name}, device: {n_kernels:.1f} kernels a call, "
                f"{sum(by_class.values()):.4f} ms ("
                + ", ".join(f"{c} {v:.4f}" for c, v in sorted(by_class.items())) + "); "
                f"autograd of plain {n_plain:.1f} kernels, {sum(by_class_plain.values()):.4f} ms")
            if excess > 0:
                raise AssertionError(f"{name}: backward kernel and plain version differ beyond tolerance")
            if rms_kernel > F64_RATIO * rms_ref + 1e-9:
                raise AssertionError(f"{name}: backward kernel less accurate than autograd")
            bwd_cases[name] = dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, bounds=by, attainable_ms=attainable(calls),
                                   device_ms=by_class["DL backward"])
            fwd_cases[name]["device_ms"] = by_class["DL forward"]
            del got, g
        del x, loc, logscale, head
    torch.cuda.empty_cache()
    return fwd_err, bwd_err, fwd_cases, bwd_cases


def phase_io_probes():
    """P1, P2 and both P3 pairs against their plain versions at full size.
    -> {record name: kernels-line record}."""
    records = {}

    # P1 and P2: K = 100, P = 102400, C = 50, one 2.05 GB layout at a time;
    # their times are the memory-path probes' own (structure_path)
    for layout in io_probe.LAYOUTS:
        params = kernel_isolate.probe_params(layout)
        want = io_probe.channel_sum_plain(params, layout)
        bound_ms, bound_by, _ = bound(distinct_bytes(params, want), params.numel())
        paths = [("direct", 256)] + ([("staged", tile) for tile in kernel_isolate.TILES]
                                     if layout == "channel_minor" else [])
        for path, tile in paths:
            got = io_probe.channel_sum(params, layout, path, tile)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"channel_sum {layout} {path}: shape {tuple(got.shape)}")
            err = float((got - want).abs().max())
            which = "P1" if layout == "channel_minor" else "P2"
            name = f"{which} {layout} {path}" + (f" tile={tile}" if path == "staged" else "")
            say(f"kernel {name} K={kernel_isolate.K} P={kernel_isolate.P} C={kernel_isolate.CH}: "
                f"max|d|={err:.3e} (atol {SUM_ATOL}), bound {bound_ms:.4f} ms ({bound_by})")
            if err > SUM_ATOL:
                raise AssertionError(f"{name}: kernel and plain version differ beyond tolerance")
            records[name] = dict(max_abs_err=err, shape=name, bound_ms=bound_ms,
                                 bound_by=bound_by)
        del params, want, got
    torch.cuda.empty_cache()

    # P3: the MoDL kernels' train (k = 5) and eval-chunk (k = 100) shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for k in (5, 100):
        for dtype in (torch.float32, torch.bfloat16):
            for nchw in (False, True):
                x = torch.rand((BATCH, 32, 32, 3), generator=gen, device="cuda")
                p = torch.randn((k, BATCH, 32, 32, 10 * N_MIX), generator=gen,
                                device="cuda").to(dtype)
                if nchw:
                    p = _nchw(p)
                # the cotangent as the sum over the image's axes expands it
                g = torch.randn((k, BATCH, 1, 1, 1), generator=gen,
                                device="cuda").expand(k, BATCH, 32, 32, 1)
                fwd_want = mdl_null.mdl_null_forward_plain(x, p)
                bwd_want = mdl_null.mdl_null_backward_plain(x, p, g)
                layout = "nchw" if nchw else "nhwc"
                for variant in mdl_null.VARIANTS:
                    tag = f"{variant} {dtype_name(dtype)} k={k} B={BATCH} {layout}"
                    fwd = mdl_null.mdl_null_forward(x, p, variant)
                    bwd = mdl_null.mdl_null_backward(x, p, g, variant)
                    torch.cuda.synchronize()
                    err = float((fwd - fwd_want).abs().max())
                    if fwd.shape != fwd_want.shape or err > SUM_ATOL:
                        raise AssertionError(f"P3 forward {tag}: max|d|={err:.3e}")
                    if bwd.dtype != p.dtype or bwd.stride() != p.stride() \
                            or not torch.equal(bwd, bwd_want):
                        raise AssertionError(f"P3 backward {tag}: not equal to 0.5 p + g")
                    fwd_ms = cuda_ms(lambda: mdl_null.mdl_null_forward(x, p, variant), 10)
                    bwd_ms = cuda_ms(lambda: mdl_null.mdl_null_backward(x, p, g, variant), 10)
                    fwd_plain = cuda_ms(lambda: mdl_null.mdl_null_forward_plain(x, p), 3)
                    bwd_plain = cuda_ms(lambda: mdl_null.mdl_null_backward_plain(x, p, g), 3)
                    fb, fby, _ = bound(distinct_bytes(x, p, fwd), fwd.numel() * (10 * N_MIX + 3))
                    bb, bby, _ = bound(distinct_bytes(x, p, g, bwd), 2 * p.numel())
                    library_ms = None
                    if dtype == torch.float32:  # one call, the same function
                        library_ms = cuda_ms(lambda: torch.add(g, p, alpha=0.5), 5)
                    say(f"kernel P3 {tag}: forward max|d|={err:.3e} (atol {SUM_ATOL}), "
                        f"{fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, bound {fb:.4f} ms ({fby}); "
                        f"backward equal, {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, library "
                        f"{'%.4f ms' % library_ms if library_ms else 'none'}, bound {bb:.4f} ms "
                        f"({bby})")
                    records[f"P3 forward {tag}"] = dict(
                        max_abs_err=err, shape=f"P3 forward {tag}", ms=fwd_ms, plain_ms=fwd_plain,
                        bound_ms=fb, bound_by=fby, library_ms=None)
                    records[f"P3 backward {tag}"] = dict(
                        max_abs_err=0.0, shape=f"P3 backward {tag}", ms=bwd_ms,
                        plain_ms=bwd_plain, bound_ms=bb, bound_by=bby, library_ms=library_ms)
                del x, p, g, fwd, bwd, fwd_want, bwd_want
        torch.cuda.empty_cache()
    return records


def phase_small_models(smi: str) -> None:
    """model01 (MLP, Bernoulli) and model02 (Gaussian head): train steps with
    a finite, falling loss, and model01's rate through the timing harness at
    100 steps per call."""
    for name in ("model01", "model02"):
        cfg = experiment(name)
        model = seeded_model(cfg.model)
        state = create_train_state(model, cfg.train)
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        shape = cfg.model.image_shape
        batch = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, 256, (BATCH,) + shape, dtype=np.uint8), device="cuda")
        losses = []
        for _ in range(20):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        say(f"{name} train, 20 steps on one batch of {BATCH}: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}")
        if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
            raise AssertionError(f"{name}: loss {losses[0]} -> {losses[-1]} is not finite and falling")
    spc = 100
    step, state, batch, cfg, flops = setup_scanned_step("model01", spc=spc)
    rates = time_scanned_step(step, state, batch, spc, cfg.data.batch_size, n_iters=2,
                              n_repeats=4)
    say(f"model01 train f32 k={cfg.model.n_samples} B={cfg.data.batch_size}, {spc} steps per "
        f"call: {float(np.median(rates)):.1f} imgs/s (median of {len(rates)} blocks of 2 calls: "
        f"{', '.join(f'{r:.0f}' for r in rates)}); {flops / cfg.data.batch_size / 1e6:.2f} "
        f"MFLOP per image and step on {smi}")


def probe_counts() -> dict:
    """Every kernel's launches since ``reset_probe_counts``."""
    return {**kernel_structure.launch_counts(), "sfu_probe": sfu_probe.launches,
            "channel_sum": io_probe.launches,
            **{f"channel_sum {layout} {path}": n
               for (layout, path), n in io_probe.launches_by_path.items()}}


def reset_probe_counts() -> None:
    kernel_structure.reset_counts()
    sfu_probe.launches = io_probe.launches = 0
    io_probe.launches_by_path.clear()


def _only(counts: dict, wanted, what: str) -> None:
    """Fail unless exactly the ``wanted`` kernels launched."""
    for kernel, n in counts.items():
        if kernel in wanted and n < 1:
            raise AssertionError(f"{what} never launched {kernel}")
        if kernel not in wanted and n:
            raise AssertionError(f"{what} launched {kernel} {n} times")


def structure_path(smi: str):
    """This slice's main path, second part: the four-way step and the
    memory-path probes on model05, batch 128, k = 5, f32, each with every
    count set to 0 just before it and read just after. -> ({path: counts},
    the memory-path probes' times in ms by their labels)."""
    by_path = {}
    say(f"-- probes.kernel_structure on {smi}")
    reset_probe_counts()
    structure = kernel_structure.run(n_iters=3, n_repeats=4, say=say)
    wanted = {"full": ("mdl_log_prob", "mdl_log_prob_backward"),
              "dma": ("mdl_null_forward", "mdl_null_backward"),
              "staged": ("mdl_null_forward", "mdl_null_backward"),
              "dl_head": ("dl_log_prob", "dl_log_prob_backward")}
    for label, kernels in wanted.items():
        counts = {**structure["steps"][label]["launches"]}
        _only(counts, kernels, f"the {label} step")
        by_path[f"kernel_structure {label}"] = counts
    if mdl_kernel.mdl_log_prob.__module__ != mdl_kernel.__name__:
        raise AssertionError("the MoDL likelihood was not put back after the probe")

    say(f"-- probes.kernel_isolate, kernel_isolate2 on {smi}")
    reset_probe_counts()
    times = {**kernel_isolate.run(reps=5, say=say), **kernel_isolate2.run(reps=5, say=say)}
    by_path["kernel_isolate"] = counts = probe_counts()
    say(f"kernel_isolate main path: kernel launches {counts}")
    _only(counts, ("channel_sum", "channel_sum channel_minor direct",
                   "channel_sum channel_minor staged", "channel_sum channel_first direct"),
          "the memory-path probes")
    return by_path, times


def kernels_of(name: str):
    """The kernel module a model's likelihood launches."""
    return mdl_kernel if MODELS[name].likelihood == "mdl" else dl_kernel


def seeded_model(cfg):
    return build_model(cfg, torch.Generator().manual_seed(SEED)).eval()


def images(n: int) -> np.ndarray:
    return np.random.default_rng(SEED).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def seeded_noise(cfg):
    """One standard-normal tensor ``[k, B, n_i]`` per stochastic layer."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return [torch.randn((cfg.n_samples, BATCH, n), generator=gen, device="cuda")
            for n in cfg.latents()]


def phase_bound(name: str) -> None:
    cfg = MODELS[name]
    kernels = kernels_of(name)
    kernel_model = seeded_model(cfg)
    plain_model = seeded_model(dataclasses.replace(cfg, use_pallas=False))
    x = torch.as_tensor(images(BATCH), device="cuda").float() / 255.0
    eps = seeded_noise(cfg)
    results = {}
    for which, model in (("kernel", kernel_model), ("plain", plain_model)):
        before = kernels.launches
        with torch.inference_mode():
            Qs, Ps, pxz = model(x, cfg.n_samples, eps=eps)
            loss, metrics = compute_loss(prior_for(cfg, "cuda"), Qs, Ps, pxz, x)
        results[which] = (float(loss), metrics["lpxz"].double(), kernels.launches - before)
    (loss_k, lpxz_k, n_k), (loss_p, lpxz_p, n_p) = results["kernel"], results["plain"]
    lpxz_rel = float(((lpxz_k - lpxz_p).abs() / lpxz_p.abs()).max())
    say(f"{name} f32 bound k={cfg.n_samples} B={BATCH}: -iwae kernel {loss_k:.6f}, "
        f"plain {loss_p:.6f}, max rel lpxz diff {lpxz_rel:.3e}, kernel launches {n_k}/{n_p}")
    if not np.isfinite(loss_k) or abs(loss_k - loss_p) > SUM_RTOL * abs(loss_p) or lpxz_rel > SUM_RTOL:
        raise AssertionError(f"{name} bound: kernel and plain version disagree")
    if n_k < 1 or n_p != 0:
        raise AssertionError(f"{name} bound: kernel launched {n_k} times, plain path {n_p}")


def phase_train_step_check(name: str) -> None:
    """One f32 train step of the model, through the kernels and through the
    plain version, from one state, batch and noise: the loss and each
    parameter's gradient, then the whole step."""
    base = MODELS[name]
    kernels = kernels_of(name)
    batch = torch.as_tensor(images(BATCH), device="cuda")
    x = batch.float() / 255.0
    eps = seeded_noise(base)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same conv algorithms in both runs
    results = {}
    for which, use in (("kernel", None), ("plain", False)):
        cfg = experiment(name, model=dataclasses.replace(base, use_pallas=use))
        model = seeded_model(cfg.model)
        state = create_train_state(model, cfg.train)
        before = kernels.launches, kernels.backward_launches
        loss_fn = training_loss_fn(model, cfg, prior_for(cfg.model, "cuda"), x,
                                   cfg.model.n_samples, eps=eps)
        loss, _ = loss_fn(state.params)
        grads = torch.autograd.grad(loss, list(state.params.values()))
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        state, metrics = step(state, batch, eps=eps)
        torch.cuda.synchronize()
        results[which] = (float(loss.detach()), dict(zip(state.params, grads)),
                          float(metrics["loss"]), kernels.launches - before[0],
                          kernels.backward_launches - before[1])
    torch.backends.cudnn.deterministic = deterministic
    loss_k, grads_k, step_k, fwd_k, bwd_k = results["kernel"]
    loss_p, grads_p, step_p, fwd_p, bwd_p = results["plain"]
    rel = {leaf: float((grads_k[leaf] - grads_p[leaf]).norm() / grads_p[leaf].norm())
           for leaf in grads_p}
    leaf = max(rel, key=rel.get)
    say(f"{name} f32 train step k={base.n_samples} B={BATCH}: loss kernel {loss_k:.6f}, "
        f"plain {loss_p:.6f} (step {step_k:.6f} / {step_p:.6f}); max norm-relative gradient "
        f"diff {rel[leaf]:.3e} ({leaf}, of {len(rel)} leaves); kernel launches forward "
        f"{fwd_k}/{fwd_p}, backward {bwd_k}/{bwd_p}")
    for a, b in ((loss_k, loss_p), (step_k, step_p), (loss_k, step_k)):
        if not np.isfinite(a) or abs(a - b) > SUM_RTOL * abs(b):
            raise AssertionError(f"{name} train step: kernel and plain losses disagree")
    if not np.isfinite(rel[leaf]) or rel[leaf] > GRAD_RTOL:
        raise AssertionError(f"{name} train step: {leaf} gradients differ beyond tolerance")
    if fwd_k < 1 or bwd_k < 1 or fwd_p != 0 or bwd_p != 0:
        raise AssertionError(f"{name} train step: kernels launched {fwd_k}+{bwd_k} times, "
                             f"plain path {fwd_p}+{bwd_p}")


def configs_of(name: str, plain: bool) -> dict:
    """The float32 parity config, the bfloat16 config (bf16 conv body; the
    MoDL's head -> likelihood boundary in bf16 too, the DL head stays
    float32) and, for training, float32 through the plain version."""
    base = MODELS[name]
    io_dtype = "bfloat16" if base.likelihood == "mdl" else None
    configs = {
        "f32": base,
        "bf16": dataclasses.replace(base, compute_dtype="bfloat16", likelihood_io_dtype=io_dtype),
    }
    if plain:
        configs["f32 plain"] = dataclasses.replace(base, use_pallas=False)
    return configs


def train_pool() -> torch.Tensor:
    """One call's worth of seeded synthetic uint8 batches, on the card."""
    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.integers(0, 256, (TRAIN_STEPS_PER_CALL, BATCH, 32, 32, 3),
                                        dtype=np.uint8), device="cuda")


def phase_train(name: str, smi: str):
    """The main path of training. -> {config: imgs/s}."""
    pool = train_pool()
    rates = {}
    for which, mcfg in configs_of(name, plain=True).items():
        cfg = experiment(name, model=mcfg)
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
        rates[which] = TRAIN_STEPS_PER_CALL * BATCH / (float(np.median(block_ms)) / 1e3)
        say(f"{name} train {which} k={mcfg.n_samples} B={BATCH}: {rates[which]:.1f} imgs/s "
            f"(median of {TRAIN_BLOCKS} calls of {TRAIN_STEPS_PER_CALL} steps: "
            f"{', '.join(f'{ms:.2f}' for ms in block_ms)} ms; peak {peak:.2f} GiB); "
            f"loss {first:.4f} after {TRAIN_STEPS_PER_CALL} steps, {last:.4f} after "
            f"{(TRAIN_BLOCKS + 1) * TRAIN_STEPS_PER_CALL} on {smi}")
        if not (np.isfinite(first) and np.isfinite(last)) or last >= first:
            raise AssertionError(f"{name} train {which}: loss {first} -> {last} is not finite and falling")
        if state.step != (TRAIN_BLOCKS + 1) * TRAIN_STEPS_PER_CALL:
            raise AssertionError(f"{name} train {which}: state at step {state.step}")
    return rates


def traced(fn):
    """Run ``fn()`` under ``torch.profiler``. -> (host milliseconds of the
    traced run, device kernels launched, {kernel class: device ms},
    {likelihood kernel class: launches})."""
    wall_ms, kernels = device_times(fn)
    by_class: dict = {}
    launches: dict = {}
    n_kernels = 0
    for name, (count, ms) in kernels.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        n_kernels += count
        if cls.startswith(("MoDL", "DL")):
            launches[cls] = launches.get(cls, 0) + count
    return wall_ms, n_kernels, by_class, launches


def device_profile(fn, reps: int):
    """-> (device kernels per call of ``fn``, {kernel class: device ms per
    call}), over ``reps`` traced calls after a warm-up."""
    fn()
    _, n_kernels, by_class, _ = traced(lambda: [fn() for _ in range(reps)])
    return n_kernels / reps, {cls: ms / reps for cls, ms in by_class.items()}


def phase_profile(name: str) -> None:
    """Device time by kernel class over 5 train steps of each config, and the
    likelihood kernels' device time per launch."""
    pool = train_pool()
    for which, mcfg in configs_of(name, plain=False).items():
        cfg = experiment(name, model=mcfg)
        model = seeded_model(mcfg)
        state = create_train_state(model, cfg.train)
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        for batch in pool[:2]:
            state, _ = step(state, batch)

        def five_steps():
            nonlocal state
            for batch in pool[:5]:
                state, _ = step(state, batch)

        wall_ms, n_kernels, by_class, launches = traced(five_steps)
        busy = sum(by_class.values())
        shares = ", ".join(f"{cls} {ms:.3f} ms ({ms / busy:.1%})"
                           for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]))
        per_launch = ", ".join(f"{cls} {by_class[cls] / n:.4f} ms per launch ({n} launches)"
                               for cls, n in sorted(launches.items()))
        say(f"profile {name} train {which}, 5 steps: wall {wall_ms:.3f} ms (traced), "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}, "
            f"{n_kernels} device kernels; {shares}; {per_launch}")


def phase_eval(name: str, smi: str):
    """The main path of evaluation. -> {config: imgs/s}."""
    batch = images(BATCH)
    rates = {}
    base = MODELS[name]
    for which, cfg in configs_of(name, plain=False).items():
        model = seeded_model(cfg)
        ecfg = experiment(name, model=cfg)
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
        rates[which] = BATCH / seconds
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"{name} 5000-IS {which}: llh {llh:.4f} nats, bpd {metrics['bpd']:.6f} "
            f"(seed {SEED + 1}: llh {llh2:.4f}); {rates[which]:.2f} imgs/s "
            f"({seconds:.3f} s per batch of {BATCH}, peak {peak:.1f} GiB) on {smi}")
        values = [llh, metrics["bpd"], llh2, metrics2["bpd"]]
        if not (np.isfinite(values).all() and np.isfinite(per_image).all()):
            raise AssertionError(f"{name} 5000-IS {which}: non-finite result")
        if per_image.shape != (BATCH,):
            raise AssertionError(f"{name} 5000-IS {which}: per-image shape {per_image.shape}")

    # the same 200-sample evaluation through the kernel and the plain version
    plain_cfg = dataclasses.replace(base, use_pallas=False)
    got = evaluate_llh(seeded_model(base), experiment(name), batch, n_samples=200,
                       k_chunk=100, batch_size=BATCH, seed=SEED)[1]
    want = evaluate_llh(seeded_model(plain_cfg), experiment(name, model=plain_cfg),
                        batch, n_samples=200, k_chunk=100, batch_size=BATCH, seed=SEED)[1]
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    say(f"{name} 200-IS f32 kernel vs plain: max rel per-image diff {rel:.3e}")
    if rel > SUM_RTOL:
        raise AssertionError(f"{name} evaluator: kernel and plain version disagree")
    return rates


def phase_layout() -> dict:
    """The memory layout in which each model's head hands its output to the
    likelihood kernel, read off the strides: the decoder's dense layer is
    reshaped to an NHWC grid and viewed as NCHW, which is channels-last
    memory, and cuDNN keeps a channels-last input's format through the
    stack. -> {"model05": "nhwc" | "nchw", "model03": the same}: the layout
    whose case goes into the kernels line."""
    layouts = {}
    for name in ("model05", "model03"):
        cfg = MODELS[name]
        model = seeded_model(cfg)
        x = torch.as_tensor(images(2), device="cuda").float() / 255.0
        with torch.inference_mode():
            dist = model(x, 1, generator=torch.Generator("cuda").manual_seed(SEED))[2].dist
        head = dist.parameters if cfg.likelihood == "mdl" else dist.loc
        channel, width = head.stride(-1), head.stride(-2)
        layouts[name] = "nhwc" if channel < width else "nchw"
        say(f"{name}: the head hands the likelihood {tuple(head.shape)} with strides "
            f"{head.stride()}: {layouts[name]}")
    return layouts


def main_path(name: str, path: str, smi: str) -> dict:
    """Drive one main path with every count set to 0 just before it and read
    just after. -> {kernel name: launches}; fails unless the path launched
    its own kernels (the forward; in training the backward too) and no
    other."""
    reset_probe_counts()
    if path == "eval":
        phase_eval(name, smi)
    else:
        phase_train(name, smi)
    counts = probe_counts()
    say(f"{name} {path} main path: kernel launches {counts}")
    own = "mdl_log_prob" if MODELS[name].likelihood == "mdl" else "dl_log_prob"
    _only(counts, [own] + ([f"{own}_backward"] if path == "train" else []),
          f"the {name} {path} path")
    return counts


def main() -> None:
    smi = phase_device()
    phase_build()
    layouts = phase_layout()
    k6_err = phase_sfu_check()
    by_path = {"roofline": roofline_path(smi)}
    k6_case = k6_record(k6_err)
    max_err, fwd_cases = phase_kernel_vs_plain()
    bwd_err, bwd_excess, bwd_cases = phase_backward()
    dl_err, dl_bwd_err, dl_cases, dl_bwd_cases = phase_dl_kernels()
    io_cases = phase_io_probes()
    for name in ("model05", "model03"):
        phase_bound(name)
    for name in ("model05", "model03", "model04", "model06"):
        phase_train_step_check(name)
    phase_small_models(smi)

    by_path.update({f"{name} {path}": main_path(name, path, smi)
                    for name in ("model05", "model03") for path in ("eval", "train")})
    structure_counts, isolate_ms = structure_path(smi)
    by_path.update(structure_counts)
    for name in ("model05", "model03"):
        phase_profile(name)

    def record(kernel, source, replaces, max_abs_err, case, counter=None, paths=None, **more):
        """One entry of the kernels line; ``launches`` sums the main paths'
        counts of ``counter`` (default: the kernel's name) over ``paths``
        (default: all)."""
        launches = {path: counts[counter or kernel] for path, counts in by_path.items()
                    if counts.get(counter or kernel) and (paths is None or path in paths)}
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(launches.values()), "launches_by_path": launches,
                "max_abs_err": max_abs_err, "library_ms": None, **case, **more}

    modl, dl = layouts["model05"], f"{layouts['model03']} halves"

    def null_record(direction, variant):
        case = io_cases[f"P3 {direction} {variant} float32 k=5 B={BATCH} {modl}"]
        return record(f"mdl_null_{direction}[{variant}]", IO_SOURCE, REPLACES_P3,
                      case["max_abs_err"], case, counter=f"mdl_null_{direction}",
                      paths=(f"kernel_structure {variant}",))

    def sum_record(kernel, replaces, case, timed, library):
        """A channel sum's entry: checked in phase_io_probes, timed by the
        memory-path probes; its plain version is the library's ``sum``."""
        case = io_cases[case]
        counter = "channel_sum " + kernel[kernel.index("[") + 1:-1].replace(",", " ")
        return record(kernel, IO_SOURCE, replaces, case["max_abs_err"], case, counter=counter,
                      ms=isolate_ms[timed], plain_ms=isolate_ms[library],
                      library_ms=isolate_ms[library])

    kernels = [
        record("mdl_log_prob", MODL_SOURCE, REPLACES, max_err,
               fwd_cases[f"K3f/K1f eval float32 k=100 B={BATCH} {modl}"]),
        record("mdl_log_prob_backward", MODL_SOURCE, REPLACES_BACKWARD, bwd_err["float32"],
               bwd_cases[f"K1b/K3b float32 k=5 B={BATCH} {modl}"],
               max_abs_err_bf16=bwd_err["bfloat16"], tolerance_excess=bwd_excess),
        record("dl_log_prob", DL_SOURCE, REPLACES_DL, dl_err,
               dl_cases[f"K5 f32 k=100 B={BATCH} {dl}"]),
        record("dl_log_prob_backward", DL_SOURCE, REPLACES_DL, dl_bwd_err,
               dl_bwd_cases[f"K5 f32 k=5 B={BATCH} {dl}"],
               replaces_note=REPLACES_DL_BACKWARD_NOTE),
        record("sfu_probe", SFU_SOURCE, REPLACES_K6, k6_case["max_abs_err"], k6_case),
        sum_record("channel_sum[channel_minor,direct]", REPLACES_P1, "P1 channel_minor direct",
                   "direct", "library sum(-1)"),
        sum_record("channel_sum[channel_minor,staged]", REPLACES_P1,
                   "P1 channel_minor staged tile=256", "staged tile=256", "library sum(-1)"),
        sum_record("channel_sum[channel_first,direct]", REPLACES_P2, "P2 channel_first direct",
                   "channel-first direct", "library sum(1)"),
        null_record("forward", "dma"), null_record("forward", "staged"),
        null_record("backward", "dma"), null_record("backward", "staged"),
    ]
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"no main path launched {entry['name']}")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
