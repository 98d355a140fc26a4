"""Hand-written CUDA kernel: the special-function throughput probe.

Port of ``vae_mdl_tpu/ops/pallas/vpu_probe.py``: the Pallas loop kernel
``_loop_probe`` becomes ``csrc/sfu_probe.cu`` (its header says what it
measures and how it is laid out), and ``measure_op_rate``, ``measure_rates``
and ``vpu_floor_seconds`` keep their names and meaning. The floor it prices,

    floor_seconds = sum_op  census[op] / measured_rate[op]

is the time a kernel's transcendentals take as the accurate functions these
kernels call, with the census from ``utils/flops.py``: what those instruction
sequences attain, not a bound of the card (``logf`` needs no special-function
instruction at all). The card's own bound is the calls' MUFU instructions
(``utils/flops.py`` ``mufu_instructions``) over ``sfu_peak_per_second``.

- ``loop_probe(x, op, iters, ...)`` applies ``op`` ``iters`` times to every
  element, each application followed by ``v * scale + shift``: with the
  defaults 1 and 0 that is ``op^iters``, what the TPU kernel computes. CPU
  tensors take the plain version ``loop_probe_plain``; CUDA tensors launch the
  kernel (``loop_probe_cuda``), which raises on what it does not take. There
  is no fallback between them.
- Rates are differential: the same launch at two loop depths, extra
  evaluations over extra time from CUDA events, median of repeats, so the
  launch and the traffic cancel. The timed chains are re-ranged (``RERANGE``:
  a scale and shift per op that hold the chain at a fixed point in the normal
  range; exp would reach inf in three steps and log nan in two, and the
  accurate functions treat those apart). ``measure_op_rate`` gives the rate
  of op plus re-ranging; ``measure_rates`` subtracts the time of the
  re-ranging alone (the op ``none``), which can only raise a rate and lower
  the floor priced with it.
- Geometry: 256 threads a block as the MoDL kernels, ``DEFAULT_BLOCKS`` the
  blocks of their k = 5, B = 128 launch, ``CONTROL_BLOCKS`` eight times that,
  ``chains`` independent chains a thread (1, 2, 4, 8 or 16).
- ``launches`` counts the kernel's launches; callers reset it to 0 and read
  it to show that a run went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import re
import shutil
import subprocess
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from vae_mdl_tpu_torch.distributions.continuous import softplus
from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.ops.cuda.build import CSRC, build, mufu_counts

SOURCE = CSRC / "sfu_probe.cu"
BLOCK_THREADS = 256
DEFAULT_BLOCKS = 5 * 128 * 32 * 32 // BLOCK_THREADS  # the MoDL train launch: 2560
CONTROL_BLOCKS = 8 * DEFAULT_BLOCKS
DEFAULT_CHAINS = 8
CHAINS = (1, 2, 4, 8, 16)
# special-function results per clock per SM at compute capability 9.0
# (NVIDIA's arithmetic-throughput table)
SFU_PER_CLOCK_PER_SM = 16

# kernel launches since the counter was last set to 0
launches = 0


def cascade(v: torch.Tensor) -> torch.Tensor:
    """The fused discretized-logistic cascade as one op, on the MoDL's bins:
    what ``scripts/vpu_roofline.py`` times against the additive model."""
    return discretized_logistic_log_prob(v, 0.9 * v, 0.1 * v, low=-1.0, high=1.0,
                                         interval_width=2.0 / 255.0)


# the ops the census counts, in its units (one call of the function)
OPS: Dict[str, Callable] = {
    "exp": torch.exp,
    "log": torch.log,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": softplus,
}
# every op the kernel has: the five, the cascade, and the re-ranging alone
_ALL_OPS: Dict[str, Callable] = {"none": lambda v: v, **OPS, "cascade": cascade}
_OP_CODES = {name: code for code, name in enumerate(
    ("none", "exp", "log", "tanh", "sigmoid", "softplus", "cascade"))}

# (scale, shift) that hold a chain of v <- op(v) * scale + shift near a fixed
# point in the normal range: exp 0.49, log 2.36, tanh 1.37 (tanhf's
# exponential path), sigmoid 0.66, softplus 0.48, the cascade 0.63 (inside
# the bins: the CDF-difference branch), the re-ranging alone 1.0
RERANGE: Dict[str, Tuple[float, float]] = {
    "none": (0.5, 0.5),
    "exp": (0.3, 0.0),
    "log": (1.0, 1.5),
    "tanh": (1.0, 0.5),
    "sigmoid": (1.0, 0.0),
    "softplus": (0.5, 0.0),
    "cascade": (-0.1, 0.0),
}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sfu_probe.argtypes = [ptr, ptr, i32, i32, i32, i32, f32, f32, ptr]
    lib.sfu_probe.restype = i32
    return lib


def loop_probe_plain(x: torch.Tensor, op: str, iters: int, scale: float = 1.0,
                     shift: float = 0.0) -> torch.Tensor:
    """The kernel's plain version: ``v <- op(v) * scale + shift``, ``iters``
    times, elementwise."""
    fn = _ALL_OPS[op]
    v = x
    for _ in range(iters):
        v = fn(v) * scale + shift
    return v


def loop_probe_cuda(x: torch.Tensor, op: str, iters: int, chains: int = DEFAULT_CHAINS,
                    scale: float = 1.0, shift: float = 0.0) -> torch.Tensor:
    """The kernel: a contiguous float32 CUDA tensor of ``blocks * 256 *
    chains`` elements -> the same shape, ``blocks`` following from its size."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"the probe kernel takes CUDA tensors only; got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"the probe kernel takes contiguous float32; got {x.dtype}, "
                        f"strides {x.stride()}")
    if op not in _OP_CODES:
        raise ValueError(f"op must be one of {sorted(_OP_CODES)}; got {op!r}")
    if chains not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}; got {chains}")
    per_block = BLOCK_THREADS * chains
    if x.numel() == 0 or x.numel() % per_block:
        raise ValueError(f"the probe kernel takes a multiple of {per_block} elements "
                         f"(256 threads x {chains} chains); got {x.numel()}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0; got {iters}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().sfu_probe(x.data_ptr(), out.data_ptr(), _OP_CODES[op], chains,
                                   x.numel() // per_block, iters, scale, shift,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sfu_probe kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def loop_probe(x: torch.Tensor, op: str, iters: int, chains: int = DEFAULT_CHAINS,
               scale: float = 1.0, shift: float = 0.0) -> torch.Tensor:
    """``op`` applied ``iters`` times per element in a loop-carried chain:
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return loop_probe_plain(x, op, iters, scale, shift)
    return loop_probe_cuda(x, op, iters, chains, scale, shift)


def _device(device) -> torch.device:
    """The card unless the caller asks for the CPU; never the CPU by default."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the probe measures on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to run its "
                "plain version on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def probe_input(blocks: int, chains: int, device) -> torch.Tensor:
    """Seeded inputs in [0.5, 1.5], as the TPU probe's."""
    n = blocks * BLOCK_THREADS * chains
    x = np.random.default_rng(0).uniform(0.5, 1.5, n).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _time_call(fn: Callable[[], torch.Tensor], device: torch.device, repeats: int) -> float:
    """Median seconds of ``fn()`` over ``repeats`` runs after a warm-up: CUDA
    events around the launch on a card, the host's clock on the CPU."""
    fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_op_rate(name: str, *, blocks: int = DEFAULT_BLOCKS, chains: int = DEFAULT_CHAINS,
                    iters: Tuple[int, int] = (200, 2200), repeats: int = 5,
                    device=None) -> float:
    """Measured evaluations per second of one op (with its re-ranging
    multiply and add) at the probe geometry: differential over the two loop
    depths, so the launch and the traffic cancel."""
    device = _device(device)
    x = probe_input(blocks, chains, device)
    scale, shift = RERANGE[name]
    lo, hi = iters
    t_lo = _time_call(lambda: loop_probe(x, name, lo, chains, scale, shift), device, repeats)
    t_hi = _time_call(lambda: loop_probe(x, name, hi, chains, scale, shift), device, repeats)
    return x.numel() * (hi - lo) / (t_hi - t_lo)


def measure_raw_rates(names: Optional[Iterable[str]] = None, **kw) -> Dict[str, float]:
    """Evaluations per second per op name, each with its re-ranging, and of
    the re-ranging alone under ``"none"``."""
    return {n: measure_op_rate(n, **kw) for n in ("none", *(names or OPS))}


def subtract_identity(raw: Dict[str, float]) -> Dict[str, float]:
    """Op-only rates from ``measure_raw_rates``: the time of an evaluation
    less that of the re-ranging alone. Where the two overlap in the pipes
    this takes off too much, so the rate is an upper estimate and a floor
    priced with it errs low."""
    return {n: 1.0 / (1.0 / r - 1.0 / raw["none"]) for n, r in raw.items() if n != "none"}


def measure_rates(names: Optional[Iterable[str]] = None, **kw) -> Dict[str, float]:
    """Evaluations per second per op name (default: every op the census
    uses), the re-ranging's time taken off."""
    return subtract_identity(measure_raw_rates(names, **kw))


def sfu_floor_seconds(counts: Dict[str, float], rates: Dict[str, float]) -> float:
    """The arithmetic floor: the time ``counts`` evaluations take at the
    measured per-op rates. Ops of different kinds share the special-function
    and float32 pipes, so their times add; the cascade measured as one op
    checks that (``probes/roofline.py``)."""
    return sum(counts[op] / rates[op] for op in counts)


vpu_floor_seconds = sfu_floor_seconds  # the name in vae_mdl_tpu/ops/pallas/vpu_probe.py


# -- the card's own ceiling -----------------------------------------------------


def sm_clock_under_load(seconds: float = 2.0) -> Optional[float]:
    """The SM clock in MHz that ``nvidia-smi`` reports while a probe launch of
    about ``seconds`` runs; None where ``nvidia-smi`` is missing."""
    if shutil.which("nvidia-smi") is None:
        return None
    x = probe_input(DEFAULT_BLOCKS, DEFAULT_CHAINS, _device(None))
    rate = measure_op_rate("sigmoid", repeats=1)
    iters = max(1, int(seconds * rate / x.numel()))
    loop_probe(x, "sigmoid", iters, DEFAULT_CHAINS, *RERANGE["sigmoid"])  # runs on
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return float(out.strip().splitlines()[0])


def sfu_peak_per_second(sm_clock_mhz: float, device=None) -> float:
    """Special-function results per second of the whole card at that clock."""
    n_sm = torch.cuda.get_device_properties(_device(device)).multi_processor_count
    return n_sm * SFU_PER_CLOCK_PER_SM * sm_clock_mhz * 1e6


def mufu_per_eval(chains: int = DEFAULT_CHAINS) -> Optional[Dict[str, Dict[str, float]]]:
    """MUFU instructions per evaluation of each op, by kind, counted in the
    SASS of the built library: the loop over the depth is not unrolled, so a
    kernel's listing holds the instructions of ``chains`` evaluations once,
    every branch of the function included (a division's slow path too). None
    where the toolkit has no ``cuobjdump``."""
    by_kernel = mufu_counts(build(SOURCE))
    if by_kernel is None:
        return None
    names = {code: name for name, code in _OP_CODES.items()}
    out: Dict[str, Dict[str, float]] = {}
    for kernel, kinds in by_kernel.items():
        match = re.search(r"sfu_probe_kernelILi(\d+)ELi(\d+)EE", kernel)
        if match and int(match.group(2)) == chains:
            out[names[int(match.group(1))]] = {k: n / chains for k, n in kinds.items()}
    return out
