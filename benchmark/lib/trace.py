"""The traced slice of a run: the device's operations under
``torch.profiler``, and what the per-layer metrics read from them.

A slice is one call into the program (a ``Trainer.fit`` call, a run of
``evaluate_llh`` batches) traced whole, or the part of it between two
markers (``mark``): a spin of one cycle on the card, launched on the
current stream just before the work it marks, so that its start on the
device is where that work starts. Its operations are the profiler's device
events (kernels, copies, fills) with their start and length; the host's
events are kept to name what the host was doing in the device's idle gaps.
Nothing is written to disk.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, List, Tuple

import torch

# kernel-name fragments of the program's own kernels, most specific first;
# matched at a word start, so that "dl_log_prob" is not found in
# "mdl_log_prob"
_OWN = (
    ("mdl_log_prob_backward_kernel", "MoDL backward"),
    ("mdl_log_prob_kernel", "MoDL forward"),
    ("dl_log_prob_backward_kernel", "DL backward"),
    ("dl_log_prob_kernel", "DL forward"),
)
MARK = "spin_kernel("  # the kernel ``mark`` launches (``torch.cuda._sleep``)
_CONV = ("conv", "gemm", "cudnn", "xmma", "cutlass", "wgrad", "dgrad", "fft", "flip_filter",
         "region_transform")


def kernel_class(name: str) -> str:
    """One of the program's likelihood kernels, "conv/gemm" (cuDNN and
    cuBLAS, with cuDNN's FFT, filter-flip and layout kernels), "optimizer"
    (multi-tensor kernels) or "elementwise" (everything else, copies and
    fills included): the program's ``utils/timing.kernel_class``, frozen."""
    for fragment, cls in _OWN:
        if re.search(r"(?<![A-Za-z0-9_])" + fragment, name):
            return cls
    lowered = name.lower()
    if any(t in lowered for t in _CONV):
        return "conv/gemm"
    if "multi_tensor" in lowered or "foreach" in lowered:
        return "optimizer"
    return "elementwise"


@dataclasses.dataclass
class Slice:
    """A traced call: device operations ``(name, start_s, length_s)`` on
    the run's clock, host operations the same, the call's wall seconds and
    the work it did (``steps``, ``batches``, ``images``)."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    start_s: float
    steps: int = 0
    batches: int = 0
    images: int = 0

    def device_s(self, select: Callable[[str], bool]) -> float:
        return sum(length for name, _, length in self.device if select(name))

    def class_s(self, cls: str) -> float:
        return self.device_s(lambda name: kernel_class(name) == cls)

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        busy, end = 0.0, float("-inf")
        for _, start, length in sorted(self.device, key=lambda e: e[1]):
            stop = start + length
            if start > end:
                busy += length
                end = stop
            elif stop > end:
                busy += stop - end
                end = stop
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """The device's idle intervals inside the call, ``(start, end)``."""
        out, end = [], self.start_s
        for _, start, length in sorted(self.device, key=lambda e: e[1]):
            if start > end:
                out.append((end, start))
            end = max(end, start + length)
        if self.start_s + self.wall_s > end:
            out.append((end, self.start_s + self.wall_s))
        return out

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time, and the ``n``
        longest idle gaps named by the innermost host operation under each
        gap's middle."""
        by_name: Dict[str, float] = {}
        for name, _, length in self.device:
            by_name[name] = by_name.get(name, 0.0) + length
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        named = []
        for start, end in gaps:
            mid = (start + end) / 2.0
            under = [(length, name) for name, s, length in self.host if s <= mid <= s + length]
            named.append([min(under)[1] if under else "host: no traced operation", end - start])
        return {"device_ops": [[name, s] for name, s in ops], "idle_gaps": named}


def mark() -> None:
    """A marker on the card's current stream: a kernel of one cycle."""
    torch.cuda._sleep(1)


def between_marks(sl: Slice) -> Slice:
    """``sl`` cut to the device's time from the start of its first marker
    to the start of its last: the device's and the host's operations clipped
    to that interval, the markers left out, the wall time the interval's."""
    starts = sorted(s for name, s, _ in sl.device if MARK in name)
    if len(starts) < 2:
        like = sorted({name for name, _, _ in sl.device if "spin" in name or "sleep" in name})
        raise RuntimeError(f"the trace holds {len(starts)} of the slice's two markers "
                           f"(device operations named like one: {like[:5]})")
    a, b = starts[0], starts[-1]

    def clip(rows, drop_marks):
        out = []
        for name, s, length in rows:
            lo, hi = max(s, a), min(s + length, b)
            if hi > lo and not (drop_marks and MARK in name):
                out.append((name, lo, hi - lo))
        return out

    return dataclasses.replace(sl, device=clip(sl.device, True), host=clip(sl.host, False),
                               wall_s=b - a, start_s=a)


def traced(fn: Callable[[], object]) -> Tuple[object, Slice]:
    """``fn()`` under ``torch.profiler`` with the card's activity: its result
    and its ``Slice`` (work counts left 0 for the caller to fill)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0_ns = time.perf_counter_ns()
        result = fn()
        torch.cuda.synchronize()
        wall_s = (time.perf_counter_ns() - t0_ns) / 1e9
    device, host = [], []
    for evt in prof.profiler.kineto_results.events():
        row = (evt.name(), evt.start_ns() / 1e9, evt.duration_ns() / 1e9)
        (device if evt.device_type() == DeviceType.CUDA else host).append(row)
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    # on the profiler's clock the call starts with its first event
    start_s = min(s for _, s, _ in host + device)
    return result, Slice(device=device, host=host, wall_s=wall_s, start_s=start_s)
