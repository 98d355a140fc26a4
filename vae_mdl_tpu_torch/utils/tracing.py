"""Spans and counters of the program, on the clock of whatever
``torch.profiler`` is recording.

``span(name)`` is a profiler range named ``"vae/" + name`` while a
profiler records, and one shared null context otherwise: a read of the
profiler's module flag, no allocation and no clock read, so it may sit on a
path taken every step. The range is a host operation
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): with the card's activity on, the
profiler mirrors each user annotation onto the device's timeline as a range
over the kernels launched inside it, and a reader of the device's events
would count that range as device work. ``timed(name)`` opens the
same range and always adds the call and its seconds (``time.perf_counter``)
to a process-wide total under ``name``: for rare boundaries (a capture, a
checkpoint save), never once a step. ``totals()`` copies the totals,
``reset()`` clears them.

The profiler records the ranges of the thread it runs on, not those of
other threads, so the spans sit on the main thread: the prefetch
producer's lateness is the consumer's wait for it (``data.wait``).

| Name | Where | Kind |
| --- | --- | --- |
| ``trainer.iter`` | one iteration of ``Trainer._fit_loop`` | span |
| ``data.wait`` | ``DevicePrefetch.__next__``: the wait on the producer | span |
| ``step.train``, ``step.eval`` | ``CapturedStep.__call__`` | span |
| ``capture`` | one key's warm-up and capture (a step's, an evaluator's) | timed |
| ``checkpoint.save`` | ``Checkpointer.save`` | timed |
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Tuple

import torch
import torch.autograd.profiler as _profiler

PREFIX = "vae/"
_NULL = contextlib.nullcontext()
_totals: Dict[str, Tuple[int, float]] = {}
_lock = threading.Lock()


def recording() -> bool:
    """Whether a torch profiler is recording: the module flag that every
    profiler's start sets and its stop clears."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A host range ``"vae/" + name`` while a profiler records, else a
    shared null context."""
    if recording():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _NULL


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    """``span(name)``, and one call and its seconds added to ``name``'s
    total, profiler or not."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        seconds = time.perf_counter() - t0
        with _lock:
            count, total = _totals.get(name, (0, 0.0))
            _totals[name] = (count + 1, total + seconds)


def totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (calls, seconds)}`` of every ``timed`` name, copied."""
    with _lock:
        return dict(_totals)


def reset() -> None:
    with _lock:
        _totals.clear()
