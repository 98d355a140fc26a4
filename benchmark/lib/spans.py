"""The program's own spans in a traced slice: the host rows that
``vae_mdl_tpu_torch/utils/tracing.py`` names ``vae/<name>``, already
clipped to the slice (``trace.between_marks``), and the totals of its timed
boundaries. A program without them (an older commit) gives None, never 0.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

PREFIX = "vae/"


def _rows(sl, name: str) -> List[Tuple[float, float]]:
    """``(start, end)`` of the slice's host rows named ``vae/<name>``."""
    return [(s, s + length) for n, s, length in sl.host if n == PREFIX + name]


def total_s(sl, name: str) -> Optional[float]:
    """Summed seconds of the rows of span ``name``; None where there is none."""
    rows = _rows(sl, name)
    return sum(end - start for start, end in rows) if rows else None


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def self_s(sl, parent: str, children: Iterable[str]) -> Optional[float]:
    """Seconds of span ``parent``'s rows that no row of ``children`` covers:
    each parent row's length less the part of it under the children's rows.
    None where the slice holds no row of ``parent``."""
    parents = _rows(sl, parent)
    if not parents:
        return None
    covered = _union(row for child in children for row in _rows(sl, child))
    starts = [start for start, _ in covered]
    total = 0.0
    for lo, hi in parents:
        under = 0.0
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(covered) and covered[i][0] < hi:
            under += max(0.0, min(hi, covered[i][1]) - max(lo, covered[i][0]))
            i += 1
        total += (hi - lo) - under
    return total


def timed_total(name: str) -> Optional[Tuple[int, float]]:
    """``(calls, seconds)`` of the program's timed boundary ``name`` in this
    process; None where the program keeps no such total or made no call."""
    try:
        import vae_mdl_tpu_torch.utils.tracing as tracing
    except ImportError:
        return None
    count, seconds = tracing.totals().get(name, (0, 0.0))
    return (count, seconds) if count else None
