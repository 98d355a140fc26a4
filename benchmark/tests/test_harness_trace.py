"""The traced slice cut between its two markers: what the per-layer metrics
read is the device's time from the first marked step to the last, with the
markers themselves left out."""
from __future__ import annotations

import pytest

from benchmark.lib import trace


def _slice(device, host=(), start=0.0, wall=10.0):
    return trace.Slice(device=list(device), host=list(host), wall_s=wall, start_s=start)


def test_between_marks_clips_to_the_marked_interval():
    sl = _slice([("prefetch_copy", 0.0, 1.5), ("at::cuda::spin_kernel(long)", 2.0, 1e-6),
                 ("conv", 2.5, 1.0), ("edge", 5.5, 1.0), ("spin_kernel(long)", 6.0, 1e-6),
                 ("save", 7.0, 2.0)],
                host=[("fit", 0.0, 10.0), ("late", 6.5, 1.0)])
    cut = trace.between_marks(sl)
    assert cut.start_s == 2.0 and cut.wall_s == 4.0
    assert cut.device == [("conv", 2.5, 1.0), ("edge", 5.5, 0.5)]
    assert cut.host == [("fit", 2.0, 4.0)]
    assert cut.busy_s() == 1.5
    assert cut.gaps() == [(2.0, 2.5), (3.5, 5.5)]


def test_between_marks_without_its_markers_raises():
    with pytest.raises(RuntimeError, match="markers"):
        trace.between_marks(_slice([("conv", 0.0, 1.0), ("at::cuda::spin_kernel(long)", 2.0, 1e-6)]))
