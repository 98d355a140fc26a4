"""Host milliseconds a train step of the traced slice spent waiting on the
data pipeline's producer thread: the program's ``vae/data.wait`` span
(``DevicePrefetch.__next__``), summed over the slice."""
from benchmark.lib import spans


def read(sl, cell, suffix=None):
    total = spans.total_s(sl, "data.wait")
    return 1e3 * total / sl.steps if total is not None and sl.steps else None
