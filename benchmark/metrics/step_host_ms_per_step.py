"""Host milliseconds a train step of the traced slice spent inside the
captured step's call: the program's ``vae/step.train`` span
(``CapturedStep.__call__``: copy-in, re-seeding, the graph's launch,
copy-out), summed over the slice."""
from benchmark.lib import spans


def read(sl, cell, suffix=None):
    total = spans.total_s(sl, "step.train")
    return 1e3 * total / sl.steps if total is not None and sl.steps else None
