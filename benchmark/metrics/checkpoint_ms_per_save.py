"""Milliseconds a checkpoint save took, on the host's clock: the program's
timed ``checkpoint.save`` boundary (``Checkpointer.save``), its seconds over
its calls in the run (set-up's saves and the traced call's final one)."""
from benchmark.lib import spans


def read(sl, cell, suffix=None):
    total = spans.timed_total("checkpoint.save")
    return 1e3 * total[1] / total[0] if total is not None else None
