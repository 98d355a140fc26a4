"""Seconds the run spent capturing CUDA graphs, on the host's clock: the
program's timed ``capture`` boundary (a key's warm-up and capture), summed
over the run, which captures during set-up only. Serves every suffix
(``capture_s.train``: the train and eval steps; ``capture_s.eval``: the
evaluator's batch)."""
from benchmark.lib import spans


def read(sl, cell, suffix=None):
    total = spans.timed_total("capture")
    return total[1] if total is not None else None
