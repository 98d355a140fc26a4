"""The whole train step's share of the card's peak: the analytic FLOPs of an
image's step (``lib/counts.train_flops``) times the traced slice's images a
second, over the published peak of the configuration's compute dtype."""
from benchmark.lib import counts


def read(sl, cell, suffix=None):
    if not sl.images or cell.peaks is None:
        return None
    model = cell.config["model"]
    rate = counts.train_flops(model) * sl.images / sl.wall_s
    return 100.0 * rate / cell.peaks[model["compute_dtype"]]
