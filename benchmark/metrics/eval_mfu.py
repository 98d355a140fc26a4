"""The evaluator's share of the card's peak: the analytic forward FLOPs of an
image at the mix's samples times the traced slice's images a second, over
the published peak of the configuration's compute dtype."""
from benchmark.lib import counts


def read(sl, cell, suffix=None):
    if not sl.images or cell.peaks is None:
        return None
    model = cell.config["model"]
    rate = counts.forward_flops(model, cell.mix["n_samples"]) * sl.images / sl.wall_s
    return 100.0 * rate / cell.peaks[model["compute_dtype"]]
