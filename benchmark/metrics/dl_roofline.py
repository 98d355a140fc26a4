"""The discretized-logistic kernels' share of their roofline: the least time
of the DL work the slice did (``lib/counts``: one forward and one backward a
train step over the head ``[k, B, H, W, 2C]``, the backward handed one
cotangent a sample and image; one forward a k-chunk of the evaluator), over
the device time of the kernels named below. Nothing to read where no such
kernel ran. ``dl_roofline.train`` and ``dl_roofline.eval``."""
from benchmark.lib import counts

KERNELS = ("DL forward", "DL backward")


def read(sl, cell, suffix=None):
    device_s = sum(sl.class_s(k) for k in KERNELS)
    if device_s <= 0 or cell.peaks is None:
        return None
    model, mix = cell.config["model"], cell.mix
    h, w, c = model["image_shape"]
    b = mix["batch_size"]
    if mix["driver"] == "train":
        k = model["n_samples"]
        least_ms = sl.steps * (counts.least_ms(*counts.dl_forward(k, b, h, w, c), cell.peaks)
                               + counts.least_ms(*counts.dl_backward(k, b, h, w, c, k * b),
                                                 cell.peaks))
    else:
        chunks = sl.batches * (mix["n_samples"] // mix["k_chunk"])
        least_ms = chunks * counts.least_ms(*counts.dl_forward(mix["k_chunk"], b, h, w, c),
                                            cell.peaks)
    return 100.0 * least_ms / (1e3 * device_s)
