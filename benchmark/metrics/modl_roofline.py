"""The MoDL likelihood kernels' share of their roofline: the least time of
the MoDL work the slice did (``lib/counts``: one forward and one backward a
train step over the head ``[k, B, H, W, 10 n]``, the backward handed one
cotangent a sample and image; one forward a k-chunk of the evaluator), over
the device time of the kernels named below. Nothing to read where no such
kernel ran. ``modl_roofline.train`` and ``modl_roofline.eval``."""
from benchmark.lib import counts

KERNELS = ("MoDL forward", "MoDL backward")


def read(sl, cell, suffix=None):
    device_s = sum(sl.class_s(k) for k in KERNELS)
    if device_s <= 0 or cell.peaks is None:
        return None
    model, mix = cell.config["model"], cell.mix
    h, w, _ = model["image_shape"]
    n_mix, b = model["n_mix"], mix["batch_size"]
    if mix["driver"] == "train":
        k = model["n_samples"]
        fwd = counts.modl_forward(k, b, h, w, n_mix)
        bwd = counts.modl_backward(k, b, h, w, n_mix, cotangent=k * b)
        least_ms = sl.steps * (counts.least_ms(*fwd, cell.peaks)
                               + counts.least_ms(*bwd, cell.peaks))
    else:
        chunks = sl.batches * (mix["n_samples"] // mix["k_chunk"])
        least_ms = chunks * counts.least_ms(*counts.modl_forward(mix["k_chunk"], b, h, w, n_mix),
                                            cell.peaks)
    return 100.0 * least_ms / (1e3 * device_s)
