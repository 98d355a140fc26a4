"""Device milliseconds of the optimizer's multi-tensor kernels a train step
of the traced slice."""


def read(sl, cell, suffix=None):
    if not sl.steps:
        return None
    ms = 1e3 * sl.class_s("optimizer") / sl.steps
    return ms if ms > 0 else None
