"""Device milliseconds of every other kernel (activations, casts, resizes,
reductions, copies and fills: neither a convolution, the optimizer's
multi-tensor kernels nor a likelihood kernel) a train step of the traced
slice."""


def read(sl, cell, suffix=None):
    return 1e3 * sl.class_s("elementwise") / sl.steps if sl.steps else None
