"""Device milliseconds of convolution and matrix-product kernels a batch of
the evaluator in the traced slice."""


def read(sl, cell, suffix=None):
    return 1e3 * sl.class_s("conv/gemm") / sl.batches if sl.batches else None
