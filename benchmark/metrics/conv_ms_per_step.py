"""Device milliseconds of convolution and matrix-product kernels (cuDNN,
cuBLAS) a train step of the traced slice."""


def read(sl, cell, suffix=None):
    return 1e3 * sl.class_s("conv/gemm") / sl.steps if sl.steps else None
