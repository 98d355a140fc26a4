"""PyTorch port of vae_mdl_tpu, with hand-written CUDA kernels for Hopper.

The JAX package ``vae_mdl_tpu`` stays the reference; this package imports
neither it nor jax. Module paths mirror the JAX package's, and public
functions keep its layouts: images ``[B, H, W, C]``, MoDL parameters
``[k, B, H, W, 10 * n_mix]``, log-weights ``[k, B]``.

Ported so far: the model05 5000-importance-sample evaluation path and the
MoDL log-prob forward kernel (``ops/cuda/mdl_kernel.py``,
``csrc/mdl_log_prob.cu``).
"""
