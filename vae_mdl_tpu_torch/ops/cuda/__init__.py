"""Hand-written CUDA kernels, built from ``vae_mdl_tpu_torch/csrc`` at first use."""
