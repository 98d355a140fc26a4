"""The benchmark of the PyTorch and CUDA port (``vae_mdl_tpu_torch``)."""
