"""The measurement path: the special-function roofline and the memory-path
and kernel-structure probes, each runnable as ``python -m
vae_mdl_tpu_torch.probes.<name>`` on a CUDA card."""
