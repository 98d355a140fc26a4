"""User tools over a trained run, each runnable as ``python -m
vae_mdl_tpu_torch.scripts.<name>``."""
