"""The measurement path: the special-function roofline, the memory-path and
kernel-structure probes, and the probes of the train step and the evaluator
(attributions, sweeps, the objectives' and the stability kit's cost, scale,
the profile, the MoDL kernel against ``torch.compile``), each runnable as
``python -m vae_mdl_tpu_torch.probes.<name>`` on a CUDA card."""
