"""PyTorch port of vae_mdl_tpu, with hand-written CUDA kernels for Hopper.

The JAX package ``vae_mdl_tpu`` stays the reference; this package imports
neither it nor jax. Module paths mirror the JAX package's, and public
functions keep its layouts: images ``[B, H, W, C]``, MoDL parameters
``[k, B, H, W, 10 * n_mix]``, log-weights ``[k, B]``.

Ported so far, for one process on one device: every model of the zoo
(model01-06, ``digits`` and the ladder families) with its train and eval
steps, optimizers and train state (``models/``, ``nn/``, ``train/``); the
training run as users start it, ``train.trainer.Trainer`` with its data
pipeline (``data/``: sources, TFRecord and native parsers, epoch streams,
``device_prefetch``), checkpoints and exact resume (``train/checkpoint.py``),
metric logging and report grids (``utils/``) and config files
(``config_io.py``); the n-sample test evaluation with the PSIS k-hat and the
convergence curve, and the active-units diagnostic (``evaluation/``); every
TPU kernel's CUDA counterpart (``csrc/``, ``ops/cuda/``) and the measurement
probes (``probes/``, ``utils/timing.py``, ``utils/flops.py``); and how users
start it: the CLI (``cli/run.py``, ``python -m vae_mdl_tpu_torch``),
inference (``models/inference.py``), ``torch.export`` serving
(``models/export.py``), the Keras reference-checkpoint import
(``utils/import_reference.py``) and ``examples/``. The parallel paths are to
come (ROADMAP.md).

Entry points run on the CUDA card and raise where there is none, unless the
caller passes ``device="cpu"``.
"""
