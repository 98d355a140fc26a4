"""5000-importance-sample test evaluation, the headline metric.

Port of ``effective_chunks``, ``make_batch_evaluator`` and ``evaluate_llh``
from ``vae_mdl_tpu/evaluation/harness.py`` for one process on one device:

- images go in batches; the padded tail batch keeps every batch the same
  shape and its padding is dropped;
- the k = 5000 samples are streamed in k-chunks folded into a streaming
  logmeanexp (``ops.math``); ``[5000, B, H, W, C]`` never exists;
- the chunk loop is a Python loop under ``torch.inference_mode()``; for
  the VAE family q(z_1 | x) is computed once per batch and reused by every
  chunk (the JAX version recomputes it per chunk; the numbers are the same),
  and the upper stochastic layers are sampled per chunk from it; the ladder
  families run their whole forward pass per chunk, as the JAX version does;
- each batch draws from its own generator, seeded from ``(seed, batch
  index)``, so a batch's result does not depend on the batches before it;
- a Bernoulli model whose data is binarised dynamically
  (``dynamic_binarization``) is evaluated on one fixed binarisation of each
  batch, drawn once from the batch's generator before any sample noise, as
  the reference folds key 0 for it and key 1 for the samples: the encoder,
  every k-chunk and the likelihood see the same binary images.

The PSIS k-hat, the convergence curve and the mesh options are not ported
yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from vae_mdl_tpu_torch.config import ExperimentConfig
from vae_mdl_tpu_torch.data.preprocess import binarize
from vae_mdl_tpu_torch.models.objective import log_weights
from vae_mdl_tpu_torch.models.vae import VAE, prior_for
from vae_mdl_tpu_torch.ops.math import (
    streaming_logmeanexp_finalize,
    streaming_logmeanexp_init,
    streaming_logmeanexp_update,
)


def effective_chunks(n_samples: int, k_chunk: int) -> Tuple[int, int]:
    """Clamp ``k_chunk`` to a divisor of ``n_samples`` so the chunks cover
    exactly ``n_samples``; returns ``(k_chunk, n_chunks)``."""
    k_chunk = min(k_chunk, n_samples)
    while n_samples % k_chunk:
        k_chunk -= 1
    return k_chunk, n_samples // k_chunk


def make_batch_evaluator(model, cfg: ExperimentConfig, n_samples: int = 5000,
                         k_chunk: int = 100):
    """Returns ``batch_llh(batch, generator=None, eps=None, u=None) -> llh [B]``.

    ``batch``: uint8 images (scaled by 1/255) or floats in [0, 1],
    ``[B, H, W, C]``, on the model's device. The standard-normal draws come
    from ``generator``, or from ``eps`` ``[n_chunks, k_chunk, B] + shape``
    (z_1's noise, or a sequence with one such tensor per stochastic layer,
    bottom up; ``shape`` is ``models.vae.latent_shapes``': ``(n_latent,)``,
    or ``(h, w, c)`` for a ladder).
    Where the model is a Bernoulli on dynamically binarised data, the batch
    is binarised once, before any sample noise: ``x = (u < x)`` with ``u``
    uniform on [0, 1) ``[B, H, W, C]``, drawn from ``generator`` or injected
    as ``u`` (a binary batch is its own binarisation whatever ``u``).
    """
    k_chunk, n_chunks = effective_chunks(n_samples, k_chunk)
    binarize_input = cfg.model.likelihood == "bernoulli" and cfg.data.dynamic_binarization
    # the VAE family computes q(z_1 | x) once a batch; the ladders have no
    # such split
    once_a_batch = isinstance(model, VAE)

    def batch_llh(batch: torch.Tensor, generator: Optional[torch.Generator] = None,
                  eps=None, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.inference_mode():
            x = batch.float()
            if not batch.is_floating_point():
                x = x / 255.0
            if binarize_input:
                # one fixed draw per evaluation, the same in every k-chunk
                x = binarize(generator, x) if u is None else (u < x).float()
            prior = prior_for(cfg.model, x.device)
            q = model.encoder(x) if once_a_batch else None
            state = streaming_logmeanexp_init((x.shape[0],), device=x.device)
            if isinstance(eps, torch.Tensor):
                eps = (eps,)
            for j in range(n_chunks):
                noise = None if eps is None else [layer[j] for layer in eps]
                if once_a_batch:
                    Qs = model.sample_posterior(q, k_chunk, generator, noise)
                    Ps, pxz = model.decode_down(Qs)
                else:
                    Qs, Ps, pxz = model(x, k_chunk, generator, noise)
                log_w = log_weights(prior, Qs, Ps, pxz, x)  # [k_chunk, B]
                state = streaming_logmeanexp_update(state, log_w, dim=0)
            return streaming_logmeanexp_finalize(state)

    return batch_llh


def _batch_seed(seed: int, index: int) -> int:
    """The generator seed of batch ``index`` of an evaluation seeded ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def evaluate_llh(
    model,
    cfg: ExperimentConfig,
    test_images: np.ndarray,
    n_samples: int = 5000,
    k_chunk: int = 100,
    batch_size: int = 128,
    seed: int = 0,
) -> Tuple[float, np.ndarray, dict]:
    """Test-set n-sample importance-weighted log-likelihood.

    ``test_images``: host array ``[N, H, W, C]``, uint8 or floats in [0, 1].
    Runs on the model's device. Returns ``(mean_llh,
    per_image_llh, metrics)`` with ``bpd = -llh / (log 2 * H * W * C)``.
    """
    device = next(model.parameters()).device
    evaluator = make_batch_evaluator(model, cfg, n_samples, k_chunk)

    def run_batch(batch: np.ndarray, index: int) -> np.ndarray:
        generator = torch.Generator(device=device)
        generator.manual_seed(_batch_seed(seed, index))
        llh = evaluator(torch.as_tensor(batch, device=device), generator)
        return llh.cpu().numpy()

    n = len(test_images)
    n_batches, leftover = divmod(n, batch_size)
    per_image = np.zeros(n, np.float32)
    for i in range(n_batches):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        per_image[sl] = run_batch(test_images[sl], i)
    if leftover:
        # pad the tail batch to the batch shape, then drop the padding
        tail = test_images[n_batches * batch_size:]
        pad = np.concatenate([tail] * -(-batch_size // leftover))[:batch_size]
        per_image[n_batches * batch_size:] = run_batch(pad, n_batches)[:leftover]

    # float64 accumulation: a mean quoted to two decimals over 10k images
    mean_llh = float(per_image.mean(dtype=np.float64))
    h, w, c = cfg.model.image_shape
    bpd = -mean_llh / (math.log(2.0) * h * w * c)
    metrics = {
        "llh": mean_llh,
        "bpd": bpd,
        "n_samples": n_samples,
        "batches": n_batches + bool(leftover),
    }
    return mean_llh, per_image, metrics
