"""Posterior diagnostics: the IWAE paper's "active units" statistic.

Port of ``vae_mdl_tpu/evaluation/diagnostics.py``. Burda et al. 2016 (§5.2)
measure latent usage as

    AU = #{ u : Cov_x( E_{q(z_u|x)}[z_u] ) > 0.01 }

the number of latent dimensions whose posterior mean varies with the
input, per stochastic layer. One ``encode`` a batch (for the VAE family the
posterior means only; the bidirectional ladder's ``encode`` runs its whole
forward pass); the variances accumulate on the host as float64 sums and
sums of squares.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_mdl_tpu_torch.data.pipeline import resolve_device
from vae_mdl_tpu_torch.evaluation.harness import _batch_seed
from vae_mdl_tpu_torch.models.objective import apply
from vae_mdl_tpu_torch.train.steps import preprocess


def active_units(
    model,
    cfg,
    params,
    images: np.ndarray,
    batch_size: int = 500,
    threshold: float = 0.01,
    seed: int = 0,
    device=None,
    u: Optional[Sequence[torch.Tensor]] = None,
    eps: Optional[Sequence] = None,
) -> Dict[str, object]:
    """Per-layer active-unit counts over a test set.

    ``images``: uint8 or float array ``[N, H, W, C]``; only the leading
    ``N // batch_size * batch_size`` images are used (one batch shape).
    ``params``: ``{name: tensor}`` evaluated in place of the model's own
    parameters, or None for those. Runs on ``device``: the CUDA card by
    default (raising where there is none), ``"cpu"`` on the CPU; the model
    must be there. Batch i draws its binarisation (a Bernoulli model on
    dynamically binarised data) and then its latent noise from a generator
    seeded from ``(seed, i)``; ``u[i]`` (the uniforms ``x = (u < x)``) and
    ``eps[i]`` (per layer, as ``model.encode`` takes it) inject them.

    Returns ``{"au": [per layer], "n_dims": [per layer], "au_total": int,
    "variance": [per-layer arrays of Cov_x(E_q[z_u|x])]}``, layer 1 (the
    one nearest the observation) first.
    """
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device != device:
        raise ValueError(f"active_units runs on {device} and the model lies on {model_device}")
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    n_batches = len(images) // batch_size
    if n_batches == 0:
        raise ValueError(
            f"active_units needs at least one full batch "
            f"({len(images)} images < batch_size={batch_size})")

    def post_means(batch: torch.Tensor, i: int) -> List[torch.Tensor]:
        gen = torch.Generator(device=device).manual_seed(_batch_seed(seed, i))
        if u is None:
            x = preprocess(cfg, batch, gen)
        else:  # the injected uniforms binarise as preprocess's draw does
            x = batch.float() / 255.0 if not batch.is_floating_point() else batch
            if cfg.model.likelihood == "bernoulli" and cfg.data.dynamic_binarization:
                x = (u[i].to(device) < x).float()
        noise = None if eps is None else eps[i]
        if params is None:
            Qs = model.encode(x, 1, gen, noise)
        else:
            Qs = apply(model, params, x, 1, gen, noise, method="encode")
        out = []
        for q in Qs:
            m = q.dist.mean()
            if m.shape[0] != x.shape[0]:  # leading k = 1 sample axis
                m = m[0]
            out.append(m.reshape(m.shape[0], -1).float())
        return out

    sums: List[np.ndarray] = []
    sumsqs: List[np.ndarray] = []
    n = 0
    with torch.inference_mode():
        for i in range(n_batches):
            batch = torch.as_tensor(images[i * batch_size:(i + 1) * batch_size], device=device)
            means = post_means(batch, i)
            n += batch_size
            for li, m in enumerate(means):
                m64 = m.cpu().numpy().astype(np.float64)
                if i == 0:
                    sums.append(m64.sum(axis=0))
                    sumsqs.append((m64 * m64).sum(axis=0))
                else:
                    sums[li] += m64.sum(axis=0)
                    sumsqs[li] += (m64 * m64).sum(axis=0)

    variances = [sq / n - (s / n) ** 2 for s, sq in zip(sums, sumsqs)]
    au = [int((v > threshold).sum()) for v in variances]
    return {
        "au": au,
        "n_dims": [int(v.size) for v in variances],
        "au_total": int(sum(au)),
        "variance": variances,
    }
