"""Pareto tail-shape diagnostic (k-hat) for the importance-sampled eval.

Port of ``vae_mdl_tpu/evaluation/psis.py``. The n-sample test bound is an
importance-weighted estimate whose reliability is set by the tail of the
importance weights. PSIS (Vehtari, Simpson, Gelman, Yao & Gabry 2024, JMLR
25) fits a generalized Pareto distribution to the largest weights and reads
its shape k-hat:

- k < 0.5   : finite weight variance, the estimate converges at CLT rates;
- 0.5 - 0.7 : usable but slow convergence;
- k > 0.7   : unreliable; more samples may move the bound a lot.

The fit (Zhang & Stephens 2009's profile posterior mean, with PSIS's weak
prior toward 0.5) runs on the host in numpy, a copy of the JAX package's;
the evaluator carries only the top tail of each image's log-weights on the
device (``top_lw_init`` / ``top_lw_update``, ``torch.topk`` over the sample
axis) and copies it once a batch.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def tail_size(n_samples: int) -> int:
    """PSIS tail size: ``min(n/5, 3*sqrt(n))`` (Vehtari et al. 2024 §2.2)."""
    return int(min(n_samples / 5.0, 3.0 * math.sqrt(n_samples)))


def fit_gpd_khat(exceedances: np.ndarray) -> float:
    """GPD shape k-hat for positive exceedances over the tail threshold,
    via Zhang & Stephens 2009 (the profile posterior mean PSIS prescribes),
    including PSIS's weak prior shrinking k toward 0.5 with ~10
    observations' weight. Returns NaN when fewer than 5 positive
    exceedances survive — the fit itself cannot say whether that is a
    tie-degenerate (light) or underflow-degenerate (heavy) tail; callers
    with access to the log-weights must decide
    (``khat_from_top_log_weights``)."""
    x = np.sort(np.asarray(exceedances, np.float64))
    x = x[x > 0]  # ties with the threshold carry no tail information
    n = x.size
    if n < 5 or not np.isfinite(x[-1]):
        return float("nan")
    m = 30 + int(math.sqrt(n))
    bs = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs = bs / (3.0 * x[max(int(n / 4 + 0.5) - 1, 0)]) + 1.0 / x[-1]
    ks = np.log1p(-bs[:, None] * x[None, :]).mean(axis=1)  # [m]
    L = n * (np.log(-bs / ks) - ks - 1.0)
    w = 1.0 / np.exp(L - L[:, None]).sum(axis=1)
    b_post = (bs * w).sum() / w.sum()
    k_post = float(np.log1p(-b_post * x).mean())
    # regularise toward 0.5 (PSIS: nuisance-prior with 10 pseudo-obs)
    return (n * k_post + 10.0 * 0.5) / (n + 10.0)


def khat_from_top_log_weights(top_lw: np.ndarray) -> np.ndarray:
    """k-hat per column from the ``M+1`` LARGEST log-weights ``[M+1, B]``
    (the smallest row is the tail threshold; the other M are the tail).

    Degenerate tails are resolved from the log-weights, where the two
    failure modes are distinguishable:

    - (near-)TIES — the whole tail within ~0 nats of the threshold — is
      the lightest possible tail: **-inf** (a perfect proposal).
    - UNDERFLOW — the tail spans so many nats that ``exp(lw - max)``
      flushes most of it to zero — is the heaviest possible tail (a
      handful of samples dominate the estimate by hundreds of nats):
      **+inf**, matching loo/arviz's worst-case convention. Reporting
      these as reliable would invert the diagnostic exactly where it
      matters most (early or mismatched checkpoints).
    """
    top = np.sort(np.asarray(top_lw, np.float64), axis=0)  # ascending
    out = np.empty(top.shape[1], np.float64)
    for j in range(top.shape[1]):
        col = top[:, j]
        scale = col[-1]  # k-hat is normalisation-invariant
        w = np.exp(col - scale)
        exceed = w[1:] - w[0]  # over the (M+1)-th largest weight
        k = fit_gpd_khat(exceed)
        if math.isnan(k):
            spread = col[-1] - col[0]  # nats from threshold to max
            k = float("-inf") if spread <= 1e-8 else float("inf")
        out[j] = k
    return out


def khat_from_log_weights(log_w: np.ndarray) -> np.ndarray:
    """k-hat per column of ``[S]`` or ``[S, B]`` log-weights (the
    non-streaming reference path; the harness streams the top tail)."""
    lw = np.asarray(log_w, np.float64)
    if lw.ndim == 1:
        lw = lw[:, None]
    S = lw.shape[0]
    M = tail_size(S)
    if M < 5:
        return np.full(lw.shape[1], np.nan)
    top = np.sort(lw, axis=0)[-(M + 1):]
    return khat_from_top_log_weights(top)


# -- streaming top-M accumulator (device side, rides the evaluator's chunks) --


def top_lw_init(batch_shape: tuple, m: int, device=None) -> torch.Tensor:
    """``[m, *batch_shape]`` carry of the largest log-weights seen, -inf."""
    return torch.full((m,) + tuple(batch_shape), -math.inf, dtype=torch.float32,
                      device=device)


def top_lw_update(carry: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    """Fold a ``[k, B]`` chunk into the running ``[m, B]`` top set, sorted
    descending along the sample axis (the order of ties is topk's, the
    values are those of ``jax.lax.top_k``)."""
    m = carry.shape[0]
    stacked = torch.cat([carry, log_w.to(carry.dtype)], dim=0)
    return torch.topk(stacked, m, dim=0).values
