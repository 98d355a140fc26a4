"""Numerical primitives shared across losses and evaluation.

Port of ``vae_mdl_tpu/ops/math.py``. The streaming logmeanexp is the
building block of the k-chunked importance-sampling evaluator: the 5000
samples are folded in chunks, never held in one tensor.
"""
from __future__ import annotations

import math

import torch


def logmeanexp(log_w: torch.Tensor, dim: int) -> torch.Tensor:
    """Numerically stable log(mean(exp(log_w))) over ``dim`` (max-shifted)."""
    m = torch.amax(log_w, dim=dim, keepdim=True).detach()
    out = torch.log(torch.mean(torch.exp(log_w - m), dim=dim)) + m.squeeze(dim)
    return out


def log_prob_from_logits(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log softmax: logits minus logsumexp over ``dim``."""
    return logits - torch.logsumexp(logits, dim=dim, keepdim=True)


# --- streaming logmeanexp over importance-sample chunks -----------------------
#
# State (running_max m, running_sum s, count n) with
#   logsumexp(seen) = m + log(s),   s = sum(exp(seen - m)).


def streaming_logmeanexp_init(shape, device=None):
    """Float32 state ``(m, s, n)`` for log-weights of shape ``shape``."""
    m = torch.full(shape, -math.inf, device=device)
    s = torch.zeros(shape, device=device)
    return m, s, 0


def streaming_logmeanexp_update(state, log_w_chunk: torch.Tensor, dim: int = 0):
    """Fold a chunk of log-weights (reduced over ``dim``) into the state."""
    m, s, n = state
    chunk_max = torch.amax(log_w_chunk, dim=dim)
    new_m = torch.maximum(m, chunk_max)
    # rescale the previous sum to the new max; a -inf max (nothing seen yet)
    # contributes exp(-inf) = 0 instead of exp(-inf - -inf) = NaN
    neg_inf = torch.full_like(m, -math.inf)
    s = s * torch.exp(torch.where(torch.isfinite(m), m - new_m, neg_inf))
    # where new_m is still -inf every weight in the chunk is -inf too: a zero
    # contribution, so the result stays -inf (the logsumexp convention)
    new_m_b = new_m.unsqueeze(dim)
    shifted = torch.where(torch.isfinite(new_m_b), log_w_chunk - new_m_b,
                          torch.full_like(log_w_chunk, -math.inf))
    s = s + torch.sum(torch.exp(shifted), dim=dim)
    return new_m, s, n + log_w_chunk.shape[dim]


def streaming_logmeanexp_finalize(state) -> torch.Tensor:
    m, s, n = state
    return m + torch.log(s) - math.log(n)
