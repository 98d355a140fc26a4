"""Plain PyTorch pieces both references share: the seeding rule of the
program's random streams, the likelihoods, the Gaussian log-density, the
importance-weighted bound, optax's Adam and the lower-precision control.

Nothing here imports the program. What the program derives from the
benchmark's seed (each stream's generator seed) is worked out again from the
rule the program states: a train step's stream ``name`` at step ``step`` is
seeded from ``SeedSequence([seed, step, crc32(name) & 0x7FFFFFFF])`` and an
evaluation's batch ``index`` from ``SeedSequence([seed, index])``, the first
64-bit word shifted right by one. The noise itself is then drawn by PyTorch
on the same device from generators seeded so, at the same shapes and in the
same order as the model draws it.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


def stream_seed(seed: int, step: int, name: str) -> int:
    entropy = [seed, step, zlib.crc32(name.encode()) & 0x7FFFFFFF]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def batch_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def normal_log_prob(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * (z * z + LOG_2PI) - torch.log(scale)


def discretized_logistic(x, loc, logscale, low: float, high: float, width: float):
    """log P(bin of x): the CDF difference over the bin (floored at 1e-12),
    the density times the width where that is at most 1e-5, and the whole
    tail in the edge bins."""
    centered = x - loc
    inv_std = torch.exp(-logscale)
    start = (centered - width / 2.0) * inv_std
    stop = (centered + width / 2.0) * inv_std
    prob = torch.clamp(torch.sigmoid(stop) - torch.sigmoid(start), min=1e-12)
    a = centered * inv_std
    approx = -a - logscale - 2.0 * softplus(-a) + math.log(width)
    out = torch.where(prob > 1e-5, torch.log(prob), approx)
    out = torch.where(x <= low, stop - softplus(stop), out)
    return torch.where(x >= high, -softplus(start), out)


def mixture_discretized_logistic(x01, params):
    """PixelCNN++'s mixture over RGB, the green and blue locations
    conditioned on the observed red and green: ``x01`` ``[..., H, W, 3]`` in
    [0, 1], ``params`` ``[..., H, W, 10 n]`` laid out as [n logits | 3 x (n
    locs, n logscales, n coefficients)]; returns the per-pixel log-prob
    ``[..., H, W]``."""
    x = x01 * 2.0 - 1.0
    n = params.shape[-1] // 10
    logits = params[..., :n]
    rest = params[..., n:].reshape(params.shape[:-1] + (3, 3 * n))
    loc, logscale, coeffs = rest[..., :n], rest[..., n:2 * n], rest[..., 2 * n:]
    logscale = torch.clamp(logscale, min=-7.0)
    coeffs = torch.tanh(coeffs)
    r, g = x[..., 0:1], x[..., 1:2]
    loc = torch.stack([loc[..., 0, :],
                       loc[..., 1, :] + coeffs[..., 0, :] * r,
                       loc[..., 2, :] + coeffs[..., 1, :] * r + coeffs[..., 2, :] * g], dim=-2)
    lp = discretized_logistic(x[..., None], loc, logscale, -1.0, 1.0, 2.0 / 255.0)
    weighted = lp.sum(dim=-2) + torch.log_softmax(logits, dim=-1)
    return torch.logsumexp(weighted, dim=-1)


def iwae_bound(log_w: torch.Tensor) -> torch.Tensor:
    """log mean exp over the leading sample axis."""
    return torch.logsumexp(log_w, dim=0) - math.log(log_w.shape[0])


def adam_steps(params: Dict[str, torch.Tensor], grads_of, n: int, lr: float = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``n`` steps of optax's Adam from zero moments at a constant rate
    (the staircase schedule's first 7000). ``grads_of(params, step)`` ->
    ``(loss, {name: grad})``. Returns the losses, the first gradients and
    the parameters after the ``n`` steps."""
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for t in range(1, n + 1):
        loss, grads = grads_of(params, t - 1)
        losses.append(float(loss))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        new = {}
        for k, p in params.items():
            mu[k] = (1.0 - b1) * grads[k] + b1 * mu[k]
            nu[k] = (1.0 - b2) * grads[k] * grads[k] + b2 * nu[k]
            mu_hat = mu[k] / (1.0 - b1 ** t)
            nu_hat = nu[k] / (1.0 - b2 ** t)
            new[k] = (p - lr * mu_hat / (torch.sqrt(nu_hat) + eps)).detach()
        params = new
    return losses, first, params


class Precision:
    """How the reference computes the layers the configuration runs in its
    body dtype: ``"float32"`` (the reference itself) or, as the control,
    ``"fp8"``: each such convolution's input and weight, and each tensor the
    model passes to ``round``, rounded to float8 e4m3 with a scale a
    tensor, the products accumulated in float32; the gradient passes the
    rounding unchanged, so the backward convolutions run on the rounded
    operands.
    The float32 configuration's control is the reference with TF32 on,
    which the caller sets on the backends."""

    def __init__(self, body: str = "float32"):
        if body not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {body!r}")
        self.body = body

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.body == "float32":
            return t
        scale = 448.0 / torch.clamp(t.detach().abs().amax(), min=1e-30)
        rounded = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return t + (rounded - t.detach())

    def conv(self, x, w, b=None, body: bool = True, **kw):
        if body:
            x, w = self.round(x), self.round(w)
        return F.conv2d(x, w, b, **kw)

