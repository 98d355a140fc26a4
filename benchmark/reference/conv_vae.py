"""Plain PyTorch reference of the one-layer convolutional IWAE with a mixture
of discretized logistics (nbip/vae-mdl ``models/model05.py``).

    q(z | x)  = N(mu, softplus(s)),  [mu, s] = Dense(flatten_NHWC(convs(x)))
    p(z)      = N(0, I)
    p(x | z)  = MoDL(head(deconvs(relu(Dense(z)))))

Convolutions pad as XLA's SAME (a stride-2 3x3 conv on an even grid pads
one row and column at the far end); a kernel-4 stride-2 transposed
convolution is ``conv_transpose2d(padding=1)`` on a ``[in, out, 4, 4]``
weight, which is the layer the parameters are stored for. The last layer is
the likelihood head, run in float32. No kernel, no cache, no batching
across calls: float32 throughout, with TF32 off on the backends.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import common

ACT = {"relu": F.relu, "none": lambda v: v,
       "gelu": lambda v: F.gelu(v, approximate="none")}


def _same(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def parameter_spec(model: dict) -> List[tuple]:
    """``(name, shape, kind, fan_in, fan_out)`` of every parameter, named as
    the program names them."""
    h, w, c = model["image_shape"]
    spec, ch = [], c
    for i, (f, k, s, t, _a) in enumerate(model["encoder"]["conv_layers"]):
        spec += [(f"encoder.conv_{i}.weight", (f, ch, k, k), "kernel", ch * k * k, f * k * k),
                 (f"encoder.conv_{i}.bias", (f,), "bias", 0, 0)]
        h, w, ch = -(-h // s), -(-w // s), f
    n = model["n_latent"]
    spec += [("encoder.Dense_0.weight", (2 * n, h * w * ch), "kernel", h * w * ch, 2 * n),
             ("encoder.Dense_0.bias", (2 * n,), "bias", 0, 0)]
    bh, bw, bc = model["decoder"]["base_size"]
    spec += [("decoder.Dense_0.weight", (bh * bw * bc, n), "kernel", n, bh * bw * bc),
             ("decoder.Dense_0.bias", (bh * bw * bc,), "bias", 0, 0)]
    ch = bc
    for i, (f, k, s, t, _a) in enumerate(model["decoder"]["conv_layers"]):
        shape = (ch, f, k, k) if t else (f, ch, k, k)
        spec += [(f"decoder.conv_{i}.weight", shape, "kernel", ch * k * k, f * k * k),
                 (f"decoder.conv_{i}.bias", (f,), "bias", 0, 0)]
        ch = f
    return spec


def _conv(P, name, x, layer, prec: common.Precision, body: bool):
    f, k, s, t, a = layer
    wt, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if t:
        if (k, s) != (4, 2):
            raise NotImplementedError("the reference's transposed conv is kernel 4, stride 2")
        if body:
            x, wt = prec.round(x), prec.round(wt)
        y = F.conv_transpose2d(x, wt, b, stride=2, padding=1)
    else:
        top, bottom = _same(x.shape[-2], k, s)
        left, right = _same(x.shape[-1], k, s)
        y = prec.conv(F.pad(x, (left, right, top, bottom)), wt, b, body=body, stride=s)
    return ACT[a](y)


def encode(P, model, x, prec):
    """x ``[B, H, W, C]`` in [0, 1] -> (mu, sigma) ``[B, n]``."""
    h = x.permute(0, 3, 1, 2)
    for i, layer in enumerate(model["encoder"]["conv_layers"]):
        h = _conv(P, f"encoder.conv_{i}", h, layer, prec, body=True)
    flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    out = F.linear(flat, P["encoder.Dense_0.weight"], P["encoder.Dense_0.bias"])
    mu, raw = out.chunk(2, dim=-1)
    return mu, common.softplus(raw)


def decode(P, model, z, prec):
    """z ``[N, n]`` -> the head's output ``[N, H, W, 10 n_mix]``."""
    bh, bw, bc = model["decoder"]["base_size"]
    h = ACT[model["decoder"]["fc_activation"]](
        F.linear(z, P["decoder.Dense_0.weight"], P["decoder.Dense_0.bias"]))
    h = h.reshape(-1, bh, bw, bc).permute(0, 3, 1, 2)
    layers = model["decoder"]["conv_layers"]
    for i, layer in enumerate(layers):
        h = _conv(P, f"decoder.conv_{i}", h, layer, prec, body=i < len(layers) - 1)
    return h.permute(0, 2, 3, 1)


def log_weights(P, model, x, z, mu, sigma, prec):
    """``[k, B]`` log p(x, z) - log q(z | x) at samples z ``[k, B, n]``."""
    k, b, n = z.shape
    head = decode(P, model, z.reshape(k * b, n), prec).reshape((k, b) + tuple(
        model["image_shape"][:2]) + (-1,))
    lpx = common.mixture_discretized_logistic(x, head).sum(dim=(-1, -2))
    lpz = common.normal_log_prob(z, torch.zeros_like(z), torch.ones_like(z)).sum(-1)
    lqz = common.normal_log_prob(z, mu, sigma).sum(-1)
    return lpx + lpz - lqz


def latent_shapes(model) -> List[tuple]:
    return [(model["n_latent"],)]


def train_loss(P, model, x, eps: Sequence[torch.Tensor], prec):
    """The step's loss, minus the batch mean of the bound, at the noise
    ``eps`` (one ``[k, B, n]`` tensor)."""
    mu, sigma = encode(P, model, x, prec)
    z = mu + sigma * eps[0]
    return -common.iwae_bound(log_weights(P, model, x, z, mu, sigma, prec)).mean()


def eval_llh(P, model, x, rows, gen: torch.Generator, n_samples: int, k_chunk: int, prec):
    """The n-sample bound of the images ``rows`` of the batch ``x`` ``[B,
    H, W, C]``, each chunk's noise drawn at the whole batch's shape from
    ``gen``, as the program's evaluator draws it."""
    b = x.shape[0]
    xs = x[rows]
    with torch.no_grad():
        mu, sigma = encode(P, model, xs, prec)
        parts = []
        for _ in range(n_samples // k_chunk):
            eps = torch.randn((k_chunk, b) + latent_shapes(model)[0], generator=gen,
                              device=x.device)[:, rows]
            parts.append(log_weights(P, model, xs, mu + sigma * eps, mu, sigma, prec))
        return common.iwae_bound(torch.cat(parts))
