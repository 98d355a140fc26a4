"""Plain PyTorch reference of the bidirectional ladder VAE with a
discretized-logistic likelihood (this project's 64x64 four-scale design; its
blocks follow VDVAE, arXiv:2011.10650).

    bottom-up:   h_1 .. h_L = EncoderBlocks(act(stem(x)))     (once an image)
    top:         q(z_L | h_L) = N(mu, softplus(s)), [mu, s] = conv(h_L)
    top-down,    d_i = DecoderBlock_i(z_{i+1})               (once a sample)
    i = L-1..1:  p(z_i | z_{i+1}) = N from conv(d_i)
                 q(z_i | x, z_{>i}) = N from conv_h(h_i) + conv_d(d_i)
    observation: p(x | z_1) = DL(obs_head(DecoderBlock(z_1)))

A residual block is 1x1 -> 3x3 -> 3x3 -> 1x1 convolutions, each followed by
the tanh-form GELU, scaled by a scalar gate, plus the input (through a 1x1
conv where the width changes); an encoder block ends in an average pool and
a decoder block starts with a bilinear upsample (half-pixel centres). The
configuration runs the stem and the blocks in bfloat16 and every head in
float32; the reference runs everything in float32, with TF32 off. Its
control (``common.Precision("fp8")``) rounds what the configuration holds in
bfloat16 to float8 e4m3 instead: each body convolution's input and weight,
each activation and each residual sum.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import common


def _act(v):
    return F.gelu(v, approximate="tanh")


def latent_shapes(model) -> List[tuple]:
    """Each stage's latent ``(h, w, c)``, bottom first."""
    h, w, _ = model["image_shape"]
    shapes = []
    for (_hidden, lat, _n, rate) in model["stages"]:
        h, w = h // rate, w // rate
        shapes.append((h, w, lat))
    return shapes


def _conv_spec(name, c_in, c_out, k, bias=True):
    spec = [(f"{name}.weight", (c_out, c_in, k, k), "kernel", c_in * k * k, c_out * k * k)]
    return spec + ([(f"{name}.bias", (c_out,), "bias", 0, 0)] if bias else [])


def _block_spec(name, c_in, hidden, out, n):
    spec = []
    for b in range(n):
        p, cin = f"{name}.ResidualBlock_{b}", c_in if b == 0 else out
        spec.append((f"{p}.gate", (), "gate", 0, 0))
        spec += _conv_spec(f"{p}.Conv_0", cin, hidden, 1)
        spec += _conv_spec(f"{p}.Conv_1", hidden, hidden, 3)
        spec += _conv_spec(f"{p}.Conv_2", hidden, hidden, 3)
        spec += _conv_spec(f"{p}.Conv_3", hidden, out, 1)
        if cin != out:
            spec += _conv_spec(f"{p}.shortcut", cin, out, 1)
    return spec


def parameter_spec(model: dict) -> List[tuple]:
    """``(name, shape, kind, fan_in, fan_out)`` of every parameter, named as
    the program names them."""
    stages = model["stages"]
    spec = _conv_spec("stem", model["image_shape"][-1], model["stem_features"], 3)
    c_in = model["stem_features"]
    for i, (h, _lat, n, _r) in enumerate(stages):
        spec += _block_spec(f"enc_{i}", c_in, h, h, n)
        c_in = h
    spec += _conv_spec("q_top.Conv_0", stages[-1][0], 2 * stages[-1][1], 3)
    for i in range(len(stages) - 1):
        h, lat, n, _r = stages[i]
        spec += _block_spec(f"up_{i}", stages[i + 1][1], h, h, n)
        spec += _conv_spec(f"p_{i}.Conv_0", h, 2 * lat, 3)
        spec += _conv_spec(f"q_{i}.conv_h", h, 2 * lat, 3, bias=False)
        spec += _conv_spec(f"q_{i}.conv_d", h, 2 * lat, 3)
    h0, lat0, n0, _r = stages[0]
    spec += _block_spec("obs_up", lat0, h0, h0, n0)
    spec += _conv_spec("obs_head", h0, 2 * model["image_shape"][-1], 3)
    return spec


def _conv(P, name, x, prec, body):
    w = P[f"{name}.weight"]
    return prec.conv(x, w, P.get(f"{name}.bias"), body=body, padding=w.shape[-1] // 2)


def _residual(P, name, x, prec):
    h = x
    for j in range(4):
        h = prec.round(_act(_conv(P, f"{name}.Conv_{j}", h, prec, True)))
    h = h * P[f"{name}.gate"]
    if f"{name}.shortcut.weight" in P:
        x = _conv(P, f"{name}.shortcut", x, prec, True)
    return prec.round(x + h)


def _blocks(P, name, x, n, prec):
    for b in range(n):
        x = _residual(P, f"{name}.ResidualBlock_{b}", x, prec)
    return x


def _gaussian(out, lead):
    """A head's NCHW output -> (mu, sigma) ``lead + [h, w, c]``."""
    out = out.permute(0, 2, 3, 1)
    out = out.reshape(tuple(lead) + tuple(out.shape[1:]))
    mu, raw = out.chunk(2, dim=-1)
    return mu, common.softplus(raw)


def _merged(t):
    """``[k, B, h, w, c]`` -> its ``[k B, c, h, w]`` batch."""
    return t.reshape((-1,) + tuple(t.shape[2:])).permute(0, 3, 1, 2)


def _spatial_sum(t):
    return t.sum(dim=(-1, -2, -3))


def log_weights(P, model, x, k, noise_of, prec):
    """``[k, B]`` log-weights of ``x`` ``[B, H, W, C]`` in [0, 1];
    ``noise_of(level)`` gives the standard normals of stochastic layer
    ``level`` (0 = bottom) ``[k, B, h, w, c]``, asked for top first."""
    stages = model["stages"]
    b, L = x.shape[0], len(stages)
    h = prec.round(_act(_conv(P, "stem", x.permute(0, 3, 1, 2), prec, True)))
    hs = []
    for i, (_w, _lat, n, rate) in enumerate(stages):
        h = F.avg_pool2d(_blocks(P, f"enc_{i}", h, n, prec), rate, rate)
        hs.append(h)
    mu, sigma = _gaussian(_conv(P, "q_top.Conv_0", hs[-1], prec, False), (b,))
    z = mu + sigma * noise_of(L - 1)
    zero = torch.zeros_like(z)
    log_w = _spatial_sum(common.normal_log_prob(z, zero, zero + 1.0)
                         - common.normal_log_prob(z, mu, sigma))
    for i in range(L - 2, -1, -1):
        d = _merged(z)
        d = F.interpolate(d, size=(d.shape[-2] * stages[i + 1][3], d.shape[-1] * stages[i + 1][3]),
                          mode="bilinear", align_corners=False)
        d = _blocks(P, f"up_{i}", d, stages[i][2], prec)
        mu_p, sigma_p = _gaussian(_conv(P, f"p_{i}.Conv_0", d, prec, False), (k, b))
        out_h = _conv(P, f"q_{i}.conv_h", hs[i], prec, False)
        out_d = _conv(P, f"q_{i}.conv_d", d, prec, False)
        out = (out_d.reshape((k, b) + tuple(out_d.shape[1:])) + out_h).reshape(out_d.shape)
        mu_q, sigma_q = _gaussian(out, (k, b))
        z = mu_q + sigma_q * noise_of(i)
        log_w = log_w + _spatial_sum(common.normal_log_prob(z, mu_p, sigma_p)
                                     - common.normal_log_prob(z, mu_q, sigma_q))
    o = _merged(z)
    o = F.interpolate(o, size=(o.shape[-2] * stages[0][3], o.shape[-1] * stages[0][3]),
                      mode="bilinear", align_corners=False)
    o = _blocks(P, "obs_up", o, stages[0][2], prec)
    head = _conv(P, "obs_head", o, prec, False).permute(0, 2, 3, 1)
    head = head.reshape((k, b) + tuple(head.shape[1:]))
    loc, logscale = head.chunk(2, dim=-1)
    lpx = common.discretized_logistic(x, loc, logscale, 0.0, 1.0, 1.0 / 255.0)
    return log_w + _spatial_sum(lpx)


def train_loss(P, model, x, eps: Sequence[torch.Tensor], prec):
    """The step's loss at the noise ``eps``, one ``[k, B, h, w, c]`` tensor a
    layer, bottom first."""
    k = eps[0].shape[0]
    return -common.iwae_bound(log_weights(P, model, x, k, lambda i: eps[i], prec)).mean()


def eval_llh(P, model, x, rows, gen: torch.Generator, n_samples: int, k_chunk: int, prec):
    """The n-sample bound of the images ``rows`` of the batch ``x``: each
    chunk draws its layers' noise top first at the whole batch's shape from
    ``gen``, as the program's ladder draws it, and keeps ``rows``."""
    b = x.shape[0]
    shapes = latent_shapes(model)
    xs = x[rows]
    with torch.no_grad():
        parts = []
        for _ in range(n_samples // k_chunk):
            drawn = {i: torch.randn((k_chunk, b) + shapes[i], generator=gen,
                                    device=x.device)[:, rows]
                     for i in range(len(shapes) - 1, -1, -1)}
            parts.append(log_weights(P, model, xs, k_chunk, drawn.__getitem__, prec))
        return common.iwae_bound(torch.cat(parts))
