"""The yardstick's arithmetic: operations and bytes counted from the shapes
of the work, and the card's published peaks.

``forward_flops`` is the closed form of the program's ``utils/flops.py``
(matrix products and convolutions; pools, resizes and elementwise work not
counted), frozen here and read from a configuration file's ``model``
section. One term differs: a transposed convolution is charged its
multiply-adds, input positions x taps x input x output channels, where
``utils/flops.py`` charges output positions x taps, stride^2 times as many,
a count a faster program could take past 100% of the peak.

The likelihood kernels' work is counted from the head, the image and the
result, each once, at float32: forward, the head ``[k, B, H, W, P]``, the
image ``[B, H, W, C]`` and the log-probabilities; backward, the head, the
image, the cotangent of the log-probabilities (as many values as the caller
hands over) and the head's gradient. The least time of a call is the larger
of its bytes over the memory rate and its operations over the float32 rate.
"""
from __future__ import annotations

from typing import Dict, Optional

# Published dense peaks (NVIDIA's H100 SXM data sheet; at the full 700 W
# power limit): float32 outside the tensor cores, bfloat16 in them, memory.
_H100_SXM = {"float32": 67e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12}
PEAKS = {"NVIDIA H100 80GB HBM3": _H100_SXM, "NVIDIA H100 SXM5 80GB": _H100_SXM}

# operations of the cheapest branch of one discretized-logistic cascade, and
# the MoDL kernel's work around its cascades (a pixel: the rescaling of x;
# a mixture: the clamp, tanh, autoregression, weights and logsumexps; the
# backward's softmax weights and the nine gradients' products)
_CASCADE_FWD, _CASCADE_BWD = 14, 15
_MODL_PIXEL, _MODL_MIX, _MODL_MIX_BWD = 10, 23, 30


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def _conv(hw, c_in, c_out, k, stride, transpose):
    h, w = hw
    out = (h * stride, w * stride) if transpose else (-(-h // stride), -(-w // stride))
    positions = (h, w) if transpose else out
    return 2.0 * positions[0] * positions[1] * c_out * k * k * c_in, out


_HEAD_CHANNELS = {"bernoulli": 1, "gaussian": 2, "dl": 2, "mdl": None, "pmdl": None}


def head_channels(likelihood: str, channels: int, n_mix: int) -> int:
    per = _HEAD_CHANNELS[likelihood]
    return n_mix * 10 if per is None else per * channels


def _glu(hw, ch, n_glu, f):
    fl = 0.0
    for _ in range(n_glu):
        fl += _conv(hw, ch, f, 3, 1, False)[0] + _conv(hw, f, 2 * f, 3, 1, False)[0]
        ch = f
    return fl, ch


def _conv_vae_flops(m: dict, k: int) -> float:
    h, w, c = m["image_shape"]
    latents = m["latent_sizes"] or [m["n_latent"]] * m["n_stochastic"]
    n_head = head_channels(m["likelihood"], c, m["n_mix"])
    e, d = m["encoder"], m["decoder"]
    if e["kind"] == "mlp":
        n_in, n_h = h * w * c, e["n_hidden"]
        enc = 2.0 * (n_in * n_h + n_h * n_h + n_h * 2 * latents[0])
    else:
        enc, hw, ch = 0.0, (h, w), c
        for (f, kk, s, t, _a) in e["conv_layers"]:
            fl, hw = _conv(hw, ch, f, kk, s, t)
            enc, ch = enc + fl, f
        fl, ch = _glu(hw, ch, e["n_glu"], e["glu_features"])
        enc += fl + 2.0 * hw[0] * hw[1] * ch * 2 * latents[0]
    if d["kind"] == "mlp":
        n_h = d["n_hidden"]
        dec = 2.0 * (latents[0] * n_h + n_h * n_h + n_h * h * w * n_head)
    else:
        bh, bw, bc = d["base_size"]
        dec, hw, ch = 2.0 * latents[0] * bh * bw * bc, (bh, bw), bc
        for (f, kk, s, t, _a) in d["pre_layers"]:
            fl, hw = _conv(hw, ch, f, kk, s, t)
            dec, ch = dec + fl, f
        fl, ch = _glu(hw, ch, d["n_glu"], d["glu_features"])
        dec += fl
        for (f, kk, s, t, _a) in d["conv_layers"]:
            fl, hw = _conv(hw, ch, f, kk, s, t)
            dec, ch = dec + fl, f
        if not (d["conv_layers"] and d["conv_layers"][-1][0] == n_head):
            dec += _conv(hw, ch, n_head, 3, 1, False)[0]  # a standalone head
    mlp = sum(2.0 * (latents[i - 1] * m["mlp_hidden"] + m["mlp_hidden"] * 2 * latents[i]) * 2
              for i in range(1, len(latents)))
    return enc + k * (dec + mlp)


def _residual(hw, c_in, hidden, out):
    fl = _conv(hw, c_in, hidden, 1, 1, False)[0]
    fl += 2 * _conv(hw, hidden, hidden, 3, 1, False)[0]
    fl += _conv(hw, hidden, out, 1, 1, False)[0]
    if c_in != out:
        fl += _conv(hw, c_in, out, 1, 1, False)[0]
    return fl


def _blocks(hw, c_in, hidden, out, n):
    return sum(_residual(hw, c_in if b == 0 else out, hidden, out) for b in range(n))


def _scales(m):
    res, (h, w, _c) = [], m["image_shape"]
    for (_hid, _lat, _n, rate) in m["stages"]:
        h, w = h // rate, w // rate
        res.append((h, w))
    return res


def _observation(m):
    H, W, C = m["image_shape"]
    h0, lat0, n0, _r = m["stages"][0]
    return _blocks((H, W), lat0, h0, h0, n0) + _conv(
        (H, W), h0, head_channels(m["likelihood"], C, m["n_mix"]), 3, 1, False)[0]


def _ladder_flops(m: dict, k: int) -> float:
    """The stem and the first stochastic stage once an image, the upper
    encoder stages, the top-down blocks and the observation once a sample."""
    H, W, C = m["image_shape"]
    stages, res = m["stages"], _scales(m)
    res_in = [(H, W)] + res[:-1]

    def stochastic(i, c_in):
        hid, out, n_b, _r = stages[i]
        return _blocks(res_in[i], c_in, hid, out, n_b) + _conv(res[i], out, 2 * out, 3, 1,
                                                               False)[0]

    per_img = _conv((H, W), C, m["stem_features"], 3, 1, False)[0] + stochastic(
        0, m["stem_features"])
    per_sample = sum(stochastic(i, stages[i - 1][1]) for i in range(1, len(stages)))
    for i in range(len(stages) - 1):
        hid, out, n_b, _r = stages[i]
        per_sample += _blocks(res[i], stages[i + 1][1], hid, out, n_b)
        per_sample += _conv(res[i], out, 2 * out, 3, 1, False)[0]
    return per_img + k * (per_sample + _observation(m))


def _biladder_flops(m: dict, k: int) -> float:
    """The bottom-up path, the top posterior head and the merge heads'
    ``conv_h`` once an image; the top-down path once a sample."""
    H, W, C = m["image_shape"]
    stages, res = m["stages"], _scales(m)
    per_img = _conv((H, W), C, m["stem_features"], 3, 1, False)[0]
    c_in, hw = m["stem_features"], (H, W)
    for i, (hid, _lat, n_b, _r) in enumerate(stages):
        per_img += _blocks(hw, c_in, hid, hid, n_b)
        c_in, hw = hid, res[i]
    per_img += _conv(res[-1], stages[-1][0], 2 * stages[-1][1], 3, 1, False)[0]
    per_sample = 0.0
    for i in range(len(stages) - 2, -1, -1):
        hid, lat, n_b, _r = stages[i]
        per_sample += _blocks(res[i], stages[i + 1][1], hid, hid, n_b)
        head = _conv(res[i], hid, 2 * lat, 3, 1, False)[0]
        per_sample += head  # the prior head
        if m.get("split_merge", True):
            per_sample += head  # conv_d once a sample
            per_img += head     # conv_h once an image
        else:
            per_sample += _conv(res[i], 2 * hid, 2 * lat, 3, 1, False)[0]
    return per_img + k * (per_sample + _observation(m))


def forward_flops(model: dict, n_samples: int) -> float:
    """Forward FLOPs an image at ``n_samples`` importance samples."""
    if "split_merge" in model:
        return _biladder_flops(model, n_samples)
    if "stages" in model:
        return _ladder_flops(model, n_samples)
    return _conv_vae_flops(model, n_samples)


def train_flops(model: dict) -> float:
    """FLOPs an image of a train step: the forward at the configuration's k
    and the backward at twice it."""
    return 3.0 * forward_flops(model, model["n_samples"])


def least_ms(n_bytes: float, n_flops: float, peak: Dict[str, float]) -> float:
    return 1e3 * max(n_bytes / peak["bytes_per_s"], n_flops / peak["float32"])


def modl_forward(k: int, b: int, h: int, w: int, n_mix: int):
    """(bytes, operations) of one MoDL forward over ``[k, B, H, W]``."""
    pixels = k * b * h * w
    n_bytes = 4 * (pixels * 10 * n_mix + b * h * w * 3 + pixels)
    return n_bytes, pixels * (_MODL_PIXEL + _MODL_MIX * n_mix + 3 * n_mix * _CASCADE_FWD)


def modl_backward(k: int, b: int, h: int, w: int, n_mix: int, cotangent: int):
    """(bytes, operations) of one MoDL backward; ``cotangent`` values of
    the log-probabilities' gradient come in."""
    pixels = k * b * h * w
    n_bytes = 4 * (2 * pixels * 10 * n_mix + b * h * w * 3 + cotangent)
    ops = modl_forward(k, b, h, w, n_mix)[1] + pixels * (_MODL_MIX_BWD * n_mix
                                                          + 3 * n_mix * _CASCADE_BWD)
    return n_bytes, ops


def dl_forward(k: int, b: int, h: int, w: int, c: int):
    """(bytes, operations) of one discretized-logistic forward: the head
    ``[k, B, H, W, 2C]``, the image, the log-probabilities ``[k, B, H, W, C]``."""
    elems = k * b * h * w * c
    return 4 * (2 * elems + b * h * w * c + elems), elems * _CASCADE_FWD


def dl_backward(k: int, b: int, h: int, w: int, c: int, cotangent: int):
    elems = k * b * h * w * c
    return 4 * (4 * elems + b * h * w * c + cotangent), elems * (_CASCADE_FWD + _CASCADE_BWD)
