"""Analytic operation counts and the card's peaks.

Port of ``vae_mdl_tpu/utils/flops.py`` (that module imports no jax, but the
port shares no code with the JAX package and keeps its own copy; held equal
by ``tests/test_torch_flops.py``): ``analytic_model_flops``, the closed-form
forward FLOPs of a conv/mlp VAE config, ``forward_flops``,
``train_step_flops``, ``ladder_flops`` and ``biladder_flops`` (the ladder
families' closed forms, which ``forward_flops`` dispatches to), and the
per-pixel transcendental census of the MoDL kernels.

Two things read differently here:

- ``compiled_flops`` asked XLA's cost model; here it runs the function once
  under ``torch.utils.flop_counter.FlopCounterMode`` and returns what that
  counted (matrix products and convolutions), or None where it counted
  nothing. It counts a transposed convolution at its multiply-adds, input
  positions x taps, where ``_conv_flops`` charges output positions x taps
  (stride^2 times as many).
- ``mdl_transcendental_census`` is the Pallas kernels' count, where every
  ``where`` evaluates both sides: each cascade pays its three softplus
  whatever branch it takes. The CUDA kernels branch
  (``csrc/dl_cascade.cuh``), so what they evaluate depends on the data:
  ``cascade_transcendentals`` and ``mdl_cuda_transcendentals`` count, from a
  run's branch counts, the calls the CUDA sources make. A floor for the CUDA
  kernels is priced with those, and ``mufu_instructions`` turns them into the
  special-function instructions that bound a kernel on the card.

There is no v5e peak here: ``device_peaks`` gives the published peaks of the
card it is asked about and raises on a part it does not know.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from vae_mdl_tpu_torch.distributions.mixture import autoregressive_locs, split_mixture_params
from vae_mdl_tpu_torch.models.bidirectional import BiLadderConfig
from vae_mdl_tpu_torch.models.ladder import LadderConfig
from vae_mdl_tpu_torch.nn.decoders import head_channels

# Published dense peaks by part (NVIDIA's data sheets): float32 outside the
# tensor cores, bf16 in them, device memory. They assume the part's full
# power limit.
_PEAKS = {
    "H100 SXM": {"float32": 67e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12},
}
# torch.cuda.get_device_name -> part
_PARTS = {"NVIDIA H100 80GB HBM3": "H100 SXM", "NVIDIA H100 SXM5 80GB": "H100 SXM"}


def device_peaks(name: Optional[str] = None) -> Dict[str, float]:
    """``{"float32": FLOP/s, "bfloat16": FLOP/s, "bytes_per_s": B/s}`` of the
    card called ``name`` (default: ``torch.cuda.get_device_name(0)``) or of
    the part called ``name`` ("H100 SXM")."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    if name in _PEAKS:
        return dict(_PEAKS[name])
    if name not in _PARTS:
        raise ValueError(f"no published peaks recorded for {name!r}; known: {sorted(_PARTS)}")
    return dict(_PEAKS[_PARTS[name]])


def compiled_flops(fn, *args) -> Optional[float]:
    """The FLOPs ``FlopCounterMode`` counts in one run of ``fn(*args)``; None
    where it counts none (no matrix product or convolution reached it)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def _conv_flops(in_hw, in_ch, features, kernel, stride, transpose) -> tuple:
    """-> (flops, out_hw): 2 * out_elems * kernel^2 * in_ch multiply-adds."""
    h, w = in_hw
    if transpose:
        oh, ow = h * stride, w * stride
    else:
        oh, ow = -(-h // stride), -(-w // stride)
    return 2.0 * oh * ow * features * kernel * kernel * in_ch, (oh, ow)


def analytic_model_flops(model_cfg, batch: int = 1) -> float:
    """Closed-form forward FLOPs per batch for a conv/mlp VAE config: the
    encoder once per image plus the decoder once per importance sample
    (matrix-product and convolution terms only)."""
    h, w, c = model_cfg.image_shape
    k = model_cfg.n_samples
    latents = model_cfg.latents()
    n_head = head_channels(model_cfg.likelihood, c, model_cfg.n_mix)

    enc = 0.0
    if model_cfg.encoder.kind == "mlp":
        n_in = h * w * c
        n_h = model_cfg.encoder.n_hidden
        enc += 2.0 * (n_in * n_h + n_h * n_h + n_h * 2 * latents[0])
    else:
        hw, ch = (h, w), c
        for (f, kk, s, t, _a) in model_cfg.encoder.conv_layers:
            fl, hw = _conv_flops(hw, ch, f, kk, s, t)
            enc += fl
            ch = f
        for _ in range(model_cfg.encoder.n_glu):
            f = model_cfg.encoder.glu_features
            fl1, _ = _conv_flops(hw, ch, f, 3, 1, False)
            fl2, _ = _conv_flops(hw, f, 2 * f, 3, 1, False)
            enc += fl1 + fl2
            ch = f
        enc += 2.0 * hw[0] * hw[1] * ch * 2 * latents[0]

    dec = 0.0
    if model_cfg.decoder.kind == "mlp":
        # the output layer emits h * w * head_channels values
        n_out = h * w * n_head
        n_h = model_cfg.decoder.n_hidden
        dec += 2.0 * (latents[0] * n_h + n_h * n_h + n_h * n_out)
    else:
        bh, bw, bc = model_cfg.decoder.base_size
        dec += 2.0 * latents[0] * bh * bw * bc
        hw, ch = (bh, bw), bc
        for (f, kk, s, t, _a) in model_cfg.decoder.pre_layers:
            fl, hw = _conv_flops(hw, ch, f, kk, s, t)
            dec += fl
            ch = f
        for _ in range(model_cfg.decoder.n_glu):
            f = model_cfg.decoder.glu_features
            fl1, _ = _conv_flops(hw, ch, f, 3, 1, False)
            fl2, _ = _conv_flops(hw, f, 2 * f, 3, 1, False)
            dec += fl1 + fl2
            ch = f
        for (f, kk, s, t, _a) in model_cfg.decoder.conv_layers:
            fl, hw = _conv_flops(hw, ch, f, kk, s, t)
            dec += fl
            ch = f
        cl = model_cfg.decoder.conv_layers
        if not (cl and cl[-1][0] == n_head):
            # the head is not folded into the conv stack: ConvDecoder appends
            # a standalone 3x3 head conv at full resolution
            dec += _conv_flops(hw, ch, n_head, 3, 1, False)[0]

    # MLP stochastic layers (model06-style): negligible but counted
    mlp = 0.0
    for i in range(1, model_cfg.n_stochastic):
        n_h = model_cfg.mlp_hidden
        mlp += 2.0 * (latents[i - 1] * n_h + n_h * 2 * latents[i]) * 2  # up + down

    return batch * (enc + k * (dec + mlp))


def forward_flops(model_cfg, batch: int = 1, n_samples: Optional[int] = None) -> float:
    """Forward FLOPs per batch for any model family's config, at
    ``n_samples`` importance samples where given."""
    if isinstance(model_cfg, BiLadderConfig):
        return biladder_flops(model_cfg, batch, n_samples)
    if isinstance(model_cfg, LadderConfig):
        return ladder_flops(model_cfg, batch, n_samples)
    if n_samples is not None:
        model_cfg = dataclasses.replace(model_cfg, n_samples=n_samples)
    return analytic_model_flops(model_cfg, batch)


def train_step_flops(model_cfg, batch: int) -> float:
    """Forward + backward (2x forward) per optimizer step."""
    return 3.0 * forward_flops(model_cfg, batch)


def _residual_block_flops(hw, c_in: int, hidden: int, out: int) -> float:
    """1x1 -> 3x3 -> 3x3 -> 1x1 bottleneck (and the 1x1 shortcut where the
    width changes), ``nn.blocks.ResidualBlock``."""
    fl = _conv_flops(hw, c_in, hidden, 1, 1, False)[0]
    fl += _conv_flops(hw, hidden, hidden, 3, 1, False)[0]
    fl += _conv_flops(hw, hidden, hidden, 3, 1, False)[0]
    fl += _conv_flops(hw, hidden, out, 1, 1, False)[0]
    if c_in != out:
        fl += _conv_flops(hw, c_in, out, 1, 1, False)[0]
    return fl


def _scales(cfg):
    """The resolution of each stage's latent, bottom first."""
    return [(h, w) for h, w, _ in cfg.latent_shapes()]


def _observation_flops(cfg) -> float:
    """``obs_up`` from z_1 to the image's resolution and the likelihood head."""
    H, W, C = cfg.image_shape
    h0, lat0, n0, _ = cfg.stages[0]
    fl = sum(_residual_block_flops((H, W), lat0 if b == 0 else h0, h0, h0) for b in range(n0))
    return fl + _conv_flops((H, W), h0, head_channels(cfg.likelihood, C, cfg.n_mix), 3, 1,
                            False)[0]


def ladder_flops(cfg, batch: int = 1, n_samples: Optional[int] = None) -> float:
    """Closed-form forward FLOPs per batch of a ``LadderConfig``
    (``models/ladder.py``): the stem and the first stochastic encoder stage
    run once per image (the sample axis appears at z_1); the upper encoder
    stages, the top-down p(z_i | z_{i+1}) blocks and the observation decoder
    once per sample. Pools and resizes are not counted."""
    H, W, C = cfg.image_shape
    k = cfg.n_samples if n_samples is None else n_samples
    stages = cfg.stages
    res = _scales(cfg)
    res_in = [(H, W)] + res[:-1]  # the resolution entering stage i's blocks

    def stoch_enc(i: int, c_in: int) -> float:
        h_w, out, n_b, _ = stages[i]
        fl = sum(_residual_block_flops(res_in[i], c_in if b == 0 else out, h_w, out)
                 for b in range(n_b))
        return fl + _conv_flops(res[i], out, 2 * out, 3, 1, False)[0]

    per_img = _conv_flops((H, W), C, cfg.stem_features, 3, 1, False)[0]
    per_img += stoch_enc(0, cfg.stem_features)
    per_sample = sum(stoch_enc(i, stages[i - 1][1]) for i in range(1, len(stages)))
    for i in range(len(stages) - 1):
        h_w, out, n_b, _ = stages[i]
        c_in = stages[i + 1][1]
        per_sample += sum(_residual_block_flops(res[i], c_in if b == 0 else out, h_w, out)
                          for b in range(n_b))
        per_sample += _conv_flops(res[i], out, 2 * out, 3, 1, False)[0]
    per_sample += _observation_flops(cfg)
    return batch * (per_img + k * per_sample)


def biladder_flops(cfg, batch: int = 1, n_samples: Optional[int] = None) -> float:
    """Closed-form forward FLOPs per batch of a ``BiLadderConfig``
    (``models/bidirectional.py``): the bottom-up path and the top posterior
    head run once per image, and with ``split_merge`` the merge heads'
    ``conv_h``; the top-down path (upsampling blocks, prior and merge heads,
    observation decoder) once per sample."""
    H, W, C = cfg.image_shape
    k = cfg.n_samples if n_samples is None else n_samples
    stages = cfg.stages
    res = _scales(cfg)

    per_img = _conv_flops((H, W), C, cfg.stem_features, 3, 1, False)[0]
    c_in, hw = cfg.stem_features, (H, W)
    for i, (h_w, _lat, n_b, _) in enumerate(stages):
        per_img += sum(_residual_block_flops(hw, c_in if b == 0 else h_w, h_w, h_w)
                       for b in range(n_b))
        c_in, hw = h_w, res[i]
    per_img += _conv_flops(res[-1], stages[-1][0], 2 * stages[-1][1], 3, 1, False)[0]

    per_sample = 0.0
    for i in range(len(stages) - 2, -1, -1):
        h_w, lat, n_b, _ = stages[i]
        lat_above = stages[i + 1][1]
        per_sample += sum(_residual_block_flops(res[i], lat_above if b == 0 else h_w, h_w, h_w)
                          for b in range(n_b))
        head = _conv_flops(res[i], h_w, 2 * lat, 3, 1, False)[0]
        per_sample += head  # the prior head
        if cfg.split_merge:  # conv_d per sample, conv_h per image
            per_sample += head
            per_img += head
        else:
            per_sample += _conv_flops(res[i], 2 * h_w, 2 * lat, 3, 1, False)[0]
    per_sample += _observation_flops(cfg)
    return batch * (per_img + k * per_sample)


def mdl_transcendental_census(n_mix: int) -> dict:
    """Per-pixel transcendental-op counts of the Pallas MoDL kernels, by
    source-level op, as ``vae_mdl_tpu/utils/flops.py`` derives them (n =
    n_mix; one cascade = 1 exp, 2 sigmoid, 3 softplus, 1 log, every branch
    evaluated):

    forward: tanh 3n | exp 3n + 2n (two logsumexps) | sigmoid 6n
      | softplus 9n | log 3n + 2
    backward (the recompute's inv_std and sigmoid pairs merged with the
      derivative's): tanh 3n | exp 3n + 3n | sigmoid 6n + 6n | softplus 9n
      | log 3n + 1
    """
    n = n_mix
    return {
        "fwd": {"tanh": 3 * n, "exp": 5 * n, "sigmoid": 6 * n,
                "softplus": 9 * n, "log": 3 * n + 2},
        "bwd": {"tanh": 3 * n, "exp": 6 * n, "sigmoid": 12 * n,
                "softplus": 9 * n, "log": 3 * n + 1},
    }


def mdl_train_transcendentals(model_cfg, batch: int) -> dict:
    """Total transcendental ops per optimizer step spent in the MoDL
    likelihood (one forward and one backward pass over the [k, B, H, W]
    pixels), by op, in the Pallas kernels' count."""
    h, w, _ = model_cfg.image_shape
    pixels = batch * model_cfg.n_samples * h * w
    census = mdl_transcendental_census(model_cfg.n_mix)
    return {op: float((census["fwd"][op] + census["bwd"][op]) * pixels)
            for op in census["fwd"]}


# -- what the CUDA kernels evaluate ---------------------------------------------

# Calls of one cascade by the branch it takes, read off csrc/dl_cascade.cuh:
# dl_log_prob computes inv_std (exp), returns from an edge bin with one
# softplus, else takes two sigmoids and then the log or, below 1e-5, one
# softplus; dl_grads computes inv_std, then one sigmoid in an edge bin, two in
# the CDF-difference branch and a third in the PDF branch; dl_value_and_grads
# gives both from one inv_std and one pair of sigmoids.
_CASCADE_FWD = {
    "right": {"exp": 1, "softplus": 1},
    "left": {"exp": 1, "softplus": 1},
    "cdf": {"exp": 1, "sigmoid": 2, "log": 1},
    "pdf": {"exp": 1, "sigmoid": 2, "softplus": 1},
}
_CASCADE_BWD = {
    "right": {"exp": 1, "sigmoid": 1},
    "left": {"exp": 1, "sigmoid": 1},
    "cdf": {"exp": 1, "sigmoid": 2},
    "pdf": {"exp": 1, "sigmoid": 3},
}
_CASCADE_FUSED = {
    "right": {"exp": 1, "softplus": 1, "sigmoid": 1},
    "left": {"exp": 1, "softplus": 1, "sigmoid": 1},
    "cdf": {"exp": 1, "sigmoid": 2, "log": 1},
    "pdf": {"exp": 1, "sigmoid": 3, "softplus": 1},
}
_OPS = ("tanh", "exp", "sigmoid", "softplus", "log")
# The fewest MUFU (special-function unit) instructions one call of each
# accurate float32 function executes on any of its paths, as the SASS of
# csrc/sfu_probe.cu shows them: expf one EX2; 1 / (1 + expf(-v)) an EX2 and the
# division's RCP; softplus one EX2 (its log1pf is a polynomial); logf none (a
# polynomial); tanhf none below 0.55 (a polynomial; an EX2 and an RCP above).
MUFU_PER_CALL = {"exp": 1, "sigmoid": 2, "softplus": 1, "log": 0, "tanh": 0}


def branch_counts(x, loc, logscale, low: float, high: float, width: float) -> Dict[str, int]:
    """How many cascades of this data take each branch of
    ``discretized_logistic_log_prob``: ``{"right", "left", "cdf", "pdf": n}``
    over the operands' broadcast shape."""
    with torch.no_grad():
        inv_std = torch.exp(-logscale)
        prob = (torch.sigmoid((x - loc + width / 2.0) * inv_std)
                - torch.sigmoid((x - loc - width / 2.0) * inv_std))
        right = (x >= high).expand(prob.shape)
        left = (x <= low).expand(prob.shape) & ~right
        inner = ~(right | left)
        counts = {"right": int(right.sum()), "left": int(left.sum()),
                  "cdf": int((inner & (prob > 1e-5)).sum())}
    counts["pdf"] = prob.numel() - sum(counts.values())
    return counts


def modl_branch_counts(x01, parameters) -> Dict[str, int]:
    """``branch_counts`` over the 3 * n_mix cascades of every pixel of a MoDL
    call: x ``[..., H, W, 3]`` in [0, 1], parameters ``[..., H, W, 10n]``."""
    with torch.no_grad():
        x = x01 * 2.0 - 1.0
        loc, logscale, coeffs, _ = split_mixture_params(parameters.float())
        loc = autoregressive_locs(loc, coeffs, x)
        return branch_counts(x[..., None], loc, logscale, -1.0, 1.0, 2.0 / 255.0)


def cascade_transcendentals(branch_counts: Dict[str, int], backward: bool = False,
                            fused: bool = False) -> dict:
    """Calls by op of ``csrc/dl_cascade.cuh``'s ``dl_log_prob`` (with
    ``backward``, ``dl_grads``; with ``fused``, ``dl_value_and_grads``, the two
    in one sweep) over cascades that take each branch ``branch_counts`` =
    ``{"right", "left", "cdf", "pdf": n}`` times. The first two are the
    census of the discretized-logistic kernels of ``csrc/dl_log_prob.cu``,
    the third the cascades of the MoDL backward."""
    table = _CASCADE_FUSED if fused else _CASCADE_BWD if backward else _CASCADE_FWD
    out = dict.fromkeys(_OPS, 0.0)
    for branch, n in branch_counts.items():
        for op, calls in table[branch].items():
            out[op] += float(calls * n)
    return out


def mdl_cuda_transcendentals(branch_counts: Dict[str, int], pixels: int, n_mix: int,
                             backward: bool = False) -> dict:
    """Calls by op of one launch of the CUDA MoDL forward (or backward)
    kernel of ``csrc/mdl_log_prob.cu`` over ``pixels`` pixels whose 3 * n_mix
    cascades take the branches ``branch_counts``, on either memory path (each
    direction runs one body on both).

    Forward, per pixel: n exp and a log (the logits' logsumexp), 3n tanh, the
    3n cascades, n exp and a log (the weights' logsumexp).

    Backward: the logits' n exp and log, 3n tanh, each cascade once through
    ``dl_value_and_grads``, and the weights' n exp; nothing is evaluated
    twice.

    ``mdl_cuda_sass_ex2`` holds these counts against the built kernels.
    """
    n = n_mix
    out = cascade_transcendentals(branch_counts, fused=backward)
    out["tanh"] += 3.0 * n * pixels
    out["exp"] += 2.0 * n * pixels
    out["log"] += (1.0 if backward else 2.0) * pixels
    return out


def mdl_cuda_sass_ex2(n_mix: int, backward: bool = False) -> int:
    """The MUFU.EX2 instructions in the SASS of one MoDL kernel of
    ``csrc/mdl_log_prob.cu`` (``ops/cuda/build.py`` ``mufu_counts``), which
    lists every branch of every cascade once, on either memory path. A
    cascade's listing holds its exp(-logscale), the common pair of sigmoids,
    and per branch what ``cascade_transcendentals`` counts beyond those:
    forward 1 + 2 + one softplus in each edge bin and in the PDF branch = 6;
    the backward's fused sweep 1 + 2 + (softplus + sigmoid) in each edge bin
    and in the PDF branch = 9. Around them a kernel holds 3n tanhf (one EX2
    on the large-argument path) and the two softmaxes' 2n exp. n_mix = 5: 115
    forward, 160 backward."""
    per_cascade = 9 if backward else 6
    return 3 * n_mix * per_cascade + 3 * n_mix + 2 * n_mix


def mufu_instructions(calls: Dict[str, float]) -> float:
    """The fewest MUFU instructions the transcendental ``calls`` by op need
    (``MUFU_PER_CALL``): over the card's special-function results per second
    they bound a kernel's time from below whatever its other work."""
    return float(sum(n * MUFU_PER_CALL[op] for op, n in calls.items()))
