"""Bidirectional ladder VAE: top-down posterior with a bottom-up merge.

Port of ``BiLadderConfig``, ``_GaussianHead``, ``_SplitMergeGaussianHead``,
``BiLadderVAE``, ``BILADDER_SVHN`` and ``BILADDER_CELEBA`` from
``vae_mdl_tpu/models/bidirectional.py``:

    bottom-up (deterministic):  h_1 .. h_L = EncoderBlocks(stem(x))
    top level:                  q(z_L | h_L)
    top-down, i = L-1 .. 1:     d_i     = upsample(z_{i+1})
                                p(z_i | z_{i+1}) = prior head(d_i)
                                q(z_i | x, z_{>i}) = merge head([h_i, d_i])
    observation:                p(x | z_1)

The bottom-up features ``h_i`` run once per image and broadcast against the
samples. The model samples top-down, but injected noise ``eps`` comes as
everywhere in the port, one tensor ``[k, B, h_i, w_i, c_i]`` per stochastic
layer, bottom up: z_L takes ``eps[-1]``, z_1 ``eps[0]``. (The JAX model draws
z_L first, then z_{L-1} .. z_1.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal
from vae_mdl_tpu_torch.models.ladder import Stage, stage_latent_shapes
from vae_mdl_tpu_torch.models.vae import Noise, generative_noise, observe, per_layer, prior_for
from vae_mdl_tpu_torch.nn.blocks import (
    DTYPES,
    DecoderBlock,
    EncoderBlock,
    SPATIAL_AXES,
    SameConv,
    _activation,
    nchw,
    nhwc,
    merge_leading,
    on_merged,
    spatial_normal,
)
from vae_mdl_tpu_torch.nn.decoders import head_channels, ladder_observation


@dataclasses.dataclass(frozen=True)
class BiLadderConfig:
    name: str = "biladder"
    image_shape: Tuple[int, int, int] = (32, 32, 3)
    stem_features: int = 32
    # (hidden_width, latent_channels, n_blocks, scale_rate) per stochastic scale
    stages: Tuple[Stage, ...] = ((48, 16, 1, 2), (48, 8, 1, 2))
    n_samples: int = 5
    likelihood: str = "dl"
    bound_logstd: bool = False
    n_mix: int = 5
    rezero: bool = True
    use_pallas: Optional[bool] = None
    compute_dtype: str = "float32"
    beta: float = 1.0
    # tanh-approximate gelu, as the JAX package's ladders
    activation: str = "gelu_tanh"
    # each merge head as conv_h(h) + conv_d(d) over the parts of the concat
    # [h, d]: the same linear map, with conv_h run once per batch, as h has
    # no sample axis (_SplitMergeGaussianHead); False: one conv over the
    # concat, another parameter tree
    split_merge: bool = True

    @property
    def n_stochastic(self) -> int:
        return len(self.stages)

    def latent_shapes(self) -> Tuple[Tuple[int, int, int], ...]:
        return stage_latent_shapes(self.image_shape, self.stages)

    def top_latent_shape(self) -> Tuple[int, int, int]:
        return self.latent_shapes()[-1]


class _GaussianHead(nn.Module):
    """A float32 3x3 conv ``Conv_0`` -> Normal(mu, softplus(logstd)) over a
    spatial latent, with no activation; float32 whatever the body's dtype."""

    def __init__(self, in_width: int, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = SameConv(in_width, 2 * channels, generator)

    def forward(self, h: torch.Tensor) -> Normal:
        return spatial_normal(on_merged(lambda v: self.Conv_0(v.float(), torch.float32), h))


class _SplitMergeGaussianHead(nn.Module):
    """The merge head as ``conv_h(h) + conv_d(d)`` (``conv_h`` has no bias):
    h ``[B, ...]`` goes through its conv once and broadcasts into the sum
    with d ``[k, B, ...]``'s. float32, like ``_GaussianHead``."""

    def __init__(self, h_width: int, d_width: int, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_h = SameConv(h_width, 2 * channels, generator, bias=False)
        self.conv_d = SameConv(d_width, 2 * channels, generator)

    def forward(self, h: torch.Tensor, d: torch.Tensor) -> Normal:
        out_h = on_merged(lambda v: self.conv_h(v.float(), torch.float32), h)
        out_d = on_merged(lambda v: self.conv_d(v.float(), torch.float32), d)
        return spatial_normal(out_h + out_d)


class BiLadderVAE(nn.Module):
    """``stem``, the bottom-up ``enc_{i}``, the top posterior head ``q_top``,
    per lower scale the upsampler ``up_{i}``, the prior head ``p_{i}`` and
    the merge head ``q_{i}``, then ``obs_up`` and the float32 ``obs_head``,
    named as the Flax modules."""

    def __init__(self, config: BiLadderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dtype = self.dtype = DTYPES[cfg.compute_dtype]
        self.act = _activation(cfg.activation)
        stages = cfg.stages
        self.stem = SameConv(cfg.image_shape[-1], cfg.stem_features, generator)
        self.enc_blocks = []
        c_in = cfg.stem_features
        for i, (h, _, n, r) in enumerate(stages):
            block = EncoderBlock(c_in, h, h, n, r, cfg.rezero, dtype, cfg.activation, generator)
            self.add_module(f"enc_{i}", block)
            self.enc_blocks.append(block)
            c_in = h
        self.q_top = _GaussianHead(stages[-1][0], stages[-1][1], generator)
        self.up_blocks, self.prior_heads, self.merge_heads = [], [], []
        for i in range(len(stages) - 1):
            h, lat, n, _ = stages[i]
            up = DecoderBlock(stages[i + 1][1], h, h, n, stages[i + 1][3], cfg.rezero, dtype,
                              cfg.activation, generator)
            prior = _GaussianHead(h, lat, generator)
            merge = (_SplitMergeGaussianHead(h, h, lat, generator) if cfg.split_merge
                     else _GaussianHead(2 * h, lat, generator))
            # registered in Flax's order of setup: up, prior, merge per scale
            self.add_module(f"up_{i}", up)
            self.add_module(f"p_{i}", prior)
            self.add_module(f"q_{i}", merge)
            self.up_blocks.append(up)
            self.prior_heads.append(prior)
            self.merge_heads.append(merge)
        h0, lat0, n0, r0 = stages[0]
        self.obs_up = DecoderBlock(lat0, h0, h0, n0, r0, cfg.rezero, dtype, cfg.activation,
                                   generator)
        self.obs_head = SameConv(h0, head_channels(cfg.likelihood, cfg.image_shape[-1],
                                                   cfg.n_mix), generator)

    # -- bottom-up deterministic path -------------------------------------------

    def _features(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``h_1 .. h_L`` ``[B, h_i, w_i, width_i]``, each at z_i's scale."""
        merged, unmerge = merge_leading(x)
        h = self.act(self.stem(nchw(merged), self.dtype))
        hs = []
        for block in self.enc_blocks:
            h = block.forward_nchw(h)
            hs.append(unmerge(nhwc(h)))
        return tuple(hs)

    # -- full inference and generative pass -------------------------------------

    def forward(self, x: torch.Tensor, n_samples: Optional[int] = None,
                generator: Optional[torch.Generator] = None, eps: Noise = None):
        """Full forward pass: ``(Qs, Ps, pxz)``, Qs and Ps bottom first."""
        cfg = self.config
        k = cfg.n_samples if n_samples is None else n_samples
        L = len(cfg.stages)
        noise = per_layer(eps, L)
        hs = self._features(x)
        q_top = self.q_top(hs[-1])
        z = q_top.sample(generator, (k,), noise=noise[-1])
        Qs = [DistributionTuple(q_top, z, axes=SPATIAL_AXES)]
        Ps = []
        for i in range(L - 2, -1, -1):
            d = self.up_blocks[i](z)
            p_i = self.prior_heads[i](d)
            if cfg.split_merge:
                q_i = self.merge_heads[i](hs[i], d)
            else:
                h_b = hs[i].expand(d.shape[:-1] + hs[i].shape[-1:])
                q_i = self.merge_heads[i](torch.cat([h_b, d], dim=-1))
            z = q_i.sample(generator, noise=noise[i])
            Qs.append(DistributionTuple(q_i, z, axes=SPATIAL_AXES))
            Ps.append(DistributionTuple(p_i, None, axes=SPATIAL_AXES))
        Qs, Ps = tuple(reversed(Qs)), tuple(reversed(Ps))
        return Qs, Ps, self.decode(Qs[0].z)

    def encode(self, x: torch.Tensor, n_samples: int = 1,
               generator: Optional[torch.Generator] = None,
               eps: Noise = None) -> Tuple[DistributionTuple, ...]:
        """The posterior chain with samples: the full top-down inference,
        since the posterior conditions on the generative path."""
        return self(x, n_samples, generator, eps)[0]

    def decode(self, z1: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise=None) -> DistributionTuple:
        """p(x | z_1), with an x sample attached when ``generator`` or
        ``noise`` is given."""
        return observe(ladder_observation(self, z1).dist, generator, noise)

    def generate(self, z_top: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise=None) -> DistributionTuple:
        """Ancestral sampling through the prior heads, then p(x | z_1) with an
        x sample. ``noise``: the standard normals of z_{L-1} .. z_1, then the
        x draw's noise (``models.vae.generative_noise``)."""
        n_layers = len(self.config.stages)
        layer_noise, obs_noise = generative_noise(noise, n_layers)
        z = z_top
        for i, eps in zip(range(n_layers - 2, -1, -1), layer_noise):
            z = self.prior_heads[i](self.up_blocks[i](z)).sample(generator, noise=eps)
        return self.decode(z, generator, obs_noise)

    def prior(self) -> Normal:
        return prior_for(self.config, self.stem.weight.device)


BILADDER_SVHN = BiLadderConfig(
    name="biladder_svhn",
    stages=((48, 24, 2, 2), (48, 16, 1, 2), (48, 8, 1, 2)),
)

# 64x64 CelebA-scale ladder, four spatial scales down to 4x4, bf16 conv
# bodies; every posterior, prior and likelihood head is float32
BILADDER_CELEBA = BiLadderConfig(
    name="biladder_celeba",
    image_shape=(64, 64, 3),
    stem_features=48,
    stages=((64, 32, 2, 2), (64, 24, 2, 2), (64, 16, 1, 2), (64, 8, 1, 2)),
    likelihood="dl",
    compute_dtype="bfloat16",
)
