"""Conv-ladder hierarchical VAE: spatial latents at several scales.

Port of ``LadderConfig``, ``ConvLadderVAE`` and ``LADDER_SVHN`` from
``vae_mdl_tpu/models/ladder.py``:

    bottom-up:  stem conv -> q(z_1|x) at scale /r -> q(z_2|z_1) ... q(z_L|.)
    top-down:   p(z_{L-1}|z_L) ... p(z_1|z_2), observation head from z_1
    prior:      standard normal over the top spatial latent

Latents are spatial (``[..., h_i, w_i, c_i]``, event axes (-1, -2, -3));
importance samples ride as a leading axis from z_1 on, as in the dense
models. Randomness comes from an explicit ``torch.Generator`` or as injected
standard-normal noise ``eps``: one tensor ``[k, B, h_i, w_i, c_i]`` per
stochastic layer, bottom up (the JAX model draws them in the same order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal
from vae_mdl_tpu_torch.models.vae import Noise, generative_noise, observe, per_layer, prior_for
from vae_mdl_tpu_torch.nn.blocks import (
    DTYPES,
    DecoderBlock,
    SPATIAL_AXES,
    SameConv,
    StochasticDecoderBlock,
    StochasticEncoderBlock,
    _activation,
    on_merged,
)
from vae_mdl_tpu_torch.nn.decoders import head_channels, ladder_observation

# (hidden_width, out_width, n_blocks, scale_rate) per stochastic scale
Stage = Tuple[int, int, int, int]


def stage_latent_shapes(image_shape, stages) -> Tuple[Tuple[int, int, int], ...]:
    """``(h_i, w_i, c_i)`` of each stage's latent, bottom first: stage i
    divides the resolution by its rate and has ``stages[i][1]`` channels."""
    h, w, _ = image_shape
    shapes = []
    for (_, channels, _, rate) in stages:
        h, w = h // rate, w // rate
        shapes.append((h, w, channels))
    return tuple(shapes)


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    name: str = "ladder"
    image_shape: Tuple[int, int, int] = (32, 32, 3)
    stem_features: int = 32
    # bottom-up scales; latent i lives at resolution H / prod(rates[:i+1])
    stages: Tuple[Stage, ...] = ((32, 16, 1, 2), (32, 8, 1, 2))
    n_samples: int = 5
    likelihood: str = "dl"
    bound_logstd: bool = False
    n_mix: int = 5
    rezero: bool = True
    use_pallas: Optional[bool] = None
    compute_dtype: str = "float32"
    beta: float = 1.0  # KL weight in the bound
    # tanh-approximate gelu, as the JAX package's ladders
    activation: str = "gelu_tanh"

    @property
    def n_stochastic(self) -> int:
        return len(self.stages)

    def latent_shapes(self) -> Tuple[Tuple[int, int, int], ...]:
        return stage_latent_shapes(self.image_shape, self.stages)

    def top_latent_shape(self) -> Tuple[int, int, int]:
        return self.latent_shapes()[-1]


class ConvLadderVAE(nn.Module):
    """``stem``, the stochastic encoder blocks ``enc_{i}``, the stochastic
    decoder blocks ``dec_{i}`` (p(z_i | z_{i+1}) upsamples scale i+1 to i),
    ``obs_up`` and the float32 ``obs_head``, named as the Flax modules."""

    def __init__(self, config: LadderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dtype = self.dtype = DTYPES[cfg.compute_dtype]
        self.act = _activation(cfg.activation)
        self.stem = SameConv(cfg.image_shape[-1], cfg.stem_features, generator)
        self.enc_blocks = []
        c_in = cfg.stem_features
        for i, (h, o, n, r) in enumerate(cfg.stages):
            block = StochasticEncoderBlock(c_in, h, o, n, r, cfg.rezero, dtype, cfg.activation,
                                           generator)
            self.add_module(f"enc_{i}", block)
            self.enc_blocks.append(block)
            c_in = o
        self.dec_blocks = []
        for i in range(len(cfg.stages) - 1):
            h, o, n, _ = cfg.stages[i]
            block = StochasticDecoderBlock(cfg.stages[i + 1][1], h, o, n, cfg.stages[i + 1][3],
                                           cfg.rezero, dtype, cfg.activation, generator)
            self.add_module(f"dec_{i}", block)
            self.dec_blocks.append(block)
        h0, o0, n0, r0 = cfg.stages[0]
        self.obs_up = DecoderBlock(o0, h0, h0, n0, r0, cfg.rezero, dtype, cfg.activation,
                                   generator)
        self.obs_head = SameConv(h0, head_channels(cfg.likelihood, cfg.image_shape[-1],
                                                   cfg.n_mix), generator)

    # -- inference ------------------------------------------------------------

    def encode(self, x: torch.Tensor, n_samples: int = 1,
               generator: Optional[torch.Generator] = None,
               eps: Noise = None) -> Tuple[DistributionTuple, ...]:
        """q(z_1 | x) .. q(z_L | z_{L-1}) with samples attached; the stem and
        q(z_1 | x) run once per image, the rest once per sample."""
        noise = per_layer(eps, len(self.enc_blocks))
        z = on_merged(lambda h: self.act(self.stem(h, self.dtype)), x)
        Qs = []
        for i, (block, layer_noise) in enumerate(zip(self.enc_blocks, noise)):
            q = block(z)
            z = q.sample(generator, (n_samples,) if i == 0 else (), noise=layer_noise)
            Qs.append(DistributionTuple(q, z, axes=SPATIAL_AXES))
        return tuple(Qs)

    # -- generation -----------------------------------------------------------

    def decode(self, z1: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise=None) -> DistributionTuple:
        """p(x | z_1), with an x sample attached when ``generator`` or
        ``noise`` is given."""
        return observe(ladder_observation(self, z1).dist, generator, noise)

    def decode_down(self, Qs: Tuple[DistributionTuple, ...]):
        """p(z_i | z_{i+1}) at the inference samples, and p(x | z_1)."""
        Ps = tuple(DistributionTuple(block(Qs[i + 1].z), None, axes=SPATIAL_AXES)
                   for i, block in enumerate(self.dec_blocks))
        return Ps, self.decode(Qs[0].z)

    def generate(self, z_top: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise=None) -> DistributionTuple:
        """Ancestral sampling z_L -> ... -> z_1, then p(x | z_1) with an x
        sample. ``noise``: the standard normals of z_{L-1} .. z_1, then the
        x draw's noise (``models.vae.generative_noise``)."""
        layer_noise, obs_noise = generative_noise(noise, len(self.dec_blocks) + 1)
        z = z_top
        for block, eps in zip(reversed(self.dec_blocks), layer_noise):
            z = block(z).sample(generator, noise=eps)
        return self.decode(z, generator, obs_noise)

    def forward(self, x: torch.Tensor, n_samples: Optional[int] = None,
                generator: Optional[torch.Generator] = None, eps: Noise = None):
        """Full forward pass: ``(Qs, Ps, pxz)``."""
        k = self.config.n_samples if n_samples is None else n_samples
        Qs = self.encode(x, k, generator, eps)
        Ps, pxz = self.decode_down(Qs)
        return Qs, Ps, pxz

    def prior(self) -> Normal:
        return prior_for(self.config, self.stem.weight.device)


# a ready-made config: 3 spatial scales on 32x32 images
LADDER_SVHN = LadderConfig(
    name="ladder_svhn",
    stages=((48, 24, 2, 2), (48, 16, 1, 2), (48, 8, 1, 2)),
)
