"""The VAE/IWAE model family as one configurable module.

Port of ``VAE``, ``prior_for`` and ``build_model`` from
``vae_mdl_tpu/models/vae.py`` for model01 - model06 (MLP and conv encoders and
decoders, every likelihood head); ``build_model`` and ``prior_for`` also
take the ladder families' configs (``models/ladder.py``,
``models/bidirectional.py``):

- one stochastic layer: encoder -> q(z|x), k importance samples as a leading
  axis, decoder -> p(x|z) with the configured likelihood head;
- L >= 2 stochastic layers (model06): MLP blocks q(z_i | z_{i-1}) up
  (``mlp_encoder_{i}``), MLP blocks p(z_{i-1} | z_i) down
  (``mlp_decoder_{i}``), a standard-normal prior on the top latent. The
  upper layers are sampled once per z_1 sample.

Randomness comes from an explicit ``torch.Generator``, or as injected
standard-normal noise ``eps``: one tensor ``[k, B, n_latent]`` for z_1, or a
sequence with one tensor per stochastic layer, bottom up (the upper layers'
``[k, B, n_i]``). Unlike the JAX ``decode``, which draws an x sample the
evaluator never uses, ``decode`` here returns the observation distribution
without a sample.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vae_mdl_tpu_torch.config import ModelConfig
from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal
from vae_mdl_tpu_torch.nn.blocks import DTYPES, SPATIAL_AXES, MLPBlock
from vae_mdl_tpu_torch.nn.decoders import ConvDecoder, MLPDecoder
from vae_mdl_tpu_torch.nn.encoders import ConvEncoder, ConvSpec, MLPEncoder

_LATENT_AXES = (-1,)

Noise = Union[torch.Tensor, Sequence[torch.Tensor], None]


def _specs(layers) -> Tuple[ConvSpec, ...]:
    return tuple(
        ConvSpec(features=f, kernel=k, stride=s, transpose=t, activation=a)
        for (f, k, s, t, a) in layers
    )


def per_layer(eps: Noise, n_layers: int) -> Tuple[Optional[torch.Tensor], ...]:
    """``eps`` as one entry per stochastic layer (None = draw it)."""
    if eps is None:
        return (None,) * n_layers
    if isinstance(eps, torch.Tensor):
        return (eps,) + (None,) * (n_layers - 1)
    if len(eps) != n_layers:
        raise ValueError(f"noise for {len(eps)} layers given to a model of {n_layers}")
    return tuple(eps)


class VAE(nn.Module):
    """Configurable importance-weighted autoencoder."""

    def __init__(self, config: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg.decoder.head_pad:
            raise NotImplementedError(
                f"{cfg.name}: DecoderConfig.head_pad, a TPU lane-alignment experiment, "
                "is not ported (ROADMAP.md, left out on purpose)")
        self.config = cfg
        dtype = DTYPES[cfg.compute_dtype]
        latents = cfg.latents()
        if cfg.encoder.kind == "mlp":
            self.encoder = MLPEncoder(
                cfg.image_shape, cfg.encoder.n_hidden, latents[0], cfg.encoder.activation,
                cfg.encoder.std_transform, dtype, generator)
        else:
            self.encoder = ConvEncoder(
                _specs(cfg.encoder.conv_layers), cfg.image_shape, latents[0], dtype, generator,
                n_glu=cfg.encoder.n_glu, glu_features=cfg.encoder.glu_features,
                glu_activation=cfg.encoder.glu_activation)
        if cfg.decoder.kind == "mlp":
            self.decoder = MLPDecoder(
                latents[0], cfg.image_shape, cfg.decoder.n_hidden, cfg.decoder.activation,
                cfg.likelihood, cfg.n_mix, cfg.bound_logstd, cfg.use_pallas,
                cfg.likelihood_io_dtype, dtype, generator)
        else:
            self.decoder = ConvDecoder(
                _specs(cfg.decoder.conv_layers), latents[0],
                base_size=cfg.decoder.base_size, out_shape=cfg.image_shape,
                fc_activation=cfg.decoder.fc_activation, likelihood=cfg.likelihood,
                n_mix=cfg.n_mix, bound_logstd=cfg.bound_logstd,
                use_pallas=cfg.use_pallas, likelihood_io_dtype=cfg.likelihood_io_dtype,
                dtype=dtype, generator=generator,
                pre_specs=_specs(cfg.decoder.pre_layers), n_glu=cfg.decoder.n_glu,
                glu_features=cfg.decoder.glu_features,
                glu_activation=cfg.decoder.glu_activation)

        # stochastic layers 2..L: inference (up) and generative (down) MLPs
        self.mlp_encoders, self.mlp_decoders = [], []
        for i in range(1, cfg.n_stochastic):
            up = MLPBlock(latents[i - 1], cfg.mlp_hidden, latents[i], cfg.mlp_activation,
                          "softplus", dtype=dtype, generator=generator)
            down = MLPBlock(latents[i], cfg.mlp_hidden, latents[i - 1], cfg.mlp_activation,
                            "softplus", dtype=dtype, generator=generator)
            self.add_module(f"mlp_encoder_{i}", up)
            self.add_module(f"mlp_decoder_{i}", down)
            self.mlp_encoders.append(up)
            self.mlp_decoders.append(down)

    # -- inference ------------------------------------------------------------

    def encode(self, x: torch.Tensor, n_samples: int = 1,
               generator: Optional[torch.Generator] = None,
               eps: Noise = None) -> Tuple[DistributionTuple, ...]:
        """q(z_1 | x) .. q(z_L | z_{L-1}) with samples attached."""
        return self.sample_posterior(self.encoder(x), n_samples, generator, eps)

    def sample_posterior(self, q1: Normal, n_samples: int = 1,
                         generator: Optional[torch.Generator] = None,
                         eps: Noise = None) -> Tuple[DistributionTuple, ...]:
        """``encode`` from a given q(z_1 | x), which the evaluator computes
        once per batch. Importance samples are a leading axis on z_1 and ride
        through the upper layers, each sampled once per z_1 sample."""
        noise = per_layer(eps, len(self.mlp_encoders) + 1)
        z = q1.sample(generator, (n_samples,), noise=noise[0])
        Qs = [DistributionTuple(q1, z, axes=_LATENT_AXES)]
        for block, layer_noise in zip(self.mlp_encoders, noise[1:]):
            q = block(z)
            z = q.sample(generator, noise=layer_noise)
            Qs.append(DistributionTuple(q, z, axes=_LATENT_AXES))
        return tuple(Qs)

    def posterior_at(self, x: torch.Tensor,
                     zs: Tuple[torch.Tensor, ...]) -> Tuple[DistributionTuple, ...]:
        """q(z_1 | x), q(z_2 | z_1), .. evaluated at given latents, without
        sampling: q_i's parameters are computed from ``zs[i-1]`` and each
        tuple carries ``zs[i]``. The DReG estimator calls it with detached
        weights at live latents (``models/objective.py``), which keeps the
        route z_{i-1} -> q_i's parameters alive."""
        Qs = [DistributionTuple(self.encoder(x), zs[0], axes=_LATENT_AXES)]
        for i, block in enumerate(self.mlp_encoders):
            Qs.append(DistributionTuple(block(zs[i]), zs[i + 1], axes=_LATENT_AXES))
        return tuple(Qs)

    # -- generation -----------------------------------------------------------

    def decode(self, z1: torch.Tensor) -> DistributionTuple:
        """p(x | z_1), no sample attached."""
        pxz = self.decoder(z1)
        return DistributionTuple(pxz, None, axes=pxz.event_axes)

    def decode_down(self, Qs: Tuple[DistributionTuple, ...]):
        """The generative conditionals p(z_i | z_{i+1}) evaluated at the
        inference samples, and p(x | z_1)."""
        Ps = tuple(DistributionTuple(block(Qs[i + 1].z), None, axes=_LATENT_AXES)
                   for i, block in enumerate(self.mlp_decoders))
        return Ps, self.decode(Qs[0].z)

    def generate(self, z_top: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> DistributionTuple:
        """Ancestral sampling z_L -> ... -> z_1, then p(x | z_1)."""
        z = z_top
        for block in reversed(self.mlp_decoders):
            z = block(z).sample(generator)
        return self.decode(z)

    def forward(self, x: torch.Tensor, n_samples: Optional[int] = None,
                generator: Optional[torch.Generator] = None, eps: Noise = None):
        """Full forward pass: ``(Qs, Ps, pxz)``."""
        k = self.config.n_samples if n_samples is None else n_samples
        Qs = self.encode(x, k, generator, eps)
        Ps, pxz = self.decode_down(Qs)
        return Qs, Ps, pxz


def _is_ladder(config) -> bool:
    """Whether ``config`` is one of the ladder families' (spatial latents)."""
    return hasattr(config, "top_latent_shape")


def latent_shapes(config) -> Tuple[Tuple[int, ...], ...]:
    """The shape of one sample of each stochastic layer's latent, bottom
    first: ``(n_i,)`` for the VAE family, ``(h_i, w_i, c_i)`` for the
    ladders. Injected noise is ``[k, B] + shape`` per layer in this order."""
    if _is_ladder(config):
        return config.latent_shapes()
    return tuple((n,) for n in config.latents())


def prior_for(config, device=None) -> Normal:
    """Standard-normal prior over the top latent: a vector for the VAE
    family, the spatial top latent ``[h, w, c]`` (event axes (-1, -2, -3))
    for the ladders."""
    if _is_ladder(config):
        shape = config.top_latent_shape()
        return Normal(torch.zeros(shape, device=device), torch.ones(shape, device=device),
                      event_axes=SPATIAL_AXES)
    n_top = config.latents()[-1]
    return Normal(torch.zeros(n_top, device=device), torch.ones(n_top, device=device),
                  event_axes=_LATENT_AXES)


def build_model(config, generator: Optional[torch.Generator] = None,
                device=None) -> nn.Module:
    """The model for ``config`` (a ``ModelConfig``, a ``LadderConfig`` or a
    ``BiLadderConfig``), float32 parameters on ``device``.

    ``device=None`` means the card: it raises when CUDA is not available and
    never carries on on the CPU; pass ``device="cpu"`` for that. The
    parameters are initialised from ``generator`` on the CPU, so one seed
    gives the same weights on either, and then placed. ``create_train_state``,
    the steps and ``evaluate_llh`` follow the model's device.
    """
    from vae_mdl_tpu_torch.models.bidirectional import BiLadderConfig, BiLadderVAE
    from vae_mdl_tpu_torch.models.ladder import ConvLadderVAE, LadderConfig

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_model places the model on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to run on the CPU")
        device = torch.device("cuda")
    if isinstance(config, BiLadderConfig):
        model = BiLadderVAE(config, generator)
    elif isinstance(config, LadderConfig):
        model = ConvLadderVAE(config, generator)
    else:
        model = VAE(config, generator)
    return model.to(device)
