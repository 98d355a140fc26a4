"""The VAE/IWAE model family, one stochastic layer with conv encoder/decoder.

Port of ``VAE`` (with ``posterior_at``), ``prior_for`` and ``build_model``
from ``vae_mdl_tpu/models/vae.py`` for the model05 path: encoder -> q(z|x),
k importance samples as a leading axis, decoder -> p(x|z) with the MoDL head.

Randomness comes from an explicit ``torch.Generator``, or as injected
standard-normal noise ``eps`` ``[k, B, n_latent]``. Unlike the JAX
``decode``, which draws an x sample the evaluator never uses, ``decode``
here returns the observation distribution without a sample.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vae_mdl_tpu_torch.config import ModelConfig
from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal
from vae_mdl_tpu_torch.nn.blocks import DTYPES
from vae_mdl_tpu_torch.nn.decoders import ConvDecoder
from vae_mdl_tpu_torch.nn.encoders import ConvEncoder, ConvSpec

_LATENT_AXES = (-1,)


def _specs(layers) -> Tuple[ConvSpec, ...]:
    return tuple(
        ConvSpec(features=f, kernel=k, stride=s, transpose=t, activation=a)
        for (f, k, s, t, a) in layers
    )


class VAE(nn.Module):
    """Importance-weighted autoencoder with one stochastic layer."""

    def __init__(self, config: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        missing = [what for what, ok in (
            ("conv encoder", cfg.encoder.kind == "conv" and not cfg.encoder.n_glu),
            ("conv decoder", cfg.decoder.kind == "conv" and not cfg.decoder.n_glu
             and not cfg.decoder.pre_layers and not cfg.decoder.head_pad),
            ("one stochastic layer", cfg.n_stochastic == 1),
            ("mdl likelihood", cfg.likelihood == "mdl"),
        ) if not ok]
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: the port covers the model05 family only; "
                f"needs {', '.join(missing)} (ROADMAP.md Queue 1)")
        self.config = cfg
        dtype = DTYPES[cfg.compute_dtype]
        self.encoder = ConvEncoder(_specs(cfg.encoder.conv_layers), cfg.image_shape,
                                   cfg.n_latent, dtype, generator)
        self.decoder = ConvDecoder(
            _specs(cfg.decoder.conv_layers), cfg.n_latent,
            base_size=cfg.decoder.base_size, out_shape=cfg.image_shape,
            fc_activation=cfg.decoder.fc_activation, likelihood=cfg.likelihood,
            n_mix=cfg.n_mix, bound_logstd=cfg.bound_logstd,
            use_pallas=cfg.use_pallas, likelihood_io_dtype=cfg.likelihood_io_dtype,
            dtype=dtype, generator=generator)

    def encode(self, x: torch.Tensor, n_samples: int = 1,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> Tuple[DistributionTuple, ...]:
        """q(z | x) with ``n_samples`` samples attached on a leading axis."""
        q1 = self.encoder(x)
        z1 = q1.sample(generator, (n_samples,), noise=eps)
        return (DistributionTuple(q1, z1, axes=_LATENT_AXES),)

    def posterior_at(self, x: torch.Tensor,
                     zs: Tuple[torch.Tensor, ...]) -> Tuple[DistributionTuple, ...]:
        """q(z | x) evaluated at given latents ``zs[0]``, without sampling:
        the DReG estimator evaluates it under detached weights at live
        latents (``models/objective.py``)."""
        return (DistributionTuple(self.encoder(x), zs[0], axes=_LATENT_AXES),)

    def decode(self, z1: torch.Tensor) -> DistributionTuple:
        """p(x | z), no sample attached."""
        pxz = self.decoder(z1)
        return DistributionTuple(pxz, None, axes=pxz.event_axes)

    def forward(self, x: torch.Tensor, n_samples: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """Full forward pass: ``(Qs, Ps, pxz)``; ``Ps`` is empty at one layer."""
        k = self.config.n_samples if n_samples is None else n_samples
        Qs = self.encode(x, k, generator, eps)
        return Qs, (), self.decode(Qs[0].z)


def prior_for(config: ModelConfig, device=None) -> Normal:
    """Standard-normal prior over the top latent."""
    n_top = config.latents()[-1]
    return Normal(torch.zeros(n_top, device=device), torch.ones(n_top, device=device),
                  event_axes=_LATENT_AXES)


def build_model(config: ModelConfig, generator: Optional[torch.Generator] = None) -> VAE:
    """The model for ``config``, float32 parameters on the CPU, initialised
    from ``generator``."""
    return VAE(config, generator)
