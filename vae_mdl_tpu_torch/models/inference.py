"""Inference: sample, reconstruct and encode with given weights.

Port of ``vae_mdl_tpu/models/inference.py``: ``make_sampler``,
``make_reconstructor`` and ``make_encoder_fn`` return plain functions that
run under ``torch.no_grad()`` through ``models.objective.apply``, so EMA or
checkpoint weights go in as ``params`` (``{name: tensor}``).

Every random draw of these functions is a tensor input: ``noise``, or, where
it is None, drawn from ``generator`` by ``draw_noise`` in the order that
``sample_noise``, ``reconstruct_noise`` and ``encode_noise`` list. Each lists
``(name, shape, kind)``: ``"normal"`` a standard normal, ``"uniform"``
U[tiny, 1) (``torch.rand`` clamped at the float32 ``tiny``, so that no
logistic or Gumbel draw takes a log of 0). An exported program
(``models/export.py``) takes the same list as its first inputs, which makes
it equal to the live function on the same draws.

Two semantics are the JAX package's: a Gaussian observation model samples
its mean function, not noisy draws; a reconstruction is the observation
model's mean at one posterior sample, for the MoDL the Monte-Carlo mean of
``RECON_MC_SAMPLES`` samples.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from vae_mdl_tpu_torch.models.objective import apply
from vae_mdl_tpu_torch.models.vae import latent_shapes

NoiseSpec = List[Tuple[str, Tuple[int, ...], str]]

# the MoDL reconstruction's Monte-Carlo samples (JAX: ``dist.mean(key, n=32)``)
RECON_MC_SAMPLES = 32


def _observation_noise(config, batch: Tuple[int, ...], draws: Tuple[int, ...] = ()) -> NoiseSpec:
    """The uniforms of ``draws`` x samples of p(x | z) over ``batch`` images
    (a Gaussian's normals), as the likelihood's ``sample`` takes them."""
    h, w, c = config.image_shape
    shape = tuple(draws) + tuple(batch) + (h, w)
    likelihood = config.likelihood
    if likelihood in ("mdl", "pmdl"):
        return [("x_logistic", shape + (3, config.n_mix), "uniform"),
                ("x_gumbel", shape + (config.n_mix,), "uniform")]
    if likelihood == "gaussian":
        return [("x", shape + (c,), "normal")]
    return [("x", shape + (c,), "uniform")]


def sample_noise(config, n: int) -> NoiseSpec:
    """The sampler's draws for ``n`` images: the prior's normals, each lower
    layer's normals top down, then the x draw's uniforms (none for a
    Gaussian observation model, whose mean is the image)."""
    shapes = latent_shapes(config)
    spec = [("z_top", (n,) + tuple(shapes[-1]), "normal")]
    for i in range(len(shapes) - 2, -1, -1):
        spec.append((f"z_{i + 1}", (n,) + tuple(shapes[i]), "normal"))
    if config.likelihood != "gaussian":
        spec += _observation_noise(config, (n,))
    return spec


def encode_noise(config, batch: int) -> NoiseSpec:
    """One posterior sample of every stochastic layer, bottom up, ``[1, B,
    ...]`` each: the encoder's draws (the upper layers' q depend on them)."""
    return [(f"eps_{i + 1}", (1, batch) + tuple(shape), "normal")
            for i, shape in enumerate(latent_shapes(config))]


def reconstruct_noise(config, batch: int) -> NoiseSpec:
    """The encoder's draws, then those of the mean of p(x | z): the MoDL's
    ``RECON_MC_SAMPLES`` samples, the per-pixel mixture's component choice;
    no more for the other observation models, whose mean is exact."""
    spec = encode_noise(config, batch)
    if config.likelihood == "mdl":
        spec += _observation_noise(config, (1, batch), (RECON_MC_SAMPLES,))
    elif config.likelihood == "pmdl":
        spec.append(("x_gumbel", (1, batch) + tuple(config.image_shape[:2]) + (config.n_mix,),
                     "uniform"))
    return spec


def draw_noise(spec: NoiseSpec, generator: Optional[torch.Generator] = None,
               device=None) -> List[torch.Tensor]:
    """One tensor per entry of ``spec``, in its order, from ``generator``."""
    tiny = torch.finfo(torch.float32).tiny
    out = []
    for _, shape, kind in spec:
        if kind == "normal":
            out.append(torch.randn(shape, generator=generator, device=device))
        elif kind == "uniform":
            out.append(torch.rand(shape, generator=generator, device=device).clamp_min_(tiny))
        else:
            raise ValueError(f"unknown noise kind {kind!r}")
    return out


def _observation_entry(parts: Sequence[torch.Tensor]):
    """The x draw's noise as the likelihood's ``sample`` takes it."""
    if not parts:
        return None
    return tuple(parts) if len(parts) > 1 else parts[0]


def params_device(params) -> torch.device:
    """The device the ``{name: tensor}`` params lie on."""
    return next(iter(params.values())).device


def _to_uint8(img: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1] -> uint8, rounded half up, as the JAX sampler does."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def make_sampler(model, config) -> Callable:
    """``sample(params, generator, n, noise=None) -> uint8 [n, H, W, C]``:
    ancestral sampling from the top prior through the generative path; the
    draws of ``sample_noise(config, n)`` come from ``generator`` unless
    ``noise`` gives them."""

    @torch.no_grad()
    def sample(params, generator: Optional[torch.Generator], n: int,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if noise is None:
            noise = draw_noise(sample_noise(config, n), generator, params_device(params))
        n_layers = len(latent_shapes(config))
        z_top, layers, obs = noise[0], list(noise[1:n_layers]), noise[n_layers:]
        out = apply(model, params, z_top, method="generate",
                    noise=layers + [_observation_entry(obs)])
        img = out.dist.mean() if config.likelihood == "gaussian" else out.x
        return _to_uint8(img)

    return sample


def make_reconstructor(model, config) -> Callable:
    """``reconstruct(params, generator, x01, noise=None) -> float [B, H, W,
    C]``: the observation model's mean at one posterior sample of ``x01``
    (``[B, H, W, C]`` in [0, 1]); draws as ``reconstruct_noise``."""
    from vae_mdl_tpu_torch.distributions import (
        MixtureDiscretizedLogistic,
        PixelMixtureDiscretizedLogistic,
    )

    n_layers = len(latent_shapes(config))

    @torch.no_grad()
    def reconstruct(params, generator: Optional[torch.Generator], x01: torch.Tensor,
                    noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if noise is None:
            noise = draw_noise(reconstruct_noise(config, x01.shape[0]), generator, x01.device)
        eps, obs = list(noise[:n_layers]), noise[n_layers:]
        _, _, pxz = apply(model, params, x01, 1, eps=eps)
        dist = pxz.dist
        if isinstance(dist, MixtureDiscretizedLogistic):
            mean = dist.mean(n=RECON_MC_SAMPLES, noise=_observation_entry(obs))
        elif isinstance(dist, PixelMixtureDiscretizedLogistic):
            mean = dist.mean(noise=obs[0])
        else:
            mean = dist.mean()
        return mean[0]

    return reconstruct


def make_encoder_fn(model) -> Callable:
    """``encode(params, generator, x01, noise=None) -> tuple`` of each
    stochastic layer's posterior mean, bottom up (z_1's ``[B, ...]``, the
    upper layers' ``[1, B, ...]`` at one sample of the layer below); draws
    as ``encode_noise``."""
    config = model.config

    @torch.no_grad()
    def encode(params, generator: Optional[torch.Generator], x01: torch.Tensor,
               noise: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
        if noise is None:
            noise = draw_noise(encode_noise(config, x01.shape[0]), generator, x01.device)
        Qs = apply(model, params, x01, 1, method="encode", eps=list(noise))
        return tuple(q.dist.loc for q in Qs)

    return encode
