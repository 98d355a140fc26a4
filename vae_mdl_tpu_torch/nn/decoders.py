"""Decoder networks: observation model p(x | z) with its likelihood head.

Port of ``resolve_use_pallas``, ``make_observation``, ``head_channels``,
``MLPDecoder``, ``ConvDecoder`` (with ``pre_specs``, the GLU stack and the
standalone ``head`` conv) and ``ladder_observation`` (the ladder families'
observation decode) from ``vae_mdl_tpu/nn/decoders.py``. Likelihood
heads: "bernoulli" (model01), "gaussian" (model02), "dl" (model03, model04,
model06), "mdl" (model05) and "pmdl". All heads emit float32 parameters; the
body may run in bf16.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vae_mdl_tpu_torch.distributions import (
    Bernoulli,
    DiscretizedLogistic,
    DistributionTuple,
    MixtureDiscretizedLogistic,
    Normal,
    PixelMixtureDiscretizedLogistic,
)
from vae_mdl_tpu_torch.nn.blocks import (
    DTYPES,
    Dense,
    SameConv,
    _activation,
    merge_leading,
    on_merged,
)
from vae_mdl_tpu_torch.nn.encoders import (
    ConvSpec,
    apply_conv_spec,
    apply_conv_stack,
    conv_stack,
    glu_stack,
)

Obs = Union[Bernoulli, Normal, DiscretizedLogistic, MixtureDiscretizedLogistic,
            PixelMixtureDiscretizedLogistic]

_IMAGE_AXES = (-1, -2, -3)
_KERNEL_LIKELIHOODS = ("mdl", "dl")


def resolve_use_pallas(use_pallas: Optional[bool], likelihood: str,
                       operand: Optional[torch.Tensor] = None) -> bool:
    """``None`` = auto: the likelihood's CUDA kernel ("mdl", "dl") when the
    operand lies on a CUDA device, the plain version otherwise.
    ``True``/``False`` force; ``True`` on a CPU tensor raises where the
    likelihood is evaluated."""
    if use_pallas is not None:
        return use_pallas
    return likelihood in _KERNEL_LIKELIHOODS and operand is not None and operand.is_cuda


def make_observation(out: torch.Tensor, likelihood: str, bound_logstd: bool = False,
                     use_pallas: Optional[bool] = None,
                     io_dtype: Optional[str] = None) -> Obs:
    """Turn raw head output ``[..., H, W, C]`` into the observation
    distribution. ``io_dtype`` casts the head -> likelihood boundary tensor
    (mdl only); the likelihood math stays float32 either way."""
    use_pallas = resolve_use_pallas(use_pallas, likelihood, operand=out)
    out = out.float()
    if likelihood == "bernoulli":
        return Bernoulli(out, event_axes=_IMAGE_AXES)
    if likelihood == "gaussian":
        mu, logstd = torch.chunk(out, 2, dim=-1)
        if bound_logstd:
            logstd = torch.tanh(logstd)
        return Normal(mu, torch.exp(logstd), event_axes=_IMAGE_AXES)
    if likelihood == "dl":
        # the two halves of the head's channels, as views of its output; the
        # head goes along where they are its halves, so that the kernel
        # differentiates it in one piece
        mu, logstd = torch.chunk(out, 2, dim=-1)
        if bound_logstd:
            logstd = torch.tanh(logstd)
        return DiscretizedLogistic(mu, logstd, low=0.0, high=1.0, levels=256.0,
                                   event_axes=_IMAGE_AXES, use_pallas=use_pallas,
                                   head=None if bound_logstd else out)
    if likelihood == "mdl":
        if io_dtype is not None:
            out = out.to(DTYPES[io_dtype])
        return MixtureDiscretizedLogistic(out, event_axes=_IMAGE_AXES, use_pallas=use_pallas)
    if likelihood == "pmdl":
        # log_prob is per pixel, without a channel axis: event axes (-1, -2)
        return PixelMixtureDiscretizedLogistic(out, event_axes=(-1, -2))
    raise ValueError(f"unknown likelihood {likelihood!r}")


def ladder_observation(module: nn.Module, z1: torch.Tensor) -> DistributionTuple:
    """The observation decode of both ladder families: ``module.obs_up``
    upsamples z_1 ``[..., h, w, c]`` to the image's resolution, the float32
    head ``module.obs_head`` gives the likelihood's parameters, and
    ``make_observation`` turns them into p(x | z_1). It attaches no x sample:
    the ladders' ``decode`` does that where asked. The head's output reaches the likelihood as a
    ``[..., H, W, C]`` view of its NCHW result, channels-last memory on a
    card: for "dl" the two halves of one dense channel-minor tensor, which is
    what the kernels' tile path takes."""
    cfg = module.config
    out = on_merged(lambda h: module.obs_head(module.obs_up.forward_nchw(h).float(),
                                              torch.float32), z1)
    pxz = make_observation(out, cfg.likelihood, cfg.bound_logstd, cfg.use_pallas,
                           getattr(cfg, "likelihood_io_dtype", None))
    return DistributionTuple(pxz, None, axes=pxz.event_axes)


def head_channels(likelihood: str, out_channels: int, n_mix: int) -> int:
    return {
        "bernoulli": out_channels,
        "gaussian": 2 * out_channels,
        "dl": 2 * out_channels,
        "mdl": n_mix * 10,
        "pmdl": n_mix * 10,
    }[likelihood]


class MLPDecoder(nn.Module):
    """Dense stack -> reshape to the image -> likelihood head (Bernoulli by
    default). ``Dense_0`` and ``Dense_1`` run at the compute dtype, the
    output layer ``out`` in float32; its bias is what
    ``train.state.init_output_bias`` sets."""

    def __init__(self, n_latent: int, out_shape: Tuple[int, int, int] = (28, 28, 1),
                 n_hidden: int = 200, activation: str = "tanh",
                 likelihood: str = "bernoulli", n_mix: int = 5, bound_logstd: bool = False,
                 use_pallas: Optional[bool] = None,
                 likelihood_io_dtype: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = out_shape
        self.image = (h, w, head_channels(likelihood, c, n_mix))
        self.likelihood = likelihood
        self.bound_logstd = bound_logstd
        self.use_pallas = use_pallas
        self.likelihood_io_dtype = likelihood_io_dtype
        self.dtype = dtype
        self.act = _activation(activation)
        self.Dense_0 = Dense(n_latent, n_hidden, generator)
        self.Dense_1 = Dense(n_hidden, n_hidden, generator)
        self.out = Dense(n_hidden, math.prod(self.image), generator)

    def forward(self, z: torch.Tensor) -> Obs:
        h = self.act(self.Dense_0(z, self.dtype))
        h = self.act(self.Dense_1(h, self.dtype))
        out = self.out(h.float()).reshape(tuple(z.shape[:-1]) + self.image)
        return make_observation(out, self.likelihood, self.bound_logstd, self.use_pallas,
                                self.likelihood_io_dtype)


class ConvDecoder(nn.Module):
    """Dense -> reshape to the base grid -> (convs + GLU stack) -> transposed
    convs -> head.

    The dense output is read as NHWC ``base_size``, the layout of the Flax
    ``Dense_0`` kernel's columns. Where the last conv spec has the
    likelihood's channels it is the head (the zoo folds it into
    ``conv_layers``; in model04 it is a transposed conv): the body runs at
    the compute dtype and that layer in float32. Otherwise the whole stack
    runs at the compute dtype and a standalone 3x3 SAME conv ``head`` follows
    in float32 (model05 with ``likelihood="dl"``: 50 channels, then a head of
    6). ``head_pad`` makes the head layer emit ``max(n_head, head_pad)``
    channels (model05's ``conv_3`` 64 for 50), sliced back to ``n_head``
    before the likelihood, as the JAX decoder does. The head's
    ``[N, C, H, W]`` output is handed on as an
    ``[..., H, W, C]`` view, with no copy; the likelihood kernels read it
    through its strides. On a card that memory is channels-last: the NHWC
    grid viewed as NCHW is a channels-last tensor, and cuDNN keeps a
    channels-last input's format through the stack, so the view is
    NHWC-contiguous there.
    """

    def __init__(self, conv_specs: Sequence[ConvSpec], n_latent: int,
                 base_size: Tuple[int, int, int] = (4, 4, 128),
                 out_shape: Tuple[int, int, int] = (32, 32, 3),
                 fc_activation: str = "relu", likelihood: str = "mdl", n_mix: int = 5,
                 bound_logstd: bool = False, use_pallas: Optional[bool] = None,
                 likelihood_io_dtype: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 pre_specs: Sequence[ConvSpec] = (), n_glu: int = 0,
                 glu_features: int = 64, glu_activation: str = "relu", head_pad: int = 0):
        super().__init__()
        self.base_size = tuple(base_size)
        self.likelihood = likelihood
        self.bound_logstd = bound_logstd
        self.use_pallas = use_pallas
        self.likelihood_io_dtype = likelihood_io_dtype
        self.dtype = dtype
        self.act = _activation(fc_activation)
        self.Dense_0 = Dense(n_latent, math.prod(base_size), generator)
        features = base_size[-1]
        self.pre = conv_stack(pre_specs, features, self, prefix="pre", generator=generator)
        if pre_specs:
            features = pre_specs[-1].features
        self.glus = glu_stack(n_glu, features, glu_features, glu_activation, dtype, self,
                              generator)
        if n_glu:
            features = glu_features
        n_head = head_channels(likelihood, out_shape[-1], n_mix)
        self.n_head = n_head
        # head_pad: the head emits max(n_head, head_pad) channels, sliced back
        # to n_head (the padded ones get no gradient)
        n_emit = max(n_head, head_pad)
        self.folded_head = bool(conv_specs) and conv_specs[-1].features == n_head
        if self.folded_head and n_emit != n_head:
            conv_specs = tuple(conv_specs[:-1]) + (
                dataclasses.replace(conv_specs[-1], features=n_emit),)
        self.convs = conv_stack(conv_specs, features, self, generator=generator)
        if not self.folded_head:
            if conv_specs:
                features = conv_specs[-1].features
            self.head = SameConv(features, n_emit, generator)

    def forward(self, z: torch.Tensor) -> Obs:
        h = self.act(self.Dense_0(z, self.dtype))
        merged, unmerge = merge_leading(h.reshape(tuple(z.shape[:-1]) + self.base_size))
        out = apply_conv_stack(self.pre, merged.permute(0, 3, 1, 2), self.dtype)
        for block in self.glus:
            out = block(out)
        if self.folded_head:
            out = apply_conv_stack(self.convs[:-1], out, self.dtype)
            out = apply_conv_spec(self.convs[-1], out.float(), torch.float32)
        else:
            out = self.head(apply_conv_stack(self.convs, out, self.dtype).float(), torch.float32)
        if out.shape[1] != self.n_head:
            # a padded head's slice is a view with the head's strides: not
            # dense, so the likelihood kernels take their direct path on it
            out = out[:, :self.n_head]
        return make_observation(unmerge(out.permute(0, 2, 3, 1)), self.likelihood,
                                self.bound_logstd, self.use_pallas,
                                self.likelihood_io_dtype)
