"""Decoder networks: observation model p(x | z) with its likelihood head.

Port of ``resolve_use_pallas``, ``make_observation``, ``head_channels`` and
``ConvDecoder`` (with ``pre_specs`` and the GLU stack) from
``vae_mdl_tpu/nn/decoders.py``, for the "mdl" head (model05) and the "dl" head
(model03, model04, model06). The Bernoulli, Gaussian and "pmdl" heads and
the MLP decoder come with model01 and model02.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vae_mdl_tpu_torch.distributions import DiscretizedLogistic, MixtureDiscretizedLogistic
from vae_mdl_tpu_torch.nn.blocks import DTYPES, Dense, _activation, merge_leading
from vae_mdl_tpu_torch.nn.encoders import (
    ConvSpec,
    apply_conv_spec,
    apply_conv_stack,
    conv_stack,
    glu_stack,
)

Obs = Union[DiscretizedLogistic, MixtureDiscretizedLogistic]

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
    if likelihood == "dl":
        # the two halves of the head's channels, as views of its output
        mu, logstd = torch.chunk(out, 2, dim=-1)
        if bound_logstd:
            logstd = torch.tanh(logstd)
        return DiscretizedLogistic(mu, logstd, low=0.0, high=1.0, levels=256.0,
                                   event_axes=_IMAGE_AXES, use_pallas=use_pallas)
    if likelihood == "mdl":
        if io_dtype is not None:
            out = out.to(DTYPES[io_dtype])
        return MixtureDiscretizedLogistic(out, event_axes=_IMAGE_AXES, use_pallas=use_pallas)
    raise NotImplementedError(
        f"likelihood {likelihood!r} is not ported yet (ROADMAP.md Queue 1)")


def head_channels(likelihood: str, out_channels: int, n_mix: int) -> int:
    return {
        "bernoulli": out_channels,
        "gaussian": 2 * out_channels,
        "dl": 2 * out_channels,
        "mdl": n_mix * 10,
        "pmdl": n_mix * 10,
    }[likelihood]


class ConvDecoder(nn.Module):
    """Dense -> reshape to the base grid -> (convs + GLU stack) -> transposed
    convs -> head.

    The dense output is read as NHWC ``base_size``, the layout of the Flax
    ``Dense_0`` kernel's columns. The last conv spec is the likelihood head
    (the zoo folds it into ``conv_layers``; in model04 it is a transposed
    conv): the body runs at the compute dtype and the head in float32. The
    head's NCHW output is handed on as an ``[..., H, W, C]`` view, with no
    copy; the likelihood kernels read it through its strides.
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
                 glu_features: int = 64, glu_activation: str = "relu"):
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
        self.convs = conv_stack(conv_specs, features, self, generator=generator)
        n_head = head_channels(likelihood, out_shape[-1], n_mix)
        if not conv_specs or conv_specs[-1].features != n_head:
            raise NotImplementedError(
                "a separate 'head' conv after the stack is not ported yet; "
                "the zoo folds the head into conv_layers")

    def forward(self, z: torch.Tensor) -> Obs:
        h = self.act(self.Dense_0(z, self.dtype))
        merged, unmerge = merge_leading(h.reshape(tuple(z.shape[:-1]) + self.base_size))
        out = apply_conv_stack(self.pre, merged.permute(0, 3, 1, 2), self.dtype)
        for block in self.glus:
            out = block(out)
        out = apply_conv_stack(self.convs[:-1], out, self.dtype)
        out = apply_conv_spec(self.convs[-1], out.float(), torch.float32)
        return make_observation(unmerge(out.permute(0, 2, 3, 1)), self.likelihood,
                                self.bound_logstd, self.use_pallas,
                                self.likelihood_io_dtype)
