"""On-device preprocessing: batches reach the device as uint8 and the train
step dequantises, binarises and flips them there.

Port of ``vae_mdl_tpu/data/preprocess.py``. Randomness comes from an
explicit ``torch.Generator`` on the batch's device.
"""
from __future__ import annotations

import torch


def dequantize(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]."""
    return x_uint8.float() / 255.0


def binarize(generator: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """Dynamic binarisation: one Bernoulli draw per pixel."""
    return (torch.rand(probs.shape, generator=generator, device=probs.device)
            < probs).float()


def random_flip(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Flip each image of ``[B, H, W, C]`` horizontally with probability 1/2."""
    flip = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                      device=x.device) < 0.5
    return torch.where(flip, torch.flip(x, dims=(-2,)), x)
