"""Learning-rate schedules, as functions of the count of updates already
applied (0 at the first update).

Port of ``vae_mdl_tpu/train/schedule.py``. Each schedule takes the count as
an int or an integer tensor and returns a float32 tensor on the count's
device, computed in float32 as the JAX package computes it; a count on the
card gives a rate on the card, with no copy to or from the host.

The staircase (the reference's, in every model file): at step
``2^i * base`` (i < levels) the rate becomes
``base_lr * 10^(-step / (2^(levels-1) * base))``, so it ends one decade
below ``base_lr``.
"""
from __future__ import annotations

import torch


def _count(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def staircase_schedule(base_lr: float = 1e-3, base: int = 7000, levels: int = 8):
    denom = float(2 ** (levels - 1) * base)

    def schedule(step) -> torch.Tensor:
        step = _count(step)
        milestones = base * torch.pow(2.0, torch.arange(levels, device=step.device,
                                                        dtype=torch.float32))
        # the largest milestone passed (0 before the first)
        passed = torch.where(milestones <= step, milestones, 0.0).amax()
        return base_lr * torch.pow(10.0, -passed / denom)

    return schedule


def constant_schedule(base_lr: float = 1e-3):
    def schedule(step) -> torch.Tensor:
        return torch.full((), base_lr, dtype=torch.float32, device=_count(step).device)

    return schedule


def with_warmup(schedule, warmup_steps: int):
    """Linear warmup 0 -> ``schedule(step)`` over the first ``warmup_steps``
    updates; the base schedule unchanged afterwards."""
    if warmup_steps <= 0:
        return schedule

    def warmed(step) -> torch.Tensor:
        step = _count(step)
        scale = torch.clamp_max((step + 1.0) / float(warmup_steps), 1.0)
        return scale * schedule(step)

    return warmed
