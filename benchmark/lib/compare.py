"""The numbers that decide ``correct``, each against its limit.

Training (the first steps of the object the window trains): each step's
loss, the first gradient's norm and the parameters' change after the steps,
the latter two by the worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger. Leaves whose first gradient in the reference is under a
thousandth of the median leaf's move by round-off alone and are left out of
the change. Evaluation: the per-image bound's gap, relative to the
reference's.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Sequence, Tuple

import torch

Check = Tuple[str, float, float]  # (name, value, limit)


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tree.items()}


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               keep: Sequence[str]) -> float:
    floor = median(reference[k] for k in keep)
    return max(abs(program[k] - reference[k]) / max(reference[k], floor) for k in keep)


def moved(first_grads: Dict[str, float]) -> List[str]:
    """The leaves whose first gradient reaches a thousandth of the median
    leaf's."""
    floor = 1e-3 * median(first_grads.values())
    return [k for k, v in first_grads.items() if v >= floor]


def train_numbers(prog_losses, ref_losses, prog_grads, ref_grads, prog_change,
                  ref_change) -> Dict[str, float]:
    """``{loss_gap, grad_gap, change_gap}``: the norms are ``{leaf: norm}``."""
    if len(prog_losses) != len(ref_losses) or not all(map(math.isfinite, prog_losses)):
        loss = math.inf
    else:
        loss = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(prog_grads, ref_grads, list(ref_grads)),
            "change_gap": worst_leaf(prog_change, ref_change, moved(ref_grads))}


def eval_numbers(prog_llh: torch.Tensor, ref_llh: torch.Tensor) -> Dict[str, float]:
    prog, ref = prog_llh.double().cpu(), ref_llh.double().cpu()
    gap = ((prog - ref).abs() / ref.abs()).max()
    return {"llh_gap": float(gap) if bool(torch.isfinite(prog).all()) else math.inf}


def against(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    return [(name, float(numbers[name]), float(limits[name])) for name in limits]


def passed(checks: List[Check]) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= limit for _, v, limit in checks)
