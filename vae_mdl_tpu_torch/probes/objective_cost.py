"""The cost of the alternative training objectives on the card.

Port of ``scripts/objective_cost.py``: the multi step's throughput (batch
128, k = 5, 10 steps a call, the bench's harness) of model01 (the MLP family)
and model05 (the conv family) under the IWAE bound, DReG (``iwae_dreg``: two
forward passes with complementary halves detached and the posterior
re-evaluated), the ELBO, the ELBO with free bits and IWAE with a beta
warm-up.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.objective_cost``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.timing import float32_convolutions, resolve_device, train_rates

MODELS = ("model01", "model05")
VARIANTS = (
    ("iwae_dreg", dict(objective="iwae_dreg"), {}),
    ("elbo", dict(objective="elbo"), {}),
    ("elbo+free_bits", dict(objective="elbo", free_bits=0.25), {}),
    ("iwae+beta_warmup", {}, dict(beta_warmup_steps=10_000)),
)


def run(models=MODELS, device=None, say: Callable[[str], None] = print, **harness) -> dict:
    """{model: {"iwae": imgs/s, variant: imgs/s, ...}} and the launches;
    ``harness`` (``spc``, ``n_iters``, ``n_repeats``, ``data_over``) goes to
    ``train_rates``."""
    device = resolve_device(device)
    out, launches = {}, {}
    kernel_structure.reset_counts()
    for name in models:
        rates, _, _ = train_rates(name, device=device, **harness)
        base = float(np.median(rates))
        out[name] = {"iwae": base}
        say(f"{name} iwae baseline: {base:.0f} imgs/s")
        for label, m_over, t_over in VARIANTS:
            rates, _, _ = train_rates(name, device=device, model_over=m_over, train_over=t_over,
                                      **harness)
            out[name][label] = t = float(np.median(rates))
            say(f"{name} {label}: {t:.0f} imgs/s ({100 * (t / base - 1):+.1f}%)")
    launches = kernel_structure.launched()
    return {"imgs_per_sec": out, "launches": launches}


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
