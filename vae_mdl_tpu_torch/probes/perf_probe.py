"""Train-step and eval throughput across variants.

Port of ``scripts/perf_probe.py``: the single train step
(``make_train_step``, batch 128, 3 warm-up steps, then 50 timed) of model05
and model01 with the float32 or bf16 body and the plain likelihood
(``use_pallas=False``) or the kernel (``use_pallas`` None: the kernel for
the card's tensors), each forced by config as the JAX script forces it; and
the 5000-IS eval (float32, 3 timed calls after a warm-up) of model01
(k-chunks of 500, batch 100, dynamically binarised) and of model05
(k-chunks of 100, batch 25) through the plain version and the kernel.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.perf_probe``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step
from vae_mdl_tpu_torch.utils.timing import (
    eval_batch,
    eval_rates,
    float32_convolutions,
    resolve_device,
    scanned_config,
    seconds_of,
    seeded_model,
)

# (name, bf16 body, the kernel)
TRAIN = (("model05", False, False), ("model05", True, False), ("model05", False, True),
         ("model05", True, True), ("model01", False, False), ("model01", True, False))
# (name, n_samples, k_chunk, batch, the kernel)
EVALS = (("model01", 5000, 500, 100, False), ("model05", 5000, 100, 25, False),
         ("model05", 5000, 100, 25, True))


def _config(name: str, bf16: bool, pallas: bool, **data):
    cfg = scanned_config(name, compute_dtype="bfloat16" if bf16 else None,
                         model_over={"use_pallas": None if pallas else False})
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset="synthetic:svhn_cropped", **data))


def bench_train(name: str, bf16: bool = False, pallas: bool = False, batch: int = 128,
                steps: int = 50, device=None) -> float:
    cfg = _config(name, bf16, pallas)
    model = seeded_model(cfg, device)
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    x = eval_batch(cfg, batch, next(model.parameters()).device)
    for _ in range(3):
        state, m = step(state, x)
    float(m["loss"])

    def timed():
        nonlocal state
        for _ in range(steps):
            state, _ = step(state, x)

    return steps * batch / seconds_of(timed, x.is_cuda)


def bench_eval(name: str, pallas: bool = False, n_samples: int = 5000, k_chunk: int = 250,
               batch: int = 50, reps: int = 3, device=None) -> float:
    cfg = _config(name, False, pallas, dynamic_binarization=(name == "model01"))
    model = seeded_model(cfg, device)
    xb = eval_batch(cfg, batch, next(model.parameters()).device)
    rates, _ = eval_rates(model, cfg, xb, n_samples, k_chunk, n_timed=reps, discard=0)
    return float(np.median(rates))


def run(train=TRAIN, evals=EVALS, device=None, say: Callable[[str], None] = print,
        steps: int = 50, batch: int = 128, eval_over: dict = None) -> dict:
    """imgs/s of each train and eval variant, and each one's launches;
    ``eval_over`` (``n_samples``, ``k_chunk``, ``batch``) replaces the
    evals' own."""
    device = resolve_device(device)
    out, launches = {}, {}
    for name, bf16, pallas in train:
        kernel_structure.reset_counts()
        tag = f"{name} train bf16={int(bf16)} pallas={int(pallas)}"
        out[tag] = ips = bench_train(name, bf16=bf16, pallas=pallas, batch=batch, steps=steps,
                                     device=device)
        launches[tag] = kernel_structure.launched()
        say(f"{tag:45s} {ips:10.0f} imgs/s   ({1000 * batch / ips:.2f} ms/step)")
    for name, n_samples, k_chunk, bs, pallas in evals:
        shape = dict(dict(n_samples=n_samples, k_chunk=k_chunk, batch=bs), **(eval_over or {}))
        kernel_structure.reset_counts()
        tag = f"{name} {shape['n_samples']}-IS eval pallas={int(pallas)} kc={shape['k_chunk']}"
        out[tag] = ips = bench_eval(name, pallas=pallas, device=device, **shape)
        launches[tag] = kernel_structure.launched()
        say(f"{tag:45s} {ips:10.2f} imgs/s   (10k imgs in {10000 / ips / 60:.1f} min)")
    return {"imgs_per_sec": out, "launches": launches}


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
