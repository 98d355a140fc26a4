"""Cost of the eval loop's streaming extras: the PSIS k-hat tail and the
IS-convergence curve.

Port of ``scripts/khat_overhead.py``: model05's 5000-IS eval (bf16 body, the
MoDL kernel, batch 100, k-chunks of 100) without extras, with the top-M
log-weights of every chunk (``with_khat``), with the bound after every
chunk (``with_curve``) and with both; each timed once after a warm-up.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.khat_overhead``.
"""
from __future__ import annotations

from typing import Callable

from vae_mdl_tpu_torch.bench import eval_config
from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils.timing import (
    eval_batch,
    eval_rates,
    float32_convolutions,
    resolve_device,
    seeded_model,
)

VARIANTS = (("no extras", False, False), ("+khat tail", True, False),
            ("+k-curve", False, True), ("+both", True, True))


def eval_throughput(model, cfg, with_khat: bool, with_curve: bool = False,
                    batch_size: int = 100, k_chunk: int = 100, n_samples: int = 5000) -> float:
    batch = eval_batch(cfg, batch_size, next(model.parameters()).device)
    rates, _ = eval_rates(model, cfg, batch, n_samples, k_chunk, n_timed=1, discard=0,
                          with_khat=with_khat, with_curve=with_curve)
    return float(rates[0])


def run(device=None, say: Callable[[str], None] = print, **shape) -> dict:
    """imgs/s of each variant and its change against the first; ``shape``
    (``batch_size``, ``k_chunk``, ``n_samples``) overrides the defaults."""
    device = resolve_device(device)
    cfg = eval_config({})  # the bf16 body, the head's output as it comes
    model = seeded_model(cfg, device)
    out, launches = {}, {}
    for label, khat, curve in VARIANTS:
        kernel_structure.reset_counts()
        out[label] = rate = eval_throughput(model, cfg, khat, curve, **shape)
        launches[label] = kernel_structure.launched()
        base = out["no extras"]
        say(f"eval 5000-IS ({label}): {rate:.1f} imgs/s ({100 * (rate / base - 1):+.1f}%)")
    return {"imgs_per_sec": out, "launches": launches}


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
