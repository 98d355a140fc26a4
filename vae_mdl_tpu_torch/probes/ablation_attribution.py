"""Differential attribution of model05's float32 parity train step.

Port of ``scripts/ablation_attribution.py``: the same method as
``probes/prod_attribution.py`` on the float32 config (the reference's),
steps that differ by one component:

  full        the model05 step (the MoDL kernel pair)
  jnp_modl    the plain PyTorch likelihood (``use_pallas=False``)
  dl_head     a discretized-logistic head: model05's decoder keeps its
              50-channel conv and adds a 6-channel head conv, so the
              difference is the mixture's math, forward and backward
  k1          one importance sample instead of 5
  fwd_only    the forward pass and the bound only (``fwd_only_step``)
  fwd_only_dl the same with the DL head: (fwd_only - fwd_only_dl) is the
              mixture's forward, the rest of (full - dl_head) its backward

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.ablation_attribution``.
"""
from __future__ import annotations

import json
from typing import Callable, Optional

from vae_mdl_tpu_torch.probes.prod_attribution import time_variants
from vae_mdl_tpu_torch.utils.timing import float32_convolutions, resolve_device

SPC = 10
VARIANTS = (
    ("full", {}),
    ("jnp_modl", dict(model_over={"use_pallas": False})),
    ("dl_head", dict(model_over={"likelihood": "dl"})),
    ("k1", dict(model_over={"n_samples": 1})),
    ("fwd_only", dict(fwd_only=True)),
    ("fwd_only_dl", dict(model_over={"likelihood": "dl"}, fwd_only=True)),
)


def run(spc: int = SPC, n_iters: int = 5, n_repeats: int = 4, device=None,
        data_over: Optional[dict] = None, say: Callable[[str], None] = print) -> dict:
    device = resolve_device(device)
    out, launches, cfg = time_variants(VARIANTS, "float32", spc, n_iters, n_repeats, device,
                                       data_over, say)
    full = out["full"]
    mixture = full - out["dl_head"]
    mixture_fwd = out["fwd_only"] - out["fwd_only_dl"]
    out["attribution"] = {
        "modl_kernel_vs_plain_gain_ms": round(out["jnp_modl"] - full, 3),
        "mixture_math_ms": round(mixture, 3),
        "mixture_fwd_ms": round(mixture_fwd, 3),
        "mixture_bwd_ms": round(mixture - mixture_fwd, 3),
        "k_scaling_4x_samples_ms": round(full - out["k1"], 3),
        "backward_plus_adam_ms": round(full - out["fwd_only"], 3),
        "imgs_per_sec_full": round(cfg.data.batch_size / full * 1e3, 1),
    }
    out["launches"] = launches
    say(json.dumps(out))
    return out


def main() -> None:
    float32_convolutions()
    run()


if __name__ == "__main__":
    main()
