"""Define, register and train a new model family in ~40 lines.

The port's twin of ``examples/custom_model.py``: a new family is one frozen
config plus ``register_model``, after which the whole surface works on it:
``experiment()``, ``Trainer`` (staircase learning rate, checkpoints,
resume, EMA, SIGTERM), the n-sample evaluator, sampling and the CLI
(``vae-mdl-tpu-torch train tiny_cifar_pmdl``).

It builds a small CIFAR-10 VAE with the per-pixel mixture observation model
(``pmdl``: per-pixel mixture weights instead of the MoDL's per-image
channel autoregression; no zoo entry uses it). Run on the card:

    python -m vae_mdl_tpu_torch.examples.custom_model

or on the CPU with ``main(device="cpu")``. Without CIFAR-10 files the data
layer falls back to shape-correct synthetic data (``DataConfig(strict=True)``
refuses that).
"""
from __future__ import annotations

import dataclasses

import torch

from vae_mdl_tpu_torch.config import DecoderConfig, EncoderConfig, ModelConfig, conv, deconv
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
from vae_mdl_tpu_torch.models.inference import make_sampler
from vae_mdl_tpu_torch.models.zoo import experiment, register_model
from vae_mdl_tpu_torch.train.trainer import Trainer

# 1. The new family: every architectural fact is config data. The decoder's
#    last layer emits n_mix * 10 channels, the float32 likelihood head.
N_MIX = 3
TINY_CIFAR_PMDL = ModelConfig(
    name="tiny_cifar_pmdl",
    image_shape=(32, 32, 3),
    n_latent=16,
    likelihood="pmdl",
    n_mix=N_MIX,
    encoder=EncoderConfig(kind="conv",
                          conv_layers=(conv(16, 3, 2, "gelu"), conv(32, 3, 2, "gelu"))),
    decoder=DecoderConfig(kind="conv", base_size=(8, 8, 32),
                          conv_layers=(deconv(16, 4, 2, "gelu"),
                                       deconv(N_MIX * 10, 4, 2, "none"))),
)

# 2. One call makes it a zoo entry, the CLI's included.
register_model(TINY_CIFAR_PMDL, dataset="cifar10", n_updates=300)


def main(workdir: str = "./tiny_cifar_pmdl", n_updates: int = 120, device=None):
    """Train, evaluate and sample at demo scale on ``device`` (default: the
    card; it raises where there is none)."""
    # 3. experiment() assembles the reference-style defaults;
    #    dataclasses.replace tweaks anything per run
    cfg = experiment("tiny_cifar_pmdl")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, batch_size=32, val_batch_size=64),
        train=dataclasses.replace(
            cfg.train, n_updates=n_updates, eval_interval=max(10, n_updates // 2),
            steps_per_call=10, checkpoint_dir=f"{workdir}/ckpt", log_dir=f"{workdir}/logs",
            resume=False, n_eval_samples=20),
    )
    trainer = Trainer(cfg, device=device)
    state = trainer.fit(progress=False)
    print(f"trained to step {state.step}, best val loss {state.best_val_loss:.2f}")

    # 4. the streaming importance-sampled evaluator at demo scale
    mean_llh, _, metrics = evaluate_llh(trainer.model, cfg, trainer.test_set[0][:64],
                                        n_samples=20, k_chunk=10, batch_size=32)
    print(f"20-IS test LLH {mean_llh:.2f} nats  bpd {metrics['bpd']:.4f}")

    # 5. ancestral samples from the prior, through the serving surface
    sampler = make_sampler(trainer.model, cfg.model)
    imgs = sampler(state.params, torch.Generator(device=trainer.device).manual_seed(0), 4)
    print(f"sampled {tuple(imgs.shape)} from the prior")
    return state, mean_llh


if __name__ == "__main__":
    main()
