"""Write the three protocol grids (inputs, reconstructions, samples) from a
checkpoint.

Port of ``scripts/dump_assets.py``: ``train`` writes the grids after its
final reload of the best weights (``cli/run.py`` ``_dump_assets``); this
entry writes them again for a run whose training is over, without training.

    python -m vae_mdl_tpu_torch.scripts.dump_assets MODEL CKPT_DIR \
        [--ckpt best] [--out-dir ./assets] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses

from vae_mdl_tpu_torch.cli.run import _dump_assets
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.trainer import Trainer
from vae_mdl_tpu_torch.utils.timing import resolve_device


def run(model: str, checkpoint_dir: str, ckpt: str = "best", out_dir: str = "./assets",
        device=None, cfg=None) -> None:
    """The grids of ``ckpt`` in ``checkpoint_dir`` into ``out_dir`` as
    ``<model>_{inputs,recon,samples}.png``; ``cfg`` in place of the zoo's
    experiment (its ``checkpoint_dir`` is set here)."""
    device = resolve_device(device)
    cfg = cfg or experiment(model)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=checkpoint_dir, resume=False))
    trainer = Trainer(cfg, device=device)
    if not trainer.ckpt.has(ckpt):
        raise SystemExit(f"no '{ckpt}' checkpoint in {checkpoint_dir}")
    trainer.ckpt.restore_weights(trainer.state, ckpt)
    print(f"[assets] loaded '{ckpt}' at step {trainer.state.step}")
    _dump_assets(trainer, cfg, out_dir=out_dir)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model")
    p.add_argument("checkpoint_dir")
    p.add_argument("--ckpt", default="best")
    p.add_argument("--out-dir", default="./assets")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(args.model, args.checkpoint_dir, args.ckpt, args.out_dir, args.device)


if __name__ == "__main__":
    main()
