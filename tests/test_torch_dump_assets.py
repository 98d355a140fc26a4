"""``vae_mdl_tpu_torch/scripts/dump_assets.py`` against ``scripts/dump_assets.py``
(``cli/run.py`` ``_dump_assets``): from a port checkpoint of a few steps the
port writes the same three file names, each an image of the same size and
mode, as JAX's ``_dump_assets`` on the same weights converted to Flax.
Nothing numeric is compared: the grids draw their images and noise from each
package's own streams."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vae_mdl_tpu.cli.run import _dump_assets as jax_dump_assets
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.train.trainer import Trainer as JaxTrainer
from vae_mdl_tpu_torch.config import DataConfig
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.scripts import dump_assets
from vae_mdl_tpu_torch.train.trainer import Trainer
from vae_mdl_tpu_torch.utils.convert import params_to_flax

torch.set_num_threads(1)

NAMES = ["model01_inputs.png", "model01_recon.png", "model01_samples.png"]


def _config(module_experiment, data_cls, root):
    cfg = module_experiment("model01")
    return dataclasses.replace(
        cfg, data=data_cls(dataset="synthetic:mnist", batch_size=8, val_batch_size=16),
        train=dataclasses.replace(cfg.train, n_updates=3, eval_interval=2, snapshot_interval=0,
                                  checkpoint_dir=f"{root}/ckpt", log_dir=f"{root}/tb",
                                  resume=False))


def _images(directory):
    return {name: (Image.open(os.path.join(directory, name)).size,
                   Image.open(os.path.join(directory, name)).mode)
            for name in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port"))
    cfg = _config(experiment, DataConfig, root)
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    return root, cfg, trainer


def test_the_grids_match_jax_dump_assets(checkpoint, tmp_path, capsys):
    root, cfg, trainer = checkpoint
    dump_assets.run("model01", cfg.train.checkpoint_dir, "best", str(tmp_path / "port"),
                    device="cpu", cfg=cfg)
    assert "[assets] loaded 'best'" in capsys.readouterr().out
    mine = _images(tmp_path / "port")
    assert sorted(mine) == NAMES

    from vae_mdl_tpu.config import DataConfig as JaxDataConfig

    jcfg = _config(jax_experiment, JaxDataConfig, str(tmp_path / "jax"))
    jax_trainer = JaxTrainer(jcfg)
    trainer.ckpt.restore_weights(trainer.state, "best")
    params = params_to_flax(trainer.model.state_dict(), cfg.model)
    jax_trainer.state = jax_trainer.state.replace(
        params=jax.tree_util.tree_map(np.asarray, params))
    jax_dump_assets(jax_trainer, jcfg, out_dir=str(tmp_path / "jax_assets"))
    assert _images(tmp_path / "jax_assets") == mine


def test_the_entry_takes_the_cli_flags(checkpoint, tmp_path, monkeypatch):
    root, cfg, _ = checkpoint
    with pytest.raises(SystemExit, match="no 'nope' checkpoint"):
        dump_assets.run("model01", cfg.train.checkpoint_dir, "nope", str(tmp_path), device="cpu",
                        cfg=cfg)
    calls = []
    monkeypatch.setattr(dump_assets, "run", lambda *a: calls.append(a))
    dump_assets.main(["model05", "ck"])
    dump_assets.main(["model01", "ck", "--ckpt", "latest", "--out-dir", "grids",
                      "--device", "cpu"])
    assert calls == [("model05", "ck", "best", "./assets", None),
                     ("model01", "ck", "latest", "grids", "cpu")]
