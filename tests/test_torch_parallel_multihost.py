"""Several processes through the port's user-facing paths (tests/test_multihost.py
on the port): two gloo ranks through ``Trainer(cfg, mesh=...)`` (data
parallel, tensor parallel, a device-resident dataset) and ``evaluate_llh``
striped over them, then the CLI started as users start it, under
``torchrun``.

Tolerance: none. The ranks report the same losses, the same best
validation loss and the same parameters; the striped evaluation's
per-image LLH is bit-equal to one process's on the same weights (each
batch's generator is seeded from its index, and the ranks' results meet in
disjoint slots).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
from vae_mdl_tpu_torch.models.vae import build_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    work = tmp_path_factory.mktemp("multihost")
    return W.spawn("trainer_suite", 2, work / "ranks", {"workdir": str(work)})


@pytest.mark.parametrize("name", ["dp", "tp"])
def test_two_process_trainer(two, name):
    a, b = two
    assert a[f"{name}/step"] == b[f"{name}/step"] == 4
    assert a[f"{name}/losses"] == b[f"{name}/losses"]
    assert all(np.isfinite(a[f"{name}/losses"]))
    assert a[f"{name}/best"] == b[f"{name}/best"] and np.isfinite(a[f"{name}/best"])
    for n, p in a[f"{name}/params"].items():
        assert torch.equal(p, b[f"{name}/params"][n]), n
    if name == "tp":  # the tiny MLP's hidden layers, its heads whole
        assert a["tp/sharded"] == sorted(
            f"{part}.{layer}.{kind}" for part, layer in (
                ("encoder", "MLPBlock_0.Dense_0"), ("encoder", "MLPBlock_0.Dense_1"),
                ("decoder", "Dense_0"), ("decoder", "Dense_1"))
            for kind in ("weight", "bias"))


@pytest.mark.parametrize("name", ["dp", "tp"])
def test_striped_eval_is_bit_equal_to_one_process(two, name):
    """88 images in batches of 16: six batches, three on each rank (batch i
    on rank i mod 2; the tensor-parallel ranks share every batch)."""
    a, b = two
    mean, per_image, metrics = a[f"{name}/eval"]
    assert b[f"{name}/eval"][0] == mean
    assert np.array_equal(b[f"{name}/eval"][1], per_image)
    local = (a[f"{name}/eval"][2]["local_batches"], b[f"{name}/eval"][2]["local_batches"])
    assert local == ((3, 3) if name == "dp" else (6, 6))
    if name == "dp":
        cfg = W.experiment_of(W.tiny_mlp(), batch_size=16)
        model = build_model(cfg.model, device="cpu")
        from vae_mdl_tpu_torch.data.sources import load_dataset

        images = np.asarray(load_dataset("synthetic:mnist")["test"][0][:88])
        want_mean, want, want_metrics = evaluate_llh(
            model, cfg, images, n_samples=8, k_chunk=4, batch_size=16, k_curve=True,
            params=a["dp/params"])
        assert np.array_equal(per_image, want) and mean == want_mean
        # each batch's curve sums in its own slot, added in batch order
        assert np.array_equal(metrics["k_curve_llh"], want_metrics["k_curve_llh"])
        assert want_metrics["local_batches"] == 6


def test_striped_eval_of_a_padded_tail(two):
    a, b = two
    for out in (a, b):
        mean, per_image, metrics = out["dp/small_eval"]
        assert per_image.shape == (13,) and np.isfinite(per_image).all()
        assert metrics["batches"] == 2 and metrics["khat_per_image"].shape == (13,)
    assert sorted((a["dp/small_eval"][2]["local_batches"],
                   b["dp/small_eval"][2]["local_batches"])) == [1, 1]
    assert np.array_equal(a["dp/small_eval"][1], b["dp/small_eval"][1])


def test_device_dataset_under_the_mesh(two):
    a, b = two
    assert a["device/step"] == b["device/step"] == 4
    for n, p in a["device/params"].items():
        assert torch.equal(p, b["device/params"][n])


def test_cli_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc-per-node 2 -m vae_mdl_tpu_torch train model01
    --device cpu --mesh 2``: trains on two ranks, checkpoints once, and its
    final (striped) evaluation prints the LLH that one process's ``eval``
    of the same checkpoint prints, digit for digit."""
    common = ["model01", "--device", "cpu", "--dataset", "synthetic:mnist",
              "--batch-size", "8", "--checkpoint-dir", str(tmp_path / "ckpt"),
              "--log-dir", str(tmp_path / "tb"), "--n-samples", "4"]
    env = {k: v for k, v in os.environ.items() if k not in W._DROP}
    env.update(PYTHONPATH=W.REPO, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "vae_mdl_tpu_torch", "train", *common, "--n-updates", "4",
         "--eval-interval", "2", "--mesh", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    train_llh = re.findall(r"\(llh (-?[0-9.e+-]+)\)", run.stdout)
    assert len(train_llh) == 1, run.stdout  # rank 0 alone prints
    assert os.path.isdir(tmp_path / "ckpt" / "model01" / "best")
    out = subprocess.run([sys.executable, "-m", "vae_mdl_tpu_torch.cli.run", "eval", *common,
                          "--ckpt", "best"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert re.findall(r"\(llh (-?[0-9.e+-]+)\)", out.stdout) == train_llh
