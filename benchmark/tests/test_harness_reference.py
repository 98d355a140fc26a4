"""The plain references against the program's CPU path, through whole
harness runs at a small batch: the same weights, images and noise (the
program's streams re-derived by the reference), so a float32 body agrees to
rounding; the configured bfloat16 body of the ladder stays within the cell's
limits."""
from __future__ import annotations

import pytest

from conftest import drive_cpu, small_cell


@pytest.mark.parametrize("name", ["model05-f32-train", "biladder_celeba-bf16-train"])
def test_train_steps_agree_with_the_reference_in_float32(name, tmp_path):
    cell = small_cell(name)
    cell.config["model"]["compute_dtype"] = "float32"
    out = drive_cpu(cell, tmp_path)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    # the softmax weights of log-weights near -2e4 (model05's sharp head:
    # -4e4) carry float32's rounding of the log-weights into the loss of the
    # later steps and into every gradient leaf; 4 images average little of it
    assert checks["loss_gap"] < 2e-5, checks
    assert checks["grad_gap"] < 2e-3 and checks["change_gap"] < 2e-2, checks
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_eval_bounds_agree_with_the_reference_in_float32(tmp_path):
    cell = small_cell("model05-f32-eval5000")
    cell.config["model"]["compute_dtype"] = "float32"
    out = drive_cpu(cell, tmp_path)
    assert out["correct"]
    assert out["checks"]["llh_gap"]["value"] < 1e-6
    assert out["attempted"] % cell.mix["batch_size"] == 0 and out["failed"] == 0


def test_the_ladder_as_configured_passes_its_limits(tmp_path):
    out = drive_cpu(small_cell("biladder_celeba-bf16-train"), tmp_path)
    assert out["correct"], out["checks"]
    assert out["checks"]["loss_gap"]["value"] > 0  # bfloat16 against float32


def test_a_run_reports_its_cells_metrics(tmp_path):
    cell = small_cell("model05-f32-eval5000")
    out = drive_cpu(cell, tmp_path)
    assert set(out["metrics"]) == {"eval_imgs_per_s", "setup_s"}  # no memory on the CPU
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] == 1
