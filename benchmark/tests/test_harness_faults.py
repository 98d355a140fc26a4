"""A run with the timed path broken underneath reads ``correct`` false: the
harness is driven whole on the CPU (its look for a card skipped), with each
fault the cell can have planted in the program. One card has no exchange
between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from conftest import drive_cpu, small_cell


def _broken_train_step(monkeypatch, fault: str):
    import vae_mdl_tpu_torch.train.trainer as trainer_module

    real_factory = trainer_module.make_train_step

    def factory(model, cfg, tx):
        step = real_factory(model, cfg, tx)

        def broken(state, batch):
            if fault == "half":
                return step(state, batch[: batch.shape[0] // 2])
            saved = {k: v.detach().clone() for k, v in state.params.items()}
            opt = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone())
                   for k, v in state.opt_state.items()}
            state, metrics = step(state, batch)
            with torch.no_grad():  # the update thrown away: the state as it came in
                for k, v in state.params.items():
                    v.copy_(saved[k])
            state.opt_state = opt
            return state, metrics

        return broken

    monkeypatch.setattr(trainer_module, "make_train_step", factory)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("name", ["model05-f32-train", "biladder_celeba-bf16-train"])
def test_a_broken_train_step_reads_incorrect(name, fault, monkeypatch, tmp_path):
    _broken_train_step(monkeypatch, fault)
    out = drive_cpu(small_cell(name), tmp_path)
    assert not out["correct"], out["checks"]


def _broken_evaluator(monkeypatch, fault: str):
    import vae_mdl_tpu_torch.evaluation.harness as harness

    real = harness.evaluate_llh

    def broken(model, cfg, images, **kw):
        mean, per_image, metrics = real(model, cfg, images, **kw)
        per_image = per_image.copy()
        half = len(per_image) // 2
        if fault == "half":  # half of the batch left out, the mean over the rest
            per_image[half:] = per_image[:half].mean()
        else:  # an answer altered where it is produced
            per_image[0] -= 1e-3 * abs(per_image[0])
        return mean, per_image, metrics

    monkeypatch.setattr(harness, "evaluate_llh", broken)


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_a_broken_evaluator_reads_incorrect(fault, monkeypatch, tmp_path):
    _broken_evaluator(monkeypatch, fault)
    cell = small_cell("model05-f32-eval5000")
    cell.mix["check_images"] = cell.mix["batch_size"]  # the altered answer among those compared
    out = drive_cpu(cell, tmp_path)
    assert not out["correct"], out["checks"]


def test_the_unbroken_cells_read_correct(tmp_path):
    for name in ("model05-f32-train", "model05-f32-eval5000"):
        assert drive_cpu(small_cell(name), tmp_path / name)["correct"]


@pytest.mark.parametrize("where", ["params", "mu", None])
def test_a_non_finite_state_is_found(where):
    from types import SimpleNamespace

    finite = small_cell("model05-f32-train").driver.finite
    state = SimpleNamespace(params={"w": torch.ones(3)},
                            opt_state={"mu": {"w": torch.zeros(3)}, "count": torch.tensor(2)})
    if where == "params":
        state.params["w"][1] = float("nan")
    elif where == "mu":
        state.opt_state["mu"]["w"][0] = float("inf")
    assert finite(state) is (where is None)
