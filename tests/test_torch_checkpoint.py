"""The port's checkpoints: save and restore of the full train state,
restore_weights across optimizer flags, both EMA reconciliations, snapshot
rotation and pruning, the fall-back to 'best', a leftover '.tmp', and a
restore writing into the model's own parameters.

Tolerance: none; restored tensors and numbers are compared for equality.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.checkpoint import Checkpointer
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer, tree_map
from vae_mdl_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)


def _cfg(**train):
    cfg = experiment("model01")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def _trained(cfg, steps=3, seed=0):
    """A model01 state ``steps`` updates into training, on the CPU."""
    model = build_model(cfg.model, torch.Generator().manual_seed(seed), device="cpu")
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    batches = np.random.default_rng(seed).integers(0, 256, (steps, 4, 28, 28, 1), dtype=np.uint8)
    for batch in batches:
        state, _ = step(state, torch.from_numpy(batch))
    state.best_val_loss = 123.5
    return model, state


def _fresh(cfg, seed=1):
    model = build_model(cfg.model, torch.Generator().manual_seed(seed), device="cpu")
    return model, create_train_state(model, cfg.train)


def _assert_tree_equal(a, b):
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)


@pytest.mark.parametrize("train", [dict(), dict(ema_decay=0.9), dict(optimizer="adam_keras"),
                                   dict(grad_clip_norm=1.0, grad_accum_steps=2),
                                   dict(optimizer="adamax")])
def test_save_and_restore_the_full_state(tmp_path, train):
    cfg = _cfg(**train)
    model, state = _trained(cfg)
    ckpt = Checkpointer(str(tmp_path), "model01")
    ckpt.save(state, "latest")
    assert sorted(os.listdir(ckpt._path("latest"))) == ["meta.json", "state.pt"]
    assert ckpt.saved_with_ema("latest") == ("ema_decay" in train)

    fresh_model, fresh = _fresh(cfg)
    restored = ckpt.restore(fresh, "latest")
    assert restored is fresh
    assert fresh.step == 3 and fresh.best_val_loss == 123.5 and fresh.seed == state.seed
    _assert_tree_equal(fresh.params, state.params)
    _assert_tree_equal(fresh.opt_state, state.opt_state)
    if state.ema_params is None:
        assert fresh.ema_params is None
    else:
        _assert_tree_equal(fresh.ema_params, state.ema_params)
    # the model's own parameters hold the restored values
    for name, p in fresh_model.named_parameters():
        assert p is fresh.params[name]
        assert torch.equal(p, dict(model.named_parameters())[name])


def test_restore_refuses_another_optimizer_structure_and_restore_weights_does_not(tmp_path):
    clip = _cfg(grad_clip_norm=100.0, ema_decay=0.9)
    _, trained = _trained(clip, steps=4)
    ckpt = Checkpointer(str(tmp_path), "model01")
    ckpt.save(trained, "latest")

    plain = _cfg()
    _, target = _fresh(plain)
    before = tree_map(lambda t: t.clone(), target.opt_state)
    with pytest.raises(ValueError, match="another structure"):
        ckpt.restore(target, "latest")
    _assert_tree_equal(target.opt_state, before)  # nothing was touched
    st = ckpt.restore_weights(target, "latest")
    assert st is target and st.step == 4 and st.ema_params is None
    _assert_tree_equal(st.params, trained.params)
    _assert_tree_equal(st.opt_state, before)  # the optimizer state stays

    # a target with EMA takes the checkpoint's EMA copy
    _, target = _fresh(_cfg(ema_decay=0.5))
    ckpt.restore_weights(target, "latest")
    _assert_tree_equal(target.ema_params, trained.ema_params)


def test_ema_reconciliations(tmp_path):
    """A checkpoint with EMA restored into a state without drops it; one
    without restored into a state with one seeds it from the params."""
    ckpt = Checkpointer(str(tmp_path), "model01")
    _, with_ema = _trained(_cfg(ema_decay=0.9))
    ckpt.save(with_ema, "with")
    _, target = _fresh(_cfg())
    ckpt.restore(target, "with")
    assert target.ema_params is None
    _assert_tree_equal(target.params, with_ema.params)

    _, without = _trained(_cfg(), seed=2)
    ckpt.save(without, "without")
    assert not ckpt.saved_with_ema("without") and ckpt.saved_with_ema("with")
    _, target = _fresh(_cfg(ema_decay=0.9))
    ckpt.restore(target, "without")
    _assert_tree_equal(target.ema_params, without.params)
    for name, e in target.ema_params.items():  # a copy, not the params themselves
        assert e.data_ptr() != target.params[name].data_ptr()
    # restore_weights seeds it the same way
    _, target = _fresh(_cfg(ema_decay=0.9))
    ckpt.restore_weights(target, "without")
    _assert_tree_equal(target.ema_params, without.params)


def test_snapshots_rotate_and_prune(tmp_path):
    ckpt = Checkpointer(str(tmp_path), "model01")
    _, state = _fresh(_cfg())
    for step in (11, 21, 31, 41, 101):
        state.step = step
        ckpt.save(state, f"step_{step}")
    ckpt.save(state, "latest")
    ckpt.save(state, "best")
    os.makedirs(ckpt._path("step_7.tmp"))  # a leftover of a crashed save
    assert ckpt.snapshots() == ["step_11", "step_21", "step_31", "step_41", "step_101"]
    ckpt.prune_snapshots(0)  # keep everything
    assert len(ckpt.snapshots()) == 5
    ckpt.prune_snapshots(2)
    assert ckpt.snapshots() == ["step_41", "step_101"]
    assert ckpt.has("latest") and ckpt.has("best")
    with open(os.path.join(ckpt._path("step_41"), "meta.json")) as f:
        assert json.load(f) == {"step": 41, "has_ema": False}
    _, target = _fresh(_cfg())
    assert ckpt.restore(target, "step_41").step == 41


def test_restore_latest_falls_back_to_best(tmp_path, capsys):
    ckpt = Checkpointer(str(tmp_path), "model01")
    _, target = _fresh(_cfg())
    assert ckpt.restore_latest(target) is None
    _, state = _trained(_cfg())
    state.step = 7
    ckpt.save(state, "best")
    assert not ckpt.has("latest")
    assert ckpt.restore_latest(target) is target and target.step == 7
    assert "resuming from 'best'" in capsys.readouterr().out


def test_a_leftover_tmp_is_ignored_and_a_crash_between_renames_recovers(tmp_path):
    ckpt = Checkpointer(str(tmp_path), "model01")
    _, state = _trained(_cfg())
    ckpt.save(state, "latest")
    # a save that died while writing: garbage under latest.tmp
    os.makedirs(ckpt._path("latest.tmp"), exist_ok=True)
    with open(os.path.join(ckpt._path("latest.tmp"), "state.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    _, target = _fresh(_cfg())
    ckpt.restore(target, "latest")
    _assert_tree_equal(target.params, state.params)
    # the next save replaces it
    state.step = 9
    ckpt.save(state, "latest")
    assert not os.path.exists(ckpt._path("latest.tmp"))
    assert ckpt.restore(target, "latest").step == 9
    # a crash between save's two renames: the previous checkpoint is at
    # latest.old and no latest is there; it is put back
    os.replace(ckpt._path("latest"), ckpt._path("latest.old"))
    assert ckpt.has("latest")
    assert ckpt.restore(target, "latest").step == 9


def test_a_checkpoint_loads_onto_the_target_device_with_weights_only(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path), "model01")
    _, state = _trained(_cfg(ema_decay=0.5))
    ckpt.save(state, "latest")
    seen = {}
    load = torch.load

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", spy)
    _, target = _fresh(_cfg(ema_decay=0.5))
    ckpt.restore(target, "latest")
    assert seen["weights_only"] is True and seen["map_location"] == torch.device("cpu")
    ckpt.wait()  # synchronous saves: nothing in flight
