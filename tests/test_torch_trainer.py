"""The port's Trainer: the JAX package's trainer tests (tests/test_train.py,
the EMA and config-recording cases) run on the port, and 200 steps on
``digits`` against the JAX package's step on the same inputs.

Tolerances:
- resume, the data seek, steps_per_call, snapshots: exact (bit-equal
  parameters, optimizer state and EMA; the port's draws derive from the
  seed and the step);
- digits against JAX, on the same batches, the same converted initial
  weights and JAX's "sample" and "binarize" draws injected into the port's
  step: the per-step loss within rtol 1e-5 over the first 10 steps (float32
  sums in another order); after 200 steps the weights have drifted apart by
  Adam's rounding, so the validation loss and the 64-sample LLH (on the
  validation and test draws JAX makes) are held within rtol 1e-3.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu.data.pipeline import setup_data as jax_setup_data
from vae_mdl_tpu.evaluation.harness import make_batch_evaluator as jax_make_batch_evaluator
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.train import state as jstate
from vae_mdl_tpu.train.steps import make_eval_step as jax_make_eval_step
from vae_mdl_tpu.train.steps import make_train_step as jax_make_train_step
from vae_mdl_tpu_torch.config import DataConfig, TrainConfig
from vae_mdl_tpu_torch.config_io import load_config
from vae_mdl_tpu_torch.data.pipeline import setup_data
from vae_mdl_tpu_torch.evaluation.harness import make_batch_evaluator
from vae_mdl_tpu_torch.models.objective import compute_loss
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.state import make_optimizer, tree_map
from vae_mdl_tpu_torch.train.steps import make_eval_step, make_train_step
from vae_mdl_tpu_torch.train.trainer import Trainer, train
from vae_mdl_tpu_torch.utils.convert import train_state_from_flax
from vae_mdl_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_cfg(tmp, n_updates=40, eval_interval=20, name="model01",
              dataset="synthetic:mnist", **train):
    cfg = experiment(name)
    return dataclasses.replace(
        cfg,
        data=DataConfig(dataset=dataset, batch_size=16, val_batch_size=32),
        train=TrainConfig(**{"n_updates": n_updates, "eval_interval": eval_interval,
                             "report_images": False, "checkpoint_dir": str(tmp) + "/ckpt",
                             "log_dir": str(tmp) + "/tb", **train}),
    )


def _with_train(cfg, **train):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def _val_loss(tr, batch):
    return float(make_eval_step(tr.model, tr.cfg)(tr.state, batch)["loss"])


def _assert_states_equal(a, b):
    assert a.step == b.step
    same = lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0)  # noqa: E731
    tree_map(same, a.params, b.params)
    tree_map(same, a.opt_state, b.opt_state)
    assert (a.ema_params is None) == (b.ema_params is None)
    if a.ema_params is not None:
        tree_map(same, a.ema_params, b.ema_params)


def test_trainer_runs_on_the_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_tiny_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_tiny_cfg(tmp_path))
    with pytest.raises(TypeError, match="make_mesh"):
        Trainer(_tiny_cfg(tmp_path), device="cpu", mesh=object())


def test_training_reduces_loss_and_resumes(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    tr = Trainer(cfg, device="cpu")
    batch = tr._put(next(tr.val_iter))
    before = _val_loss(tr, batch)
    state = tr.fit(progress=False)
    after = _val_loss(tr, batch)
    assert after < before and state.step == 40
    assert tr._stream is None  # the producer was stopped at the end of fit

    tr2 = Trainer(cfg, device="cpu")  # auto-resume: the full state
    _assert_states_equal(tr2.state, state)
    assert _val_loss(tr2, batch) == after


@pytest.mark.parametrize("train", [dict(), dict(ema_decay=0.9)])
def test_resume_is_data_deterministic_and_bit_equal(tmp_path, train):
    s_a = Trainer(_tiny_cfg(tmp_path / "a", **train), device="cpu").fit(progress=False)
    Trainer(_tiny_cfg(tmp_path / "b", n_updates=20, **train), device="cpu").fit(progress=False)
    s_b = Trainer(_tiny_cfg(tmp_path / "b", **train), device="cpu").fit(progress=False)
    assert s_b.step == 40
    _assert_states_equal(s_a, s_b)


def test_snapshot_checkpoints_rotate_and_restore(tmp_path):
    cfg = _with_train(_tiny_cfg(tmp_path, n_updates=50, eval_interval=10),
                      snapshot_interval=10, max_snapshots=2)
    tr = Trainer(cfg, device="cpu")
    tr.fit(progress=False)
    # snapshots at loop values 10..40 -> steps 11..41, the newest 2 kept
    assert tr.ckpt.snapshots() == ["step_31", "step_41"]
    assert tr.ckpt.has("latest") and tr.ckpt.has("best")

    fresh = Trainer(_with_train(cfg, resume=False), device="cpu")
    assert fresh.state.step == 0
    assert fresh.ckpt.restore(fresh.state, "step_31").step == 31

    with pytest.raises(ValueError, match="snapshot_interval"):
        Trainer(_with_train(cfg, snapshot_interval=15), device="cpu")
    with pytest.raises(ValueError, match="snapshot_interval"):
        tr.fit(eval_interval=25, progress=False)
    with pytest.raises(ValueError, match="max_snapshots"):
        Trainer(_with_train(cfg, max_snapshots=0), device="cpu")
    before = tr.ckpt.snapshots()
    tr.ckpt.prune_snapshots(0)
    assert tr.ckpt.snapshots() == before


def test_latest_checkpoint_carries_updated_best_val_loss(tmp_path):
    """Every 'latest' written at an eval already holds that eval's improved
    best validation loss, the one the 'best' beside it holds."""
    tr = Trainer(_tiny_cfg(tmp_path), device="cpu")
    saves = []
    save = tr.ckpt.save

    def spy(state, tag="latest"):
        saves.append((tag, state.step, state.best_val_loss))
        save(state, tag)

    tr.ckpt.save = spy
    tr.fit(progress=False)
    best = [(step, loss) for tag, step, loss in saves if tag == "best"]
    assert best and all(np.isfinite(loss) for _, loss in best)
    for step, loss in best:
        assert ("latest", step, loss) in saves
    latest = tr.ckpt.load("latest", "cpu")
    assert latest["best_val_loss"] == tr.ckpt.load("best", "cpu")["best_val_loss"]


def test_resume_falls_back_to_best(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    tr = Trainer(cfg, device="cpu")
    tr.state.step = 7
    tr.ckpt.save(tr.state, "best")
    assert not tr.ckpt.has("latest")
    assert Trainer(cfg, device="cpu").state.step == 7


def test_steps_per_call(tmp_path):
    cfg = _with_train(_tiny_cfg(tmp_path / "a", n_updates=20, eval_interval=10),
                      steps_per_call=5)
    state = Trainer(cfg, device="cpu").fit(progress=False)
    assert state.step == 20
    # equal to one step a call on the same stream
    single = Trainer(_tiny_cfg(tmp_path / "b", n_updates=20, eval_interval=10),
                     device="cpu").fit(progress=False)
    _assert_states_equal(state, single)
    with pytest.raises(ValueError, match="steps_per_call"):
        Trainer(_with_train(cfg, steps_per_call=3), device="cpu")


def test_device_dataset_training(tmp_path):
    cfg = _with_train(_tiny_cfg(tmp_path, n_updates=30, eval_interval=15),
                      steps_per_call=5, device_dataset=True)
    tr = Trainer(cfg, device="cpu")
    batch = tr._put(next(tr.val_iter))
    before = _val_loss(tr, batch)
    state = tr.fit(progress=False)
    assert state.step == 30 and _val_loss(tr, batch) < before
    assert tr._device_data.shape == (2048, 28, 28, 1)
    assert Trainer(cfg, device="cpu").state.step == 30


def test_augment_flip_applies_to_train_only():
    cfg = experiment("model02")
    cfg = dataclasses.replace(cfg, data=DataConfig(dataset="synthetic:svhn_cropped",
                                                   batch_size=8))
    cfg_flip = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, augment_flip=True))
    model = build_model(cfg.model, device="cpu")
    batch = np.zeros((8, 32, 32, 3), np.uint8)
    batch[:, :, :16, :] = 200  # left half bright: a flip changes the batch
    batch = torch.from_numpy(batch)
    losses = []
    for c in (cfg, cfg_flip):
        from vae_mdl_tpu_torch.train.state import create_train_state

        state = create_train_state(model, c.train)
        saved = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses.append(float(make_eval_step(model, c)(state, batch)["loss"]))
        losses.append(float(make_train_step(model, c, make_optimizer(c.train))(
            state, batch)[1]["loss"]))
        with torch.no_grad():  # undo the update for the next config
            for n, p in model.named_parameters():
                p.copy_(saved[n])
    eval_plain, train_plain, eval_flip, train_flip = losses
    assert eval_plain == eval_flip and train_plain != train_flip


def test_sigterm_checkpoints_and_exits(tmp_path):
    """SIGTERM mid-fit finishes the step in flight, checkpoints that exact
    state and returns; the child imports only the port and prints each
    step, and the signal goes after the third."""
    code = f"""
import dataclasses
from vae_mdl_tpu_torch.config import DataConfig, TrainConfig
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.trainer import Trainer

cfg = dataclasses.replace(
    experiment("model01"),
    data=DataConfig(dataset="synthetic:mnist", batch_size=8, val_batch_size=8),
    train=TrainConfig(n_updates=1_000_000, eval_interval=500_000, report_images=False,
                      checkpoint_dir={str(tmp_path / "ckpt")!r},
                      log_dir={str(tmp_path / "tb")!r}),
)
tr = Trainer(cfg, device="cpu")
inner = tr.train_step

def step(state, batch):
    state, metrics = inner(state, batch)
    print("STEP", state.step, flush=True)
    return state, metrics

tr.train_step = step
state = tr.fit(progress=False)
print("STOPPED_AT", state.step, flush=True)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-u", "-c", code], stdout=subprocess.PIPE,
                            text=True, env=env)
    seen = []
    try:
        for line in proc.stdout:
            seen.append(line)
            if line.strip() == "STEP 3":
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        out = "".join(seen) + out
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    stopped = [line for line in out.splitlines() if line.startswith("STOPPED_AT")]
    assert stopped, out
    step = int(stopped[0].split()[1])
    assert 3 <= step < 1_000_000
    last = [int(line.split()[1]) for line in out.splitlines() if line.startswith("STEP")][-1]
    assert last == step  # the step in flight finished, and no other began

    cfg = dataclasses.replace(_tiny_cfg(tmp_path, n_updates=1_000_000, eval_interval=500_000),
                              data=DataConfig(dataset="synthetic:mnist", batch_size=8,
                                              val_batch_size=8))
    assert Trainer(cfg, device="cpu").state.step == step


def test_the_port_imports_no_jax():
    """The modules of this slice import none of jax, flax, optax, orbax or
    the JAX package: the child forgets any such module already loaded at
    start-up and refuses to load one again."""
    code = """
import importlib.abc, sys
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "vae_mdl_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
import vae_mdl_tpu_torch.train.trainer, vae_mdl_tpu_torch.evaluation.diagnostics
import vae_mdl_tpu_torch.config_io, vae_mdl_tpu_torch.data.native
import vae_mdl_tpu_torch.utils.convert, vae_mdl_tpu_torch.utils.images
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr


def test_trainer_records_config_and_warns_on_drift(tmp_path, capsys):
    cfg = _tiny_cfg(tmp_path, n_updates=2, eval_interval=2)
    trainer = Trainer(cfg, device="cpu")
    trainer._record_config()
    path = tmp_path / "ckpt" / "model01" / "config.json"
    assert path.exists() and load_config(str(path)) == cfg
    assert "WARNING" not in capsys.readouterr().out

    drifted = _with_train(cfg, learning_rate=5e-4)
    trainer.cfg = drifted
    trainer._record_config()
    out = capsys.readouterr().out
    assert "live config differs" in out and "train.learning_rate: 0.001 -> 0.0005" in out
    assert load_config(str(path)) == drifted


class _Images(MetricLogger):
    def __init__(self, *args):
        super().__init__(*args)
        self.images = []

    def image(self, step, name, img, prefix="Evaluation"):
        self.images.append((step, name, img))


@pytest.mark.parametrize("name,dataset,shape", [
    ("model01", "synthetic:mnist", (224, 224, 1)),
    ("model05", "synthetic:svhn_cropped", (256, 256, 3)),
])
def test_report_produces_three_grids(tmp_path, name, dataset, shape):
    cfg = _tiny_cfg(tmp_path, name=name, dataset=dataset, ema_decay=0.5)
    logger = _Images(str(tmp_path / "tb"), name)
    tr = Trainer(cfg, logger=logger, device="cpu")
    tr.report(3)
    assert [(s, n) for s, n, _ in logger.images] == [
        (3, "inputs"), (3, "reconstructions"), (3, "samples")]
    for _, _, img in logger.images:
        assert img.shape == shape and np.isfinite(img).all()
        assert img.min() >= 0.0 and img.max() <= 1.0


def test_test_with_khat_and_fit_continues_after_it(tmp_path):
    """test() evaluates the best checkpoint's EMA weights through params=
    and leaves the live state alone: fit then continues from it, bit-equal
    to a run that never called test()."""
    cfg = _tiny_cfg(tmp_path / "a", ema_decay=0.9)
    tr = Trainer(cfg, device="cpu")
    tr.fit(progress=False)
    live = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    mean, per_image, metrics = tr.test(n_samples=50, khat=True, k_curve=True, batch_size=128)
    assert per_image.shape == (512,) and np.isfinite(per_image).all()
    for key in ("khat_mean", "khat_max", "khat_frac_gt_07"):
        assert np.isfinite(metrics[key]), key
    assert metrics["k_curve_llh"][-1] == pytest.approx(mean, rel=1e-12)
    for n, p in tr.model.named_parameters():
        assert torch.equal(p, live[n]), n
    # the best checkpoint's EMA copy is what was evaluated
    best = tr.ckpt.load("best", "cpu")
    from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh

    want = evaluate_llh(tr.model, cfg, tr.test_set[0], n_samples=50, batch_size=128,
                        params=best["ema_params"])[1]
    np.testing.assert_array_equal(per_image, want)

    state = tr.fit(n_updates=60, progress=False)
    other = Trainer(_tiny_cfg(tmp_path / "b", ema_decay=0.9), device="cpu")
    other.fit(progress=False)
    _assert_states_equal(state, other.fit(n_updates=60, progress=False))


def test_ema_is_what_validation_and_test_read(tmp_path):
    """decay 1 pins the EMA at the initial weights: validation through the
    trainer's eval step equals that of an untrained state."""
    cfg = _tiny_cfg(tmp_path / "a", n_updates=4, eval_interval=2, ema_decay=1.0)
    tr = Trainer(cfg, device="cpu")
    init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.fit(progress=False)
    for n, e in tr.state.ema_params.items():
        assert torch.equal(e, init[n])
    batch = tr._put(next(tr.val_iter))
    untrained = Trainer(_tiny_cfg(tmp_path / "b", n_updates=4, eval_interval=2), device="cpu")
    untrained.state.step = tr.state.step  # the same eval draws
    assert _val_loss(tr, batch) == _val_loss(untrained, batch)
    assert tr.test(n_samples=30, ckpt=None, batch_size=128)[0] == untrained.test(
        n_samples=30, ckpt=None, batch_size=128)[0]


def test_model03_through_the_trainer(tmp_path):
    """A few steps of model03 (a discretized-logistic head: K5's plain
    version on the CPU) through fit, report and test."""
    cfg = dataclasses.replace(
        _tiny_cfg(tmp_path, n_updates=4, eval_interval=2, name="model03",
                  dataset="synthetic:svhn_cropped", report_images=True),
        data=DataConfig(dataset="synthetic:svhn_cropped", batch_size=4, val_batch_size=8))
    logger = _Images(str(tmp_path / "tb"), "model03")
    tr = Trainer(cfg, logger=logger, device="cpu")
    state = tr.fit(progress=False)
    assert state.step == 4 and np.isfinite(state.best_val_loss)
    assert len(logger.images) == 6  # three grids at each of two evals
    tr.test_set = (tr.test_set[0][:4], tr.test_set[1][:4])
    mean, per_image, _ = tr.test(n_samples=4, batch_size=4)
    assert np.isfinite(per_image).all()


def _crc(name):
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def test_digits_200_steps_against_jax():
    """tests/test_golden.py's digits run (batch 32, 200 steps) on both
    sides from the same initial weights, on the same batches, with JAX's
    draws injected into the port's step."""
    pytest.importorskip("sklearn")
    jcfg = jax_experiment("digits")
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, batch_size=32,
                                                              val_batch_size=64))
    cfg = experiment("digits")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=32,
                                                            val_batch_size=64))
    k = cfg.model.n_samples
    jm = jax_build_model(jcfg.model)
    js = jstate.create_train_state(jm, jcfg.train, jnp.zeros((32, 16, 16, 1)), k)
    jstep = jax_make_train_step(jm, jcfg, jstate.make_optimizer(jcfg.train), donate=False)
    model = build_model(cfg.model, device="cpu")
    state = train_state_from_flax(js, model, cfg)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))

    def step_draws(params, rng, at, sample, binarize, batch_shape):
        """The port's eps and u from the JAX state's draws at step ``at``:
        the two streams' keys as TrainState.next_rngs folds them, the noise
        from the model's make_rng("sample"), the uniforms as bernoulli's."""
        step_key = jax.random.fold_in(rng, at)
        key = jm.apply(params, rngs={"sample": jax.random.fold_in(step_key, _crc(sample))},
                       method=lambda m: m.make_rng("sample"))
        eps = jax.random.normal(key, (k, batch_shape[0], cfg.model.n_latent))
        u = jax.random.uniform(jax.random.fold_in(step_key, _crc(binarize)), batch_shape)
        return torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(u))

    jtrain, jval, _ = jax_setup_data("digits", batch_size=32, val_batch_size=64,
                                     seed=jcfg.data.seed)
    train_iter, val_iter, test = setup_data("digits", batch_size=32, val_batch_size=64,
                                            seed=cfg.data.seed)
    got, want = [], []
    for i in range(200):
        batch = next(train_iter)
        np.testing.assert_array_equal(batch, next(jtrain))
        eps, u = step_draws(js.params, js.rng, js.step, "sample", "binarize", batch.shape)
        js, jmetrics = jstep(js, jnp.asarray(batch))
        state, metrics = step(state, torch.from_numpy(batch), eps=eps, u=u)
        if i < 10:
            want.append(float(jmetrics["loss"]))
            got.append(float(metrics["loss"]))
    assert state.step == int(js.step) == 200
    np.testing.assert_allclose(got, want, rtol=1e-5)

    val = next(val_iter)
    np.testing.assert_array_equal(val, next(jval))
    want_val = float(jax_make_eval_step(jm, jcfg)(js, jnp.asarray(val))["loss"])
    eps, u = step_draws(js.params, js.rng, js.step, "eval_sample", "eval_binarize", val.shape)
    with torch.no_grad():
        x = (u < torch.from_numpy(val).float() / 255.0).float()
        Qs, Ps, pxz = model(x, k, eps=eps)
        got_val = float(compute_loss(prior_for(cfg.model), Qs, Ps, pxz, x)[0])

    images = test[0][:64]
    key = jax.random.PRNGKey(7)
    want_llh = float(jax_make_batch_evaluator(jm, jcfg, n_samples=64, k_chunk=16)(
        js.params, jnp.asarray(images), key).mean())
    chunk_keys = jax.random.split(jax.random.fold_in(key, 1), 4)
    chunk_eps = []
    for chunk_key in chunk_keys:
        noise_key = jm.apply(js.params, rngs={"sample": chunk_key},
                             method=lambda m: m.make_rng("sample"))
        chunk_eps.append(np.array(jax.random.normal(noise_key, (16, 64, cfg.model.n_latent))))
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 0),
                                                     images.shape)))
    got_llh = float(make_batch_evaluator(model, cfg, 64, 16)(
        torch.from_numpy(images), eps=torch.from_numpy(np.stack(chunk_eps)), u=u).mean())
    print(f"digits after 200 steps: val loss port {got_val:.6f} JAX {want_val:.6f} "
          f"(rel {abs(got_val / want_val - 1):.2e}); 64-IS LLH port {got_llh:.6f} "
          f"JAX {want_llh:.6f} (rel {abs(got_llh / want_llh - 1):.2e})")
    assert got_val == pytest.approx(want_val, rel=1e-3)
    assert got_llh == pytest.approx(want_llh, rel=1e-3)
