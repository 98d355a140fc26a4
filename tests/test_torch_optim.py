"""Schedules, optimizers and the train-state bridge against the JAX package
and optax, and a 5-step model05 trajectory from one state.

Tolerances:
- schedules and every optimizer's update and state over 3 steps on the same
  gradients: rtol 1e-6 (float32 on both sides; pow and sqrt may differ by
  an ulp between XLA and PyTorch), atol 1e-12 for values that are 0 on
  both sides up to rounding;
- the bridge round trip is exact;
- the 5-step loss trajectory: rtol 1e-5 per step. Adam's first steps move
  each weight by about +-lr whatever the gradient's size, so a gradient
  that is ~0 on both sides may move its weight either way: the loss, not
  the weights, is the quantity compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_grad import GradPair
from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.train import schedule as jschedule
from vae_mdl_tpu.train import state as jstate
from vae_mdl_tpu.train.steps import make_train_step as jax_make_train_step
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.train import schedule
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step
from vae_mdl_tpu_torch.utils.convert import train_state_from_flax, train_state_to_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-12)


def test_staircase_schedule_matches_jax():
    steps = [0, 1, 6999, 7000, 13999, 14000, 27999, 28000, 56000, 448000, 895999, 896000,
             10_000_000]
    got = [float(schedule.staircase_schedule(1e-3, 7000, 8)(s)) for s in steps]
    want = [float(jschedule.staircase_schedule(1e-3, 7000, 8)(s)) for s in steps]
    np.testing.assert_allclose(got, want, **TOL)
    assert got[0] == got[2] and got[3] < got[2] and got[-1] == pytest.approx(1e-4, rel=1e-6)
    assert schedule.staircase_schedule()(torch.tensor(7000, dtype=torch.int32)).dtype == torch.float32


def test_warmup_and_constant_schedules_match_jax():
    steps = [0, 1, 49, 99, 100, 7000, 14000]
    for base, jbase in ((schedule.staircase_schedule(1e-3, 7000, 8),
                         jschedule.staircase_schedule(1e-3, 7000, 8)),
                        (schedule.constant_schedule(3e-4), jschedule.constant_schedule(3e-4))):
        got = [float(schedule.with_warmup(base, 100)(s)) for s in steps]
        want = [float(jschedule.with_warmup(jbase, 100)(s)) for s in steps]
        np.testing.assert_allclose(got, want, **TOL)
        assert schedule.with_warmup(base, 0) is base


_OPTIMIZERS = {
    "adam": dict(),
    "adamax": dict(optimizer="adamax"),
    "adam_keras": dict(optimizer="adam_keras"),
    "adam constant": dict(lr_staircase=False, learning_rate=3e-4),
    "adam warmup": dict(lr_warmup_steps=2),
    "adam clip": dict(grad_clip_norm=0.5),
    "adam accumulate": dict(grad_accum_steps=2),
    "adamax clip accumulate": dict(optimizer="adamax", grad_clip_norm=0.5, grad_accum_steps=2),
}


def _jax_tree(d):
    return {name: jnp.asarray(v) for name, v in d.items()}


def _port_node(tree, key):
    """The dict holding ``key`` in a port optimizer state."""
    if isinstance(tree, dict):
        if key in tree:
            return tree
        tree = list(tree.values())
    if isinstance(tree, list):
        for node in tree:
            if isinstance(node, (dict, list)) and _port_node(node, key) is not None:
                return _port_node(node, key)
    return None


def _optax_node(tree, attr):
    """The optax state (a namedtuple, or a flax struct for keras_adam) with
    field ``attr`` in a nest of tuples."""
    fields = getattr(tree, "_fields", ())
    if dataclasses.is_dataclass(tree):
        fields = [f.name for f in dataclasses.fields(tree)]
    if attr in fields:
        return tree
    if isinstance(tree, tuple):
        for node in tree:
            if _optax_node(node, attr) is not None:
                return _optax_node(node, attr)
    return None


def _assert_states_match(state, jst, name, step):
    moments = ("m", "v") if name == "adam_keras" else ("mu", "nu")
    if "accumulate" in name:
        moments += ("acc_grads",)
    for key in moments:
        mine, theirs = _port_node(state, key), _optax_node(jst, key)
        for leaf in mine[key]:
            np.testing.assert_allclose(mine[key][leaf].numpy(), np.asarray(getattr(theirs, key)[leaf]),
                                       **TOL, err_msg=f"{name} step {step} {key} {leaf}")
    count_key = "mini_step" if "accumulate" in name else "count"
    assert int(_port_node(state, count_key)[count_key]) == int(getattr(
        _optax_node(jst, count_key), count_key))


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_matches_optax_on_the_same_gradients(name):
    """Three updates from the same gradients, through the staircase with
    milestones at 1, 2 and 4 updates so the rate moves within the run."""
    over = dict(lr_staircase_base=1, lr_staircase_levels=3, **_OPTIMIZERS[name])
    tx = make_optimizer(config.TrainConfig(**over))
    jtx = jstate.make_optimizer(jconfig.TrainConfig(**over))
    rng = np.random.default_rng(len(name))
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32) * 1e-3}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state, jst = tx.init(tparams), jtx.init(_jax_tree(params))
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 10.0 ** (1 - step)
                 for k, v in params.items()}
        grads["b"][0] = 0.0
        upd, state = tx.update({k: torch.from_numpy(v) for k, v in grads.items()}, state, tparams)
        jupd, jst = jtx.update(_jax_tree(grads), jst, _jax_tree(params))
        for k in params:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]), **TOL,
                                       err_msg=f"{name} step {step} {k}")
        _assert_states_match(state, jst, name, step)


def test_adamax_eps_is_added_to_the_gradient_inside_the_max():
    """optax.adamax: nu = max(|g| + eps, b2 * nu); torch.optim.Adamax puts
    eps elsewhere. A zero gradient at the first step gives nu = eps."""
    tx = make_optimizer(config.TrainConfig(optimizer="adamax"))
    params = {"w": torch.zeros(2)}
    _, state = tx.update({"w": torch.tensor([0.0, 2.0])}, tx.init(params), params)
    np.testing.assert_allclose(state["nu"]["w"].numpy(), [1e-8, 2.0 + 1e-8], rtol=1e-7)


def _narrow(cfg_module):
    c = cfg_module
    return c.ModelConfig(
        name="narrow", image_shape=(8, 8, 3), n_latent=4, likelihood="mdl", n_mix=2,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(20, 3, 1, "none"))),
    )


@pytest.mark.parametrize("train_over", [dict(), dict(grad_clip_norm=1.0, ema_decay=0.5),
                                        dict(optimizer="adamax")])
def test_train_state_bridge_round_trips(train_over):
    """A JAX state two steps into training -> the port -> back, exactly;
    and the port's state holds what JAX's does."""
    jcfg = jax_experiment("model05", model=_narrow(jconfig))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **train_over))
    cfg = experiment("model05", model=_narrow(config))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_over))
    jm = jax_build_model(jcfg.model)
    x = jnp.zeros((2, 8, 8, 3))
    jst = jstate.create_train_state(jm, jcfg.train, x, jcfg.model.n_samples)
    step = jax_make_train_step(jm, jcfg, jstate.make_optimizer(jcfg.train), donate=False)
    batch = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8))
    for _ in range(2):
        jst, _ = step(jst, batch)

    model = build_model(cfg.model, device="cpu")
    state = train_state_from_flax(jst, model, cfg, seed=7)
    assert state.step == 2 and state.seed == 7
    adam = state.opt_state[-1] if isinstance(state.opt_state, list) else state.opt_state
    assert int(adam["count"]) == 2
    assert (state.ema_params is None) == (jst.ema_params is None)
    np.testing.assert_array_equal(adam["nu"]["encoder.conv_0.bias"].numpy(), np.asarray(
        _optax_node(jst.opt_state, "nu").nu["params"]["encoder"]["conv_0"]["bias"]))

    back = train_state_to_flax(state, cfg, like=jst)
    a = jax.tree_util.tree_leaves(back)
    b = jax.tree_util.tree_leaves(jst)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jst)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_model05_five_step_loss_trajectory_matches_jax():
    """From one state (bridged weights, fresh Adam), five train steps on the
    same uint8 batches and injected noise: the port's step against JAX's
    composed loss, jax.grad and tx.update."""
    pair = GradPair(JAX_MODELS["model05"], MODELS["model05"], seed=11)
    ecfg = experiment("model05")
    state = create_train_state(pair.model, ecfg.train)
    step = make_train_step(pair.model, ecfg, make_optimizer(ecfg.train))
    jtx = jstate.make_optimizer(jax_experiment("model05").train)
    params = jax.tree_util.tree_map(jnp.asarray, pair.variables)
    jopt = jtx.init(params)
    update = jax.jit(lambda g, s, p: jtx.update(g, s, p))

    rng = np.random.default_rng(12)
    got, want = [], []
    for _ in range(5):
        batch = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
        eps = rng.standard_normal((ecfg.model.n_samples, 4, 20)).astype(np.float32)
        loss, grads = pair.jax_loss_and_grad(params, batch.astype(np.float32) / 255.0, eps)
        updates, jopt = update(grads, jopt, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
        state, metrics = step(state, torch.from_numpy(batch), eps=torch.from_numpy(eps))
        got.append(float(metrics["loss"]))
    assert state.step == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0]
