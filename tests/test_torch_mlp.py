"""model01 (MLP encoder and decoder, Bernoulli), model02 (Gaussian head),
the "pmdl" likelihood and model05 with a standalone ``head`` conv
(``likelihood="dl"``) against the JAX package: same weights (bridged from the
Flax params), same injected noise.

Tolerances, each with its reason:
- the Bernoulli, Gaussian and "pmdl" log-probs on seeded numpy inputs: rtol
  1e-6 of the value plus atol 1e-6 of an O(1) term (the same float32 formulas;
  XLA's and PyTorch's exp and log1p differ by an ulp). "pmdl" shares the
  MoDL's cascade, whose log(sigmoid(stop) - sigmoid(start)) moves by up to
  4 * 2**-24 / prob when an exp differs by an ulp (``test_torch_distributions``):
  with prob down to 1e-4 here that is 2e-3 a pixel, the atol; that this is
  conditioning and no fault is held by the float64 rule: against the port's
  own float64 value the port's float32 one is no farther (RMS, times 1.2)
  than JAX's;
- losses: rtol 1e-5 (sums of ~800 to ~3000 per-pixel float32 terms);
- parameter gradients, leaf by leaf in norm, as ``test_torch_grad.py`` states
  for model05: within 1e-5 at k = 1 and 2e-3 at k = 3, where the gradient is
  weighted by softmax(log w) and log w's float32 spacing is the two sides'
  disagreement; measured here: model01 7.0e-7 / 1.3e-6, model02 1.1e-6 /
  6.9e-4;
- model05 with the ``head`` conv: the rule ``test_torch_families.py`` states
  for model03 (1e-4 at k = 1, ten float32 spacings of the loss at k = 3;
  measured 1.5e-5 / 4.7e-3 against 2.0e-2);
- ``init_output_bias``: rtol 1e-6, atol 1e-6 (log and log1p of the clamped
  mean; a logit near 0 is their small difference);
- the bridges' round trips are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair, _grad_rtol, _rel

from vae_mdl_tpu import distributions as jdist
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.nn.decoders import make_observation as jax_make_observation
from vae_mdl_tpu.train import state as jstate
from vae_mdl_tpu.train.steps import make_train_step as jax_make_train_step
from vae_mdl_tpu_torch import distributions as dist
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.nn.decoders import make_observation
from vae_mdl_tpu_torch.train.state import create_train_state, init_output_bias, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step
from vae_mdl_tpu_torch.utils.convert import (
    params_from_flax,
    params_to_flax,
    train_state_from_flax,
    train_state_to_flax,
)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = {1: 1e-5, 3: 2e-3}


# -- the likelihoods --------------------------------------------------------------


def test_bernoulli_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 2, 7, 7, 1)) * 4.0).astype(np.float32)
    logits.reshape(-1)[:3] = (0.0, 40.0, -40.0)
    x = (rng.random((2, 7, 7, 1)) < 0.5).astype(np.float32)
    got, want = dist.Bernoulli(torch.from_numpy(logits)), jdist.Bernoulli(jnp.asarray(logits))
    np.testing.assert_allclose(got.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(want.log_prob(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.reduced_log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(want.reduced_log_prob(jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(got.mean().numpy(), np.asarray(want.mean()), rtol=1e-6, atol=1e-7)
    assert got.event_axes == want.event_axes == (-1, -2, -3)
    # sample: 1.0 where the injected uniform lies under sigmoid(logits)
    u = rng.random(logits.shape).astype(np.float32)
    sample = got.sample(noise=torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(sample, (u < np.asarray(want.mean())).astype(np.float32))
    drawn = got.sample(torch.Generator().manual_seed(0), (5,))
    assert drawn.shape == (5,) + logits.shape and set(np.unique(drawn.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("bound_logstd", [False, True])
def test_gaussian_head_matches_jax(bound_logstd):
    rng = np.random.default_rng(1)
    out = rng.standard_normal((3, 2, 5, 5, 6)).astype(np.float32)
    x = rng.random((2, 5, 5, 3)).astype(np.float32)
    got = make_observation(torch.from_numpy(out), "gaussian", bound_logstd)
    want = jax_make_observation(jnp.asarray(out), "gaussian", bound_logstd)
    assert isinstance(got, dist.Normal) and got.event_axes == want.event_axes
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    np.testing.assert_allclose(got.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(want.log_prob(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_pmdl_matches_jax():
    rng = np.random.default_rng(2)
    params = (rng.standard_normal((3, 2, 5, 5, 50)) * 2.0).astype(np.float32)
    x = rng.integers(0, 256, (2, 5, 5, 3)).astype(np.float32) / 255.0
    x.reshape(-1)[:2] = (0.0, 1.0)
    got = make_observation(torch.from_numpy(params), "pmdl")
    want = jax_make_observation(jnp.asarray(params), "pmdl")
    assert isinstance(got, dist.PixelMixtureDiscretizedLogistic)
    assert got.event_axes == want.event_axes == (-1, -2) and got.n_mix == want.n_mix == 5
    lp = got.log_prob(torch.from_numpy(x))
    assert lp.shape == (3, 2, 5, 5)
    want_lp = np.asarray(want.log_prob(jnp.asarray(x)))
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=1e-5, atol=2e-3)
    truth = dist.PixelMixtureDiscretizedLogistic(torch.from_numpy(params).double()).log_prob(
        torch.from_numpy(x).double()).numpy()
    rms = lambda a: float(np.sqrt(np.mean((a.astype(np.float64) - truth) ** 2)))  # noqa: E731
    assert rms(lp.numpy()) <= 1.2 * rms(want_lp) + 1e-7
    np.testing.assert_allclose(got.reduced_log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(want.reduced_log_prob(jnp.asarray(x))), rtol=1e-5)
    sample = got.sample(torch.Generator().manual_seed(0), (4,))
    assert sample.shape == (4, 3, 2, 5, 5, 3)
    assert float(sample.min()) >= 0.0 and float(sample.max()) <= 1.0


def test_unknown_likelihood_raises():
    with pytest.raises(ValueError, match="unknown likelihood"):
        make_observation(torch.zeros(1, 4, 4, 3), "poisson")


# -- model01, model02 and model05 with a head conv, end to end ----------------------------

_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        if name == "model05_dl":
            _PAIRS[name] = FamilyPair(dataclasses.replace(JAX_MODELS["model05"], likelihood="dl"),
                                      dataclasses.replace(MODELS["model05"], likelihood="dl"))
        else:
            _PAIRS[name] = FamilyPair(JAX_MODELS[name], MODELS[name])
    return _PAIRS[name]


_RESULTS = {}


def _both(name, k):
    if (name, k) not in _RESULTS:
        pair = _pair(name)
        x, eps = pair.inputs(np.random.default_rng(5 + k), batch=4, k=k)
        if pair.cfg.likelihood == "bernoulli":
            x = (x > 0.5).astype(np.float32)
        loss, grads = pair.jax_loss_and_grad(pair.variables, x, eps)
        want = {leaf: t.numpy() for leaf, t in params_from_flax(grads, pair.cfg).items()}
        _RESULTS[name, k] = pair.port_loss_and_grads(x, eps) + (float(loss), want)
    return _RESULTS[name, k]


_LEAVES = {
    "model01": sorted(f"{block}.{layer}.{kind}" for block, layers in (
        ("encoder.MLPBlock_0", ("Dense_0", "Dense_1", "Dense_2", "Dense_3")),
        ("decoder", ("Dense_0", "Dense_1", "out"))) for layer in layers
        for kind in ("weight", "bias")),
    "model02": sorted(f"{part}.{layer}.{kind}" for part in ("encoder", "decoder")
                      for layer in [f"conv_{i}" for i in range(4)] + ["Dense_0"]
                      for kind in ("weight", "bias")),
}
_LEAVES["model05_dl"] = sorted(_LEAVES["model02"] + ["decoder.head.weight", "decoder.head.bias"])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", ["model01", "model02", "model05_dl"])
def test_loss_matches_jax(name, k):
    got_loss, got, _, want_loss, want = _both(name, k)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want) == _LEAVES[name]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name,leaf", [(name, leaf) for name in ("model01", "model02")
                                       for leaf in _LEAVES[name]])
def test_gradient_matches_jax(name, leaf, k):
    _, got, _, _, want = _both(name, k)
    assert got[leaf].shape == want[leaf].shape
    assert _rel(got[leaf], want[leaf]) <= GRAD_RTOL[k]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("leaf", _LEAVES["model05_dl"])
def test_model05_with_a_dl_head_gradient_matches_jax(leaf, k):
    """The stack's 50 channels at the compute dtype, then the float32 ``head``
    conv of 6: the configuration the roofline and the structure probe time."""
    _, got, _, want_loss, want = _both("model05_dl", k)
    assert got[leaf].shape == want[leaf].shape
    assert _rel(got[leaf], want[leaf]) <= _grad_rtol(k, want_loss)


def test_model05_with_a_dl_head_runs_the_stack_then_the_head():
    pair = _pair("model05_dl")
    decoder = pair.model.decoder
    assert not decoder.folded_head and decoder.head.weight.shape == (6, 50, 3, 3)
    assert pair.model.decoder.conv_3.weight.shape == (50, 32, 3, 3)
    assert build_model(MODELS["model05"], device="cpu").decoder.folded_head


# -- init_output_bias ------------------------------------------------------------------------


@pytest.mark.parametrize("ema_decay", [0.0, 0.999])
def test_init_output_bias_matches_jax(ema_decay):
    rng = np.random.default_rng(3)
    mean = rng.random((28, 28, 1)).astype(np.float32)
    mean.reshape(-1)[:2] = (0.0, 1.0)  # clamped to [0.001, 0.999]
    jcfg = jax_experiment("model01")
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, ema_decay=ema_decay))
    jst = jstate.create_train_state(jax_build_model(jcfg.model), jcfg.train,
                                    jnp.zeros((2, 28, 28, 1)), 1)
    jst = jstate.init_output_bias(jst, jnp.asarray(mean))
    want = np.asarray(jst.params["params"]["decoder"]["out"]["bias"])

    cfg = experiment("model01")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=ema_decay))
    model = build_model(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    state = create_train_state(model, cfg.train)
    others = {n: p.detach().clone() for n, p in state.params.items() if n != "decoder.out.bias"}
    state = init_output_bias(state, torch.from_numpy(mean))
    np.testing.assert_allclose(model.decoder.out.bias.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    assert state.params["decoder.out.bias"] is model.decoder.out.bias
    for n, before in others.items():
        assert torch.equal(state.params[n], before)
    if ema_decay:
        ema = state.ema_params["decoder.out.bias"]
        np.testing.assert_allclose(
            ema.numpy(), np.asarray(jst.ema_params["params"]["decoder"]["out"]["bias"]), rtol=1e-6,
            atol=1e-6)
        assert torch.equal(ema, model.decoder.out.bias.detach())
        assert ema.data_ptr() != model.decoder.out.bias.data_ptr()  # two buffers
        assert list(state.ema_params) == list(state.params)
    else:
        assert state.ema_params is None and jst.ema_params is None


def test_init_output_bias_needs_an_mlp_decoder():
    model = build_model(MODELS["model03"], device="cpu")
    state = create_train_state(model, experiment("model03").train)
    with pytest.raises(ValueError, match="no decoder output bias"):
        init_output_bias(state, torch.zeros(32, 32, 3))


# -- the bridges ------------------------------------------------------------------------------


@pytest.mark.parametrize("name,n_params", [("model01", 455_384), ("model02", 1_023_246),
                                           ("model05_dl", 1_038_668)])
def test_weight_bridge_round_trip_is_exact(name, n_params):
    pair = _pair(name)
    state = params_from_flax(pair.variables, pair.cfg)
    assert sum(v.numel() for v in state.values()) == n_params
    assert sorted(state) == _LEAVES[name]
    back = params_to_flax(state, pair.cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pair.variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pair.variables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["model01", "model05_dl"])
def test_train_state_bridge_round_trips_and_steps(name):
    """A JAX state two steps into training -> the port -> back, exactly; then
    the port trains on from it."""
    pair = _pair(name)
    jcfg = jax_experiment("model03", model=dataclasses.replace(pair.jax_cfg, n_samples=2))
    cfg = experiment("model03", model=dataclasses.replace(pair.cfg, n_samples=2))
    h, w, c = cfg.model.image_shape
    jst = jstate.create_train_state(pair.jm, jcfg.train, jnp.zeros((2, h, w, c)), 2)
    step = jax_make_train_step(pair.jm, jcfg, jstate.make_optimizer(jcfg.train), donate=False)
    batch = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, h, w, c), dtype=np.uint8))
    for _ in range(2):
        jst, _ = step(jst, batch)
    model = build_model(cfg.model, device="cpu")
    state = train_state_from_flax(jst, model, cfg, seed=7)
    assert state.step == 2 and int(state.opt_state["count"]) == 2
    leaf = "decoder.out.weight" if name == "model01" else "decoder.head.weight"
    assert float(state.opt_state["nu"][leaf].abs().max()) > 0
    back = train_state_to_flax(state, cfg, like=jst)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jst)
    for u, v in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    state, metrics = make_train_step(model, cfg, make_optimizer(cfg.train))(
        state, torch.from_numpy(np.array(batch)))
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))
