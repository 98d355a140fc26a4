"""model03, model04 and model06 (the discretized-logistic families) end to
end against the JAX package: same weights (bridged from the Flax params),
same injected noise, one tensor per stochastic layer.

Tolerances, each with its reason:
- q, p and p(x|z) parameters: rtol/atol 1e-5 (float32 convolutions and dense
  layers summed in different orders); 3e-5 for the full-width model;
- the loss: rtol 1e-5 (a sum of ~3000 per-sub-pixel terms in float32);
- parameter gradients, leaf by leaf in norm. At k = 1: 1e-4 (measured
  2.7e-5 on the narrow models, 1.8e-5 on model03 at full width: the
  derivative of log(sigmoid(stop) - sigmoid(start)) cancels over a 1/255-wide
  bin, see tests/test_torch_dl.py). At k = 3 the gradient is weighted by
  softmax(log w), and an absolute error in log w is a relative error in w:
  log w is a float32 sum whose spacing is 1.2e-4 nats at |log w| ~ 1e3 (the
  8x8 models), 4.9e-4 at 4e3 (narrow model04, 16x16) and 2e-3 at 1.7e4
  (model03), so the two sides' weights differ by that much however exactly
  each computes (tests/test_torch_grad.py has the same rule for model05).
  The tolerance is 10 spacings of the loss (measured: 1 to 5 spacings; 4.3e-3
  on model03's encoder.conv_0.weight). That this is rounding and no fault is
  held by the float64 rule: against the port run in float64, the port's
  float32 gradient is no farther (times 1.2) than JAX's float32 gradient
  (measured 2.5e-3 against 6.5e-3 on that leaf);
- DReG on two layers: the same 10 spacings, doubled for the squared weights
  (measured 1 spacing); the route z_1 -> q_2's parameters cut moves an
  encoder leaf by more than 0.1;
- the 3-step Adam trajectory: the loss at rtol 1e-5 per step (Adam's first
  steps move each weight by about +-lr whatever the gradient's size, so the
  loss, not the weights, is compared);
- the evaluator on the same noise: rtol 1e-5 of |log w|, atol 1e-3;
- the bridges' round trips are exact.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.distributions import DistributionTuple as JaxDT
from vae_mdl_tpu.evaluation.harness import make_batch_evaluator as jax_make_batch_evaluator
from vae_mdl_tpu.models.objective import compute_loss as jax_compute_loss
from vae_mdl_tpu.models.objective import training_loss_fn as jax_training_loss_fn
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.vae import prior_for as jax_prior_for
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.train import state as jstate
from vae_mdl_tpu.train.steps import make_train_step as jax_make_train_step
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.evaluation.harness import _batch_seed, evaluate_llh, make_batch_evaluator
from vae_mdl_tpu_torch.models.objective import compute_loss, training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step
from vae_mdl_tpu_torch.utils.convert import (
    params_from_flax,
    params_to_flax,
    train_state_from_flax,
    train_state_to_flax,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FULL_TOL = dict(rtol=3e-5, atol=3e-5)
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL_K1 = 1e-4
WEIGHT_SPACINGS = 10


def _grad_rtol(k, loss, objective="iwae"):
    """The per-leaf norm-relative gradient tolerance (module docstring)."""
    if k == 1 or objective == "elbo":  # no importance weights
        return GRAD_NORM_RTOL_K1
    spacings = WEIGHT_SPACINGS * (2 if objective == "iwae_dreg" else 1)
    return max(GRAD_NORM_RTOL_K1, spacings * float(np.spacing(np.float32(abs(loss)))))


def _narrow(c, family):
    """The three families at a narrow width; ``c`` is either package's
    config module. "L3" is model06's shape with three stochastic layers."""
    if family == "model03":
        return c.ModelConfig(
            name="narrow03", image_shape=(8, 8, 3), n_latent=4, likelihood="dl",
            encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
            decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                    conv_layers=(c.deconv(8, 4, 2), c.conv(6, 3, 1, "none"))))
    if family == "model04":
        return c.ModelConfig(
            name="narrow04", image_shape=(16, 16, 3), n_latent=5, likelihood="dl",
            encoder=c.EncoderConfig(
                kind="conv", n_glu=2, glu_features=8,
                conv_layers=(c.conv(8, 4, 2), c.conv(12, 4, 2), c.conv(12, 3, 1))),
            decoder=c.DecoderConfig(
                kind="conv", base_size=(4, 4, 7), pre_layers=(c.conv(12, 3, 1),), n_glu=2,
                glu_features=8, conv_layers=(c.deconv(8, 4, 2), c.deconv(6, 4, 2, "none"))))
    n_stochastic, latent_sizes = (2, ()) if family == "model06" else (3, (4, 3, 2))
    return c.ModelConfig(
        name=f"narrow_{family}", image_shape=(8, 8, 3), n_latent=4, likelihood="dl",
        n_stochastic=n_stochastic, latent_sizes=latent_sizes, mlp_hidden=10,
        mlp_activation="gelu",
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1, "gelu"),
                                                          c.conv(16, 3, 2, "gelu"))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16), fc_activation="gelu",
                                conv_layers=(c.deconv(8, 4, 2, "gelu"), c.conv(6, 3, 1, "none"))))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class FamilyPair:
    """One config on both sides: the Flax model and its params, the port's
    model with the bridged weights, and the JAX forward, loss and gradient
    on injected noise (one tensor per stochastic layer)."""

    def __init__(self, jax_cfg, cfg, seed=0):
        self.jax_cfg, self.cfg = jax_cfg, cfg
        self.jm = jm = jax_build_model(jax_cfg)
        h, w, c = cfg.image_shape
        init = jax.jit(lambda rngs, x: jm.init(rngs, x, 1))
        self.variables = jax.tree_util.tree_map(np.asarray, init(
            {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)},
            jnp.zeros((1, h, w, c))))
        self.model = build_model(cfg, device="cpu")
        self.model.load_state_dict(params_from_flax(self.variables, cfg), strict=True)
        prior = jax_prior_for(jax_cfg)
        n_upper = cfg.n_stochastic - 1

        def forward(variables, x, eps):
            q = jm.apply(variables, x, method=lambda m, x: m.encoder(x))
            z = q.loc + q.scale * eps[0]
            Qs = [JaxDT(q, z, axes=(-1,))]
            for i in range(n_upper):
                q = jm.apply(variables, z, method=lambda m, z, i=i: m.mlp_encoders[i](z))
                z = q.loc + q.scale * eps[i + 1]
                Qs.append(JaxDT(q, z, axes=(-1,)))
            Ps = tuple(JaxDT(jm.apply(variables, Qs[i + 1].z,
                                      method=lambda m, z, i=i: m.mlp_decoders[i](z)),
                             None, axes=(-1,)) for i in range(n_upper))
            pxz = jm.apply(variables, Qs[0].z, method=lambda m, z: m.decoder(z))
            return tuple(Qs), Ps, JaxDT(pxz, None, axes=pxz.event_axes)

        def loss(variables, x, eps):
            return jax_compute_loss(prior, *forward(variables, x, eps), x)

        def stats(variables, x, eps):
            Qs, Ps, pxz = forward(variables, x, eps)
            return ([(t.dist.loc, t.dist.scale, t.z) for t in Qs],
                    [(t.dist.loc, t.dist.scale) for t in Ps],
                    (pxz.dist.loc, pxz.dist.logscale), loss(variables, x, eps))

        self.jax_stats = jax.jit(stats)
        self.jax_loss_and_grad = jax.jit(jax.value_and_grad(lambda v, x, e: loss(v, x, e)[0]))

    def inputs(self, rng, batch, k):
        h, w, c = self.cfg.image_shape
        images = rng.integers(0, 256, (batch, h, w, c)).astype(np.uint8)
        images[0] = 0  # all black: every sub-pixel on the left edge bin
        images.reshape(-1)[-2:] = (0, 255)
        eps = [rng.standard_normal((k, batch, n)).astype(np.float32)
               for n in self.cfg.latents()]
        return images.astype(np.float32) / 255.0, eps

    def port_loss_and_grads(self, x, eps, cfg=None, beta=1.0):
        cfg = cfg or self.cfg
        params = dict(self.model.named_parameters())
        loss, metrics = training_loss_fn(
            self.model, experiment("model03", model=cfg), prior_for(cfg), torch.from_numpy(x),
            eps[0].shape[0], beta=beta, eps=[torch.from_numpy(e) for e in eps])(params)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), {n: g.numpy() for n, g in zip(params, grads)}, metrics

    def jax_noise(self, rng, k, batch):
        """The standard-normal draws the JAX model makes from its "sample"
        stream ``rng``: one ``make_rng`` per stochastic layer, bottom up."""
        n_layers = self.cfg.n_stochastic
        keys = self.jm.apply(self.variables, rngs={"sample": rng},
                             method=lambda m: [m.make_rng("sample") for _ in range(n_layers)])
        return [np.array(jax.random.normal(key, (k, batch, n)))
                for key, n in zip(keys, self.cfg.latents())]

    def objective_both(self, x, k, objective, free_bits=0.0, beta=1.0, seed=11):
        """JAX's own ``training_loss_fn`` for ``objective`` against the
        port's, on the noise JAX draws from its "sample" stream."""
        jcfg = dataclasses.replace(self.jax_cfg, objective=objective, free_bits=free_bits)
        rng = jax.random.PRNGKey(seed)
        jloss_fn = jax_training_loss_fn(self.jm, jax_experiment("model03", model=jcfg),
                                        jax_prior_for(jcfg), jnp.asarray(x), k, rng, beta)
        (loss, _), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(self.variables)
        want = {name: t.numpy() for name, t in params_from_flax(grads, self.cfg).items()}
        eps = self.jax_noise(rng, k, x.shape[0])
        # the injected draws reproduce JAX's own latents, layer by layer
        Qs = self.jm.apply(self.variables, jnp.asarray(x), k, rngs={"sample": rng})[0]
        z = None
        for q, e in zip(Qs, eps):
            np.testing.assert_allclose(np.asarray(q.z), np.asarray(q.dist.loc + q.dist.scale * e),
                                       rtol=1e-6, atol=1e-6)
            z = q.z
        assert z is not None
        cfg = dataclasses.replace(self.cfg, objective=objective, free_bits=free_bits)
        got_loss, got, _ = self.port_loss_and_grads(x, eps, cfg, beta)
        return got_loss, got, float(loss), want


_PAIRS = {}


def _pair(family):
    if family not in _PAIRS:
        if family == "model03_full":
            _PAIRS[family] = FamilyPair(JAX_MODELS["model03"], MODELS["model03"])
        else:
            # narrow model03: the JAX side goes through the Pallas kernel
            # (interpret mode on the CPU) and its jnp-vjp backward
            jax_cfg = dataclasses.replace(_narrow(jconfig, family),
                                          use_pallas=family == "model03" or None)
            _PAIRS[family] = FamilyPair(jax_cfg, _narrow(config, family), seed=3)
    return _PAIRS[family]


_RESULTS = {}


def _both(family, k):
    """(port loss, port grads, port metrics, JAX loss, JAX grads) on one
    batch of 4 with an all-black image."""
    if (family, k) not in _RESULTS:
        pair = _pair(family)
        x, eps = pair.inputs(np.random.default_rng(5 + k), batch=4, k=k)
        loss, grads = pair.jax_loss_and_grad(pair.variables, x, eps)
        want = {name: t.numpy() for name, t in params_from_flax(grads, pair.cfg).items()}
        _RESULTS[family, k] = pair.port_loss_and_grads(x, eps) + (float(loss), want)
    return _RESULTS[family, k]


# -- forward statistics -----------------------------------------------------------


@pytest.mark.parametrize("family", ["model03", "model04", "model06", "L3", "model03_full"])
def test_forward_statistics_match_jax(family):
    pair = _pair(family)
    tol = FULL_TOL if family == "model03_full" else TOL
    x, eps = pair.inputs(np.random.default_rng(0), batch=2, k=3)
    jQs, jPs, (jloc, jlogscale), (jloss, jmetrics) = pair.jax_stats(pair.variables, x, eps)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        Qs, Ps, pxz = pair.model(xt, 3, eps=[torch.from_numpy(e) for e in eps])
        loss, metrics = compute_loss(prior_for(pair.cfg), Qs, Ps, pxz, xt)
    assert len(Qs) == len(jQs) == pair.cfg.n_stochastic and len(Ps) == len(jPs) == len(Qs) - 1
    for q, (loc, scale, z) in zip(Qs, jQs):
        np.testing.assert_allclose(q.dist.loc.numpy(), np.asarray(loc), **tol)
        np.testing.assert_allclose(q.dist.scale.numpy(), np.asarray(scale), **tol)
        np.testing.assert_allclose(q.z.numpy(), np.asarray(z), **tol)
    for p, (loc, scale) in zip(Ps, jPs):
        np.testing.assert_allclose(p.dist.loc.numpy(), np.asarray(loc), **tol)
        np.testing.assert_allclose(p.dist.scale.numpy(), np.asarray(scale), **tol)
    h, w, c = pair.cfg.image_shape
    assert pxz.dist.loc.shape == pxz.dist.logscale.shape == (3, 2, h, w, c)
    np.testing.assert_allclose(pxz.dist.loc.numpy(), np.asarray(jloc), **tol)
    np.testing.assert_allclose(pxz.dist.logscale.numpy(), np.asarray(jlogscale), **tol)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics)


# -- the loss and every gradient leaf ------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("family", ["model03", "model04", "model06", "L3"])
def test_narrow_loss_and_gradients_match_jax(family, k):
    got_loss, got, _, want_loss, want = _both(family, k)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    for leaf in want:
        assert got[leaf].shape == want[leaf].shape
        assert _rel(got[leaf], want[leaf]) <= _grad_rtol(k, want_loss), leaf


_MODEL03_LEAVES = sorted(f"{part}.{layer}.{kind}" for part in ("encoder", "decoder")
                         for layer in [f"conv_{i}" for i in range(4)] + ["Dense_0"]
                         for kind in ("weight", "bias"))


@pytest.mark.parametrize("k", [1, 3])
def test_model03_loss_matches_jax(k):
    got_loss, got, _, want_loss, want = _both("model03_full", k)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want) == _MODEL03_LEAVES


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("leaf", _MODEL03_LEAVES)
def test_model03_gradient_matches_jax(k, leaf):
    _, got, _, want_loss, want = _both("model03_full", k)
    assert got[leaf].shape == want[leaf].shape
    assert _rel(got[leaf], want[leaf]) <= _grad_rtol(k, want_loss)


def test_model03_float32_gradient_is_as_accurate_as_jax():
    """The float64 rule at k = 3: against the port's own float64 gradient,
    its float32 gradient (all leaves as one vector) is at most 1.2x as far
    as JAX's float32 gradient."""
    pair = _pair("model03_full")
    _, got, _, _, want = _both("model03_full", 3)
    x, eps = pair.inputs(np.random.default_rng(5 + 3), batch=4, k=3)
    model = copy.deepcopy(pair.model).double()
    params = dict(model.named_parameters())
    prior = prior_for(pair.cfg)
    prior = dataclasses.replace(prior, loc=prior.loc.double(), scale=prior.scale.double())
    loss, _ = training_loss_fn(model, experiment("model03"), prior, torch.from_numpy(x).double(),
                               3, eps=[torch.from_numpy(e).double() for e in eps])(params)
    truth = torch.autograd.grad(loss, list(params.values()))
    flat = lambda grads: np.concatenate([np.asarray(g, np.float64).reshape(-1)  # noqa: E731
                                         for g in grads])
    truth = flat(t.numpy() for t in truth)
    err_port = np.linalg.norm(flat(got[n] for n in params) - truth)
    err_jax = np.linalg.norm(flat(want[n] for n in params) - truth)
    assert err_port <= 1.2 * err_jax + 1e-9 * np.linalg.norm(truth)
    assert err_port <= 1e-2 * np.linalg.norm(truth)


def test_narrow_model_names_its_leaves_as_flax_does():
    _, got, _, _, _ = _both("model04", 1)
    for leaf in ("encoder.glu_1.Conv_1.weight", "decoder.pre_0.bias", "decoder.glu_0.Conv_0.weight",
                 "decoder.conv_1.weight"):
        assert leaf in got
    _, got, _, _, _ = _both("model06", 1)
    for leaf in ("mlp_encoder_1.Dense_0.weight", "mlp_encoder_1.Dense_3.bias",
                 "mlp_decoder_1.Dense_2.weight"):
        assert leaf in got and np.abs(got[leaf]).max() > 0


# -- the two- and L-layer bounds ------------------------------------------------------


def test_two_layer_bound_metrics_match_jax():
    pair = _pair("model06")
    x, eps = pair.inputs(np.random.default_rng(1), batch=3, k=4)
    *_, (jloss, jmetrics) = pair.jax_stats(pair.variables, x, eps)
    _, _, metrics = pair.port_loss_and_grads(x, eps)
    assert sorted(metrics) == sorted(jmetrics) == sorted(
        ["iwae_elbo", "bpd", "lpxz", "lqz1x", "lqz2z1", "lpz2", "lpz1z2", "kl1", "kl2", "ess"])
    for name, want in jmetrics.items():
        np.testing.assert_allclose(metrics[name].detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-3, err_msg=name)


def test_hierarchical_bound_metrics_match_jax_at_three_layers():
    pair = _pair("L3")
    x, eps = pair.inputs(np.random.default_rng(2), batch=3, k=4)
    *_, (jloss, jmetrics) = pair.jax_stats(pair.variables, x, eps)
    loss, _, metrics = pair.port_loss_and_grads(x, eps)
    assert loss == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics) == ["bpd", "ess", "iwae_elbo", "kl", "lpxz"]
    assert len(metrics["kl"]) == len(jmetrics["kl"]) == 3
    for got, want in zip(metrics["kl"], jmetrics["kl"]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    for name in ("iwae_elbo", "bpd", "lpxz", "ess"):
        np.testing.assert_allclose(metrics[name].detach().numpy(), np.asarray(jmetrics[name]),
                                   rtol=1e-5, atol=1e-3, err_msg=name)


# -- DReG and free bits at two layers, against JAX's own training_loss_fn ---------------

# (objective, free_bits): 1e-3 nats stay below both layers' KLs (the floor is
# inactive), 1e6 floor both (the KL terms give no gradient)
_OBJECTIVES = [("iwae", 0.0), ("iwae_dreg", 0.0), ("elbo", 0.0), ("elbo", 1e-3), ("elbo", 1e6)]


@pytest.mark.parametrize("objective,free_bits", _OBJECTIVES)
def test_model06_training_loss_matches_jax(objective, free_bits):
    pair = _pair("model06")
    x, _ = pair.inputs(np.random.default_rng(7), batch=4, k=3)
    got_loss, got, want_loss, want = pair.objective_both(x, 3, objective, free_bits, beta=0.5)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    rtol = _grad_rtol(3, want_loss, objective)
    for leaf in want:
        if np.linalg.norm(want[leaf]) > 0:
            assert _rel(got[leaf], want[leaf]) <= rtol, leaf
        else:  # floored KLs leave the upper generative layer without gradient
            assert np.abs(got[leaf]).max() == 0, leaf


def test_dreg_keeps_the_route_from_z1_to_q2s_parameters():
    """The inference gradient with q's evaluated parameters detached
    (``stop_q_params``, right for one layer only) differs from the DReG
    gradient, which re-runs the q maps on detached weights at live latents."""
    from vae_mdl_tpu_torch.models.objective import apply, log_weights, stop_gradient_half

    pair = _pair("model06")
    x, eps = pair.inputs(np.random.default_rng(8), batch=4, k=3)
    cfg = dataclasses.replace(pair.cfg, objective="iwae_dreg")
    _, dreg, _ = pair.port_loss_and_grads(x, eps, cfg)
    params = dict(pair.model.named_parameters())
    xt, noise = torch.from_numpy(x), [torch.from_numpy(e) for e in eps]
    Qs, Ps, pxz = apply(pair.model, stop_gradient_half(params, "generative"), xt, 3, eps=noise)
    prior = prior_for(cfg)
    w = torch.softmax(log_weights(prior, Qs, Ps, pxz, xt), dim=0).detach()
    lw_cut = log_weights(prior, Qs, Ps, pxz, xt, stop_q_params=True)
    leaf = "encoder.Dense_0.weight"
    (cut,) = torch.autograd.grad(-torch.mean(torch.sum(w * w * lw_cut, dim=0)), [params[leaf]])
    assert _rel(cut.numpy(), dreg[leaf]) > 0.1


# -- a train trajectory, the evaluator, the bridges ---------------------------------------


def test_model03_three_step_loss_trajectory_matches_jax():
    """From one state (bridged weights, fresh Adam), three train steps on the
    same uint8 batches and injected noise: the port's step against JAX's
    composed loss, jax.grad and tx.update."""
    pair = FamilyPair(JAX_MODELS["model03"], MODELS["model03"], seed=11)
    ecfg = experiment("model03", model=dataclasses.replace(MODELS["model03"], n_samples=3))
    state = create_train_state(pair.model, ecfg.train)
    step = make_train_step(pair.model, ecfg, make_optimizer(ecfg.train))
    jtx = jstate.make_optimizer(jax_experiment("model03").train)
    params = jax.tree_util.tree_map(jnp.asarray, pair.variables)
    jopt = jtx.init(params)
    update = jax.jit(lambda g, s, p: jtx.update(g, s, p))

    rng = np.random.default_rng(12)
    got, want = [], []
    for _ in range(3):
        batch = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
        eps = rng.standard_normal((3, 4, 20)).astype(np.float32)
        loss, grads = pair.jax_loss_and_grad(params, batch.astype(np.float32) / 255.0, [eps])
        updates, jopt = update(grads, jopt, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
        state, metrics = step(state, torch.from_numpy(batch), eps=torch.from_numpy(eps))
        got.append(float(metrics["loss"]))
    assert state.step == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0]


def test_model06_evaluator_matches_the_jax_evaluator_on_its_noise():
    """Two k-chunks of 3 through JAX's jitted batch evaluator and through the
    port's, fed the draws JAX makes from each chunk's key."""
    pair = _pair("model06")
    images = np.random.default_rng(9).integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    jcfg = jax_experiment("model03", model=pair.jax_cfg)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jax_make_batch_evaluator(pair.jm, jcfg, n_samples=6, k_chunk=3)(
        pair.variables, jnp.asarray(images), key))
    chunk_keys = jax.random.split(jax.random.fold_in(key, 1), 2)
    per_chunk = [pair.jax_noise(k_key, 3, 3) for k_key in chunk_keys]
    eps = [torch.from_numpy(np.stack([chunk[layer] for chunk in per_chunk]))
           for layer in range(2)]
    ecfg = experiment("model03", model=pair.cfg)
    evaluator = make_batch_evaluator(pair.model, ecfg, n_samples=6, k_chunk=3)
    got = evaluator(torch.from_numpy(images), eps=eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)

    # evaluate_llh draws the same way from its per-batch generator
    _, per_image, metrics = evaluate_llh(pair.model, ecfg, images, n_samples=6, k_chunk=3,
                                         batch_size=3, seed=4)
    again = evaluator(torch.from_numpy(images),
                      torch.Generator().manual_seed(_batch_seed(4, 0))).numpy()
    assert np.isfinite(per_image).all() and metrics["batches"] == 1
    np.testing.assert_array_equal(per_image, again)


@pytest.mark.parametrize("name,n_params", [("model03", 1_023_246), ("model04", 3_354_154),
                                           ("model06", 1_055_726)])
def test_weight_bridge_round_trip_is_exact(name, n_params):
    jm = jax_build_model(JAX_MODELS[name])
    init = jax.jit(lambda rngs, x: jm.init(rngs, x, 1))
    variables = jax.tree_util.tree_map(np.asarray, init(
        {"params": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)},
        jnp.zeros((1, 32, 32, 3))))
    state = params_from_flax(variables, MODELS[name])
    assert sum(v.numel() for v in state.values()) == n_params
    build_model(MODELS[name], device="cpu").load_state_dict(state, strict=True)
    back = params_to_flax(state, MODELS[name])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("family", ["model04", "model06"])
def test_train_state_bridge_round_trips_over_the_new_leaves(family):
    """A JAX state two steps into training -> the port -> back, exactly."""
    jcfg = jax_experiment("model03", model=_narrow(jconfig, family))
    cfg = experiment("model03", model=_narrow(config, family))
    jm = jax_build_model(jcfg.model)
    h, w, c = cfg.model.image_shape
    jst = jstate.create_train_state(jm, jcfg.train, jnp.zeros((2, h, w, c)), jcfg.model.n_samples)
    step = jax_make_train_step(jm, jcfg, jstate.make_optimizer(jcfg.train), donate=False)
    batch = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, h, w, c), dtype=np.uint8))
    for _ in range(2):
        jst, _ = step(jst, batch)
    model = build_model(cfg.model, device="cpu")
    state = train_state_from_flax(jst, model, cfg, seed=7)
    assert state.step == 2 and int(state.opt_state["count"]) == 2
    leaf = "decoder.glu_1.Conv_0.weight" if family == "model04" else "mlp_decoder_1.Dense_3.weight"
    assert float(state.opt_state["nu"][leaf].abs().max()) > 0
    back = train_state_to_flax(state, cfg, like=jst)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jst)
    for u, v in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    # and the port trains on from it
    state, metrics = make_train_step(model, cfg, make_optimizer(cfg.train))(
        state, torch.from_numpy(np.array(batch)))
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))
