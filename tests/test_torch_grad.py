"""Gradients of the port against jax.grad: the tie rules, the MoDL backward
kernel's plain version, and model05's loss gradient leaf by leaf.

Tolerances, each with its reason:
- at a tie, exact: both sides pass 0.5 of the gradient (a power of two);
- the analytic plain backward against the Pallas ``_bwd_math`` in float64:
  rtol 1e-6, atol 1e-9 of the largest gradient. The only difference left
  is the float32 constant log(2/255) in the JAX cascade's approximation
  branch, which moves the mixture weights by ~1e-8 relative;
- the same in float32 against ``_backward_params(interpret=True)`` and
  against autograd: the ``test_pallas.py`` bounds (rtol 1e-2, atol 5e-3 per
  element) and 1e-4 in norm. Both sides evaluate a cancelling derivative
  (CDF differences over 1/255-wide bins, scaled by up to e^7), so a one-ulp
  difference in exp or sigmoid between XLA and PyTorch moves a gradient by
  up to 1e-3 relative;
- against a float64 truth, the port's float32 analytic backward is at most
  1.2x less accurate (RMS) than JAX's float32 autograd, the
  ``test_pallas.py`` rule;
- model05's loss at rtol 1e-5 (a sum of ~3000 per-pixel terms in float32).
  Its parameter gradients, leaf by leaf in norm: at k = 1 within 1e-5
  (measured 4.9e-6: float32 convolutions summed in different orders); at
  k = 3 within 2e-3 (measured 6.1e-4). There the gradient is weighted by
  softmax(log w) over the samples, and log w ~ -1.7e4 nats has a float32
  spacing of 2e-3 nats, so the two sides' weights differ by up to ~1e-3
  relative however exactly each computes;
- the narrow model (log w ~ -1e3, float32 spacing 6e-5 nats) at 1e-4 in
  norm (measured 8.5e-5 at k = 3); its DReG gradients at 5e-4 (measured
  1.9e-4 on encoder leaves): the squared weights double the weights'
  relative rounding, and the inference gradient, with no score term, is
  the smaller one. A wrong weight power (w for w^2) or the q maps re-run on
  live weights move an encoder leaf by more than 1 in norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.distributions.mixture import mixture_log_prob as jax_mixture_log_prob
from vae_mdl_tpu.distributions.mixture import split_mixture_params as jax_split
from vae_mdl_tpu.models import losses as jlosses
from vae_mdl_tpu.models.objective import training_loss_fn as jax_training_loss_fn
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.vae import prior_for as jax_prior_for
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.ops.pallas import mdl_kernel as pallas
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.distributions.continuous import softplus
from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob, split_mixture_params
from vae_mdl_tpu_torch.models import losses
from vae_mdl_tpu_torch.models.objective import training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import mdl_backward, mdl_backward_plain
from vae_mdl_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = {1: 1e-5, 3: 2e-3}
NARROW_GRAD_NORM_RTOL = 1e-4
DREG_GRAD_NORM_RTOL = 5e-4


# -- the tie rules -------------------------------------------------------------


def test_softplus_gradient_at_zero_matches_jax():
    x = np.array([-3.0, -1e-3, 0.0, 0.0, 2e-3, 4.0], np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    softplus(t).sum().backward()
    want = np.asarray(jax.grad(lambda v: jax.nn.softplus(v).sum())(jnp.asarray(x)))
    assert want[2] == 0.5
    np.testing.assert_array_equal(t.grad.numpy()[2:4], want[2:4])
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6)


def test_logscale_clamp_gradient_at_tie_matches_jax():
    """Logscales exactly at the -7 clamp (common with a bf16 boundary, whose
    spacing near -7 is 1/32), above and below it."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal((2, 3, 50)).astype(np.float32)
    p[..., 10:15] = -7.0  # the red logscales (n_mix = 5: logits, then R loc/ls/coeff)
    p[0, 0, 10:12] = (-7.5, -6.5)
    t = torch.from_numpy(p).requires_grad_(True)
    split_mixture_params(t)[1].sum().backward()
    want = np.asarray(jax.grad(lambda q: jax_split(q)[1].sum())(jnp.asarray(p)))
    assert want[1, 1, 10] == 0.5 and want[0, 0, 10] == 0.0 and want[0, 0, 11] == 1.0
    np.testing.assert_array_equal(t.grad.numpy(), want)


# -- the backward kernel's plain version ------------------------------------------


def _bwd_inputs(rng, lead, n_mix, dtype=np.float32):
    x01 = (rng.integers(0, 256, lead[1:] + (3,)) / 255.0).astype(dtype)
    x01.reshape(-1, 3)[:2] = ((0.0,), (1.0,))  # both edge bins, all channels
    p = (rng.standard_normal(lead + (10 * n_mix,)) * 2.0).astype(dtype)
    p[..., 2 * n_mix:3 * n_mix] -= 4.0  # red logscales towards the clamp
    p[..., 3 * n_mix:4 * n_mix] += 5.0 * (rng.random(lead + (n_mix,)) < 0.2)  # far locs
    g = rng.standard_normal(lead + (1,)).astype(dtype)
    return x01, p, g


def _oriented(x01, p, g):
    """[..., 3] / [..., 10n] / [..., 1] -> the Pallas tiles [3, L], [10n, L], [1, L]."""
    c = p.shape[-1]
    pt = p.reshape(-1, c).T
    xt = np.broadcast_to(x01, p.shape[:-1] + (3,)).reshape(-1, 3).T * 2.0 - 1.0
    return xt, pt, g.reshape(1, -1)


def test_plain_backward_matches_pallas_bwd_math_in_float64():
    rng = np.random.default_rng(1)
    x01, p, g = _bwd_inputs(rng, (4, 8, 8), 5, np.float64)
    got = mdl_backward_plain(torch.from_numpy(x01), torch.from_numpy(p), torch.from_numpy(g))
    assert got.dtype == torch.float64
    xt, pt, gt = _oriented(x01, p, g)
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(pallas._bwd_math(jnp.asarray(pt), jnp.asarray(xt), jnp.asarray(gt), 5))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = got.numpy().reshape(-1, 50).T
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9 * np.abs(want).max())


def _norm_rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_mix", [1, 5])
def test_plain_backward_matches_pallas_backward_in_interpret_mode(n_mix):
    rng = np.random.default_rng(2 + n_mix)
    x01, p, g = _bwd_inputs(rng, (2, 3, 4, 4), n_mix)
    want = np.asarray(pallas._backward_params(jnp.asarray(x01), jnp.asarray(p), jnp.asarray(g),
                                              interpret=True))
    got = mdl_backward(torch.from_numpy(x01), torch.from_numpy(p), torch.from_numpy(g)).numpy()
    assert got.shape == want.shape == p.shape
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=5e-3)
    assert _norm_rel(got, want) < 1e-4


def test_plain_backward_bf16_returns_bf16():
    rng = np.random.default_rng(3)
    x01, p, g = _bwd_inputs(rng, (2, 2, 3, 3), 5)
    pb = torch.from_numpy(p).bfloat16()
    got = mdl_backward_plain(torch.from_numpy(x01), pb, torch.from_numpy(g))
    want = mdl_backward_plain(torch.from_numpy(x01), pb.float(), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_plain_backward_is_as_accurate_as_jax_autograd():
    """The float64-accuracy rule of tests/test_pallas.py."""
    rng = np.random.default_rng(4)
    x01, p, g = _bwd_inputs(rng, (2, 3, 4, 4), 3)
    got = mdl_backward_plain(torch.from_numpy(x01), torch.from_numpy(p),
                             torch.from_numpy(g)).numpy().astype(np.float64)
    ref = np.asarray(jax.grad(lambda q: jnp.sum(jax_mixture_log_prob(jnp.asarray(x01), q)
                                                * jnp.asarray(g)))(jnp.asarray(p)), np.float64)
    p64 = torch.from_numpy(p.astype(np.float64)).requires_grad_(True)
    (mixture_log_prob(torch.from_numpy(x01.astype(np.float64)), p64)
     * torch.from_numpy(g.astype(np.float64))).sum().backward()
    truth = p64.grad.numpy()
    rms = lambda e: np.sqrt((e ** 2).mean())  # noqa: E731
    assert rms(got - truth) <= 1.2 * rms(ref - truth) + 1e-9
    assert _norm_rel(got, ref) < 1e-4


# -- model05's loss gradient -----------------------------------------------------


class GradPair:
    """One config on both sides with bridged weights, and the JAX IWAE loss
    and its gradient on injected noise."""

    def __init__(self, jax_cfg, cfg, seed=0, loss_name="iwae_loss"):
        self.jax_cfg, self.cfg, self.loss_name = jax_cfg, cfg, loss_name
        self.jm = jm = jax_build_model(jax_cfg)
        h, w, c = cfg.image_shape
        init = jax.jit(lambda rngs, x: jm.init(rngs, x, 1))
        self.variables = jax.tree_util.tree_map(np.asarray, init(
            {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)},
            jnp.zeros((1, h, w, c))))
        self.model = build_model(cfg, device="cpu")
        self.model.load_state_dict(params_from_flax(self.variables, cfg))
        prior = jax_prior_for(jax_cfg)

        def loss(variables, x, eps):
            q = jm.apply(variables, x, method=lambda m, x: m.encoder(x))
            z = q.loc + q.scale * eps
            pxz = jm.apply(variables, z, method=lambda m, z: m.decoder(z))
            return getattr(jlosses, loss_name)(x, z, prior, q, pxz)[0]

        self.jax_loss_and_grad = jax.jit(jax.value_and_grad(loss))

    def inputs(self, rng, batch, k):
        h, w, c = self.cfg.image_shape
        images = rng.integers(0, 256, (batch, h, w, c)).astype(np.uint8)
        images[0] = 0  # all black: at init the encoder's logstd is exactly 0
        images.reshape(-1)[-2:] = (0, 255)
        eps = rng.standard_normal((k, batch, self.cfg.n_latent)).astype(np.float32)
        return images.astype(np.float32) / 255.0, eps

    def both(self, x, eps):
        loss, grads = self.jax_loss_and_grad(self.variables, x, eps)
        want = {name: t.numpy() for name, t in params_from_flax(grads, self.cfg).items()}
        params = dict(self.model.named_parameters())
        if self.loss_name == "iwae_loss":
            ecfg = experiment("model05", model=self.cfg)
            got_loss, _ = training_loss_fn(self.model, ecfg, prior_for(self.cfg),
                                           torch.from_numpy(x), eps.shape[0],
                                           eps=torch.from_numpy(eps))(params)
        else:
            xt = torch.from_numpy(x)
            Qs, _, pxz = self.model(xt, eps.shape[0], eps=torch.from_numpy(eps))
            got_loss, _ = getattr(losses, self.loss_name)(
                xt, Qs[0].z, prior_for(self.cfg), Qs[0].dist, pxz.dist)
        grads = torch.autograd.grad(got_loss, list(params.values()))
        return float(got_loss.detach()), {n: g.numpy() for n, g in zip(params, grads)}, float(loss), want

    def objective_both(self, x, k, objective, free_bits=0.0, beta=1.0, seed=11):
        """JAX's own ``training_loss_fn`` for ``objective`` against the
        port's, on the noise JAX draws from its "sample" stream."""
        jcfg = dataclasses.replace(self.jax_cfg, objective=objective, free_bits=free_bits)
        rng = jax.random.PRNGKey(seed)
        jloss_fn = jax_training_loss_fn(self.jm, jax_experiment("model05", model=jcfg),
                                        jax_prior_for(jcfg), jnp.asarray(x), k, rng, beta)
        (loss, _), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(self.variables)
        want = {name: t.numpy() for name, t in params_from_flax(grads, self.cfg).items()}
        # the model's first draw from that stream: z_1 = loc + scale * N(key, [k, B, n])
        key = self.jm.apply(self.variables, rngs={"sample": rng},
                            method=lambda m: m.make_rng("sample"))
        eps = np.array(jax.random.normal(key, (k, x.shape[0], self.cfg.n_latent)))
        (q, z), = [(t.dist, t.z) for t in self.jm.apply(self.variables, jnp.asarray(x), k,
                                                         rngs={"sample": rng})[0]]
        np.testing.assert_allclose(np.asarray(z), np.asarray(q.loc + q.scale * eps),
                                   rtol=1e-6, atol=1e-6)

        cfg = dataclasses.replace(self.cfg, objective=objective, free_bits=free_bits)
        params = dict(self.model.named_parameters())
        got_loss, _ = training_loss_fn(self.model, experiment("model05", model=cfg),
                                       prior_for(cfg), torch.from_numpy(x), k, beta=beta,
                                       eps=torch.from_numpy(eps))(params)
        got = torch.autograd.grad(got_loss, list(params.values()))
        return (float(got_loss.detach()), {n: g.numpy() for n, g in zip(params, got)},
                float(loss), want)


_LEAVES = sorted(f"{part}.{layer}.{kind}" for part in ("encoder", "decoder")
                 for layer in [f"conv_{i}" for i in range(4)] + ["Dense_0"]
                 for kind in ("weight", "bias"))


@pytest.fixture(scope="module")
def model05_grads():
    """k -> (port loss, port grads, JAX loss, JAX grads) on one batch of 8
    with an all-black image."""
    pair = GradPair(JAX_MODELS["model05"], MODELS["model05"])
    cache = {}

    def get(k):
        if k not in cache:
            x, eps = pair.inputs(np.random.default_rng(5), batch=8, k=k)
            cache[k] = pair.both(x, eps)
        return cache[k]

    return get


@pytest.mark.parametrize("k", [1, 3])
def test_model05_loss_matches_jax(model05_grads, k):
    got_loss, got, want_loss, want = model05_grads(k)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want) == _LEAVES


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("leaf", _LEAVES)
def test_model05_gradient_matches_jax(model05_grads, k, leaf):
    _, got, _, want = model05_grads(k)
    assert got[leaf].shape == want[leaf].shape
    assert _norm_rel(got[leaf], want[leaf]) <= GRAD_NORM_RTOL[k]


def test_black_image_logstd_bias_gradient_matches_jax(model05_grads):
    """The softplus repair, end to end: with zero biases at init, the all-black
    image's logstd is exactly 0, where softplus's gradient is 0.5."""
    _, got, _, want = model05_grads(1)
    bias_logstd = slice(20, 40)
    np.testing.assert_allclose(got["encoder.Dense_0.bias"][bias_logstd],
                               want["encoder.Dense_0.bias"][bias_logstd], rtol=1e-4, atol=1e-5)


def _narrow(cfg_module):
    c = cfg_module
    return c.ModelConfig(
        name="narrow", image_shape=(8, 8, 3), n_latent=4, likelihood="mdl", n_mix=2,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(20, 3, 1, "none"))),
    )


def test_narrow_model_gradients_match_jax_through_the_pallas_backward():
    """The JAX side differentiates through the Pallas MoDL kernel (its
    backward in interpret mode on CPU)."""
    pair = GradPair(dataclasses.replace(_narrow(jconfig), use_pallas=True), _narrow(config), seed=3)
    x, eps = pair.inputs(np.random.default_rng(6), batch=3, k=2)
    got_loss, got, want_loss, want = pair.both(x, eps)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    for leaf in want:
        assert _norm_rel(got[leaf], want[leaf]) <= NARROW_GRAD_NORM_RTOL, leaf


# -- the other objectives: DReG, ELBO, free bits -----------------------------------

# (objective, free_bits): free bits of 1e-3 nats stay below the KL (the
# floor is inactive), 1e6 floor it (the KL term gives no gradient)
_OBJECTIVES = [("iwae", 0.0), ("iwae_dreg", 0.0), ("elbo", 0.0), ("elbo", 1e-3), ("elbo", 1e6)]


@pytest.fixture(scope="module")
def narrow_pair():
    return GradPair(_narrow(jconfig), _narrow(config), seed=4)


@pytest.mark.parametrize("objective,free_bits", _OBJECTIVES)
def test_narrow_training_loss_matches_jax(narrow_pair, objective, free_bits):
    """The port's ``training_loss_fn`` against JAX's on bridged weights and
    JAX's own noise, at beta 0.5: the value and every gradient leaf."""
    x, _ = narrow_pair.inputs(np.random.default_rng(7), batch=4, k=3)
    got_loss, got, want_loss, want = narrow_pair.objective_both(x, 3, objective, free_bits,
                                                                beta=0.5)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    rtol = DREG_GRAD_NORM_RTOL if objective == "iwae_dreg" else NARROW_GRAD_NORM_RTOL
    for leaf in want:
        assert _norm_rel(got[leaf], want[leaf]) <= rtol, leaf


def test_model05_dreg_gradient_matches_jax():
    """DReG at full width, k = 3, every leaf at the IWAE k = 3 tolerance."""
    pair = GradPair(JAX_MODELS["model05"], MODELS["model05"])
    x, _ = pair.inputs(np.random.default_rng(8), batch=4, k=3)
    got_loss, got, want_loss, want = pair.objective_both(x, 3, "iwae_dreg")
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want) == _LEAVES
    for leaf in want:
        assert _norm_rel(got[leaf], want[leaf]) <= GRAD_NORM_RTOL[3], leaf


def test_elbo_loss_matches_jax():
    pair = GradPair(_narrow(jconfig), _narrow(config), seed=5, loss_name="elbo_loss")
    x, eps = pair.inputs(np.random.default_rng(9), batch=3, k=2)
    got_loss, got, want_loss, want = pair.both(x, eps)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    for leaf in want:
        assert _norm_rel(got[leaf], want[leaf]) <= NARROW_GRAD_NORM_RTOL, leaf
