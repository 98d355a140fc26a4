"""model05 end to end against the JAX package: same weights (bridged from
the Flax params), same injected noise, same numbers.

Tolerances: rtol/atol 1e-5 on q(z|x) and the MoDL parameters (float32
convolutions summed in different orders). Log-weights sum ~3000 per-sub-pixel
log-probs, each carrying up to ~1e-4 of float32 noise where the CDF
difference is ~2e-3 (see tests/test_torch_distributions.py), so they are
held to rtol 1e-5 of |log w| (~0.2 nats at |log w| ~ 2e4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.distributions import DistributionTuple as JaxDT
from vae_mdl_tpu.models import losses as jlosses
from vae_mdl_tpu.models.objective import log_weights as jax_log_weights
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.vae import prior_for as jax_prior_for
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.ops import math as jmath
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh, make_batch_evaluator
from vae_mdl_tpu_torch.models import losses
from vae_mdl_tpu_torch.models.objective import log_weights
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LW_TOL = dict(rtol=1e-5, atol=1e-3)


def _narrow(cfg_module):
    """8x8x3 images, convs 8/16, n_mix = 2: small enough for the Pallas
    kernel's interpret mode."""
    c = cfg_module
    return c.ModelConfig(
        name="narrow", image_shape=(8, 8, 3), n_latent=4, likelihood="mdl", n_mix=2,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(20, 3, 1, "none"))),
    )


class Pair:
    """One config on both sides: the Flax model and its params, the port's
    model with the bridged weights, and a jitted JAX forward on injected
    noise."""

    def __init__(self, jax_cfg, cfg, seed=0):
        self.jax_cfg, self.cfg = jax_cfg, cfg
        jm = jax_build_model(jax_cfg)
        h, w, c = cfg.image_shape
        init = jax.jit(lambda rngs, x: jm.init(rngs, x, 1))
        self.variables = jax.tree_util.tree_map(np.asarray, init(
            {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)},
            jnp.zeros((1, h, w, c))))
        self.model = build_model(cfg, device="cpu")
        self.model.load_state_dict(params_from_flax(self.variables, cfg))
        prior = jax_prior_for(jax_cfg)

        def forward(variables, x, eps):
            q = jm.apply(variables, x, method=lambda m, x: m.encoder(x))
            z = q.loc + q.scale * eps
            pxz = jm.apply(variables, z, method=lambda m, z: m.decoder(z))
            Qs = (JaxDT(q, z, axes=(-1,)),)
            pxz_t = JaxDT(pxz, None, axes=pxz.event_axes)
            lw = jax_log_weights(prior, Qs, (), pxz_t, x)
            loss, metrics = jlosses.iwae_loss(x, z, prior, q, pxz)
            return q.loc, q.scale, pxz.parameters, lw, loss, metrics

        self.jax_forward = jax.jit(forward)

    def inputs(self, rng, batch, k):
        h, w, c = self.cfg.image_shape
        images = rng.integers(0, 256, (batch, h, w, c)).astype(np.uint8)
        images.reshape(-1)[:2] = (0, 255)
        eps = rng.standard_normal((k, batch, self.cfg.n_latent)).astype(np.float32)
        return images, eps


@pytest.fixture(scope="module")
def model05():
    return Pair(JAX_MODELS["model05"], MODELS["model05"])


def _port_forward(pair, x, eps):
    with torch.inference_mode():
        Qs, Ps, pxz = pair.model(torch.from_numpy(x), eps.shape[0], eps=torch.from_numpy(eps))
        lw = log_weights(prior_for(pair.cfg), Qs, Ps, pxz, torch.from_numpy(x))
    return Qs[0].dist, pxz.dist, lw


def test_model05_full_width_matches_jax(model05):
    images, eps = model05.inputs(np.random.default_rng(0), batch=2, k=3)
    x = images.astype(np.float32) / 255.0
    loc, scale, params, lw, _, _ = model05.jax_forward(model05.variables, x, eps)
    q, pxz, got_lw = _port_forward(model05, x, eps)
    np.testing.assert_allclose(q.loc.numpy(), np.asarray(loc), **TOL)
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(scale), **TOL)
    assert pxz.parameters.shape == (3, 2, 32, 32, 50)
    np.testing.assert_allclose(pxz.parameters.numpy(), np.asarray(params), **TOL)
    assert got_lw.shape == (3, 2)
    np.testing.assert_allclose(got_lw.numpy(), np.asarray(lw), **LW_TOL)


def test_model05_iwae_bound_matches_jax(model05):
    images, eps = model05.inputs(np.random.default_rng(1), batch=2, k=3)
    x = images.astype(np.float32) / 255.0
    *_, loss, metrics = model05.jax_forward(model05.variables, x, eps)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        Qs, _, pxz = model05.model(xt, 3, eps=torch.from_numpy(eps))
        got_loss, got = losses.iwae_loss(xt, Qs[0].z, prior_for(model05.cfg),
                                         Qs[0].dist, pxz.dist)
    np.testing.assert_allclose(float(got_loss), float(loss), **LW_TOL)
    for name in ("iwae_elbo", "bpd", "lpxz", "lqzx", "lpz", "kl", "ess"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(metrics[name]),
                                   rtol=1e-5, atol=1e-3, err_msg=name)


def test_batch_evaluator_matches_jax_streaming(model05):
    """Two k-chunks of 3 through the port's evaluator and through JAX's
    streaming logmeanexp, on the same uint8 batch and noise."""
    rng = np.random.default_rng(2)
    images, _ = model05.inputs(rng, batch=2, k=3)
    eps = rng.standard_normal((2, 3, 2, 20)).astype(np.float32)
    x = images.astype(np.float32) / 255.0
    state = jmath.streaming_logmeanexp_init((2,))
    for chunk in eps:
        lw = model05.jax_forward(model05.variables, x, chunk)[3]
        state = jmath.streaming_logmeanexp_update(state, lw, axis=0)
    want = np.asarray(jmath.streaming_logmeanexp_finalize(state))

    evaluator = make_batch_evaluator(model05.model, experiment("model05"),
                                     n_samples=6, k_chunk=3)
    got = evaluator(torch.from_numpy(images), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), want, **LW_TOL)


def test_narrow_model_matches_jax_through_the_pallas_kernel():
    """The JAX side takes the Pallas MoDL kernel (interpret mode on CPU)."""
    jax_cfg = dataclasses.replace(_narrow(jconfig), use_pallas=True)
    pair = Pair(jax_cfg, _narrow(config), seed=5)
    images, eps = pair.inputs(np.random.default_rng(3), batch=2, k=3)
    x = images.astype(np.float32) / 255.0
    loc, scale, params, lw, _, _ = pair.jax_forward(pair.variables, x, eps)
    q, pxz, got_lw = _port_forward(pair, x, eps)
    np.testing.assert_allclose(q.loc.numpy(), np.asarray(loc), **TOL)
    np.testing.assert_allclose(pxz.parameters.numpy(), np.asarray(params), **TOL)
    np.testing.assert_allclose(got_lw.numpy(), np.asarray(lw), **LW_TOL)


def _noise_free(cfg):
    """A model whose log-weight does not depend on the noise: q(z|x) is
    N(0, 1), the prior, and the decoder ignores z, so log w = log p(x | .)
    is one number per image."""
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.encoder.Dense_0.weight.zero_()
        model.encoder.Dense_0.bias.zero_()
        model.encoder.Dense_0.bias[cfg.n_latent:] = float(np.log(np.e - 1.0))
        model.decoder.Dense_0.weight.zero_()
        model.decoder.Dense_0.bias.normal_(generator=torch.Generator().manual_seed(1))
    return model


def test_evaluate_llh_padded_tail_equals_unpadded_batches():
    cfg = _narrow(config)
    ecfg = config.ExperimentConfig(model=cfg)
    model = _noise_free(cfg)
    images = np.random.default_rng(4).integers(0, 256, (5, 8, 8, 3)).astype(np.uint8)
    mean, tail_run, metrics = evaluate_llh(model, ecfg, images, n_samples=4, k_chunk=2,
                                           batch_size=2)
    _, one_batch, _ = evaluate_llh(model, ecfg, images, n_samples=4, k_chunk=2,
                                   batch_size=5)
    assert metrics["batches"] == 3
    assert len(set(np.round(one_batch, 3))) == 5  # the images are told apart
    np.testing.assert_allclose(tail_run, one_batch, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(mean, one_batch.mean(dtype=np.float64), rtol=1e-6)
    assert metrics["bpd"] == pytest.approx(-mean / (np.log(2.0) * 8 * 8 * 3))


def test_evaluate_llh_is_deterministic_per_seed():
    cfg = _narrow(config)
    ecfg = config.ExperimentConfig(model=cfg)
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    images = np.random.default_rng(5).integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    run = [evaluate_llh(model, ecfg, images, n_samples=4, k_chunk=2, batch_size=2,
                        seed=s)[1] for s in (7, 7, 8)]
    assert np.isfinite(run[0]).all()
    assert np.array_equal(run[0], run[1])
    assert not np.array_equal(run[0], run[2])


def test_bf16_config_runs_the_body_in_bf16_and_the_likelihood_in_f32(model05):
    """compute_dtype and likelihood_io_dtype "bfloat16": the boundary tensor
    is bf16, and the log-weights stay within bf16 rounding of the f32
    config's (relative 1e-3)."""
    cfg = dataclasses.replace(MODELS["model05"], compute_dtype="bfloat16",
                              likelihood_io_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(model05.model.state_dict())
    images, eps = model05.inputs(np.random.default_rng(6), batch=2, k=3)
    x = torch.from_numpy(images.astype(np.float32) / 255.0)
    with torch.inference_mode():
        Qs, Ps, pxz = model(x, 3, eps=torch.from_numpy(eps))
        assert pxz.dist.parameters.dtype == torch.bfloat16
        lw = log_weights(prior_for(cfg), Qs, Ps, pxz, x)
    _, _, want = _port_forward(model05, x.numpy(), eps)
    assert lw.dtype == torch.float32
    np.testing.assert_allclose(lw.numpy(), want.numpy(), rtol=1e-3)
