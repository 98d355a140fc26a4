"""The PSIS k-hat diagnostic and the convergence curve against the JAX
package: the numpy fit, the streaming top-M carry, the evaluator's extras
and ``evaluate_llh``'s metrics, on the same weights and the same noise.

Tolerances:
- the numpy functions are copies on the same float64 inputs: exact;
- ``top_lw_update``: the same float32 values sorted: exact (the order of
  ties may differ, the sorted values may not);
- the evaluator's ``llh``, ``top_lw`` and ``curve`` on JAX's noise: rtol
  1e-5 of |log w| (float32 sums of ~800-3000 per-pixel terms and a Gaussian
  KL, taken in another order), atol 1e-3, as the families' evaluator tests;
- per-image k-hat from log-weights that agree that closely: 1e-3 absolute
  (a weight exp(lw - max) moves by the log-weight's error relatively);
- the ``params=`` path and the extras leave the llh bit for bit as it is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair

from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.evaluation import psis as jpsis
from vae_mdl_tpu.evaluation.harness import evaluate_llh as jax_evaluate_llh
from vae_mdl_tpu.evaluation.harness import make_batch_evaluator as jax_make_batch_evaluator
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.evaluation import harness, psis
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh, make_batch_evaluator
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment

torch.set_num_threads(1)

N_SAMPLES, K_CHUNK = 60, 20  # three chunks; tail_size(60) = 12


def _narrow_mdl(c):
    """A model05-shaped MoDL VAE at 8x8 (either package's config module)."""
    return c.ModelConfig(
        name="model05", image_shape=(8, 8, 3), n_latent=4, likelihood="mdl", n_mix=2,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(20, 3, 1, "none"))),
    )


@pytest.fixture(scope="module")
def pairs():
    return {"model01": FamilyPair(JAX_MODELS["model01"], MODELS["model01"], seed=5),
            "model05": FamilyPair(_narrow_mdl(jconfig), _narrow_mdl(config), seed=6)}


def _cfgs(name):
    return jax_experiment(name), experiment(name)


def _images(pair, n, seed):
    h, w, c = pair.cfg.image_shape
    images = np.random.default_rng(seed).integers(0, 256, (n, h, w, c)).astype(np.uint8)
    images[0] = 0
    return images


# -- the numpy half ------------------------------------------------------------


def test_tail_size_matches_jax():
    for n in (1, 24, 25, 60, 100, 224, 225, 1000, 5000, 10_000):
        assert psis.tail_size(n) == jpsis.tail_size(n)
    assert psis.tail_size(5000) + 1 == 213


def test_fit_gpd_khat_matches_jax():
    rng = np.random.default_rng(0)
    for shape in (0.2, 0.6, 1.1):
        x = rng.pareto(1.0 / shape, 150) + 1e-3
        assert psis.fit_gpd_khat(x) == jpsis.fit_gpd_khat(x)
    assert np.isnan(psis.fit_gpd_khat(np.array([1.0, 2.0, 0.0, 0.0])))
    assert np.isnan(jpsis.fit_gpd_khat(np.array([1.0, 2.0, 0.0, 0.0])))


def test_khat_from_log_weights_match_jax():
    rng = np.random.default_rng(1)
    lw = rng.standard_normal((1000, 6)) * np.array([0.1, 1.0, 3.0, 10.0, 0.0, 400.0])
    lw[:, 4] = 2.5  # ties: -inf
    lw[:3, 5] = 1e4  # three dominate by ~1e4 nats: underflow, +inf
    got, want = psis.khat_from_log_weights(lw), jpsis.khat_from_log_weights(lw)
    np.testing.assert_array_equal(got, want)
    assert got[4] == -np.inf and got[5] == np.inf
    np.testing.assert_array_equal(psis.khat_from_log_weights(lw[:, 1]),
                                  jpsis.khat_from_log_weights(lw[:, 1]))
    assert np.isnan(psis.khat_from_log_weights(lw[:20])).all()
    top = np.sort(lw, axis=0)[-(psis.tail_size(1000) + 1):]
    np.testing.assert_array_equal(psis.khat_from_top_log_weights(top),
                                  jpsis.khat_from_top_log_weights(top))


# -- the streaming carry ------------------------------------------------------


def test_top_lw_update_over_fifty_chunks_matches_jax():
    """50 chunks of [100, B] with -inf entries and ties, folded from the
    -inf initial state into the [213, B] carry of a 5000-sample eval."""
    rng = np.random.default_rng(2)
    batch, m = 6, psis.tail_size(5000) + 1
    chunks = rng.standard_normal((50, 100, batch)).astype(np.float32)
    chunks = np.round(chunks * 4) / 4  # many ties
    chunks[rng.random(chunks.shape) < 0.05] = -np.inf
    chunks[:, :, 0] = -np.inf  # a column that never sees a finite weight
    chunks[:, :, 1] = 1.5  # a column of ties
    update = jax.jit(jpsis.top_lw_update)
    want = jpsis.top_lw_init((batch,), m)
    got = psis.top_lw_init((batch,), m)
    assert got.shape == (m, batch) and got.dtype == torch.float32
    assert torch.isneginf(got).all()
    for chunk in chunks:
        want = update(want, jnp.asarray(chunk))
        got = psis.top_lw_update(got, torch.from_numpy(chunk))
    assert got.shape == (m, batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isneginf(got[:, 0]).all() and (got[:, 1] == 1.5).all()


# -- the evaluator's extras -----------------------------------------------------


def _jax_chunk_noise(pair, key, batch):
    chunk_keys = jax.random.split(jax.random.fold_in(key, 1), N_SAMPLES // K_CHUNK)
    per_chunk = [pair.jax_noise(k_key, K_CHUNK, batch) for k_key in chunk_keys]
    return [torch.from_numpy(np.stack([chunk[layer] for chunk in per_chunk]))
            for layer in range(len(per_chunk[0]))]


def _jax_uniforms(key, shape):
    """JAX's binarisation draw, bernoulli(fold_in(key, 0), x) = (u < x)."""
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 0), shape)))


@pytest.mark.parametrize("name", ["model01", "model05"])
def test_batch_evaluator_extras_match_jax(pairs, name):
    pair = pairs[name]
    jcfg, cfg = _cfgs(name)
    jcfg, cfg = (dataclasses.replace(jcfg, model=pair.jax_cfg),
                 dataclasses.replace(cfg, model=pair.cfg))
    images = _images(pair, 3, seed=7)
    key = jax.random.PRNGKey(3)
    want = jax_make_batch_evaluator(pair.jm, jcfg, N_SAMPLES, K_CHUNK, with_khat=True,
                                    with_curve=True)(pair.variables, jnp.asarray(images), key)
    eps = _jax_chunk_noise(pair, key, 3)
    u = _jax_uniforms(key, images.shape)
    evaluator = make_batch_evaluator(pair.model, cfg, N_SAMPLES, K_CHUNK, with_khat=True,
                                     with_curve=True)
    llh, top, curve = evaluator(torch.from_numpy(images), eps=eps, u=u)
    assert top.shape == (psis.tail_size(N_SAMPLES) + 1, 3) and curve.shape == (3, 3)
    for a, b in zip((llh, top, curve), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)
    # the extras change nothing in the llh, and the curve ends on it
    plain = make_batch_evaluator(pair.model, cfg, N_SAMPLES, K_CHUNK)(
        torch.from_numpy(images), eps=eps, u=u)
    assert torch.equal(plain, llh) and torch.equal(curve[-1], llh)
    only_curve = make_batch_evaluator(pair.model, cfg, N_SAMPLES, K_CHUNK, with_curve=True)(
        torch.from_numpy(images), eps=eps, u=u)
    assert len(only_curve) == 2 and torch.equal(only_curve[1], curve)


def test_khat_needs_a_tail_of_five():
    with pytest.raises(ValueError, match="tail of >= 5"):
        make_batch_evaluator(None, experiment("model01"), n_samples=20, with_khat=True)


def test_evaluate_llh_khat_and_curve_match_jax_with_a_ragged_tail(pairs, monkeypatch):
    """Five images in batches of two (the last padded): the port's
    evaluate_llh fed, batch by batch, the draws JAX's evaluate_llh makes
    from its batch keys."""
    pair = pairs["model01"]
    jcfg, cfg = _cfgs("model01")
    images = _images(pair, 5, seed=8)
    _, want_per_image, want = jax_evaluate_llh(
        pair.jm, jcfg, pair.variables, images, n_samples=N_SAMPLES, k_chunk=K_CHUNK,
        batch_size=2, seed=4, progress=False, khat=True, k_curve=True)

    real = harness.make_batch_evaluator

    def injected(*args, **kwargs):
        evaluator = real(*args, **kwargs)
        index = iter(range(10))

        def with_jax_draws(batch, generator=None, params=None):
            key = jax.random.fold_in(jax.random.PRNGKey(4), next(index))
            return evaluator(batch, eps=_jax_chunk_noise(pair, key, batch.shape[0]),
                             u=_jax_uniforms(key, tuple(batch.shape)), params=params)
        return with_jax_draws

    monkeypatch.setattr(harness, "make_batch_evaluator", injected)
    mean, per_image, got = evaluate_llh(pair.model, cfg, images, n_samples=N_SAMPLES,
                                        k_chunk=K_CHUNK, batch_size=2, seed=4, khat=True,
                                        k_curve=True)
    assert got["batches"] == 3
    np.testing.assert_allclose(per_image, want_per_image, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got["khat_per_image"], want["khat_per_image"], rtol=0, atol=1e-3)
    for name in ("khat_frac_gt_07", "khat_n_underflow", "khat_n_ties"):
        assert got[name] == want[name], name
    for name in ("khat_mean", "khat_max"):
        assert got[name] == pytest.approx(want[name], abs=1e-3)
    np.testing.assert_array_equal(got["k_curve_ks"], want["k_curve_ks"])
    np.testing.assert_allclose(got["k_curve_llh"], want["k_curve_llh"], rtol=1e-5)
    assert got["k_curve_llh"][-1] == pytest.approx(mean, rel=1e-12)
    assert np.all(np.diff(got["k_curve_llh"]) > -5.0)  # no collapse along the stream


def test_evaluate_llh_extras_leave_the_llh_as_it_is(pairs):
    pair = pairs["model05"]
    cfg = dataclasses.replace(experiment("model05"), model=pair.cfg)
    images = _images(pair, 5, seed=9)
    plain = evaluate_llh(pair.model, cfg, images, N_SAMPLES, K_CHUNK, batch_size=2, seed=1)
    extra = evaluate_llh(pair.model, cfg, images, N_SAMPLES, K_CHUNK, batch_size=2, seed=1,
                         khat=True, k_curve=True)
    assert plain[0] == extra[0]
    np.testing.assert_array_equal(plain[1], extra[1])
    assert extra[2]["k_curve_llh"][-1] == pytest.approx(extra[0], rel=1e-12)
    assert extra[2]["khat_per_image"].shape == (5,)
    assert np.isfinite(extra[2]["khat_mean"])


def test_params_path_equals_the_weights_copied_into_the_model(pairs):
    """evaluate_llh(params=other weights) gives what a model holding those
    weights gives, and leaves the model's own parameters as they were."""
    pair = pairs["model05"]
    cfg = dataclasses.replace(experiment("model05"), model=pair.cfg)
    images = _images(pair, 4, seed=10)
    gen = torch.Generator().manual_seed(3)
    other = {name: p.detach() + 0.05 * torch.randn(p.shape, generator=gen)
             for name, p in pair.model.named_parameters()}
    before = {name: p.detach().clone() for name, p in pair.model.named_parameters()}
    via_params = evaluate_llh(pair.model, cfg, images, N_SAMPLES, K_CHUNK, batch_size=4,
                              seed=2, params=other, khat=True)
    for name, p in pair.model.named_parameters():
        assert torch.equal(p, before[name]), name
    copy = build_model(pair.cfg, device="cpu")
    copy.load_state_dict(other)
    copied = evaluate_llh(copy, cfg, images, N_SAMPLES, K_CHUNK, batch_size=4, seed=2,
                          khat=True)
    np.testing.assert_array_equal(via_params[1], copied[1])
    np.testing.assert_array_equal(via_params[2]["khat_per_image"],
                                  copied[2]["khat_per_image"])
    own = evaluate_llh(pair.model, cfg, images, N_SAMPLES, K_CHUNK, batch_size=4, seed=2)
    assert not np.array_equal(own[1], copied[1])
