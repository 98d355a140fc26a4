"""The evaluator's Bernoulli binarisation against the reference's: a model
whose likelihood is a Bernoulli on dynamically binarised data (model01) is
evaluated on one fixed binarisation of each batch, drawn before any sample
noise and seen by every k-chunk (``vae_mdl_tpu/evaluation/harness.py``
``binarize_input``).

Tolerances: the port against itself is exact (the same draws, the same
float32 operations); against JAX's jitted evaluator on bridged weights, the
same binary images and the noise JAX draws from each chunk's key, rtol 1e-5
of |log w| (sums of 784 Bernoulli terms and a 100-dimensional Gaussian KL
in float32, folded over the chunks in another order) and atol 1e-3, as
tests/test_torch_families.py holds model06's evaluator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair

from vae_mdl_tpu.evaluation.harness import make_batch_evaluator as jax_make_batch_evaluator
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu_torch.data.preprocess import binarize
from vae_mdl_tpu_torch.evaluation import harness
from vae_mdl_tpu_torch.evaluation.harness import _batch_seed, evaluate_llh, make_batch_evaluator
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment

torch.set_num_threads(1)

N_SAMPLES, K_CHUNK = 6, 3  # two k-chunks


@pytest.fixture(scope="module")
def pair():
    return FamilyPair(JAX_MODELS["model01"], MODELS["model01"], seed=5)


def _images(n=3, seed=0):
    """uint8 MNIST-shaped images with every grey level, all-black and
    all-white pixels among them."""
    images = np.random.default_rng(seed).integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)
    images.reshape(-1)[:2] = (0, 255)
    return images


def _without_binarization(ecfg):
    return dataclasses.replace(ecfg, data=dataclasses.replace(ecfg.data,
                                                            dynamic_binarization=False))


def test_model01_evaluates_one_binarization_a_batch(pair):
    """The evaluator on uint8 images equals itself with the binarisation off
    fed the batch binarised by the same draw, the generator then going on to
    the sample noise; and that differs from the grey images' result."""
    ecfg = experiment("model01")
    assert ecfg.model.likelihood == "bernoulli" and ecfg.data.dynamic_binarization
    images = torch.from_numpy(_images())
    got = make_batch_evaluator(pair.model, ecfg, N_SAMPLES, K_CHUNK)(
        images, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    binary = binarize(gen, images.float() / 255.0)
    assert set(np.unique(binary.numpy())) == {0.0, 1.0}
    off = make_batch_evaluator(pair.model, _without_binarization(ecfg), N_SAMPLES, K_CHUNK)
    torch.testing.assert_close(got, off(binary, gen), rtol=0, atol=0)
    grey = off(images, torch.Generator().manual_seed(7))
    assert not torch.allclose(got, grey, rtol=1e-3)


def test_every_chunk_sees_the_same_binary_batch(pair, monkeypatch):
    seen = []
    log_weights = harness.log_weights

    def spy(prior, Qs, Ps, pxz, x):
        seen.append(x.clone())
        return log_weights(prior, Qs, Ps, pxz, x)

    monkeypatch.setattr(harness, "log_weights", spy)
    images = torch.from_numpy(_images(seed=1))
    evaluator = make_batch_evaluator(pair.model, experiment("model01"), N_SAMPLES, K_CHUNK)
    evaluator(images, torch.Generator().manual_seed(2))
    assert len(seen) == N_SAMPLES // K_CHUNK
    want = binarize(torch.Generator().manual_seed(2), images.float() / 255.0)
    for x in seen:
        assert torch.equal(x, want)


def test_evaluate_llh_draws_the_binarization_from_each_batchs_generator(pair):
    ecfg = experiment("model01")
    images = _images(n=4, seed=2)
    _, per_image, metrics = evaluate_llh(pair.model, ecfg, images, n_samples=N_SAMPLES,
                                         k_chunk=K_CHUNK, batch_size=2, seed=4)
    assert metrics["batches"] == 2
    off = make_batch_evaluator(pair.model, _without_binarization(ecfg), N_SAMPLES, K_CHUNK)
    for index in range(2):
        gen = torch.Generator().manual_seed(_batch_seed(4, index))
        batch = torch.from_numpy(images[2 * index:2 * index + 2]).float() / 255.0
        want = off(binarize(gen, batch), gen).numpy()
        np.testing.assert_array_equal(per_image[2 * index:2 * index + 2], want)


def test_model01_evaluator_matches_jax_on_the_same_binary_images_and_noise(pair):
    """JAX's jitted evaluator on a binary batch (its own draw leaves a binary
    image as it is) and the port's on the grey batch with the injected
    uniform draw that binarises it to that same batch, both on the noise JAX
    draws from each chunk's key."""
    grey = _images(seed=3).astype(np.float32) / 255.0
    u = np.random.default_rng(6).random(grey.shape).astype(np.float32)
    binary = (u < grey).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jcfg = jax_experiment("model01")
    assert jcfg.data.dynamic_binarization
    want = np.asarray(jax_make_batch_evaluator(pair.jm, jcfg, n_samples=N_SAMPLES,
                                               k_chunk=K_CHUNK)(
        pair.variables, jnp.asarray(binary), key))
    chunk_keys = jax.random.split(jax.random.fold_in(key, 1), N_SAMPLES // K_CHUNK)
    per_chunk = [pair.jax_noise(k_key, K_CHUNK, grey.shape[0]) for k_key in chunk_keys]
    eps = [torch.from_numpy(np.stack([chunk[layer] for chunk in per_chunk]))
           for layer in range(len(per_chunk[0]))]
    evaluator = make_batch_evaluator(pair.model, experiment("model01"), N_SAMPLES, K_CHUNK)
    got = evaluator(torch.from_numpy(grey), eps=eps, u=torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # the same binary batch injected directly is its own binarisation
    again = evaluator(torch.from_numpy(binary), eps=eps, u=torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, again)
    # without the draw the grey images give another bound
    grey_bound = make_batch_evaluator(
        pair.model, _without_binarization(experiment("model01")), N_SAMPLES, K_CHUNK)(
        torch.from_numpy(grey), eps=eps).numpy()
    assert not np.allclose(grey_bound, want, rtol=1e-3)
