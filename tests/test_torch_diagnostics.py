"""The active-units diagnostic and the distributions' means against the JAX
package, on the same weights and the same draws.

Tolerances:
- active-unit counts: equal; per-unit variances: rtol 1e-5 (posterior means
  from float32 convolutions and dense layers summed in another order, then
  float64 sums and squares); atol 1e-9 for a unit whose variance is 0 up to
  rounding;
- the means of Normal and Logistic: exact (the same values broadcast);
- the pixel MoDL's mean: the mixture component chosen from the same Gumbel
  uniforms is the same, exactly; its location, folded through the
  autoregression (tanh, multiplies and adds in float32), within one float32
  ulp of values in [0, 1] (2**-23; XLA's tanh and fused multiply-adds round
  differently from PyTorch's in the last bit, measured on 6 of 96 values);
- the MoDL's Monte-Carlo mean against the mean of its own samples under the
  same generator seed: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair, _narrow

from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.distributions import Logistic as JLogistic
from vae_mdl_tpu.distributions import Normal as JNormal
from vae_mdl_tpu.distributions import PixelMixtureDiscretizedLogistic as JPMDL
from vae_mdl_tpu.evaluation.diagnostics import active_units as jax_active_units
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.distributions import (
    Logistic,
    MixtureDiscretizedLogistic,
    Normal,
    PixelMixtureDiscretizedLogistic,
)
from vae_mdl_tpu_torch.evaluation.diagnostics import active_units
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment

torch.set_num_threads(1)

BATCH = 8
# below the paper's 0.01: at initialisation few units vary that much, and
# a count of 0 on both sides would compare nothing
THRESHOLD = 1e-4


def _two_layer_model04(c):
    return dataclasses.replace(_narrow(c, "model04"), name="model04", n_stochastic=2,
                               mlp_hidden=10)


def _narrow05(c):
    return c.ModelConfig(
        name="model05", image_shape=(8, 8, 3), n_latent=4, likelihood="mdl", n_mix=2,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(20, 3, 1, "none"))))


CASES = {
    "model01": lambda c, models: models["model01"],
    "model05": lambda c, models: _narrow05(c),
    "model04 two layers": lambda c, models: _two_layer_model04(c),
}


@pytest.mark.parametrize("case", list(CASES))
def test_active_units_match_jax(case):
    jcfg_model, cfg_model = CASES[case](jconfig, JAX_MODELS), CASES[case](config, MODELS)
    pair = FamilyPair(jcfg_model, cfg_model, seed=3)
    name = "model01" if case == "model01" else "model03"
    jcfg = dataclasses.replace(jax_experiment(name), model=jcfg_model)
    cfg = dataclasses.replace(experiment(name), model=cfg_model)
    h, w, c = cfg_model.image_shape
    images = np.random.default_rng(4).integers(0, 256, (3 * BATCH + 2, h, w, c), dtype=np.uint8)
    want = jax_active_units(pair.jm, jcfg, pair.variables, images, batch_size=BATCH, seed=5,
                            threshold=THRESHOLD)

    # batch i's draws as JAX makes them: the binarisation from fold_in(key_i,
    # 0), the latents from the "sample" stream fold_in(key_i, 1)
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(3)]
    u = [torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(k, 0),
                                                      (BATCH, h, w, c)))) for k in keys]
    eps = [[torch.from_numpy(e) for e in pair.jax_noise(jax.random.fold_in(k, 1), 1, BATCH)]
           for k in keys]
    got = active_units(pair.model, cfg, None, images, batch_size=BATCH, seed=5, device="cpu",
                       u=u, eps=eps, threshold=THRESHOLD)
    assert got["au"] == want["au"] and got["au_total"] == want["au_total"]
    assert got["n_dims"] == want["n_dims"] == list(cfg_model.latents())
    for a, b in zip(got["variance"], want["variance"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
    assert got["au_total"] > 0, "nothing to compare"

    # the model's own draws and params= run too
    own = active_units(pair.model, cfg, dict(pair.model.named_parameters()), images,
                       batch_size=BATCH, device="cpu")
    assert own["n_dims"] == got["n_dims"]


def test_active_units_errors_match_jax():
    pair = FamilyPair(_narrow05(jconfig), _narrow05(config), seed=3)
    images = np.zeros((5, 8, 8, 3), np.uint8)
    cfg = dataclasses.replace(experiment("model05"), model=pair.cfg)
    jcfg = dataclasses.replace(jax_experiment("model05"), model=pair.jax_cfg)
    for kwargs, match in ((dict(batch_size=8), "at least one full batch"),
                          (dict(batch_size=0), "batch_size must be positive")):
        with pytest.raises(ValueError, match=match):
            jax_active_units(pair.jm, jcfg, pair.variables, images, **kwargs)
        with pytest.raises(ValueError, match=match):
            active_units(pair.model, cfg, None, images, device="cpu", **kwargs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            active_units(pair.model, cfg, None, images, batch_size=4)


def test_normal_and_logistic_means_match_jax():
    rng = np.random.default_rng(0)
    loc = rng.standard_normal((3, 1, 4)).astype(np.float32)
    scale = rng.random((2, 4)).astype(np.float32) + 0.1
    for ours, theirs in ((Normal, JNormal), (Logistic, JLogistic)):
        got = ours(torch.from_numpy(loc), torch.from_numpy(scale)).mean()
        want = theirs(jnp.asarray(loc), jnp.asarray(scale)).mean()
        assert got.shape == (3, 2, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pixel_mixture_mean_matches_jax():
    """The locations of one mixture component per pixel, chosen by
    jax.random.categorical: argmax(logits + Gumbel(u)) with u uniform on
    [tiny, 1) from the same key."""
    params = np.random.default_rng(1).standard_normal((2, 4, 4, 30)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JPMDL(jnp.asarray(params)).mean(key))
    tiny = np.finfo(np.float32).tiny
    u = np.array(jax.random.uniform(key, (2, 4, 4, 3), minval=tiny, maxval=1.0))
    got = PixelMixtureDiscretizedLogistic(torch.from_numpy(params)).mean(
        noise=torch.from_numpy(u)).numpy()
    assert got.shape == (2, 4, 4, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
    mix_logits = params[..., :3]
    choice = np.argmax(mix_logits - np.log(-np.log(u)), axis=-1)
    np.testing.assert_array_equal(choice, np.asarray(jax.random.categorical(
        key, jnp.asarray(mix_logits))))
    # without a generator: seed 0, as JAX's PRNGKey(0) default
    default = PixelMixtureDiscretizedLogistic(torch.from_numpy(params)).mean()
    seeded = PixelMixtureDiscretizedLogistic(torch.from_numpy(params)).mean(
        torch.Generator().manual_seed(0))
    assert torch.equal(default, seeded)


def test_modl_mean_is_the_mean_of_its_own_samples():
    params = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 4, 4, 50)).astype(np.float32))
    dist = MixtureDiscretizedLogistic(params)
    got = dist.mean(torch.Generator().manual_seed(11), n=16)
    want = torch.mean(dist.sample(torch.Generator().manual_seed(11), (16,)), dim=0)
    assert got.shape == (2, 4, 4, 3)
    assert torch.equal(got, want)
    assert torch.equal(dist.mean(), dist.mean(torch.Generator().manual_seed(0)))
    assert ((got >= 0) & (got <= 1)).all()
