"""The port's inference functions (models/inference.py) against the JAX
package's on the same weights (bridged from the Flax params) and JAX's own
draws.

The JAX sampler, reconstructor and encoder draw inside ``model.apply`` from
their "sample" key; the draws are rebuilt here from the same keys (one
``make_rng`` per draw, in the order the model makes them; the observation's
uniforms as ``jax.random.uniform`` / ``categorical``'s Gumbel draw them) and
injected into the port as ``noise``.

Tolerances, each with its reason: the encoder's means and every float image
within rtol/atol 1e-5 (float32 convolutions and dense layers summed in
another order); the uint8 images equal in at least 99.9% of pixels and never
more than 1 apart (a float within 1e-5 of a rounding boundary can round
either way; a MoDL draw can also pick another mixture component where two
Gumbel scores tie within 1e-5, which this rule would show as a larger
difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.models import ladder as jladder
from vae_mdl_tpu.models.inference import make_encoder_fn as jax_make_encoder_fn
from vae_mdl_tpu.models.inference import make_reconstructor as jax_make_reconstructor
from vae_mdl_tpu.models.inference import make_sampler as jax_make_sampler
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.models import ladder
from vae_mdl_tpu_torch.models.inference import (
    RECON_MC_SAMPLES,
    make_encoder_fn,
    make_reconstructor,
    make_sampler,
    reconstruct_noise,
    sample_noise,
)
from vae_mdl_tpu_torch.models.vae import build_model, latent_shapes
from vae_mdl_tpu_torch.models.zoo import MODELS
from vae_mdl_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = float(np.finfo(np.float32).tiny)


def _narrow(c, family):
    """Narrow configs of the zoo's families on 8x8 images (``c`` is either
    package's config module), and a three-stage ladder on 16x16."""
    enc = c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2)))
    if family == "ladder":
        module = jladder if c is jconfig else ladder
        return module.LadderConfig(name="narrow_ladder", image_shape=(16, 16, 3),
                                   stem_features=8,
                                   stages=((8, 6, 2, 2), (8, 4, 1, 2), (8, 4, 1, 2)))
    head, likelihood = {"model02": (6, "gaussian"), "model05": (50, "mdl"),
                        "model06": (6, "dl")}[family]
    two = family == "model06"
    return c.ModelConfig(
        name=f"narrow_{family}", image_shape=(8, 8, 3), n_latent=4, likelihood=likelihood,
        n_mix=5, n_stochastic=2 if two else 1, mlp_hidden=10, use_pallas=False,
        encoder=enc,
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(head, 3, 1, "none"))))


def _draw(shapes, seed):
    """Flax params shaped as ``shapes``: kernels glorot-uniform, biases
    U(-0.1, 0.1) (not Flax's zeros, which would hide a lost bias), rezero
    gates U(0.5, 1.5); one ``jax.random.uniform`` draw."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    sizes = [int(np.prod(leaf.shape)) for _, leaf in leaves]
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (sum(sizes),), minval=-1.0))
    out = []
    for (path, leaf), part in zip(leaves, np.split(u, np.cumsum(sizes)[:-1])):
        part = part.reshape(leaf.shape)
        name = path[-1].key
        if name == "kernel":
            taps = int(np.prod(leaf.shape[:-2]))
            part = part * np.sqrt(6.0 / (taps * (leaf.shape[-2] + leaf.shape[-1])))
        elif name == "gate":
            part = 1.0 + 0.5 * part
        else:
            part = 0.1 * part
        out.append(part.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


class Pair:
    """One config on both sides, the port's weights bridged from JAX's."""

    def __init__(self, jax_cfg, cfg, seed=0):
        self.jax_cfg, self.cfg = jax_cfg, cfg
        self.jm = jm = jax_build_model(jax_cfg)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
            jnp.zeros((1,) + tuple(cfg.image_shape)), 1))["params"]
        self.variables = {"params": _draw(shapes, seed)}
        self.model = build_model(cfg, device="cpu")
        self.model.load_state_dict(params_from_flax(self.variables, cfg), strict=True)
        self.params = dict(self.model.named_parameters())

    def keys(self, key, n):
        """The first ``n`` keys ``make_rng("sample")`` gives under ``key``."""
        return self.jm.apply(self.variables, rngs={"sample": key},
                             method=lambda m: [m.make_rng("sample") for _ in range(n)])

    def observation_uniforms(self, key, shape):
        """The uniforms JAX's observation ``sample(key, ...)`` draws for x
        samples over ``shape = sample_shape + [..., H, W]``."""
        c = self.cfg
        if c.likelihood == "mdl":
            k_logistic, k_cat = jax.random.split(key)
            return [jax.random.uniform(k_logistic, shape + (3, c.n_mix), minval=TINY, maxval=1.0),
                    jax.random.uniform(k_cat, shape + (c.n_mix,), minval=TINY, maxval=1.0)]
        channels = c.image_shape[-1]
        if c.likelihood == "bernoulli":
            return [jax.random.uniform(key, shape + (channels,))]
        if c.likelihood == "dl":
            return [jax.random.uniform(key, shape + (channels,), minval=TINY, maxval=1.0)]
        return []  # gaussian: the sampler shows the mean

    def sampler_noise(self, key, n):
        """JAX's sampler draws (``vae_mdl_tpu/models/inference.py``): z_top
        from the first half of ``key``, then the model's draws from the
        second, in ``sample_noise``'s order."""
        k_prior, k_gen = jax.random.split(key)
        shapes = latent_shapes(self.cfg)
        L = len(shapes)
        keys = self.keys(k_gen, L)
        noise = [jax.random.normal(k_prior, (n,) + tuple(shapes[-1]))]
        noise += [jax.random.normal(keys[j], (n,) + tuple(shapes[i]))
                  for j, i in enumerate(range(L - 2, -1, -1))]
        noise += self.observation_uniforms(keys[L - 1], (n,) + tuple(self.cfg.image_shape[:2]))
        return [torch.from_numpy(np.array(e)) for e in noise]

    def encoder_noise(self, key, batch):
        shapes = latent_shapes(self.cfg)
        return [torch.from_numpy(np.array(jax.random.normal(k, (1, batch) + tuple(s))))
                for k, s in zip(self.keys(key, len(shapes)), shapes)]

    def reconstructor_noise(self, key, batch):
        noise = self.encoder_noise(key, batch)
        if self.cfg.likelihood == "mdl":  # the 32-sample mean from fold_in(key, 1)
            shape = (RECON_MC_SAMPLES, 1, batch) + tuple(self.cfg.image_shape[:2])
            noise += [torch.from_numpy(np.array(u)) for u in
                      self.observation_uniforms(jax.random.fold_in(key, 1), shape)]
        return noise


_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        if name == "model01":
            _PAIRS[name] = Pair(JAX_MODELS["model01"], MODELS["model01"])
        else:
            _PAIRS[name] = Pair(_narrow(jconfig, name), _narrow(config, name), seed=3)
    return _PAIRS[name]


def _images(cfg, batch, seed=9):
    return np.random.default_rng(seed).random((batch,) + tuple(cfg.image_shape),
                                              dtype=np.float32)


NAMES = ["model01", "model02", "model05", "model06", "ladder"]


@pytest.mark.parametrize("name", NAMES)
def test_encoder_matches_jax(name):
    pair = _pair(name)
    x = _images(pair.cfg, 3)
    key = jax.random.PRNGKey(4)
    want = jax_make_encoder_fn(pair.jm)(pair.variables, key, jnp.asarray(x))
    got = make_encoder_fn(pair.model)(pair.params, None, torch.from_numpy(x),
                                      noise=pair.encoder_noise(key, 3))
    assert len(got) == len(want) == pair.cfg.n_stochastic
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_sampler_matches_jax(name):
    """The port's sampler on JAX's draws: uint8 images by the rounding rule,
    and the float images (the x sample; a Gaussian's mean) within 1e-5."""
    pair = _pair(name)
    n, key = 6, jax.random.PRNGKey(11)
    noise = pair.sampler_noise(key, n)
    assert [tuple(t.shape) for t in noise] == [s for _, s, _ in sample_noise(pair.cfg, n)]
    want = np.asarray(jax_make_sampler(pair.jm, pair.jax_cfg)(pair.variables, key, n))
    got = make_sampler(pair.model, pair.cfg)(pair.params, None, n, noise=noise).numpy()
    assert got.shape == want.shape == (n,) + tuple(pair.cfg.image_shape)
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999, (diff.max(), np.mean(diff == 0))

    # the floats behind them: JAX's generate on its own draws
    k_prior, k_gen = jax.random.split(key)
    out = pair.jm.apply(pair.variables, jnp.asarray(noise[0].numpy()), rngs={"sample": k_gen},
                        method="generate")
    L = len(latent_shapes(pair.cfg))
    obs = noise[L:]
    with torch.no_grad():
        port = pair.model.generate(noise[0], noise=noise[1:L] + [
            (tuple(obs) if len(obs) > 1 else obs[0]) if obs else None])
    if pair.cfg.likelihood == "gaussian":
        np.testing.assert_allclose(port.dist.mean().numpy(), np.asarray(out.dist.mean()), **TOL)
        assert port.x is None
    else:
        np.testing.assert_allclose(port.x.numpy(), np.asarray(out.sample), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_reconstructor_matches_jax(name):
    pair = _pair(name)
    x = _images(pair.cfg, 3, seed=2)
    key = jax.random.PRNGKey(5)
    noise = pair.reconstructor_noise(key, 3)
    assert [tuple(t.shape) for t in noise] == [s for _, s, _ in reconstruct_noise(pair.cfg, 3)]
    want = jax_make_reconstructor(pair.jm, pair.jax_cfg)(pair.variables, key, jnp.asarray(x))
    got = make_reconstructor(pair.model, pair.cfg)(pair.params, None, torch.from_numpy(x),
                                                   noise=noise)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the four tests of tests/test_inference.py, on the port ---------------------


def _zoo(name):
    cfg = MODELS[name]
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, dict(model.named_parameters())


def test_sampler_produces_uint8_images():
    cfg, model, params = _zoo("model06")
    imgs = make_sampler(model, cfg)(params, torch.Generator().manual_seed(0), 4)
    assert imgs.shape == (4,) + cfg.image_shape and imgs.dtype == torch.uint8


def test_reconstructor_and_encoder():
    cfg, model, params = _zoo("model02")
    x = torch.rand((2,) + cfg.image_shape, generator=torch.Generator().manual_seed(9))
    recon = make_reconstructor(model, cfg)(params, torch.Generator().manual_seed(0), x)
    assert recon.shape == x.shape and torch.isfinite(recon).all()
    latents = make_encoder_fn(model)(params, torch.Generator().manual_seed(0), x)
    assert latents[0].shape == (2, cfg.n_latent)


def test_sampler_spatial_ladder():
    cfg, model, params = _zoo("ladder_svhn")
    imgs = make_sampler(model, cfg)(params, torch.Generator().manual_seed(0), 2)
    assert imgs.shape == (2,) + cfg.image_shape


def test_gaussian_sampler_uses_mean_function():
    """model02's samples are the observation model's mean, not noisy draws;
    its sampler draws no x noise."""
    cfg, model, params = _zoo("model02")
    assert [kind for _, _, kind in sample_noise(cfg, 4)] == ["normal"]
    gen = torch.Generator().manual_seed(0)
    imgs = make_sampler(model, cfg)(params, gen, 4)
    z_top = torch.randn((4, cfg.latents()[-1]), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model.generate(z_top, torch.Generator().manual_seed(1))
    expected = (torch.clamp(out.dist.mean(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    assert torch.equal(imgs, expected)
    raw = (torch.clamp(out.x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    assert not torch.equal(imgs, raw)


def test_repairs_for_inference():
    """``DistributionTuple.x/p/q``, ``Normal.kl_to_standard_normal`` against
    JAX's, and ``decode``'s x sample: attached when a generator or noise is
    given, none without either."""
    from vae_mdl_tpu.distributions import Normal as JaxNormal
    from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal

    rng = np.random.default_rng(0)
    loc, scale = rng.standard_normal(7).astype(np.float32), rng.random(7).astype(np.float32) + .1
    got = Normal(torch.from_numpy(loc), torch.from_numpy(scale)).kl_to_standard_normal()
    want = JaxNormal(jnp.asarray(loc), jnp.asarray(scale)).kl_to_standard_normal()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    t = DistributionTuple("d", "s")
    assert t.x == t.z == "s" and t.p == t.q == "d"

    cfg, model, _ = _zoo("model05")
    z = torch.zeros(2, cfg.n_latent)
    with torch.no_grad():
        assert model.decode(z).x is None
        drawn = model.decode(z, torch.Generator().manual_seed(0)).x
        u = [torch.full((2, 32, 32, 3, 5), 0.5), torch.full((2, 32, 32, 5), 0.5)]
        given = model.decode(z, noise=tuple(u)).x
    assert drawn.shape == given.shape == (2, 32, 32, 3)
    assert 0.0 <= float(drawn.min()) and float(drawn.max()) <= 1.0
