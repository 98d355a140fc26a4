"""The ladder families' pieces against the JAX package: the five blocks
(``ResidualBlock``, ``EncoderBlock``, ``StochasticEncoderBlock``,
``DecoderBlock``, ``StochasticDecoderBlock``) on inputs with leading sample
axes ``[k, B, H, W, C]``, each on weights drawn in JAX and bridged; the
ladders' discretized-logistic head against JAX's jnp likelihood and its
Pallas kernel in interpret mode; and what the zoo, ``build_model`` and
``prior_for`` give the three ladder configs.

Tolerances:
- a block's value: rtol 1e-5, atol 1e-5 (float32 convolutions summed in
  other orders; the bilinear upsample and the average pool agree to 2.4e-7
  and exactly);
- every parameter's gradient and the input's, in norm: 1e-4, the rule
  ``tests/test_torch_families.py`` states for conv stacks without
  importance weights;
- the discretized-logistic head: the rules of tests/test_torch_dl.py and
  tests/test_torch_dl_tile.py, per element: the value within 1e-5 (1 + |v|)
  plus the rounding of the CDF difference over a 1/255-wide bin
  (4 ulp / prob), the gradient into the head within 1e-4 |g| + 1e-6 plus that
  cancellation carried through the derivative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dl import _terms, _value_tolerance
from test_torch_ladder import draw_params, rel

from vae_mdl_tpu.distributions.discretized import (
    discretized_logistic_log_prob as jax_discretized_logistic_log_prob,
)
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.nn import blocks as jblocks
from vae_mdl_tpu.ops.pallas.dl_kernel import dl_log_prob as pallas_dl_log_prob
from vae_mdl_tpu_torch.models import bidirectional, ladder, zoo
from vae_mdl_tpu_torch.models.vae import VAE, build_model, latent_shapes, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment, register_model
from vae_mdl_tpu_torch.nn import blocks
from vae_mdl_tpu_torch.ops.cuda import dl_kernel
from vae_mdl_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
LADDERS = ["ladder_svhn", "biladder_svhn", "biladder_celeba"]

# (Flax block, the port's, Flax's arguments): in 5 channels, hidden 8, out 6
# (so a shortcut), 2 residual blocks, rate 2, rezero, the ladders' tanh gelu
_ARGS = (8, 6, 2, 2, True, jnp.float32, "gelu_tanh")
_PORT_ARGS = (5, 8, 6, 2, 2, True, torch.float32, "gelu_tanh")
BLOCKS = {
    "ResidualBlock": (jblocks.ResidualBlock,
                      lambda: blocks.ResidualBlock(5, 8, 6, True, torch.float32, "gelu_tanh"),
                      (8, 6, True, jnp.float32, "gelu_tanh")),
    **{name: (getattr(jblocks, name), lambda name=name: getattr(blocks, name)(*_PORT_ARGS), _ARGS)
       for name in ("EncoderBlock", "StochasticEncoderBlock", "DecoderBlock",
                    "StochasticDecoderBlock")},
}


def _outputs(out):
    """A block's result as a tuple of arrays: the tensor, or (loc, scale)."""
    return (out.loc, out.scale) if hasattr(out, "loc") else (out,)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax_in_value_and_gradient(name):
    """On ``[k=2, B=3, 8, 8, 5]`` inputs: the value, and the gradient of a
    seeded linear functional of it into every parameter and the input."""
    jax_cls, make, args = BLOCKS[name]
    jm = jax_cls(*args)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, 8, 5)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    variables = {"params": draw_params(shapes, seed=2)}
    block = make()
    block.load_state_dict(params_from_flax(variables, None), strict=True)

    out_shapes = [o.shape for o in _outputs(jax.eval_shape(jm.apply, variables, jnp.asarray(x)))]
    gs = [rng.standard_normal(s).astype(np.float32) for s in out_shapes]

    def functional(variables, x):
        outs = _outputs(jm.apply(variables, x))
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs)), outs

    (_, want), (want_grads, want_dx) = jax.jit(jax.value_and_grad(
        functional, argnums=(0, 1), has_aux=True))(variables, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = _outputs(block(xt))
    params = dict(block.named_parameters())
    grads = torch.autograd.grad(sum(torch.sum(o * torch.from_numpy(g)) for o, g in zip(got, gs)),
                                list(params.values()) + [xt])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    want_grads = {n: t.numpy() for n, t in params_from_flax(want_grads, None).items()}
    assert sorted(want_grads) == sorted(params)
    for leaf, g in zip(params, grads):
        assert np.abs(want_grads[leaf]).max() > 0, leaf
        assert rel(g.numpy(), want_grads[leaf]) <= GRAD_RTOL, leaf
    assert rel(grads[-1].numpy(), np.asarray(want_dx)) <= GRAD_RTOL


def test_residual_block_without_rezero_or_shortcut_has_neither():
    block = blocks.ResidualBlock(6, 8, 6)
    assert sorted(dict(block.named_parameters())) == sorted(
        f"Conv_{i}.{kind}" for i in range(4) for kind in ("weight", "bias"))
    x = torch.randn(2, 3, 4, 4, 6)
    assert block(x).shape == x.shape


def _ladder_head(name="biladder_svhn", k=3, batch=2):
    """A zoo ladder's observation at initialisation on seeded images: (x,
    the DiscretizedLogistic)."""
    cfg = MODELS[name]
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    h, w, c = cfg.image_shape
    images = np.random.default_rng(3).integers(0, 256, (batch, h, w, c)).astype(np.uint8)
    images.reshape(-1)[:2] = (0, 255)
    x = torch.from_numpy(images).float() / 255.0
    with torch.no_grad():
        pxz = model(x, k, torch.Generator().manual_seed(1))[2]
    return x, pxz.dist


@pytest.mark.parametrize("name", LADDERS)
def test_the_head_reaches_the_likelihood_dense_and_channels_last(name):
    """The float32 head's output is one dense channel-minor ``[k, B, H, W,
    6]`` tensor whose halves are loc and logscale, x broadcast over k: the
    operands the DL kernels' tile path takes, forward and backward (the
    cotangent of the sum over an image's axes is expanded over them)."""
    x, dist = _ladder_head(name)
    h, w, _ = MODELS[name].image_shape
    assert dist.head.shape == (3, 2, h, w, 6) and dist.head.is_contiguous()
    assert dist._halves_of_head() and dist.head.dtype == torch.float32
    g = torch.ones(3, 2, 1, 1, 1).expand(dist.loc.shape)
    assert dl_kernel.forward_path(x, dist.loc, dist.logscale) == "tiled"
    assert dl_kernel.backward_path(x, dist.loc, dist.logscale, g) == "tiled"


def test_ladder_head_likelihood_matches_jax_and_the_pallas_kernel():
    """biladder_svhn's head at initialisation: the port's plain likelihood
    (what a CPU tensor takes) against JAX's jnp ``discretized_logistic_log_prob``
    and its Pallas kernel in interpret mode; the gradient into the head
    against ``jax.vjp`` of the kernel on the head's halves."""
    x, dist = _ladder_head()
    bins = dict(low=0.0, high=1.0, interval_width=1.0 / 255.0)
    head = dist.head.numpy()
    xn = x.numpy()
    leaf = dist.head.detach().clone().requires_grad_(True)
    got = dataclasses.replace(dist, loc=leaf[..., :3], logscale=leaf[..., 3:], head=leaf)
    got_lp = got.log_prob(x)
    g = np.random.default_rng(4).standard_normal(got_lp.shape).astype(np.float32)
    (got_grad,) = torch.autograd.grad(got_lp, leaf, torch.from_numpy(g))

    want_jnp = np.asarray(jax_discretized_logistic_log_prob(xn, head[..., :3], head[..., 3:],
                                                            **bins))
    want, vjp = jax.vjp(lambda h: pallas_dl_log_prob(xn, h[..., :3], h[..., 3:], 0.0, 1.0,
                                                     1.0 / 255.0), jnp.asarray(head))
    (want_grad,) = vjp(jnp.asarray(g))
    got_lp, want_grad = got_lp.detach().numpy(), np.asarray(want_grad)
    loc, logscale = head[..., :3], head[..., 3:]
    for value in (want_jnp, np.asarray(want)):
        assert value.shape == got_lp.shape
        assert (np.abs(got_lp - value) <= _value_tolerance(xn, loc, logscale, value,
                                                           0.0, 1.0, 1.0 / 255.0)).all()
    prob, start, stop, inv_std, edge = _terms(xn, loc, logscale, 0.0, 1.0, 1.0 / 255.0)
    cancel = np.where(edge | (prob <= 1e-5), 0.0,
                      8 * 2.0 ** -24 * (1 + np.abs(start) + np.abs(stop)) / np.maximum(prob, 1e-5))
    cancel = np.where(edge, 16 * 2.0 ** -24, cancel)
    halves = zip(np.split(got_grad.numpy(), 2, axis=-1), np.split(want_grad, 2, axis=-1),
                 (inv_std, np.abs(start) + np.abs(stop)))
    for got_half, want_half, scale in halves:
        limit = 1e-4 * np.abs(want_half) + 1e-6 + np.abs(g) * cancel * scale
        assert (np.abs(got_half - want_half) <= limit).all()


# -- the zoo, build_model and prior_for ------------------------------------------------


@pytest.mark.parametrize("name,dataset,n_updates,flip", [
    ("ladder_svhn", "svhn_cropped", 100_000, False),
    ("biladder_svhn", "svhn_cropped", 100_000, False),
    ("biladder_celeba", "celeba", 200_000, True)])
def test_experiment_entries_equal_jax(name, dataset, n_updates, flip):
    cfg, jcfg = experiment(name), jax_experiment(name)
    assert (cfg.data.dataset, cfg.train.n_updates, cfg.data.augment_flip) == (
        dataset, n_updates, flip)
    assert (jcfg.data.dataset, jcfg.train.n_updates, jcfg.data.augment_flip) == (
        dataset, n_updates, flip)
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)


@pytest.mark.parametrize("name,cls", [("ladder_svhn", ladder.ConvLadderVAE),
                                      ("biladder_svhn", bidirectional.BiLadderVAE),
                                      ("biladder_celeba", bidirectional.BiLadderVAE),
                                      ("model03", VAE)])
def test_build_model_dispatches_on_the_config_and_needs_the_card(name, cls):
    cfg = MODELS[name]
    assert type(build_model(cfg, device="cpu")) is cls
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


@pytest.mark.parametrize("name,top", [("ladder_svhn", (4, 4, 8)), ("biladder_svhn", (4, 4, 8)),
                                      ("biladder_celeba", (4, 4, 8))])
def test_prior_is_a_spatial_standard_normal_over_the_top_latent(name, top):
    cfg = MODELS[name]
    prior = prior_for(cfg, "cpu")
    assert prior.loc.shape == prior.scale.shape == top == cfg.top_latent_shape()
    assert prior.event_axes == (-1, -2, -3)
    assert torch.equal(prior.loc, torch.zeros(top)) and torch.equal(prior.scale, torch.ones(top))
    assert latent_shapes(cfg)[-1] == top and len(latent_shapes(cfg)) == cfg.n_stochastic
    assert latent_shapes(MODELS["model06"]) == ((20,), (20,))


def test_celeba_latents_run_down_to_four_by_four():
    assert MODELS["biladder_celeba"].latent_shapes() == (
        (32, 32, 32), (16, 16, 24), (8, 8, 16), (4, 4, 8))


def test_register_model_round_trips():
    cfg = dataclasses.replace(MODELS["biladder_svhn"], name="my_biladder", split_merge=False)
    register_model(cfg, dataset="celeba", n_updates=7)
    try:
        exp = experiment("my_biladder")
        assert exp.model is cfg and exp.data.dataset == "celeba" and exp.data.augment_flip
        assert exp.train.n_updates == 7
        assert type(build_model(exp.model, device="cpu")) is bidirectional.BiLadderVAE
    finally:
        for table in (zoo.MODELS, zoo._DATASETS, zoo._N_UPDATES):
            table.pop("my_biladder")
