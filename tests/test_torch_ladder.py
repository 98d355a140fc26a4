"""ConvLadderVAE (the family of ladder_svhn) against the JAX package: the
same weights (drawn in JAX, ``flax_params``, and bridged), the same seeded
images and the noise JAX draws from its "sample" stream, fed to the port in
its injected order (one tensor ``[k, B, h_i, w_i, c_i]`` per stochastic
layer, bottom up), at k = 3. Two stages reach ``two_layer_iwae_loss``, three
``hierarchical_iwae_loss``. The likelihood is the discretized logistic: on
the JAX side its jnp path, on the port's its plain version (the CPU);
``tests/test_torch_ladder_blocks.py`` holds a ladder's head against JAX's
Pallas kernel too. Each JAX function is jitted once with everything it
serves (forward statistics, loss, gradient, the noise), which keeps the
file's compile time to a few seconds a config.

Tolerances, as ``tests/test_torch_families.py`` states them for conv
stacks, each with its reason:
- q, p and p(x|z) parameters and the samples: rtol/atol 1e-5 (float32
  convolutions summed in different orders; measured <= 7e-7);
- the loss and the metrics: rtol 1e-5 (sums of ~3000 per-sub-pixel terms in
  float32); per-layer KLs atol 1e-4 beside it;
- parameter gradients, leaf by leaf in norm: 1e-4 without importance
  weights (k = 1, the free-bits ELBO); at k = 3 the gradient is weighted by
  softmax(log w), whose float32 spacing (6e-5 at |log w| ~ 940, the
  two-stage ladder) moves the weights by that much, so 10 spacings of the
  loss (``grad_rtol``). The three-stage ladder (|log w| ~ 3800, spacing
  2.4e-4) is compared at k = 1: at k = 3 the scalar gradient of one of its
  rezero gates, a sum that cancels to 1e-2, is 8% from a float64 run of the
  port on both sides (JAX 7.8e-2, the port 8.2e-2), 4e-3 apart, where the
  whole gradient vectors stay 4e-4 from it;
- the evaluator on the same noise: rtol 1e-5 of |log w|, atol 1e-3;
- the bridges' round trips are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_mdl_tpu.evaluation.harness import make_batch_evaluator as jax_make_batch_evaluator
from vae_mdl_tpu.models import ladder as jladder
from vae_mdl_tpu.models.objective import compute_loss as jax_compute_loss
from vae_mdl_tpu.models.objective import training_loss_fn as jax_training_loss_fn
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.vae import prior_for as jax_prior_for
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.train import state as jstate
from vae_mdl_tpu_torch.evaluation.harness import _batch_seed, evaluate_llh, make_batch_evaluator
from vae_mdl_tpu_torch.models import ladder
from vae_mdl_tpu_torch.models.objective import training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.utils.convert import (
    params_from_flax,
    params_to_flax,
    train_state_from_flax,
    train_state_to_flax,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL_K1 = 1e-4
WEIGHT_SPACINGS = 10


def grad_rtol(k, loss):
    """The per-leaf norm-relative gradient tolerance (module docstring)."""
    if k == 1:  # no importance weights
        return GRAD_NORM_RTOL_K1
    return max(GRAD_NORM_RTOL_K1, WEIGHT_SPACINGS * float(np.spacing(np.float32(abs(loss)))))


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _narrow(module, family):
    """The narrow ladders; ``module`` is either package's ``models.ladder``."""
    if family == "L2":
        return module.LadderConfig(name="narrow_ladder2", image_shape=(8, 8, 3),
                                   stem_features=8, stages=((8, 6, 1, 2), (8, 4, 1, 2)))
    return module.LadderConfig(name="narrow_ladder3", image_shape=(16, 16, 3), stem_features=8,
                               stages=((8, 6, 2, 2), (8, 4, 1, 2), (8, 4, 1, 2)))


def draw_params(shapes, seed):
    """A Flax params tree shaped as ``shapes`` (``jax.eval_shape``'s), from
    one draw of ``jax.random.uniform`` on [-1, 1): kernels glorot-uniform
    (scaled by Flax's limit sqrt(6 / (fan_in + fan_out)), taps counted in
    both fans), biases U(-0.1, 0.1) and rezero gates U(0.5, 1.5). Flax starts
    biases and gates at 0; gates at 0 leave every conv inside a residual
    branch without gradient, and biases at 0 would hide a bias the bridge
    lost."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    sizes = [int(np.prod(leaf.shape)) for _, leaf in leaves]
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (sum(sizes),), minval=-1.0))
    drawn = []
    for (path, leaf), part in zip(leaves, np.split(u, np.cumsum(sizes)[:-1])):
        part = part.reshape(leaf.shape)
        name = path[-1].key
        if name == "kernel":
            taps = int(np.prod(leaf.shape[:-2]))
            part = part * np.float32(np.sqrt(6.0 / (taps * (leaf.shape[-2] + leaf.shape[-1]))))
        elif name == "gate":
            part = np.float32(1.0) + np.float32(0.5) * part
        else:
            part = np.float32(0.1) * part
        drawn.append(part.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, drawn)


def flax_params(jm, image_shape, seed):
    """``draw_params`` in the tree ``jm.init`` makes for a model; the shapes
    come from ``jax.eval_shape``, which compiles nothing."""
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1,) + tuple(image_shape)), 1))["params"]
    return {"params": draw_params(shapes, seed)}


class LadderPair:
    """One ladder config on both sides: the Flax model with gated params,
    the port's model with the bridged weights, and JAX's forward, loss and
    gradient, jitted per k, on the noise of a "sample" key."""

    def __init__(self, jax_cfg, cfg, seed=0):
        self.jax_cfg, self.cfg = jax_cfg, cfg
        self.jm = jax_build_model(jax_cfg)
        self.variables = flax_params(self.jm, cfg.image_shape, seed)
        self.model = build_model(cfg, device="cpu")
        self.model.load_state_dict(params_from_flax(self.variables, cfg), strict=True)
        n = cfg.n_stochastic
        # the layers in the order the JAX model draws their noise: the
        # ladder bottom up, the biladder top first, then top-down
        self.draws = (tuple(range(n)) if isinstance(jax_cfg, jladder.LadderConfig)
                      else (n - 1,) + tuple(range(n - 2, -1, -1)))
        self._jitted = {}

    def jax_noise(self, variables, key, k, batch):
        """The standard-normal draws the JAX model makes from ``key``, one
        array per stochastic layer, bottom up (traceable: callers jit it
        with what it serves)."""
        keys = self.jm.apply(variables, rngs={"sample": key},
                             method=lambda m: [m.make_rng("sample") for _ in self.draws])
        eps = [None] * len(self.draws)
        shapes = self.cfg.latent_shapes()
        for layer_key, layer in zip(keys, self.draws):
            eps[layer] = jax.random.normal(layer_key, (k, batch) + shapes[layer])
        return eps

    def jax_side(self, k, batch):
        """-> jitted ``(variables, x, key) -> ((loss, (stats, metrics,
        noise)), grads)``: one compile for the forward's statistics, the
        loss, its gradient and the noise the port is given."""
        if k not in self._jitted:
            prior = jax_prior_for(self.jax_cfg)

            def fn(variables, x, key):
                Qs, Ps, pxz = self.jm.apply(variables, x, k, rngs={"sample": key})
                loss, metrics = jax_compute_loss(prior, Qs, Ps, pxz, x)
                stats = ([(q.dist.loc, q.dist.scale, q.z) for q in Qs],
                         [(p.dist.loc, p.dist.scale) for p in Ps],
                         (pxz.dist.loc, pxz.dist.logscale))
                return loss, (stats, metrics, self.jax_noise(variables, key, k, batch))

            self._jitted[k] = jax.jit(jax.value_and_grad(fn, has_aux=True))
        return self._jitted[k]

    def images(self, rng, batch):
        h, w, c = self.cfg.image_shape
        images = rng.integers(0, 256, (batch, h, w, c)).astype(np.uint8)
        images[0] = 0  # all black: every sub-pixel on the left edge bin
        images.reshape(-1)[-2:] = (0, 255)
        return images

    def port_loss_and_grads(self, x, eps, cfg=None, name="ladder_svhn"):
        cfg = cfg or self.cfg
        params = dict(self.model.named_parameters())
        loss, metrics = training_loss_fn(
            self.model, experiment(name, model=cfg), prior_for(cfg), torch.from_numpy(x),
            eps[0].shape[0], eps=[torch.from_numpy(np.array(e)) for e in eps])(params)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), {n: g.numpy() for n, g in zip(params, grads)}, metrics


_PAIRS = {}


def _pair(family):
    if family not in _PAIRS:
        _PAIRS[family] = LadderPair(_narrow(jladder, family), _narrow(ladder, family), seed=3)
    return _PAIRS[family]


_RESULTS = {}


def both(pair, k=3, batch=3, seed=5):
    """(JAX loss, stats, metrics, grads as port leaves; port loss, grads,
    metrics, forward; x) on one seeded batch with an all-black image."""
    x = pair.images(np.random.default_rng(seed + k), batch).astype(np.float32) / 255.0
    rng = jax.random.PRNGKey(seed)
    (loss, (stats, metrics, eps)), grads = pair.jax_side(k, batch)(pair.variables,
                                                                   jnp.asarray(x), rng)
    want = {name: t.numpy() for name, t in params_from_flax(grads, pair.cfg).items()}
    got_loss, got, got_metrics = pair.port_loss_and_grads(x, eps)
    with torch.no_grad():
        forward = pair.model(torch.from_numpy(x), k,
                             eps=[torch.from_numpy(np.array(e)) for e in eps])
    return dict(loss=float(loss), stats=stats, metrics=metrics, grads=want, got_loss=got_loss,
                got=got, got_metrics=got_metrics, forward=forward, x=x)


# the importance samples of each family's comparison (module docstring)
K = {"L2": 3, "L3": 1}


def _both(family):
    if family not in _RESULTS:
        _RESULTS[family] = both(_pair(family), K[family])
    return _RESULTS[family]


def assert_forward_matches(r, n_layers):
    jQs, jPs, (jloc, jlogscale) = r["stats"]
    Qs, Ps, pxz = r["forward"]
    assert len(Qs) == len(jQs) == n_layers and len(Ps) == len(jPs) == n_layers - 1
    for q, (loc, scale, z) in zip(Qs, jQs):
        np.testing.assert_allclose(q.dist.loc.numpy(), np.asarray(loc), **TOL)
        np.testing.assert_allclose(q.dist.scale.numpy(), np.asarray(scale), **TOL)
        np.testing.assert_allclose(q.z.numpy(), np.asarray(z), **TOL)
    for p, (loc, scale) in zip(Ps, jPs):
        np.testing.assert_allclose(p.dist.loc.numpy(), np.asarray(loc), **TOL)
        np.testing.assert_allclose(p.dist.scale.numpy(), np.asarray(scale), **TOL)
    np.testing.assert_allclose(pxz.dist.loc.numpy(), np.asarray(jloc), **TOL)
    np.testing.assert_allclose(pxz.dist.logscale.numpy(), np.asarray(jlogscale), **TOL)
    # the observation carries its head: on a card the DL kernel takes it whole
    assert pxz.dist._halves_of_head()


def assert_gradients_match(r, k):
    assert r["got_loss"] == pytest.approx(r["loss"], rel=LOSS_RTOL)
    got, want = r["got"], r["grads"]
    assert sorted(got) == sorted(want)  # the leaves carry Flax's names
    for leaf in want:
        assert got[leaf].shape == want[leaf].shape, leaf
        assert np.abs(want[leaf]).max() > 0, leaf  # every leaf is reached
        assert rel(got[leaf], want[leaf]) <= grad_rtol(k, r["loss"]), leaf


def assert_metrics_match(r, names):
    got, want = r["got_metrics"], r["metrics"]
    assert sorted(got) == sorted(want) == sorted(names)
    for name, value in want.items():
        if name == "kl":
            assert len(got["kl"]) == len(value)
            for a, b in zip(got["kl"], value):
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(value),
                                       rtol=1e-5, atol=1e-3, err_msg=name)


TWO_LAYER_METRICS = ["iwae_elbo", "bpd", "lpxz", "lqz1x", "lqz2z1", "lpz2", "lpz1z2", "kl1",
                     "kl2", "ess"]
L_LAYER_METRICS = ["bpd", "ess", "iwae_elbo", "kl", "lpxz"]


@pytest.mark.parametrize("family", ["L2", "L3"])
def test_forward_matches_jax(family):
    assert_forward_matches(_both(family), _pair(family).cfg.n_stochastic)


@pytest.mark.parametrize("family", ["L2", "L3"])
def test_loss_and_every_gradient_leaf_match_jax(family):
    assert_gradients_match(_both(family), K[family])


@pytest.mark.parametrize("family,names", [("L2", TWO_LAYER_METRICS), ("L3", L_LAYER_METRICS)])
def test_bound_metrics_match_jax(family, names):
    assert_metrics_match(_both(family), names)


def test_leaves_carry_the_flax_names():
    got = _both("L3")["got"]
    for leaf in ("stem.weight", "enc_0.EncoderBlock_0.ResidualBlock_0.Conv_0.weight",
                 "enc_0.EncoderBlock_0.ResidualBlock_0.shortcut.weight",
                 "enc_0.EncoderBlock_0.ResidualBlock_1.gate", "enc_0.Conv_0.bias",
                 "enc_2.EncoderBlock_0.ResidualBlock_0.Conv_3.weight",
                 "dec_0.DecoderBlock_0.ResidualBlock_1.Conv_2.weight", "dec_1.Conv_0.weight",
                 "obs_up.ResidualBlock_0.shortcut.bias", "obs_up.ResidualBlock_1.gate",
                 "obs_head.weight"):
        assert leaf in got, leaf
    # the second block keeps its width: no shortcut
    assert "enc_0.EncoderBlock_0.ResidualBlock_1.shortcut.weight" not in got


def with_fields(base, **fields):
    """-> ``like -> config``: a subclass of the config class ``base`` with
    the extra ``fields``, built from ``like``'s values. So a ladder config
    carries ``objective`` and ``free_bits``, which the ladder configs do not
    define."""
    cls = dataclasses.make_dataclass(
        f"{base.__name__}With", [(name, type(value), dataclasses.field(default=value))
                                 for name, value in fields.items()],
        bases=(base,), frozen=True)
    return lambda like: cls(**dataclasses.asdict(like), **fields)


def test_iwae_dreg_on_a_ladder_raises_as_in_jax():
    pair = _pair("L2")
    x = np.zeros((1, 8, 8, 3), np.float32)
    jcfg = with_fields(jladder.LadderConfig, objective="iwae_dreg")(pair.jax_cfg)
    with pytest.raises(ValueError, match="VAE family"):
        jax_training_loss_fn(pair.jm, jax_experiment("ladder_svhn", model=jcfg),
                             jax_prior_for(jcfg), jnp.asarray(x), 2, jax.random.PRNGKey(0), 1.0)
    cfg = with_fields(ladder.LadderConfig, objective="iwae_dreg")(pair.cfg)
    with pytest.raises(ValueError, match="VAE family"):
        training_loss_fn(pair.model, experiment("ladder_svhn", model=cfg), prior_for(cfg),
                         torch.from_numpy(x), 2)


def test_elbo_with_free_bits_matches_jax():
    """``objective`` and ``free_bits`` are read with defaults, as in JAX: a
    ladder config that carries them trains on the free-bits ELBO. The floor
    is set between the two layers' expected KLs, so that one is floored
    (its terms give no gradient: p(z_1 | z_2) gets none when it is the lower
    layer's) and the other is not."""
    pair = _pair("L2")
    x = pair.images(np.random.default_rng(7), 3).astype(np.float32) / 255.0
    rng = jax.random.PRNGKey(17)
    eps = jax.jit(lambda v: pair.jax_noise(v, rng, 3, 3))(pair.variables)
    _, _, metrics = pair.port_loss_and_grads(
        x, eps, with_fields(ladder.LadderConfig, objective="elbo", free_bits=1e-9)(pair.cfg))
    kls = sorted(float(kl.detach()) for kl in metrics["kl"])
    free_bits = float(np.sqrt(kls[0] * kls[1]))
    assert 0 < kls[0] < free_bits < kls[1]

    jcfg = with_fields(jladder.LadderConfig, objective="elbo",
                       free_bits=free_bits)(pair.jax_cfg)
    loss_fn = jax_training_loss_fn(pair.jm, jax_experiment("ladder_svhn", model=jcfg),
                                   jax_prior_for(jcfg), jnp.asarray(x), 3, rng, 1.0)
    (want_loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(pair.variables)
    want = {name: t.numpy() for name, t in params_from_flax(grads, pair.cfg).items()}
    cfg = with_fields(ladder.LadderConfig, objective="elbo", free_bits=free_bits)(pair.cfg)
    got_loss, got, metrics = pair.port_loss_and_grads(x, eps, cfg)
    assert got_loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    assert float(metrics["kl_floored_layers"]) == 1.0
    for leaf in want:
        if np.linalg.norm(want[leaf]) > 0:
            assert rel(got[leaf], want[leaf]) <= GRAD_NORM_RTOL_K1, leaf
        else:
            assert np.abs(got[leaf]).max() == 0, leaf


def evaluator_matches_jax(pair, name, batch=3, n_samples=20, k_chunk=10):
    """``n_samples`` in k-chunks through JAX's jitted batch evaluator and
    through the port's, fed the draws JAX makes from each chunk's key; then
    ``evaluate_llh`` against the evaluator on its batch generator."""
    images = pair.images(np.random.default_rng(9), batch)
    key = jax.random.PRNGKey(13)
    n_chunks = n_samples // k_chunk
    jax_llh = jax_make_batch_evaluator(pair.jm, jax_experiment(name, model=pair.jax_cfg),
                                       n_samples=n_samples, k_chunk=k_chunk)

    def run(variables, images, key):
        chunk_keys = jax.random.split(jax.random.fold_in(key, 1), n_chunks)
        noise = [pair.jax_noise(variables, k_key, k_chunk, batch) for k_key in chunk_keys]
        return jax_llh(variables, images, key), noise

    want, per_chunk = jax.jit(run)(pair.variables, jnp.asarray(images), key)
    eps = [torch.from_numpy(np.stack([np.array(chunk[layer]) for chunk in per_chunk]))
           for layer in range(pair.cfg.n_stochastic)]
    ecfg = experiment(name, model=pair.cfg)
    evaluator = make_batch_evaluator(pair.model, ecfg, n_samples=n_samples, k_chunk=k_chunk)
    got = evaluator(torch.from_numpy(images), eps=eps)
    assert got.shape == (batch,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)

    _, per_image, metrics = evaluate_llh(pair.model, ecfg, images, n_samples=n_samples,
                                         k_chunk=k_chunk, batch_size=batch, seed=4)
    again = evaluator(torch.from_numpy(images),
                      torch.Generator().manual_seed(_batch_seed(4, 0))).numpy()
    assert np.isfinite(per_image).all() and metrics["batches"] == 1
    np.testing.assert_array_equal(per_image, again)


def test_evaluator_matches_the_jax_evaluator_on_its_noise():
    evaluator_matches_jax(_pair("L2"), "ladder_svhn")


def test_generate_and_encode_shapes():
    pair = _pair("L3")
    model, cfg = pair.model, pair.cfg
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        z_top = torch.randn((2, 4) + cfg.top_latent_shape(), generator=gen)
        pxz = model.generate(z_top, gen)
        Qs = model.encode(torch.rand(4, 16, 16, 3, generator=gen), 2, gen)
    # generate attaches the x sample, drawn from the generator, as JAX's does
    assert pxz.dist.loc.shape == pxz.x.shape == (2, 4, 16, 16, 3)
    assert [tuple(q.z.shape) for q in Qs] == [(2, 4) + s for s in cfg.latent_shapes()]
    assert model.prior().loc.shape == cfg.top_latent_shape() == (2, 2, 4)


def params_round_trip(jax_cfg, cfg):
    """The zoo config's Flax tree -> the port's state_dict -> back, exactly."""
    variables = flax_params(jax_build_model(jax_cfg), cfg.image_shape, seed=3)
    state = params_from_flax(variables, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    back = params_to_flax(state, cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return state


def test_weight_bridge_round_trip_is_exact_at_full_width():
    state = params_round_trip(JAX_MODELS["ladder_svhn"], MODELS["ladder_svhn"])
    assert sum(v.numel() for v in state.values()) == 434_143
    assert state["enc_0.EncoderBlock_0.ResidualBlock_0.gate"].shape == ()


def train_state_round_trip(pair, name):
    """A JAX train state (Adam moments filled, step 7) -> the port -> back,
    exactly."""
    jcfg, ecfg = jax_experiment(name, model=pair.jax_cfg), experiment(name, model=pair.cfg)
    params = pair.variables
    tx = jstate.make_optimizer(jcfg.train)
    opt_state = tx.init(params)
    count = np.asarray(7, np.int32)

    def filled(s):  # seven steps in: Adam's moments and every count
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(count=count,
                              mu=jax.tree_util.tree_map(lambda p: np.float32(0.5) * p, params),
                              nu=jax.tree_util.tree_map(lambda p: p * p, params))
        return s._replace(count=count) if "count" in getattr(s, "_fields", ()) else s

    opt_state = tuple(filled(s) for s in opt_state)
    jst = jstate.TrainState(params=params, opt_state=opt_state, step=np.asarray(7, np.int32),
                            rng=jax.random.PRNGKey(0), best_val_loss=np.float32(3.5),
                            ema_params=None)
    state = train_state_from_flax(jst, build_model(pair.cfg, device="cpu"), ecfg)
    assert state.step == 7 and int(state.opt_state["count"]) == 7
    back = train_state_to_flax(state, ecfg, jst)
    for a, b in zip(jax.tree_util.tree_leaves((back.params, back.opt_state, back.step)),
                    jax.tree_util.tree_leaves((jst.params, jst.opt_state, jst.step))):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    return state


def test_train_state_bridge_round_trips_over_the_ladder_tree():
    state = train_state_round_trip(_pair("L2"), "ladder_svhn")
    assert state.params["obs_up.ResidualBlock_0.gate"].shape == ()
    assert state.opt_state["mu"]["obs_up.ResidualBlock_0.gate"].shape == ()
