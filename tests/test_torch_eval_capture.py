"""The evaluator's batch as one program (``evaluation/harness.py``
``BatchEvaluator``): the rule that sends a call to the eager loop or to a
CUDA graph, the key cache kept by model across evaluators, the generator
hand-over a replay makes, and the evaluator, eager here, against the JAX
package's ``make_batch_evaluator`` on its injected noise with the k-hat top
set and the curve. The captured path itself runs on the card only
(``tests/test_torch_cuda.py``, marker ``cuda``).

Tolerances:
- the evaluator's ``llh``, ``top_lw`` and ``curve`` on JAX's noise: rtol
  1e-5 of |log w| (float32 sums of ~800-3000 per-pixel terms and a Gaussian
  KL, taken in another order), atol 1e-3, as ``test_torch_psis.py``;
- the hand-over and the eager rule: the same body on the same generator
  state, held bit for bit.
"""
import dataclasses
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair

from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.evaluation.harness import make_batch_evaluator as jax_make_batch_evaluator
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.config import DataConfig, TrainConfig
from vae_mdl_tpu_torch.evaluation import harness, psis
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh, make_batch_evaluator
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.train import capture
from vae_mdl_tpu_torch.train.trainer import Trainer

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


def _cfgs(pair, name):
    jcfg, cfg = jax_experiment(name), experiment(name)
    return (dataclasses.replace(jcfg, model=pair.jax_cfg),
            dataclasses.replace(cfg, model=pair.cfg))


def _images(shape, n, seed):
    images = np.random.default_rng(seed).integers(0, 256, (n,) + tuple(shape)).astype(np.uint8)
    images[0] = 0
    return images


def _small():
    cfg = experiment("model01")
    return build_model(cfg.model, torch.Generator().manual_seed(0), device="cpu"), cfg


# -- the rule ---------------------------------------------------------------------


class _FakeGroup:
    def __init__(self, backend):
        self.backend = backend


class _FakeMesh:
    """A world of one with ``data`` and ``sample`` dims over one backend."""

    mesh_dim_names = ("data", "sample")

    def __init__(self, backend):
        self.group = _FakeGroup(backend)

    def get_coordinate(self):
        return [0, 0]

    def size(self, dim):
        return 1

    def get_group(self, name):
        return self.group


@pytest.mark.parametrize("device,backend,want", [
    ("cpu", None, False),
    ("cuda", None, True),
    ("cuda", "gloo", False),
    ("cuda", "nccl", True),
    ("cuda", "cpu:gloo,cuda:nccl", True),
    ("cpu", "gloo", False),
])
def test_the_rule_by_device_and_mesh_backend(monkeypatch, device, backend, want):
    """CPU tensors and a mesh over gloo take the eager loop; the card takes a
    graph with no mesh or a mesh whose groups carry its tensors over NCCL."""
    monkeypatch.setattr(capture.dist, "get_backend", lambda group: group.backend)
    model, cfg = _small()
    mesh = None if backend is None else _FakeMesh(backend)
    evaluator = make_batch_evaluator(model, cfg, 50, 25, mesh=mesh)
    assert evaluator.captures(types.SimpleNamespace(device=torch.device(device))) is want


def _no_capture(*args, **kwargs):
    raise AssertionError("the eager loop's calls must capture nothing")


@pytest.mark.parametrize("inject", ["eps", "u", "cpu"])
def test_cpu_and_injected_noise_take_the_eager_loop(monkeypatch, inject):
    """Injected ``eps=`` or ``u=`` take the eager body even where the rule
    would capture; CPU tensors take it by the rule. No graph is built."""
    monkeypatch.setattr(harness, "_EvalGraph", _no_capture)
    model, cfg = _small()
    evaluator = make_batch_evaluator(model, cfg, 50, 25)
    if inject != "cpu":
        monkeypatch.setattr(harness.BatchEvaluator, "captures", lambda self, batch: True)
    batch = torch.from_numpy(_images((28, 28, 1), 4, seed=1))
    gen = torch.Generator().manual_seed(3)
    noise = {}
    if inject == "eps":
        noise["eps"] = torch.randn((2, 25, 4, 100), generator=torch.Generator().manual_seed(4))
    elif inject == "u":
        noise["u"] = torch.rand((4, 28, 28, 1), generator=torch.Generator().manual_seed(4))
    got = evaluator(batch, gen, **noise)
    want = evaluator.eager(batch, torch.Generator().manual_seed(3), **noise)
    assert torch.equal(got, want)


def test_a_failed_capture_raises_and_caches_nothing(monkeypatch):
    """Where the rule captures, a capture that fails raises: nothing falls
    back to the eager loop, and the key holds no graph."""
    def fail(fn, pool, generators=()):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(harness.BatchEvaluator, "captures", lambda self, batch: True)
    monkeypatch.setattr(harness, "warm_up", lambda fn, device: None)
    monkeypatch.setattr(harness, "capture", fail)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    model, cfg = _small()
    evaluator = make_batch_evaluator(model, cfg, 50, 25)
    with pytest.raises(RuntimeError, match="capture failed"):
        evaluator(torch.from_numpy(_images((28, 28, 1), 4, seed=1)),
                  torch.Generator().manual_seed(0))
    assert evaluator.cache_size() == 0


# -- the key cache ------------------------------------------------------------------


def test_the_key_cache_counts_one_key_a_signature_and_outlives_the_evaluator():
    model, cfg = _small()
    images = _images((28, 28, 1), 10, seed=2)
    evaluate_llh(model, cfg, images, n_samples=50, k_chunk=25, batch_size=4)
    evaluator = make_batch_evaluator(model, cfg, 50, 25)
    # a batch of 4 and the padded tail of 2 -> 4: one signature
    assert evaluator.cache_size() == 1 and harness.cache_size(model) == 1
    evaluate_llh(model, cfg, images, n_samples=50, k_chunk=25, batch_size=4)
    assert evaluator.cache_size() == 1
    # params= is a key of its own; so are the extras, a setting of their own
    evaluate_llh(model, cfg, images, n_samples=50, k_chunk=25, batch_size=4,
                 params=dict(model.named_parameters()))
    evaluate_llh(model, cfg, images, n_samples=50, k_chunk=25, batch_size=4, khat=True)
    assert evaluator.cache_size() == 2 and harness.cache_size(model) == 2
    with_khat = make_batch_evaluator(model, cfg, 50, 25, with_khat=True)
    assert with_khat.cache_size() == 1
    # another batch shape under one setting: another key
    evaluator(torch.from_numpy(images[:3]), torch.Generator().manual_seed(0))
    assert evaluator.cache_size() == 3 and harness.cache_size(model) == 3
    # the effective k_chunk is the key's: 25 and 30 -> 25 are one setting
    assert make_batch_evaluator(model, cfg, 50, 30).cache_size() == 3


def test_the_cache_is_dropped_with_its_model():
    """The cache holds its model weakly and nothing in it refers back to the
    model: dropping the model drops its entry."""
    model, cfg = _small()
    evaluate_llh(model, cfg, _images((28, 28, 1), 4, seed=2), n_samples=50, k_chunk=25,
                 batch_size=4)
    assert model in harness._GRAPHS
    alive = weakref.ref(model)
    del model
    gc.collect()
    assert alive() is None


def test_clear_cache_drops_one_models_keys():
    model, cfg = _small()
    other, _ = _small()
    images = _images((28, 28, 1), 4, seed=2)
    for m in (model, other):
        evaluate_llh(m, cfg, images, n_samples=50, k_chunk=25, batch_size=4)
    harness.clear_cache(model)
    assert harness.cache_size(model) == 0 and harness.cache_size(other) == 1


def test_the_trainers_guard_reads_the_evaluation_cache(tmp_path, capsys):
    cfg = experiment("model01")
    cfg = dataclasses.replace(
        cfg, data=DataConfig(dataset="synthetic:mnist", batch_size=16, val_batch_size=32),
        train=TrainConfig(n_updates=4, eval_interval=2, report_images=False,
                          checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "tb")))
    trainer = Trainer(cfg, device="cpu")
    images = trainer.test_set[0][:8]
    evaluate_llh(trainer.model, cfg, images, n_samples=50, k_chunk=25, batch_size=4)
    trainer._check_retrace()
    assert "WARNING" not in capsys.readouterr().out
    evaluate_llh(trainer.model, cfg, images, n_samples=50, k_chunk=25, batch_size=8)
    trainer._check_retrace()
    trainer._check_retrace()
    out = capsys.readouterr().out
    assert out.count("WARNING: evaluate_llh has 2 captured variants") == 1


# -- the generator hand-over ----------------------------------------------------------


@pytest.mark.parametrize("name", ["model01", "model05"])
def test_the_hand_over_leaves_the_callers_generator_where_the_eager_loop_does(pairs, name):
    """A replay's draws: the graph's own generator takes the caller's seed
    and offset, the body draws from it, and the caller's is left at the
    offset the eager loop leaves it at; the results are the eager loop's,
    bit for bit. model01 draws the binarisation first."""
    pair = pairs[name]
    _, cfg = _cfgs(pair, name)
    evaluator = make_batch_evaluator(pair.model, cfg, N_SAMPLES, K_CHUNK, with_khat=True,
                                     with_curve=True)
    batch = torch.from_numpy(_images(pair.cfg.image_shape, 3, seed=8))
    eager_gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=eager_gen)  # a caller's generator part-way through its stream
    caller = torch.Generator().set_state(eager_gen.get_state())
    want = evaluator.eager(batch, eager_gen)

    own = torch.Generator().manual_seed(999)
    harness.hand_over(caller, own)
    got = evaluator.body(batch, own, None, None, None)
    harness.hand_over(own, caller)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(caller.get_state(), eager_gen.get_state())
    assert torch.equal(torch.rand(4, generator=caller), torch.rand(4, generator=eager_gen))


# -- against the JAX package -----------------------------------------------------------


def _jax_chunk_noise(pair, key, batch):
    chunk_keys = jax.random.split(jax.random.fold_in(key, 1), N_SAMPLES // K_CHUNK)
    per_chunk = [pair.jax_noise(k_key, K_CHUNK, batch) for k_key in chunk_keys]
    return [torch.from_numpy(np.stack([chunk[layer] for chunk in per_chunk]))
            for layer in range(len(per_chunk[0]))]


@pytest.mark.parametrize("params", [False, True])
@pytest.mark.parametrize("name", ["model01", "model05"])
def test_the_evaluator_equals_jax_with_khat_and_curve(pairs, name, params):
    """``make_batch_evaluator`` on JAX's noise and binarisation draw, with
    the k-hat top set and the curve, on the model's weights and through
    ``params=``."""
    pair = pairs[name]
    jcfg, cfg = _cfgs(pair, name)
    images = _images(pair.cfg.image_shape, 3, seed=7)
    key = jax.random.PRNGKey(4)
    want = jax_make_batch_evaluator(pair.jm, jcfg, N_SAMPLES, K_CHUNK, with_khat=True,
                                    with_curve=True)(pair.variables, jnp.asarray(images), key)
    eps = _jax_chunk_noise(pair, key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 0),
                                                     images.shape)))
    evaluator = make_batch_evaluator(pair.model, cfg, N_SAMPLES, K_CHUNK, with_khat=True,
                                     with_curve=True)
    given = {n: p.detach().clone() for n, p in pair.model.named_parameters()} if params else None
    llh, top, curve = evaluator(torch.from_numpy(images), eps=eps, u=u, params=given)
    assert top.shape == (psis.tail_size(N_SAMPLES) + 1, 3) and curve.shape == (3, 3)
    for a, b in zip((llh, top, curve), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)
    assert torch.equal(curve[-1], llh)
