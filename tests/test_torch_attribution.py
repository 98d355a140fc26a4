"""The attribution probes (``probes/prod_attribution.py``,
``ablation_attribution.py``, ``eval_attribution.py``,
``biladder_ablation.py``) against their JAX scripts: the same variants with
the same configs; ``utils/timing.py``'s one ``fwd_only_step`` against the
scripts' forward-only loss on the same weights and noise; the manual 2x
upsample against ``jax.image.resize``; remat against the plain step; the
patches put back; and each probe end to end on the CPU at a tiny size.

Tolerances: configs and variant tables exactly; the forward-only loss within
rtol 1e-5 (a float32 bound of 192 pixels' MoDL terms, summed in another
order); manual2x within 1e-6 of ``jax.image.resize`` (the check of
``scripts/biladder_ablation.py``); remat's loss and gradients bit-equal to
the plain step's (the same float32 operations recomputed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair
from test_torch_model05 import _narrow
from test_torch_probes import _load

import vae_mdl_tpu.train.state as jstate
from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.models import bidirectional as jbidirectional
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.models import bidirectional, ladder
from vae_mdl_tpu_torch.models.objective import training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, latent_shapes, prior_for
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.nn import blocks
from vae_mdl_tpu_torch.probes import (
    ablation_attribution,
    biladder_ablation,
    eval_attribution,
    prod_attribution,
)
from vae_mdl_tpu_torch.train.state import create_train_state
from vae_mdl_tpu_torch.utils.timing import forward_loss, fwd_only_step, scanned_config

torch.set_num_threads(1)

TINY = dict(spc=1, n_iters=1, n_repeats=2, device="cpu", data_over={"batch_size": 2})


def _same(port_cfg, jax_cfg):
    for part in ("model", "train", "data"):
        assert dataclasses.asdict(getattr(port_cfg, part)) == \
            dataclasses.asdict(getattr(jax_cfg, part)), part


# -- the variant tables -------------------------------------------------------------


def test_prod_attribution_variants_equal_the_scripts(monkeypatch):
    """The script's ``timed`` calls, caught in order: each label and its
    arguments are the port's table."""
    script = _load("scripts/prod_attribution.py")
    calls = []

    def timed(name, **kw):
        calls.append((name, kw))
        return 10.0 + len(calls), None

    monkeypatch.setattr(script, "timed", timed)
    monkeypatch.setattr(script.bench, "setup_scanned_step",
                        lambda *a, **k: (None, None, None, jax_experiment("model05"), None))
    script.main()
    assert [name for name, _ in calls] == ["model05"] * len(prod_attribution.VARIANTS)
    assert [kw for _, kw in calls] == [setup for _, setup in prod_attribution.VARIANTS]
    assert prod_attribution.SPC == script.SPC
    assert prod_attribution.PROD_MODEL == script.PROD_MODEL


def test_ablation_attribution_variants_equal_the_scripts(monkeypatch):
    """The script's configs, caught where it builds each step, in its order:
    four variants by config, then fwd_only and fwd_only_dl."""
    script = _load("scripts/ablation_attribution.py")
    built = []
    monkeypatch.setattr(script, "build", lambda cfg: (built.append(cfg), (None, None))[1])
    monkeypatch.setattr(script, "time_step", lambda *a, **k: 10.0 + len(built))
    monkeypatch.setattr(script, "fwd_only_step", lambda cfg: None)
    script.main()
    labels = ["full", "jnp_modl", "dl_head", "k1", "fwd_only", "fwd_only_dl"]
    assert [label for label, _ in ablation_attribution.VARIANTS] == labels
    for (label, setup), jcfg in zip(ablation_attribution.VARIANTS, built):
        setup = {k: v for k, v in setup.items() if k != "fwd_only"}
        _same(scanned_config("model05", **setup), jcfg)
    assert ablation_attribution.SPC == script.SPC


def test_eval_attribution_variants_equal_the_scripts(monkeypatch):
    script = _load("scripts/eval_attribution.py")
    calls = []
    monkeypatch.setattr(script, "eval_rate",
                        lambda over, n_timed=3: (calls.append((over, n_timed)),
                                                 100.0 - 10 * len(calls))[1])
    script.main()
    assert calls == [(over, n) for _, over, n in eval_attribution.VARIANTS]
    assert (eval_attribution.BATCH, eval_attribution.K_CHUNK, eval_attribution.N_SAMPLES) == \
        (script.BATCH, script.K_CHUNK, script.N_SAMPLES)


def test_biladder_ablation_variants_equal_the_scripts(monkeypatch):
    """The script's default variants, and the configs it builds for them
    (tanhgelu, full, nearest, manual2x, f32, k1, remat, fwd_only, in its
    order of building)."""
    script = _load("scripts/biladder_ablation.py")
    built = []
    monkeypatch.setattr(script, "build", lambda cfg: (built.append(cfg), (None, None))[1])
    monkeypatch.setattr(script, "time_step", lambda *a, **k: 1.0)
    monkeypatch.setattr(script, "fwd_only_step", lambda cfg: None)
    monkeypatch.setattr(script, "BATCH", 1)  # its synthetic batch only
    script.main([])
    order = ["tanhgelu", "full", "nearest", "manual2x", "f32", "k1", "remat", "fwd_only"]
    assert sorted(order) == sorted(biladder_ablation.VARIANTS)
    for name, jcfg in zip(order, built):
        setup = {k: v for k, v in biladder_ablation._SETUP.get(name, {}).items()
                 if k != "fwd_only"}
        setup.setdefault("compute_dtype", None)
        _same(scanned_config("biladder_celeba", **setup), jcfg)
    assert biladder_ablation.SPC == script.SPC


# -- the forward-only step -------------------------------------------------------------


def test_fwd_only_loss_equals_the_scripts():
    """``prod_attribution.fwd_only_step`` of the JAX script on a narrow
    model05 against ``utils.timing.forward_loss`` on the bridged weights and
    the noise JAX draws from the state's "sample" stream."""
    script = _load("scripts/prod_attribution.py")
    pair = FamilyPair(_narrow(jconfig), _narrow(config), seed=2)
    jcfg = jax_experiment("model05", model=pair.jax_cfg)
    cfg = experiment("model05", model=pair.cfg)
    batches = np.random.default_rng(1).integers(0, 256, (1, 3, 8, 8, 3), dtype=np.uint8)
    jax_state = jstate.TrainState(params=pair.variables, opt_state=None,
                                  step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(4),
                                  best_val_loss=jnp.inf)
    _, metrics = script.fwd_only_step(jcfg)(jax_state, jnp.asarray(batches))
    key = jax_state.next_rngs("sample", "binarize", "flip")["sample"]
    eps = [torch.from_numpy(e) for e in pair.jax_noise(key, cfg.model.n_samples, 3)]
    state = create_train_state(pair.model, cfg.train)
    got = forward_loss(pair.model, cfg, state, torch.from_numpy(batches[0]), eps=eps)
    np.testing.assert_allclose(float(got), float(metrics["loss"]), rtol=1e-5)


def test_fwd_only_step_runs_the_window_without_an_update():
    cfg = experiment("model05", model=_narrow(config))
    model = build_model(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    state = create_train_state(model, cfg.train)
    before = {n: p.clone() for n, p in model.named_parameters()}
    batches = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 2, 8, 8, 3),
                                                                 dtype=np.uint8))
    state, metrics = fwd_only_step(model, cfg, 3)(state, batches)
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))
    assert not metrics["loss"].requires_grad
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name])
    with pytest.raises(ValueError, match="expected 3 batches"):
        fwd_only_step(model, cfg, 3)(state, batches[:2])


# -- biladder_ablation's patches ---------------------------------------------------------


def test_manual2x_equals_jax_bilinear_resize():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 16, 16, 3), method="bilinear"))
    got = biladder_ablation.manual_resize(torch.from_numpy(x).permute(0, 3, 1, 2), (16, 16))
    assert float(np.abs(got.permute(0, 2, 3, 1).numpy() - want).max()) < 1e-6
    assert biladder_ablation.check_manual_exact(say=lambda _: None) < 1e-6
    # on a channels-last input (the blocks' memory) the same values, in that layout
    cl = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = biladder_ablation.manual_resize(cl, (16, 16))
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, got)
    # any other size is the blocks' own resize
    odd = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(biladder_ablation.manual_resize(odd, (12, 12)),
                       blocks.upsample(odd, (12, 12)))


def _biladder_loss_and_grads(model, cfg, x, eps):
    params = dict(model.named_parameters())
    loss, _ = training_loss_fn(model, experiment("biladder_celeba", model=cfg), prior_for(cfg),
                               x, 2, eps=eps)(params)
    return loss, torch.autograd.grad(loss, list(params.values()))


def test_remat_gives_the_plain_steps_loss_and_gradients():
    cfg = dataclasses.replace(_narrow_biladder(), compute_dtype="float32")
    model = build_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gate"):
                p.fill_(0.5)  # open the rezero gates, so every branch has a gradient
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((3, 8, 8, 3)).astype(np.float32))
    eps = [torch.from_numpy(rng.standard_normal((2, 3) + s).astype(np.float32))
           for s in latent_shapes(cfg)]
    want_loss, want = _biladder_loss_and_grads(model, cfg, x, eps)
    calls = []
    real = biladder_ablation._remat_residual

    def counted(self, x):
        calls.append(1)
        return real(self, x)

    with biladder_ablation.patched("remat"):
        blocks.ResidualBlock.forward_nchw = counted  # the patch is put back all the same
        got_loss, got = _biladder_loss_and_grads(model, cfg, x, eps)
    assert calls
    assert torch.equal(got_loss, want_loss)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _narrow_biladder():
    return bidirectional.BiLadderConfig(name="narrow_biladder2", image_shape=(8, 8, 3),
                                        stem_features=8, stages=((8, 6, 1, 2), (8, 4, 1, 2)))


def _originals():
    return (blocks.upsample, blocks._activation, bidirectional._activation, ladder._activation,
            blocks.ResidualBlock.forward_nchw)


@pytest.mark.parametrize("variant", ["tanhgelu", "nearest", "manual2x", "remat"])
def test_a_patch_is_put_back_whatever_happens(variant):
    before = _originals()
    with biladder_ablation.patched(variant):
        assert _originals() != before
    assert _originals() == before
    with pytest.raises(KeyError):
        with biladder_ablation.patched(variant):
            raise KeyError("inside")
    assert _originals() == before


def test_tanhgelu_changes_the_exact_gelu_alone():
    """Under the patch a block built with the exact gelu computes the tanh
    form; the ladders' own ``gelu_tanh`` is untouched (so on
    biladder_celeba the variant is the same program as full)."""
    x = torch.linspace(-3, 3, 11)
    with biladder_ablation.patched("tanhgelu"):
        exact, tanh = blocks._activation("gelu"), bidirectional._activation("gelu_tanh")
    assert torch.equal(exact(x), torch.nn.functional.gelu(x, approximate="tanh"))
    assert torch.equal(tanh(x), torch.nn.functional.gelu(x, approximate="tanh"))
    assert jbidirectional.BiLadderConfig.activation == bidirectional.BiLadderConfig.activation \
        == "gelu_tanh"


def test_nearest_is_jax_nearest_resize():
    x = np.random.default_rng(2).standard_normal((1, 4, 4, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 8, 8, 2), method="nearest"))
    got = biladder_ablation.nearest_resize(torch.from_numpy(x).permute(0, 3, 1, 2), (8, 8))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# -- end to end on the CPU ------------------------------------------------------------------


def test_prod_and_ablation_attribution_run_on_the_cpu():
    prod = prod_attribution.run(say=lambda _: None, **TINY)
    assert set(prod) == {label for label, _ in prod_attribution.VARIANTS} | {"attribution",
                                                                             "launches"}
    assert prod["attribution"]["fwd_mfu"] is None  # no peak on the CPU
    assert all(np.isfinite(v) for k, v in prod["attribution"].items()
               if k not in ("fwd_mfu", "bwd_mfu", "session_stable"))
    abl = ablation_attribution.run(say=lambda _: None, **TINY)
    a = abl["attribution"]
    assert a["mixture_bwd_ms"] == pytest.approx(a["mixture_math_ms"] - a["mixture_fwd_ms"],
                                                abs=2e-3)
    assert abl["launches"]["full"] == {}  # no kernel runs on the CPU


def test_eval_attribution_runs_on_the_cpu():
    out = eval_attribution.run(n_samples=10, batch_size=2, k_chunk=5, n_timed=1, device="cpu",
                               say=lambda _: None)
    assert out["attribution"]["boundary_floor_s_per_batch"] is None
    assert np.isfinite(out["attribution"]["mixture_share_frac"])


def test_biladder_ablation_runs_on_the_cpu():
    out = biladder_ablation.run(("full", "nearest", "remat"), say=lambda _: None,
                                **dict(TINY, data_over={"batch_size": 1}))
    assert set(out["ms"]) == {"full", "nearest", "remat"}
    assert all(np.isfinite(v) and v > 0 for v in out["ms"].values())
    assert blocks.upsample is biladder_ablation._real_upsample
