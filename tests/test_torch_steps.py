"""The port's train and eval steps: the semantics the JAX package's
``tests/test_train.py``, ``test_ema.py`` and ``test_objectives.py`` pin,
held on the narrow model05-family config on the CPU.

Tolerances: bit-for-bit where the two sides run the same operations in the
same order (multi-step vs single steps, resume, a loose clip, a skipped
update); rtol 1e-5 for the EMA replay (float32 recursions in another
order); 1e-4 in norm for gradients that should agree up to float32 sums
(DReG's generative half against IWAE's, free bits against the ELBO).
"""
import copy
import dataclasses
import io

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.data.preprocess import binarize, dequantize, random_flip
from vae_mdl_tpu_torch.distributions import DistributionTuple, Normal
from vae_mdl_tpu_torch.models.objective import bound_terms, log_weights, training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.state import (
    create_train_state,
    eval_params,
    global_norm,
    make_optimizer,
    tree_map,
)
from vae_mdl_tpu_torch.train.steps import (
    effective_beta,
    make_device_data_train_step,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
    update_ok,
)

torch.set_num_threads(1)

BATCH = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 8, 8, 3), dtype=np.uint8))


def _cfg(objective="iwae", free_bits=0.0, **train):
    c = config
    model = c.ModelConfig(
        name="narrow", image_shape=(8, 8, 3), n_latent=4, likelihood="mdl", n_mix=2,
        objective=objective, free_bits=free_bits,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(20, 3, 1, "none"))),
    )
    cfg = experiment("model05", model=model)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=4),
                               train=dataclasses.replace(cfg.train, **train))


def _setup(cfg, seed=0):
    model = build_model(cfg.model, torch.Generator().manual_seed(seed), device="cpu")
    return model, make_optimizer(cfg.train), create_train_state(model, cfg.train)


def _copy(state):
    return copy.deepcopy(state.state_dict())


def _assert_equal(a, b):
    tree_map(lambda u, v: torch.testing.assert_close(u, v, rtol=0, atol=0), a, b)


def _differs(a, b) -> bool:
    return any(not torch.equal(u, v) for u, v in zip(a.values(), b.values()))


# -- preprocessing --------------------------------------------------------------


def test_dequantize_binarize_and_flip():
    x = dequantize(BATCH)
    assert x.dtype == torch.float32 and float(x.max()) <= 1.0
    torch.testing.assert_close(x * 255.0, BATCH.float(), rtol=0, atol=1e-4)
    probs = torch.full((2000,), 0.3)
    draws = binarize(torch.Generator().manual_seed(0), probs)
    assert set(draws.unique().tolist()) <= {0.0, 1.0} and abs(float(draws.mean()) - 0.3) < 0.05
    assert torch.equal(draws, binarize(torch.Generator().manual_seed(0), probs))
    flipped = random_flip(torch.Generator().manual_seed(1), x)
    same = [torch.equal(f, i) for f, i in zip(flipped, x)]
    mirrored = [torch.equal(f, i.flip(-2)) for f, i in zip(flipped, x)]
    assert all(s or m for s, m in zip(same, mirrored)) and any(mirrored)


# -- one step and many ----------------------------------------------------------


def test_train_step_moves_params_and_counts():
    cfg = _cfg()
    model, tx, state = _setup(cfg)
    before = _copy(state)
    state, metrics = make_train_step(model, cfg, tx)(state, BATCH)
    assert state.step == 1 and int(state.opt_state["count"]) == 1
    assert np.isfinite(float(metrics["loss"])) and "grad_norm" not in metrics
    assert _differs(before["params"], state.state_dict()["params"])
    # the state's params are the model's own, updated in place
    assert all(p is q for p, q in zip(state.params.values(), model.parameters()))


def test_multi_step_equals_single_steps():
    cfg = _cfg()
    batches = torch.stack([BATCH, BATCH.flip(0), 255 - BATCH])
    model, tx, s1 = _setup(cfg)
    single = make_train_step(model, cfg, tx)
    for batch in batches:
        s1, m1 = single(s1, batch)
    model2, tx2, s2 = _setup(cfg)
    s2, m2 = make_multi_train_step(model2, cfg, tx2, n_steps=3)(s2, batches)
    assert s2.step == 3
    _assert_equal(s1.state_dict(), s2.state_dict())
    assert float(m1["loss"]) == float(m2["loss"])


def test_bf16_config_trains_float32_parameters():
    """compute_dtype and likelihood_io_dtype "bfloat16": the body and the
    likelihood boundary run in bf16, the parameters, their gradients and
    the optimizer state stay float32, and the loss is within bf16 rounding
    (rtol 1e-2) of the float32 config's on the same weights and batch."""
    cfg = _cfg()
    bf16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16", likelihood_io_dtype="bfloat16"))
    losses = {}
    for name, c in (("f32", cfg), ("bf16", bf16)):
        model, tx, state = _setup(c)
        state, metrics = make_train_step(model, c, tx)(state, BATCH)
        losses[name] = float(metrics["loss"])
        assert all(p.dtype == torch.float32 for p in state.params.values())
        assert all(m.dtype == torch.float32 for m in state.opt_state["mu"].values())
    assert losses["bf16"] == pytest.approx(losses["f32"], rel=1e-2)


def test_determinism_per_seed():
    cfg = _cfg()
    losses = []
    for seed in (0, 0, 1):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
        model, tx, state = _setup(c)
        step = make_train_step(model, c, tx)
        for _ in range(2):
            state, metrics = step(state, BATCH)
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_resume_from_state_dict_is_exact():
    """Four steps straight equal two steps, a save, a load into a fresh model
    with other weights, and two more steps: bit for bit."""
    cfg = _cfg(ema_decay=0.9)
    model, tx, straight = _setup(cfg)
    step = make_train_step(model, cfg, tx)
    for _ in range(4):
        straight, _ = step(straight, BATCH)

    model, tx, first = _setup(cfg)
    step = make_train_step(model, cfg, tx)
    for _ in range(2):
        first, _ = step(first, BATCH)
    buffer = io.BytesIO()
    torch.save(first.state_dict(), buffer)
    buffer.seek(0)

    model, tx, resumed = _setup(cfg, seed=9)
    resumed.load_state_dict(torch.load(buffer))
    assert resumed.step == 2
    step = make_train_step(model, cfg, tx)
    for _ in range(2):
        resumed, _ = step(resumed, BATCH)
    _assert_equal(resumed.state_dict(), straight.state_dict())


def test_device_data_train_step_draws_batches_by_seeded_indices():
    cfg = _cfg()
    data = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (16, 8, 8, 3),
                                                              dtype=np.uint8))
    model, tx, state = _setup(cfg)
    state, metrics = make_device_data_train_step(model, cfg, tx, n_steps=3, n_data=16)(state, data)
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))

    model2, tx2, state2 = _setup(cfg)
    step = make_train_step(model2, cfg, tx2)
    for _ in range(3):
        gen = state2.next_rngs("device_batch")["device_batch"]
        state2, _ = step(state2, data[torch.randint(0, 16, (4,), generator=gen)])
    _assert_equal(state.state_dict(), state2.state_dict())


def test_generators_are_per_step_and_per_stream():
    _, _, state = _setup(_cfg())
    draw = lambda g: torch.rand(4, generator=g)  # noqa: E731
    first = draw(state.next_rngs("sample")["sample"])
    assert torch.equal(first, draw(state.next_rngs("flip", "sample")["sample"]))
    assert not torch.equal(first, draw(state.next_rngs("flip")["flip"]))
    state.step += 1
    assert not torch.equal(first, draw(state.next_rngs("sample")["sample"]))


# -- accumulation, clipping, skipping, beta warmup ---------------------------------


def test_gradient_accumulation_applies_every_second_step():
    cfg = _cfg(grad_accum_steps=2, lr_staircase=False)
    model, tx, state = _setup(cfg)
    step = make_train_step(model, cfg, tx)
    p0 = _copy(state)["params"]
    state, _ = step(state, BATCH)
    _assert_equal(p0, state.state_dict()["params"])  # accumulating
    state, _ = step(state, BATCH)
    assert _differs(p0, state.state_dict()["params"])  # applied
    assert int(state.opt_state["gradient_step"]) == 1


def test_clip_applies_per_microbatch_with_accumulation():
    tx = make_optimizer(config.TrainConfig(grad_accum_steps=2, grad_clip_norm=1.0,
                                           lr_staircase=False))
    params = {"w": torch.zeros(4)}
    _, state = tx.update({"w": torch.full((4,), 100.0)}, tx.init(params), params)
    assert float(global_norm(state[1]["acc_grads"])) <= 1.0 + 1e-5


@pytest.mark.parametrize("threshold", [1e-9, 1e9])
def test_grad_skip_threshold(threshold):
    """Always exceeded: the step advances, params, moments and EMA stay
    bit-identical and the skip is counted. Never exceeded: the update
    applies."""
    cfg = _cfg(grad_skip_threshold=threshold, ema_decay=0.99)
    model, tx, state = _setup(cfg)
    before = _copy(state)
    state, metrics = make_train_step(model, cfg, tx)(state, BATCH)
    assert state.step == 1 and float(metrics["grad_norm"]) > 1e-9
    after = state.state_dict()
    if threshold < 1:
        assert float(metrics["skipped"]) == 1.0
        for key in ("params", "opt_state", "ema_params"):
            _assert_equal(before[key], after[key])
    else:
        assert float(metrics["skipped"]) == 0.0
        assert _differs(before["params"], after["params"])


def test_multi_step_window_sums_skips_and_maxes_the_norm():
    cfg = _cfg(grad_skip_threshold=1e-9)
    model, tx, state = _setup(cfg)
    state, metrics = make_multi_train_step(model, cfg, tx, n_steps=3)(
        state, torch.stack([BATCH] * 3))
    assert float(metrics["skipped"]) == 3.0 and state.step == 3


def test_update_ok_rule():
    one, nan = torch.tensor(1.0), torch.tensor(float("nan"))
    assert bool(update_ok(one, one, 10.0))
    assert not bool(update_ok(nan, one, 10.0))
    assert not bool(update_ok(one, nan, 10.0))
    assert not bool(update_ok(one, torch.tensor(11.0), 10.0))


def test_grad_clip_norm_bounds_the_first_update():
    """A tight clip changes the first update; a loose one is a no-op."""
    out = {}
    for clip in (0.0, 1e-3, 1e9):
        cfg = _cfg(grad_clip_norm=clip)
        model, tx, state = _setup(cfg)
        state, metrics = make_train_step(model, cfg, tx)(state, BATCH)
        out[clip] = torch.cat([p.detach().reshape(-1) for p in state.params.values()])
        if clip:
            assert float(metrics["grad_norm"]) > 1e-3
        else:
            assert "grad_norm" not in metrics
    assert not torch.equal(out[0.0], out[1e-3])
    assert torch.equal(out[0.0], out[1e9])


def test_effective_beta_ramp():
    base = _cfg()
    assert effective_beta(base, 0) == base.model.beta
    cfg = _cfg(beta_warmup_steps=10)
    for step, expect in [(0, 0.1), (4, 0.5), (9, 1.0), (1000, 1.0)]:
        assert effective_beta(cfg, step) == pytest.approx(expect)
    acc = _cfg(beta_warmup_steps=10, grad_accum_steps=4)
    for step, expect in [(0, 0.1), (3, 0.1), (4, 0.2), (39, 1.0), (1000, 1.0)]:
        assert effective_beta(acc, step) == pytest.approx(expect)


def test_beta_warmup_anneals_the_train_bound():
    def loss_at_step0(warmup):
        cfg = _cfg(beta_warmup_steps=warmup)
        model, tx, state = _setup(cfg)
        _, m = make_train_step(model, cfg, tx)(state, BATCH)
        return float(m["loss"]), float(m["kl"])

    loss0, kl0 = loss_at_step0(0)
    loss_w, kl_w = loss_at_step0(1000)
    loss_1, _ = loss_at_step0(1)
    assert kl_w == pytest.approx(kl0)
    assert loss_w < loss0
    assert loss_1 == pytest.approx(loss0, rel=1e-6)


# -- EMA and eval -----------------------------------------------------------------


def test_ema_matches_manual_replay():
    decay = 0.9
    cfg = _cfg(ema_decay=decay)
    model, tx, state = _setup(cfg)
    step = make_train_step(model, cfg, tx)
    ema = {n: p.detach().clone() for n, p in state.params.items()}
    for _ in range(4):
        state, _ = step(state, BATCH)
        ema = {n: decay * e + (1 - decay) * state.params[n].detach() for n, e in ema.items()}
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7),
             state.ema_params, ema)
    assert _differs(state.ema_params, {n: p.detach() for n, p in state.params.items()})


def test_ema_disabled_keeps_state_empty():
    cfg = _cfg()
    model, tx, state = _setup(cfg)
    state, _ = make_train_step(model, cfg, tx)(state, BATCH)
    assert state.ema_params is None and eval_params(cfg.train, state) is state.params


def test_eval_uses_frozen_ema_at_decay_one():
    cfg = _cfg(ema_decay=1.0)
    model, tx, state = _setup(cfg)
    init = _copy(state)["params"]
    step = make_train_step(model, cfg, tx)
    for _ in range(3):
        state, _ = step(state, BATCH)
    _assert_equal(state.ema_params, init)
    m_ema = make_eval_step(model, cfg)(state, BATCH)
    off = _cfg(ema_decay=0.0)
    raw = make_eval_step(model, off)(state, BATCH)
    trained = {n: p.detach().clone() for n, p in state.params.items()}
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(init[n])
    at_init = make_eval_step(model, off)(state, BATCH)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(trained[n])
    assert float(m_ema["loss"]) == pytest.approx(float(at_init["loss"]), rel=1e-6)
    assert float(m_ema["loss"]) != pytest.approx(float(raw["loss"]), rel=1e-4)


def test_eval_step_reports_the_true_bound_under_free_bits():
    cfg_f = _cfg("elbo", free_bits=1e6)
    model, _, state = _setup(cfg_f)
    m_f = make_eval_step(model, cfg_f)(state, BATCH)
    m_0 = make_eval_step(model, _cfg("elbo"))(state, BATCH)
    assert float(m_f["loss"]) == pytest.approx(float(m_0["loss"]), rel=1e-6)
    assert abs(float(m_f["loss"])) < 1e5


# -- DReG and free bits -------------------------------------------------------------


def _loss_and_grads(cfg, model, eps):
    x = dequantize(BATCH)
    params = dict(model.named_parameters())
    loss_fn = training_loss_fn(model, cfg, prior_for(cfg.model), x, cfg.model.n_samples,
                               eps=eps)
    loss, metrics = loss_fn(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), metrics, dict(zip(params, grads))


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


@pytest.fixture(scope="module")
def objective_grads():
    eps = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 4, 4)).astype(np.float32))
    model, _, _ = _setup(_cfg())
    out = {}
    for name, cfg in (("iwae", _cfg()), ("dreg", _cfg("iwae_dreg")), ("elbo", _cfg("elbo")),
                      ("fb_low", _cfg("elbo", free_bits=1e-6)),
                      ("fb_high", _cfg("elbo", free_bits=1e6))):
        out[name] = _loss_and_grads(cfg, model, eps)
    # reconstruction alone: -mean log p(x|z)
    x = dequantize(BATCH)
    params = dict(model.named_parameters())
    Qs, Ps, pxz = model(x, 5, eps=eps)
    lpxz, _ = bound_terms(prior_for(model.config), Qs, Ps, pxz, x)
    out["recon"] = dict(zip(params, torch.autograd.grad(-lpxz.mean(), list(params.values()))))
    return out


def test_dreg_value_is_the_iwae_bound(objective_grads):
    loss_i, metrics_i, _ = objective_grads["iwae"]
    loss_d, metrics_d, _ = objective_grads["dreg"]
    assert loss_d == pytest.approx(loss_i, rel=1e-6)
    assert float(metrics_d["iwae_elbo"].detach()) == pytest.approx(
        float(metrics_i["iwae_elbo"].detach()), rel=1e-6)


def test_dreg_generative_grads_are_iwae_and_inference_grads_differ(objective_grads):
    _, _, g_i = objective_grads["iwae"]
    _, _, g_d = objective_grads["dreg"]
    for name in g_i:
        if name.startswith("decoder."):
            assert _rel(g_d[name], g_i[name]) < 1e-4, name
    enc = [n for n in g_i if n.startswith("encoder.")]
    assert enc and max(_rel(g_d[n], g_i[n]) for n in enc) > 1e-3


def test_dreg_zero_variance_at_the_true_posterior():
    """p(z) = N(0, 1), p(x|z) = N(z, 1), q(z|x) = N(x/2, 1/2) is the true
    posterior: every log-weight is log p(x), so the DReG inference gradient
    vanishes while the IWAE estimator's score term does not."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 1)).astype(np.float32))
    eps = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 16, 1)).astype(np.float32))
    prior = Normal(torch.zeros(1), torch.ones(1), event_axes=(-1,))

    def surrogates(a, b, log_s):
        mu = a * x + b
        s = torch.exp(log_s) * torch.ones_like(mu)
        z = mu + s * eps
        Qs = (DistributionTuple(Normal(mu, s, event_axes=(-1,)), z, axes=(-1,)),)
        pxz = DistributionTuple(Normal(z, torch.ones_like(z), event_axes=(-1,)), None, axes=(-1,))
        lw = log_weights(prior, Qs, (), pxz, x)
        lw_hat = log_weights(prior, Qs, (), pxz, x, stop_q_params=True)
        w = torch.softmax(lw, dim=0).detach()
        return -torch.mean(torch.sum(w * lw, 0)), -torch.mean(torch.sum(w * w * lw_hat, 0)), lw

    phi = [torch.tensor(0.5, requires_grad=True), torch.tensor(0.0, requires_grad=True),
           torch.tensor(0.5 * float(np.log(0.5)), requires_grad=True)]
    iwae, dreg, lw = surrogates(*phi)
    assert float(lw.detach().std(dim=0).max()) < 1e-4
    g_dreg = torch.autograd.grad(dreg, phi, retain_graph=True)
    g_iwae = torch.autograd.grad(iwae, phi)
    assert max(float(g.abs()) for g in g_dreg) < 1e-4
    assert max(float(g.abs()) for g in g_iwae) > 1e-2


def test_dreg_with_free_bits_is_refused_when_the_step_is_built():
    cfg = _cfg("iwae_dreg", free_bits=0.25)
    model, tx, _ = _setup(_cfg())
    with pytest.raises(ValueError, match="free_bits"):
        training_loss_fn(model, cfg, prior_for(cfg.model), dequantize(BATCH), 5)
    with pytest.raises(ValueError, match="free_bits"):
        training_loss_fn(model, _cfg("iwae", free_bits=0.1), prior_for(cfg.model),
                         dequantize(BATCH), 5)


def test_dreg_train_step_runs():
    cfg = _cfg("iwae_dreg")
    model, tx, state = _setup(cfg)
    before = _copy(state)["params"]
    state, metrics = make_train_step(model, cfg, tx)(state, BATCH)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert _differs(before, state.state_dict()["params"])


def test_free_bits_inactive_floor_is_the_elbo(objective_grads):
    loss_e, _, g_e = objective_grads["elbo"]
    loss_f, metrics_f, g_f = objective_grads["fb_low"]
    assert loss_f == pytest.approx(loss_e, rel=1e-5)
    assert max(_rel(g_f[n], g_e[n]) for n in g_e) < 1e-4
    assert float(metrics_f["kl_floored_layers"]) == 0.0


def test_free_bits_floor_blocks_the_kl_gradient(objective_grads):
    _, metrics, g_f = objective_grads["fb_high"]
    g_r = objective_grads["recon"]
    assert float(metrics["kl_floored_layers"]) == 1.0 and len(metrics["kl"]) == 1
    assert max(_rel(g_f[n], g_r[n]) for n in g_r if g_r[n].norm() > 0) < 1e-4
