"""The captured train steps (``train/capture.py``) on the CPU.

On the card each step factory returns a CUDA graph of the step or of its
whole window (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 18
hold it there to the eager steps, bit for bit). Here the factories run the
same body eagerly, and what the capture is built from is held:

- the factories' results equal the step as the port ran it before it was
  captured (written out below from the same parts: fresh generators from
  ``next_rngs`` at each step, beta as the float ``effective_beta`` gives),
  bit for bit, under beta warm-up, accumulation, clip, skip and EMA;
- the key cache: one key a signature, none for a call that injects noise;
- the graph's betas and generators: each step's beta written to a float32
  tensor equals ``effective_beta``; generators re-seeded in place draw what
  fresh ones draw;
- the state's tensors survive a ``state_dict()`` round trip in place, the
  addresses a graph reads;
- the launch counters a replay adds.

Tolerance: none; every comparison is bit for bit.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.models.objective import apply, compute_loss, training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.ops.cuda import dl_kernel, mdl_kernel
from vae_mdl_tpu_torch.train import capture
from vae_mdl_tpu_torch.train.state import (
    create_train_state,
    eval_params,
    make_optimizer,
    seed_streams,
    stream_generators,
    tree_leaves,
    tree_map,
)
from vae_mdl_tpu_torch.train.steps import (
    _scalarize,
    apply_update,
    effective_beta,
    ema_step,
    make_device_data_train_step,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
    preprocess,
    preprocess_train,
    reduce_scan_metrics,
)

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
BATCHES = torch.from_numpy(RNG.integers(0, 256, (4, 4, 8, 8, 3), dtype=np.uint8))
DATA = torch.from_numpy(RNG.integers(0, 256, (16, 8, 8, 3), dtype=np.uint8))


def _cfg(likelihood="mdl", **train):
    c = config
    out = 20 if likelihood == "mdl" else 3
    model = c.ModelConfig(
        name="narrow", image_shape=(8, 8, 3), n_latent=4, likelihood=likelihood, n_mix=2,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(out, 3, 1, "none"))),
    )
    cfg = experiment("model05", model=model)
    data = dataclasses.replace(cfg.data, batch_size=4, augment_flip=likelihood != "mdl")
    return dataclasses.replace(cfg, data=data, train=dataclasses.replace(cfg.train, **train))


CONFIGS = {
    "plain": {},
    "warmup, accumulation, clip, skip, EMA": dict(
        beta_warmup_steps=4, grad_accum_steps=2, grad_clip_norm=5.0,
        grad_skip_threshold=1e4, ema_decay=0.9),
    "bernoulli, binarised and flipped": dict(ema_decay=0.5, beta_warmup_steps=3),
}


def _config(which):
    likelihood = "bernoulli" if which.startswith("bernoulli") else "mdl"
    return _cfg(likelihood, **CONFIGS[which])


def _setup(cfg, seed=0):
    model = build_model(cfg.model, torch.Generator().manual_seed(seed), device="cpu")
    return model, make_optimizer(cfg.train), create_train_state(model, cfg.train)


def _todays_step(model, cfg, tx):
    """The train step as the port ran it before its body was captured:
    generators from ``next_rngs`` at the state's step, beta the float."""
    def step(state, batch):
        rngs = state.next_rngs("sample", "binarize", "flip", device=batch.device)
        x = preprocess_train(cfg, batch, rngs)
        loss_fn = training_loss_fn(model, cfg, prior_for(cfg.model, x.device), x,
                                   cfg.model.n_samples, rngs["sample"],
                                   effective_beta(cfg, state.step))
        loss, metrics = loss_fn(state.params)
        grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
        state.opt_state, ok, stats = apply_update(cfg, tx, state.params, state.opt_state,
                                                  grads, loss.detach())
        state.ema_params = ema_step(cfg, state.ema_params, state.params, ok)
        state.step += 1
        out = _scalarize(metrics)
        out.update(stats)
        out["loss"] = loss.detach()
        return state, out

    return step


def _assert_equal(a, b):
    tree_map(lambda u, v: torch.testing.assert_close(u, v, rtol=0, atol=0), a, b)


def _gathered(state):
    gen = state.next_rngs("device_batch")["device_batch"]
    return DATA[torch.randint(0, len(DATA), (4,), generator=gen)]


@pytest.mark.parametrize("which", list(CONFIGS))
def test_factories_on_the_cpu_run_the_eager_body_as_before(which):
    """Four steps of each factory against four of the step written out as
    before: the same state and metrics, bit for bit."""
    cfg = _config(which)
    model, tx, want = _setup(cfg)
    todays = _todays_step(model, cfg, tx)
    want_metrics = []
    for batch in BATCHES:
        want, m = todays(want, batch)
        want_metrics.append(m)
    window = reduce_scan_metrics(want_metrics[2:])

    model, tx, single = _setup(cfg)
    step = make_train_step(model, cfg, tx)
    for batch in BATCHES:
        single, got = step(single, batch)
    _assert_equal(single.state_dict(), want.state_dict())
    _assert_equal(got, want_metrics[-1])

    model, tx, multi = _setup(cfg)
    step = make_multi_train_step(model, cfg, tx, n_steps=2)
    for pair in (BATCHES[:2], BATCHES[2:]):
        multi, got = step(multi, pair)
    _assert_equal(multi.state_dict(), want.state_dict())
    _assert_equal(got, window)

    model, tx, resident = _setup(cfg)
    resident, got = make_device_data_train_step(model, cfg, tx, n_steps=4, n_data=16)(
        resident, DATA)
    model, tx, want = _setup(cfg)
    gathered = []
    for _ in range(4):
        want, m = todays(want, _gathered(want))
        gathered.append(m)
    _assert_equal(resident.state_dict(), want.state_dict())
    _assert_equal(got, reduce_scan_metrics(gathered))


def test_eval_step_on_the_cpu_runs_the_eval_body_as_before():
    cfg = _config("bernoulli, binarised and flipped")
    model, tx, state = _setup(cfg)
    state, _ = make_train_step(model, cfg, tx)(state, BATCHES[0])
    got = make_eval_step(model, cfg, fold=3)(state, BATCHES[1])
    rngs = state.next_rngs("eval_sample", "eval_binarize", fold=3)
    with torch.no_grad():
        x = preprocess(cfg, BATCHES[1], rngs["eval_binarize"])
        Qs, Ps, pxz = apply(model, eval_params(cfg.train, state), x, cfg.model.n_samples,
                            generator=rngs["eval_sample"])
        loss, metrics = compute_loss(prior_for(cfg.model), Qs, Ps, pxz, x, beta=cfg.model.beta,
                                     objective="iwae", free_bits=0.0)
    want = _scalarize(metrics)
    want["loss"] = loss
    _assert_equal(got, want)


def test_key_cache_counts_one_key_a_signature():
    cfg = _cfg()
    model, tx, state = _setup(cfg)
    step = make_train_step(model, cfg, tx)
    for batch in BATCHES[:2]:
        state, _ = step(state, batch)
    assert step.cache_size() == 1
    state, _ = step(state, BATCHES[0, :2])  # a batch of another shape
    assert step.cache_size() == 2
    # a call that injects noise runs the eager body and adds no key
    eps = torch.zeros((cfg.model.n_samples, 4, cfg.model.n_latent))
    state, _ = step(state, BATCHES[0], eps=eps)
    assert step.cache_size() == 2 and state.step == 4

    multi = make_multi_train_step(model, cfg, tx, n_steps=2)
    state, _ = multi(state, BATCHES[:2])
    state, _ = multi(state, BATCHES[2:])
    assert multi.cache_size() == 1
    assert multi.key(BATCHES[:2]) == ((2, 4, 8, 8, 3), torch.uint8, torch.device("cpu"), 2)


@pytest.mark.parametrize("accum", [1, 2])
def test_the_graphs_betas_equal_effective_beta(accum):
    """What the graph reads for each step of a window: the float
    ``effective_beta`` gives, written to a float32 tensor (eagerly, the same
    tensor), over a warm-up of 4 applied updates."""
    cfg = _cfg(beta_warmup_steps=4, grad_accum_steps=accum)
    model, tx, _ = _setup(cfg)
    multi = make_multi_train_step(model, cfg, tx, n_steps=5)
    assert multi.tensor_betas and multi.beta_of(0) == effective_beta(cfg, 0)
    for start in (0, 5):
        betas = multi.betas(start, "cpu")
        written = torch.empty(5)
        for i in range(5):
            written[i].fill_(multi.beta_of(start + i))
            want = effective_beta(cfg, start + i)
            assert betas[i].dtype == torch.float32 and betas[i].dim() == 0
            assert float(betas[i]) == float(written[i]) == np.float32(want)
    ramp = [float(b) for b in multi.betas(0, "cpu") + multi.betas(5, "cpu")]
    expect = [min(1.0, (s // accum + 1) / 4) for s in range(10)]
    assert ramp == expect
    # no warm-up: the float itself, a constant of the graph
    plain = make_train_step(model, _cfg(), tx)
    assert not plain.tensor_betas and plain.betas(7, "cpu") == [_cfg().model.beta]


def test_reseeded_generators_draw_what_fresh_ones_draw():
    """The graph keeps its generators and re-seeds them before each replay:
    after any draws, ``seed_streams`` puts them where ``stream_generators``
    starts, per step and per stream (and per fold)."""
    streams = ("sample", "binarize", "flip", "device_batch")
    kept = stream_generators(0, 0, streams)
    for gen in kept.values():
        torch.rand(7, generator=gen)
    for step, fold in ((5, None), (6, None), (6, 2)):
        seed_streams(kept, seed=11, step=step, fold=fold)
        fresh = stream_generators(11, step, streams, fold=fold)
        for name in streams:
            assert torch.equal(torch.rand(5, generator=kept[name]),
                               torch.rand(5, generator=fresh[name]))
    draws = {step: torch.rand(5, generator=seed_streams(kept, 11, step)["sample"])
             for step in (5, 6)}
    assert not torch.equal(draws[5], draws[6])


def test_state_tensors_survive_a_state_dict_round_trip():
    """``load_state_dict`` writes into the state's own tensors, the
    addresses a captured step reads, and a resume through ``state_dict()``
    is exact."""
    cfg = _config("warmup, accumulation, clip, skip, EMA")
    model, tx, state = _setup(cfg)
    step = make_multi_train_step(model, cfg, tx, n_steps=2)
    state, _ = step(state, BATCHES[:2])
    own = {attr: tree_leaves(getattr(state, attr))
           for attr in ("params", "opt_state", "ema_params")}
    saved = copy.deepcopy(state.state_dict())
    state, _ = step(state, BATCHES[2:])
    after = copy.deepcopy(state.state_dict())
    # the live state's tensors are new after an eager step; put the bound
    # ones back, then load the saved values into them
    state.opt_state = tree_map(lambda t, v: t.copy_(v), tree_map(torch.empty_like,
                                                                   saved["opt_state"]),
                               saved["opt_state"])
    bound = tree_leaves(state.opt_state)
    state.load_state_dict(saved)
    assert all(a is b for a, b in zip(tree_leaves(state.opt_state), bound))
    assert all(a is b for a, b in zip(tree_leaves(state.params), own["params"]))
    ema = tree_leaves(state.ema_params)
    state.load_state_dict(copy.deepcopy(saved))
    assert all(a is b for a, b in zip(tree_leaves(state.ema_params), ema))
    _assert_equal(state.state_dict(), saved)
    state, _ = step(state, BATCHES[2:])
    _assert_equal(state.state_dict(), after)

    fresh = _setup(cfg, seed=9)[2]
    mine = tree_leaves(fresh.opt_state)
    fresh.load_state_dict(saved)
    assert all(a is b for a, b in zip(tree_leaves(fresh.opt_state), mine))
    _assert_equal(fresh.state_dict(), saved)


def test_a_replay_adds_the_launches_its_graph_holds():
    """The counters the capture records and puts back, and a replay's
    addition, on the wrappers' own counters."""
    before = capture.launch_counts()
    try:
        mdl_kernel.launches += 3
        mdl_kernel.backward_launches_by_path["tiled"] += 2
        dl_kernel.launches_by_path["direct"] += 1
        delta = capture._counts_since(before)
        assert delta == {
            ("vae_mdl_tpu_torch.ops.cuda.mdl_kernel", "launches"): 3,
            ("vae_mdl_tpu_torch.ops.cuda.mdl_kernel", "backward_launches_by_path"): {"tiled": 2},
            ("vae_mdl_tpu_torch.ops.cuda.dl_kernel", "launches_by_path"): {"direct": 1},
        }
        capture._restore_counts(before)
        assert capture.launch_counts() == before
        capture._add_counts(delta)
        capture._add_counts(delta)
        assert mdl_kernel.launches == before[("vae_mdl_tpu_torch.ops.cuda.mdl_kernel",
                                              "launches")] + 6
        assert capture._counts_since(before) == {
            key: ({k: 2 * v for k, v in value.items()} if isinstance(value, dict) else 2 * value)
            for key, value in delta.items()}
    finally:
        capture._restore_counts(before)


def test_packed_metrics_unpack_to_the_same_values():
    metrics = {"loss": torch.tensor(1.5), "kl": [torch.tensor(0.25), torch.tensor(2.0)],
               "skipped": torch.tensor(0.0)}
    packed, unpack = capture.pack_metrics(metrics)
    assert packed.shape == (4,)
    _assert_equal(unpack(packed.clone()), metrics)
