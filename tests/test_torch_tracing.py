"""The port's spans and counters (``utils/tracing.py``): with no profiler a
span is one shared null context and counts nothing; under
``torch.profiler`` the training loop's iterations, its waits on the
prefetch producer and its step calls are ranges of the profiler's trace,
one each a step, the waits and calls inside the iterations; checkpoint
saves and captures are counted with or without a profiler. The captures'
count on the card is marked ``cuda`` and skips elsewhere.

This file imports no jax, so that it runs on the card as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vae_mdl_tpu_torch.config import DataConfig, TrainConfig
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.trainer import Trainer
from vae_mdl_tpu_torch.utils import tracing

torch.set_num_threads(1)


def _tiny_cfg(tmp, n_updates=3, eval_interval=20):
    """model01 on synthetic MNIST, batch 16: the trainer tests' tiny run."""
    cfg = experiment("model01")
    return dataclasses.replace(
        cfg,
        data=DataConfig(dataset="synthetic:mnist", batch_size=16, val_batch_size=32),
        train=TrainConfig(n_updates=n_updates, eval_interval=eval_interval,
                          report_images=False, checkpoint_dir=str(tmp) + "/ckpt",
                          log_dir=str(tmp) + "/tb"),
    )


def _rows(prof):
    """``{name: [(start_us, end_us), ...]}`` of the trace's ``vae/`` ranges."""
    out = {}
    for evt in prof.events():
        if evt.name.startswith(tracing.PREFIX):
            out.setdefault(evt.name, []).append((evt.time_range.start, evt.time_range.end))
    return out


def _count(name):
    return tracing.totals().get(name, (0, 0.0))[0]


def test_a_span_without_a_profiler_is_the_shared_null_context():
    assert not tracing.recording()
    before = tracing.totals()
    first, second = tracing.span("trainer.iter"), tracing.span("data.wait")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first, second:
        pass
    assert tracing.totals() == before


def test_a_span_under_a_profiler_is_a_range_of_its_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(4).sum()
    assert not tracing.recording()
    rows = _rows(prof)
    (outer,), (inner,) = rows["vae/outer"], rows["vae/inner"]
    assert outer[0] <= inner[0] <= inner[1] <= outer[1]
    # host operations, not user annotations, which the profiler would
    # mirror onto the device's timeline with the card's activity on
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]
    assert len(ours) == 2 and not any(e.is_user_annotation() for e in ours)


@pytest.mark.parametrize("profiled", [False, True])
def test_timed_counts_each_call_and_its_seconds(profiled):
    name = f"test.timed.{profiled}"
    count, seconds = tracing.totals().get(name, (0, 0.0))
    profiler = profile(activities=[ProfilerActivity.CPU])
    with profiler if profiled else contextlib.nullcontext() as prof:
        for _ in range(2):
            with tracing.timed(name):
                torch.ones(4).sum()
    now = tracing.totals()[name]
    assert now[0] == count + 2 and now[1] > seconds
    if profiled:
        assert len(_rows(prof)[tracing.PREFIX + name]) == 2


def test_timed_counts_a_call_that_raises():
    name = "test.timed.raises"
    count = _count(name)
    with pytest.raises(ValueError):
        with tracing.timed(name):
            raise ValueError("inside")
    assert _count(name) == count + 1


def test_reset_clears_the_totals():
    with tracing.timed("test.reset"):
        pass
    assert "test.reset" in tracing.totals()
    tracing.reset()
    assert tracing.totals() == {}


def test_fit_records_one_iteration_wait_and_step_a_step(tmp_path):
    """Three steps of a CPU ``fit`` under the profiler: three iterations,
    three waits on the producer and three train-step calls, each wait and
    call inside an iteration; the validation at step 0 is one eval-step
    call and its checkpoint saves lie inside that iteration too."""
    tr = Trainer(_tiny_cfg(tmp_path), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(progress=False)
    rows = _rows(prof)
    iters = rows["vae/trainer.iter"]
    assert len(iters) == 3
    assert len(rows["vae/data.wait"]) == 3 and len(rows["vae/step.train"]) == 3
    assert len(rows["vae/step.eval"]) == 1
    # step 0's "latest" and "best", and the final save after the loop
    assert len(rows["vae/checkpoint.save"]) == 3
    for name in ("vae/data.wait", "vae/step.train", "vae/step.eval"):
        for start, end in rows[name]:
            assert any(a <= start <= end <= b for a, b in iters), name
    inside = [r for r in rows["vae/checkpoint.save"] if any(a <= r[0] <= r[1] <= b
                                                           for a, b in iters)]
    assert len(inside) == 2


def test_fit_counts_every_checkpoint_save(tmp_path):
    tr = Trainer(_tiny_cfg(tmp_path, eval_interval=1), device="cpu")
    before = tracing.totals().get("checkpoint.save", (0, 0.0))
    tr.fit(progress=False)
    count, seconds = tracing.totals()["checkpoint.save"]
    assert count >= before[0] + 3 and seconds > before[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_capture_is_counted_once_a_new_key_and_never_on_a_replay(cuda):
    """``make_train_step``'s and the batch evaluator's CUDA graphs: one
    ``capture`` count each new key (a batch shape), none on a replay."""
    from vae_mdl_tpu_torch.evaluation.harness import make_batch_evaluator
    from vae_mdl_tpu_torch.models.vae import build_model
    from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
    from vae_mdl_tpu_torch.train.steps import make_train_step

    cfg = experiment("model01")
    model = build_model(cfg.model, torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    images = np.random.default_rng(0).integers(0, 256, (8,) + tuple(cfg.model.image_shape),
                                               dtype=np.uint8)
    batch = torch.as_tensor(images, device=cuda)
    evaluator = make_batch_evaluator(model, cfg, 200, 100)
    counts = [_count("capture")]
    for call in (lambda: step(state, batch), lambda: step(state, batch),
                 lambda: step(state, batch[:4]), lambda: step(state, batch[:4]),
                 lambda: evaluator(batch), lambda: evaluator(batch)):
        call()
        counts.append(_count("capture"))
    torch.cuda.synchronize()
    assert np.diff(counts).tolist() == [1, 0, 1, 0, 1, 0]
    assert step.cache_size() == 2 and evaluator.cache_size() == 1
