"""The mesh steps as one program (``parallel/spmd.py``, ``train/steps.py``,
``train/capture.py``) on the CPU, in 2 gloo rank processes
(tests/torch_parallel_worker.py).

On the card over NCCL each mesh step and window is one CUDA graph with its
collectives (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 19
hold it there to the eager body, bit for bit). Here, over gloo, the same
window bodies run eagerly, and what the capture is built from is held:

- a 10-step ``make_multi_train_step(mesh=)`` and
  ``make_device_data_train_step(mesh=)`` equal 10 calls of the one-step
  mesh step, the device-data one on the rows the eager loop drew before the
  window was captured (the unfolded "device_batch" stream, the same indices
  on every rank, each rank its slice), under beta warm-up too, whose betas
  equal ``effective_beta``;
- each stream's fold: the train streams fold in the rank's batch shard,
  "device_batch" is not folded;
- the rule that decides the path, a plain function of (device type,
  backend);
- the trainer's retrace guard over ``Trainer(mesh=)`` at a world of two
  (tests/test_retrace.py's cases).

Tolerance: none; every comparison is bit for bit.
"""
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu_torch.train.capture import captures, cuda_backend
from vae_mdl_tpu_torch.train.steps import effective_beta

torch.set_num_threads(1)


def _equal(a, b):
    """Two trees of tensors and numbers equal bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    else:
        assert a == b or (a != a and b != b)


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    rng = np.random.default_rng(0)
    _, _, state = W.setup(W.experiment_of(W.narrow_model()))
    inputs = {"params": {n: p.detach().clone() for n, p in state.params.items()},
              "batches": rng.integers(0, 256, (10, 8, 8, 8, 3), dtype=np.uint8),
              "data": rng.integers(0, 256, (32, 8, 8, 3), dtype=np.uint8)}
    return W.spawn("mesh_window_suite", 2, tmp_path_factory.mktemp("windows"), inputs)


@pytest.mark.parametrize("case", ["plain", "warmup"])
@pytest.mark.parametrize("factory", ["window", "device"])
def test_mesh_window_equals_ten_mesh_steps(windows, case, factory):
    """The window's state and metrics equal those of 10 one-step calls (the
    device-data one on the rows drawn as the eager loop drew them), on each
    rank, and the ranks' parameters are equal."""
    want = "steps" if factory == "window" else "device_steps"
    for out in windows:
        got_state, got_metrics = out[f"{case}/{factory}"][:2]
        want_state, want_metrics = out[f"{case}/{want}"]
        _equal(got_state, want_state)
        _equal(got_metrics, want_metrics)
        assert got_state["step"] == 10
    _equal(windows[0][f"{case}/{factory}"][0]["params"],
           windows[1][f"{case}/{factory}"][0]["params"])


def test_device_data_rows_are_equal_across_ranks(windows):
    """Every rank draws the same indices from the unfolded stream and
    takes its own slice of them."""
    for case in ("plain", "warmup"):
        _equal(windows[0][f"{case}/indices"], windows[1][f"{case}/indices"])
    assert sorted(out["index"] for out in windows) == [0, 1]


def test_each_stream_folds_as_the_eager_mesh_step_did(windows):
    for out in windows:
        train = {name: out["index"] for name in ("sample", "binarize", "flip")}
        assert out["folds"]["window"] == train
        assert out["folds"]["device"] == {**train, "device_batch": None}


def test_the_window_betas_equal_effective_beta(windows):
    cfg = W.experiment_of(W.narrow_model(), beta_warmup_steps=4)
    want = [float(np.float32(effective_beta(cfg, s))) for s in range(10)]
    for out in windows:
        assert out["warmup/betas"] == want
        assert out["plain/betas"] == [cfg.model.beta] * 10
    assert windows[0]["plain/window"][2] == 1  # one key: the CPU's signature


@pytest.mark.parametrize("device, backend, want", [
    ("cuda", None, True),  # no collectives: the single-device steps
    ("cuda", "nccl", True),
    ("cuda", "cpu:gloo,cuda:nccl", True),  # the port's backend on the card
    ("cuda", "cuda:nccl,cpu:gloo", True),
    ("cuda", "gloo", False),  # gloo cannot be captured
    ("cuda", "cpu:gloo,cuda:gloo", False),
    ("cuda", "cpu:gloo", False),
    ("cpu", None, False),
    ("cpu", "gloo", False),
    ("cpu", "nccl", False),
    ("cpu", "cpu:gloo,cuda:nccl", False),
])
def test_the_capture_rule(device, backend, want):
    assert captures(device, backend) is want


def test_cuda_backend_reads_the_backend_string():
    assert cuda_backend("cpu:gloo,cuda:nccl") == "nccl"
    assert cuda_backend("nccl") == "nccl"
    assert cuda_backend("gloo") == "gloo"
    assert cuda_backend("cpu:gloo") == ""


@pytest.fixture(scope="module")
def retrace(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("retrace")
    return W.spawn("retrace_suite", 2, workdir, {"workdir": str(workdir)})


@pytest.mark.parametrize("spc", [1, 2])
def test_mesh_fit_captures_each_step_exactly_once(retrace, spc):
    """Across a run over the mesh the train and eval steps each hold one
    key, with steps_per_call 1 and 2, and the guard stays quiet."""
    for out in retrace:
        run = out[f"spc{spc}"]
        assert run["sizes"] == (1, 1) and run["n_steps"] == spc
        assert "WARNING" not in run["printed"]


def test_mesh_retrace_warns_once(retrace):
    """A drifting input signature on the mesh step triggers one warning,
    not one per eval interval."""
    for out in retrace:
        assert out["drift"]["size"] == 2
        first, second = out["drift"]["checks"]
        assert "train_step has 2 captured variants" in first
        assert "WARNING" not in second
