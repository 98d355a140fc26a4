"""The port's metric logger and image grids against the JAX package's.

Tolerance: none. The JSONL records, canvases and uint8 images are compared
for equality (the same numpy code; tensors are read with ``float``).
"""
import json
import os

import numpy as np
import pytest
import torch

from vae_mdl_tpu.utils import images as jimages
from vae_mdl_tpu.utils.logging import MetricLogger as JaxMetricLogger
from vae_mdl_tpu_torch.utils import images
from vae_mdl_tpu_torch.utils.logging import MetricLogger


def _records(logger):
    with open(os.path.join(logger.dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metric_logger_jsonl_matches_jax(tmp_path):
    """The same metrics, as tensors on the port's side and numbers on JAX's,
    give the same records."""
    ours = MetricLogger(str(tmp_path / "port"), "run")
    theirs = JaxMetricLogger(str(tmp_path / "jax"), "run")
    steps = [(5, {"loss": 1.25, "bpd": np.float32(0.5)}, "Evaluation"),
             (10, {"loss": 1.0, "grad_norm": 3.75, "kl": [0.5, 1.5]}, "Train"),
             (10, {"imgs_per_sec": 812.5, "step_ms": 19.6875}, "Perf")]
    for step, metrics, prefix in steps:
        as_tensors = {name: torch.tensor(v) if not isinstance(v, list)
                      else [torch.tensor(u) for u in v] for name, v in metrics.items()}
        ours.scalars(step, as_tensors, prefix=prefix)
        theirs.scalars(step, metrics, prefix=prefix)
    ours.image(5, "grid", np.zeros((16, 16, 3), np.float32))
    ours.close()
    theirs.close()
    assert _records(ours) == _records(theirs)
    assert _records(ours)[0] == {"step": 5, "prefix": "Evaluation", "loss": 1.25, "bpd": 0.5}


def test_metric_logger_writes_tensorboard_where_it_imports(tmp_path):
    pytest.importorskip("tensorboardX")
    logger = MetricLogger(str(tmp_path), "run")
    logger.scalars(1, {"loss": torch.tensor(2.0)})
    logger.image(1, "grid", np.ones((8, 8, 3), np.float32))
    logger.close()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(logger.dir))


@pytest.mark.parametrize("n_images", [4, 3, 9])
def test_fill_canvas_matches_jax(n_images):
    imgs = np.random.default_rng(0).random((n_images, 8, 6, 3)).astype(np.float32)
    got, want = images.fill_canvas(imgs, 2), jimages.fill_canvas(imgs, 2)
    assert got.shape == (16, 12, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if n_images == 3:  # the missing cell stays zero
        assert np.all(got[8:, 6:] == 0)


def test_to_uint8_matches_jax(tmp_path):
    values = np.array([-0.5, 0.0, 0.0019, 0.002, 0.5, 0.9999, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(images.to_uint8(values), jimages.to_uint8(values))
    assert images.to_uint8(values).dtype == np.uint8
    raw = np.arange(6, dtype=np.uint8)
    assert images.to_uint8(raw) is raw
    pytest.importorskip("PIL")
    path = str(tmp_path / "grid.png")
    images.save_png(images.fill_canvas(np.ones((4, 4, 4, 1), np.float32), 2), path)
    assert os.path.getsize(path) > 0
