"""Helpers of the harness's CPU tests: a cell of ``BENCHMARK.json`` cut to a
size the CPU runs in seconds (the batch, the pools, the samples; the widths
stay), driven by ``benchmark/run.py``'s ``drive`` with the CPU in place of
the card."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "train": dict(batch_size=4, pool_images=32, val_batch_size=4, probe_steps=2),
    "eval": dict(batch_size=4, n_samples=200, k_chunk=100, test_images=8, check_images=2),
}
# the ladder at full width: fewer images still
SMALL_LADDER = {
    "train": dict(batch_size=2, pool_images=16, val_batch_size=2, probe_steps=1),
}


def small_cell(name: str, **mix):
    from benchmark.lib import cells

    cell = cells.load(ROOT, name)
    sizes = SMALL_LADDER if "stages" in cell.config["model"] else SMALL
    cell.mix.update(sizes[cell.mix["driver"]], **mix)
    return cell


def drive_cpu(cell, tmp_path: Path, seed: int = 2 ** 31 + 99, seconds: float = 0.5):
    from benchmark import run

    torch.set_num_threads(4)
    return run.drive(cell, run.Run(seed=seed, seconds=seconds, trace=False,
                                   device=torch.device("cpu"), tmp=tmp_path))


@pytest.fixture
def cuda():
    """The card, decided inside the test; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
