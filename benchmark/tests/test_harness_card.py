"""On the card (marker ``cuda``; each test decides for itself whether there
is one and skips where there is none): a short run of each cell reads
``correct``, and each cell's control, the reference computed in the
precision below the configuration's, fails at least one of its limits at
the cell's own size.

    python -m pytest benchmark/tests/test_harness_card.py -q -p no:cacheprovider
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.lib import cells, compare
from conftest import ROOT

pytestmark = pytest.mark.cuda

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_a_short_run_reads_correct(name, cuda):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["kind"].startswith("NVIDIA") and result["device"]["count"] == 1


@pytest.mark.parametrize("name", WORKLOADS)
def test_the_control_fails_a_limit(name, cuda):
    from benchmark import control
    from benchmark.lib import program

    cell = cells.load(ROOT, name)
    with program.tf32(False):
        numbers = control.readings(cell, 2 ** 31 + 11, "control", cuda)
    assert not compare.passed(compare.against(numbers, cell.limits)), numbers
