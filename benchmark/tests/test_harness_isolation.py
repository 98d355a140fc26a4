"""Nothing a run imports is JAX or the JAX package, compared by whole
top-level name (the port's name begins with the JAX package's), and the
references import nothing of the program."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vae_mdl_tpu"}

_SET_UP = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from benchmark import run
from conftest import small_cell
cell = small_cell({name!r})
prog = cell.driver.setup(cell, run.Run(seed=7, seconds=0.1, trace=False,
                                       device=torch.device("cpu"), tmp=Path(tempfile.mkdtemp())))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _imported(name: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SET_UP.format(
        root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"), name=name)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.mark.parametrize("name", ["model05-f32-train", "model05-f32-eval5000"])
def test_a_cells_set_up_imports_no_jax(name):
    top = _imported(name)
    assert "vae_mdl_tpu_torch" in top and "benchmark" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "vae_mdl_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (FORBIDDEN | {"vae_mdl_tpu_torch"}), (path, tops)


def test_no_harness_file_imports_jax():
    for path in sorted((ROOT / "benchmark").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops)


def test_a_run_that_loads_jax_in_its_check_prints_no_result(monkeypatch, tmp_path):
    """The search for JAX comes after the check: a module loaded by the
    reference or the comparison is found as one loaded by the window."""
    from conftest import drive_cpu, small_cell

    cell = small_cell("model05-f32-eval5000")
    real = cell.driver.check

    def check(*args):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(*args)

    monkeypatch.setattr(cell.driver, "check", check)
    with pytest.raises(RuntimeError, match="jax"):
        drive_cpu(cell, tmp_path)
