"""The port's entry hooks (``vae_mdl_tpu_torch/graft_entry.py``) against
the JAX package's ``__graft_entry__.py``.

- ``_flagship_cfg(tiny)`` equals JAX's field for field, for both values;
- ``entry(device="cpu")`` gives a finite loss of model05's forward;
- ``dryrun_multichip(4, device="cpu")`` (four gloo ranks it starts itself)
  ends with rank 0's ``ok`` line, in the format of the JAX dry run's line
  (read from its f-string), every number finite where JAX's is;
- ``entry()`` and ``dryrun_multichip(1)`` raise where there is no card.
"""
import ast
import dataclasses
import math
import os
import re

import pytest
import torch

import __graft_entry__ as jax_entry
from vae_mdl_tpu_torch import graft_entry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_line_pattern() -> str:
    """The JAX dry run's ``ok`` line as a regex: its f-string's text, each
    formatted value a number (or nan, the hybrid mesh's where it does not
    run)."""
    tree = ast.parse(open(os.path.join(REPO, "__graft_entry__.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            first = node.values[0]
            if isinstance(first, ast.Constant) and str(first.value).startswith(
                    "[dryrun_multichip] ok:"):
                return "".join(re.escape(part.value) if isinstance(part, ast.Constant)
                               else r"(-?[0-9.]+|nan)" for part in node.values)
    raise AssertionError("the JAX dry run's ok line was not found")


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_cfg_equals_jax(tiny):
    mine = dataclasses.asdict(graft_entry._flagship_cfg(tiny))
    theirs = dataclasses.asdict(jax_entry._flagship_cfg(tiny))
    assert mine == theirs
    if tiny:
        cfg = graft_entry._flagship_cfg(True)
        assert cfg.model.encoder.conv_layers[0][0] == 16
        assert cfg.model.decoder.conv_layers[-1][0] == 50  # the head stays whole


def test_entry_on_the_cpu_gives_a_finite_loss():
    fn, (params, x, generator) = graft_entry.entry(device="cpu")
    assert x.shape == (16, 32, 32, 3) and x.device.type == "cpu"
    with torch.no_grad():
        loss = fn(params, x, generator)
    assert loss.dim() == 0 and torch.isfinite(loss)


def test_dryrun_multichip_over_four_gloo_ranks(capfd):
    line = graft_entry.dryrun_multichip(4, device="cpu")
    assert capfd.readouterr().out.strip().splitlines()[-1] == line
    match = re.fullmatch(_jax_line_pattern(), line)
    assert match, line
    assert "mesh data=2 sample=2," in line and "tp(2x2)" in line
    numbers = [float(v) for v in match.groups()]
    assert all(math.isfinite(v) for v in numbers), line
    assert "sharded_leaves=0" not in line and "ckpt roundtrip step=6" in line


def test_the_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(1)


def test_the_module_imports_no_jax():
    source = open(graft_entry.__file__).read()
    assert not re.search(r"^\s*(import jax|from jax)|vae_mdl_tpu\.|import __graft_entry__",
                         source, re.M)
