"""The port stands alone: it imports neither jax, flax nor vae_mdl_tpu, and
its CUDA-only paths refuse CPU tensors instead of falling back."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.distributions import MixtureDiscretizedLogistic
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS
from vae_mdl_tpu_torch.nn.decoders import resolve_use_pallas
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vae_mdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vae_mdl_tpu_torch.__path__, "vae_mdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "vae_mdl_tpu"))
print(len(names), bad)
"""


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    n_modules, bad = out.split(maxsplit=1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


def _inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 4, 4, 3)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 50)).astype(np.float32))
    return x, p


def test_kernel_refuses_cpu_tensors():
    x, p = _inputs()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mdl_kernel.mdl_log_prob_cuda(x, p)


def test_use_pallas_true_on_cpu_raises():
    x, p = _inputs()
    with pytest.raises(ValueError, match="use_pallas=True"):
        MixtureDiscretizedLogistic(p, use_pallas=True).log_prob(x)
    cfg = dataclasses.replace(MODELS["model05"], use_pallas=True)
    model = build_model(cfg)
    pxz = model.decode(torch.zeros(1, 1, cfg.n_latent)).dist
    with pytest.raises(ValueError, match="use_pallas=True"):
        pxz.log_prob(torch.zeros(1, 32, 32, 3))


def test_auto_resolves_by_the_operand_device():
    x, p = _inputs()
    assert resolve_use_pallas(None, "mdl", p) is False
    assert resolve_use_pallas(True, "mdl", p) is True
    assert resolve_use_pallas(False, "mdl", p) is False
    assert resolve_use_pallas(None, "mdl", torch.empty(1, device="meta")) is False


def test_kernel_backward_raises_and_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mdl_kernel._MDLLogProb.backward(None, torch.zeros(1))


def test_nothing_is_built_at_import():
    """Importing the kernel module compiles and loads nothing."""
    assert mdl_kernel._forward_fn.cache_info().currsize == 0
    assert mdl_kernel.library_path().parent == mdl_kernel.BUILD_DIR
    assert mdl_kernel.SOURCE.is_file()
