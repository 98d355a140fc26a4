"""The port stands alone: it imports neither jax, flax nor vae_mdl_tpu, its
CUDA-only paths (the MoDL and discretized-logistic kernels, forward and
backward) refuse CPU tensors instead of falling back, and ``build_model``
places the model on the card unless it is asked for the CPU."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.distributions import DiscretizedLogistic, MixtureDiscretizedLogistic
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS
from vae_mdl_tpu_torch.nn.decoders import resolve_use_pallas
from vae_mdl_tpu_torch.ops.cuda import build, dl_kernel, mdl_kernel

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
    assert int(n_modules) >= 22  # ops.cuda.build and ops.cuda.dl_kernel among them
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
    model = build_model(cfg, device="cpu")
    pxz = model.decode(torch.zeros(1, 1, cfg.n_latent)).dist
    with pytest.raises(ValueError, match="use_pallas=True"):
        pxz.log_prob(torch.zeros(1, 32, 32, 3))


def test_auto_resolves_by_the_operand_device():
    x, p = _inputs()
    assert resolve_use_pallas(None, "mdl", p) is False
    assert resolve_use_pallas(True, "mdl", p) is True
    assert resolve_use_pallas(False, "mdl", p) is False
    assert resolve_use_pallas(None, "mdl", torch.empty(1, device="meta")) is False


def test_backward_kernel_refuses_cpu_tensors():
    x, p = _inputs()
    g = torch.ones(p.shape[:-1] + (1,))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mdl_kernel.mdl_backward_cuda(x, p, g)


def test_backward_takes_the_plain_version_for_cpu_tensors():
    x, p = _inputs()
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(p.shape[:-1] + (1,))
                         .astype(np.float32))
    before = mdl_kernel.backward_launches
    got = mdl_kernel.mdl_backward(x, p, g)
    assert mdl_kernel.backward_launches == before
    torch.testing.assert_close(got, mdl_kernel.mdl_backward_plain(x, p, g), rtol=0, atol=0)


def test_nothing_is_built_at_import():
    """Importing the kernel module compiles and loads nothing."""
    assert mdl_kernel._library.cache_info().currsize == 0
    assert mdl_kernel.library_path().parent == mdl_kernel.BUILD_DIR
    assert mdl_kernel.SOURCE.is_file()


def _dl_inputs():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((2, 4, 4, 3)).astype(np.float32))
    loc = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 3)).astype(np.float32))
    logscale = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 3)).astype(np.float32))
    return x, loc, logscale


def test_dl_kernels_refuse_cpu_tensors():
    x, loc, logscale = _dl_inputs()
    before = dl_kernel.launches, dl_kernel.backward_launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dl_kernel.dl_log_prob_cuda(x, loc, logscale, 0.0, 1.0, 1.0 / 255.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dl_kernel.dl_backward_cuda(x, loc, logscale, torch.ones_like(loc), 0.0, 1.0, 1.0 / 255.0)
    assert (dl_kernel.launches, dl_kernel.backward_launches) == before


def test_dl_use_pallas_true_on_cpu_raises_through_the_model():
    x, loc, logscale = _dl_inputs()
    with pytest.raises(ValueError, match="use_pallas=True"):
        DiscretizedLogistic(loc, logscale, low=0.0, high=1.0, use_pallas=True).log_prob(x)
    cfg = dataclasses.replace(MODELS["model03"], use_pallas=True)
    pxz = build_model(cfg, device="cpu").decode(torch.zeros(1, 1, cfg.n_latent)).dist
    with pytest.raises(ValueError, match="use_pallas=True"):
        pxz.log_prob(torch.zeros(1, 32, 32, 3))


def test_dl_kernel_builds_nothing_at_import():
    assert dl_kernel._library.cache_info().currsize == 0
    assert dl_kernel.SOURCE.is_file() and (build.CSRC / "dl_cascade.cuh").is_file()
    assert build.library_path(dl_kernel.SOURCE).parent == build.BUILD_DIR
    assert build.library_path(dl_kernel.SOURCE) != build.library_path(mdl_kernel.SOURCE)


def test_the_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to ``csrc/dl_cascade.cuh`` is a new build of both sources."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for source in build.CSRC.iterdir():
        (csrc / source.name).write_bytes(source.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = [build.library_path(csrc / name) for name in ("mdl_log_prob.cu", "dl_log_prob.cu")]
    assert before[0].name == mdl_kernel.library_path().name
    with open(csrc / "dl_cascade.cuh", "a") as header:
        header.write("// edited\n")
    after = [build.library_path(csrc / name) for name in ("mdl_log_prob.cu", "dl_log_prob.cu")]
    assert all(a != b for a, b in zip(after, before))


def test_build_model_without_a_device_raises_where_there_is_no_card():
    """The default device is the card; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(MODELS["model03"])
    model = build_model(MODELS["model03"], torch.Generator().manual_seed(0), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


@pytest.mark.parametrize("name,what", [("model01", "MLP encoder"), ("model02", "'gaussian'"),
                                       ("digits", "'bernoulli'")])
def test_families_still_to_port_are_refused_by_name(name, what):
    with pytest.raises(NotImplementedError, match=what):
        build_model(MODELS[name], device="cpu")


def test_head_pad_and_unported_likelihoods_are_refused():
    cfg = MODELS["model05"]
    padded = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, head_pad=64))
    with pytest.raises(NotImplementedError, match="head_pad"):
        build_model(padded, device="cpu")
    with pytest.raises(NotImplementedError, match="'pmdl'"):
        build_model(dataclasses.replace(cfg, likelihood="pmdl"), device="cpu")
