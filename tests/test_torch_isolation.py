"""The port stands alone: it imports neither jax, flax nor vae_mdl_tpu, its
CUDA-only paths (the MoDL and discretized-logistic kernels, forward and
backward, the probe kernel, the channel sum and the null-body kernels) refuse
CPU tensors instead of falling back, and ``build_model``, the timing harness
and the probes run on the card unless they are asked for the CPU."""
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
from vae_mdl_tpu_torch.ops.cuda import (
    build,
    dl_kernel,
    io_probe,
    mdl_kernel,
    mdl_null,
    sfu_probe,
)
from vae_mdl_tpu_torch.probes import kernel_isolate, kernel_isolate2, kernel_structure, roofline

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vae_mdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vae_mdl_tpu_torch.__path__, "vae_mdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "vae_mdl_tpu"))
wanted = ["ops.cuda.sfu_probe", "ops.cuda.io_probe", "ops.cuda.mdl_null", "utils.flops",
          "utils.timing", "probes.roofline", "probes.kernel_isolate", "probes.kernel_isolate2",
          "probes.kernel_structure", "bench", "probes.prod_attribution",
          "probes.ablation_attribution", "probes.eval_sweep", "probes.eval_attribution",
          "probes.khat_overhead", "probes.objective_cost", "probes.stability_overhead",
          "probes.scale_probe", "probes.perf_probe", "probes.biladder_ablation",
          "probes.trace_profile", "probes.kernel_bench", "scripts.dump_assets"]
bad += [w for w in wanted if "vae_mdl_tpu_torch." + w not in names]
print(len(names), bad)
"""


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    n_modules, bad = out.split(maxsplit=1)
    assert int(n_modules) >= 46  # the probes, the bench, utils.flops and utils.timing
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
    """The families this test saw refused until their parts were ported: each
    now builds, with the part that was missing in place."""
    model = build_model(MODELS[name], torch.Generator().manual_seed(0), device="cpu")
    if what == "MLP encoder":
        assert type(model.encoder).__name__ == "MLPEncoder"
        assert type(model.decoder).__name__ == "MLPDecoder"
    h, w, c = MODELS[name].image_shape
    pxz = model.decode(torch.zeros(1, 1, MODELS[name].n_latent)).dist
    expected = {"'gaussian'": "Normal", "'bernoulli'": "Bernoulli", "MLP encoder": "Bernoulli"}
    assert type(pxz).__name__ == expected[what]
    assert torch.isfinite(pxz.reduced_log_prob(torch.zeros(1, h, w, c))).all()


def test_head_pad_and_unported_likelihoods_are_refused():
    """``head_pad`` is ported now and builds (the head emits 64 channels,
    the observation keeps 50); "pmdl" is ported and builds; a likelihood
    that does not exist raises where the head is built."""
    cfg = MODELS["model05"]
    padded = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, head_pad=64))
    model = build_model(padded, device="cpu")
    assert model.decoder.conv_3.weight.shape[0] == 64
    assert model.decode(torch.zeros(1, 1, cfg.n_latent)).dist.parameters.shape[-1] == 50
    pmdl = build_model(dataclasses.replace(cfg, likelihood="pmdl"), device="cpu")
    pxz = pmdl.decode(torch.zeros(1, 1, cfg.n_latent)).dist
    assert pxz.log_prob(torch.zeros(1, 32, 32, 3)).shape == (1, 1, 32, 32)
    with pytest.raises(KeyError):
        build_model(dataclasses.replace(cfg, likelihood="poisson"), device="cpu")


def test_probe_kernels_refuse_cpu_tensors_and_build_nothing_at_import():
    x, p = _inputs()
    g = torch.ones(p.shape[:-1] + (1,))
    before = (sfu_probe.launches, io_probe.launches, mdl_null.launches,
              mdl_null.backward_launches)
    for call in (lambda: sfu_probe.loop_probe_cuda(torch.ones(256), "exp", 2, chains=1),
                 lambda: io_probe.channel_sum_cuda(torch.ones(2, 8, 5)),
                 lambda: mdl_null.mdl_null_forward_cuda(x, p),
                 lambda: mdl_null.mdl_null_backward_cuda(x, p, g)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    assert before == (sfu_probe.launches, io_probe.launches, mdl_null.launches,
                      mdl_null.backward_launches)
    assert sfu_probe._library.cache_info().currsize == 0
    assert io_probe.library.cache_info().currsize == 0
    for module in (sfu_probe, io_probe):
        assert module.SOURCE.is_file()
        assert build.library_path(module.SOURCE).parent == build.BUILD_DIR
    assert (build.CSRC / "mdl_addressing.cuh").is_file()


def test_probe_wrappers_take_the_plain_versions_for_cpu_tensors():
    x, p = _inputs()
    g = torch.ones(p.shape[:-1] + (1,))
    torch.testing.assert_close(sfu_probe.loop_probe(x, "tanh", 2),
                               torch.tanh(torch.tanh(x)), rtol=0, atol=0)
    torch.testing.assert_close(io_probe.channel_sum(p[0, 0]), p[0, 0].sum(-1), rtol=0, atol=0)
    torch.testing.assert_close(mdl_null.mdl_null_backward(x, p, g), 0.5 * p + 1.0, rtol=0, atol=0)
    assert (sfu_probe.launches, io_probe.launches, mdl_null.backward_launches) == (0, 0, 0)


def test_the_probes_need_a_card():
    """No probe carries on on the CPU when no card is found."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for run in (roofline.run, kernel_structure.run, kernel_isolate.run, kernel_isolate2.run):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    assert mdl_kernel.mdl_log_prob.__module__ == mdl_kernel.__name__  # nothing left swapped


# the measurement entry points, by module, with the arguments a call needs
# beyond the device
MEASUREMENT_ENTRIES = {
    "bench": {}, "prod_attribution": {}, "ablation_attribution": {}, "eval_sweep": {},
    "eval_attribution": {}, "khat_overhead": {}, "objective_cost": {}, "stability_overhead": {},
    "scale_probe": {}, "perf_probe": {}, "biladder_ablation": {}, "trace_profile": {},
    "kernel_bench": {"arms": ("plain",)},
    "dump_assets": {"model": "model05", "checkpoint_dir": "no-such-dir"},
}


def _entry(name):
    import importlib

    package = ("vae_mdl_tpu_torch" if name == "bench" else
               "vae_mdl_tpu_torch.scripts" if name == "dump_assets" else "vae_mdl_tpu_torch.probes")
    return importlib.import_module(f"{package}.{name}").run


@pytest.mark.parametrize("name", sorted(MEASUREMENT_ENTRIES))
def test_the_measurement_entries_need_a_card_unless_asked_for_the_cpu(name, monkeypatch):
    """Without a card each entry raises before it builds anything, unless it
    is given ``device="cpu"``: then it gets past the device check (and here
    stops at the first thing it builds, stubbed to raise)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from vae_mdl_tpu_torch.utils import timing

    run, kwargs = _entry(name), MEASUREMENT_ENTRIES[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(**kwargs)

    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached

    # past the device check every entry builds a model (the trainer's too)
    for module in (timing, __import__("vae_mdl_tpu_torch.train.trainer", fromlist=["x"])):
        monkeypatch.setattr(module, "build_model", reached)
    monkeypatch.setattr(timing, "seeded_model", reached)
    monkeypatch.setattr("vae_mdl_tpu_torch.probes.kernel_bench.inputs", reached)
    monkeypatch.setattr("vae_mdl_tpu_torch.probes.biladder_ablation.check_manual_exact",
                        reached)
    for module in ("bench", "probes.eval_sweep", "probes.khat_overhead", "probes.perf_probe",
                   "probes.trace_profile"):
        monkeypatch.setattr(f"vae_mdl_tpu_torch.{module}.seeded_model", reached)
    with pytest.raises(Reached):
        run(device="cpu", **kwargs)
