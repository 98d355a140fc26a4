"""Export for serving (models/export.py): ``torch.export`` programs with the
weights in them, their noise as inputs, loadable with torch alone.

The port's counterpart of tests/test_export.py. On the CPU a loaded program
equals the live function bit for bit on the same draws (the same aten
operations on the same inputs): ``load_exported(path, "cpu")(seed)`` draws
them as the live function does from a generator seeded ``seed``. A program
holds ``aten`` and ``operator`` calls only: no custom kernel (the
likelihood's ctypes-bound CUDA kernels cannot be exported, and sampling,
reconstruction and encoding evaluate no log-likelihood) and no random op
(every draw is an input).
"""
import operator
import os

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.models.export import (
    export_callable,
    export_encoder,
    export_reconstructor,
    export_sampler,
    load_exported,
)
from vae_mdl_tpu_torch.models.inference import (
    encode_noise,
    make_encoder_fn,
    make_reconstructor,
    make_sampler,
    reconstruct_noise,
    sample_noise,
)
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS

torch.set_num_threads(1)

_MODELS = {}


def _model(name):
    if name not in _MODELS:
        cfg = MODELS[name]
        model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        _MODELS[name] = cfg, model, {n: p.detach() for n, p in model.named_parameters()}
    return _MODELS[name]


def _images(cfg, batch, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(
        (batch,) + tuple(cfg.image_shape), dtype=np.float32))


def _program(blob):
    import io

    return torch.export.load(io.BytesIO(blob))


def _call_targets(blob):
    return [node.target for node in _program(blob).graph.nodes if node.op == "call_function"]


def test_export_callable_roundtrip(tmp_path):
    path = str(tmp_path / "f.pt2")
    blob = export_callable(lambda params, noise, data: data[0] @ data[1] + 1.0,
                           (torch.zeros(3, 4), torch.zeros(4, 2)), path)
    assert isinstance(blob, bytes) and len(blob) > 0
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = torch.ones(4, 2)
    f = load_exported(path, device="cpu")
    assert f.noise_spec == []
    assert torch.equal(f(None, a, b), a @ b + 1.0)


@pytest.mark.parametrize("name", ["model01", "model05", "ladder_svhn"])
def test_sampler_export_matches_live(tmp_path, name):
    cfg, model, params = _model(name)
    path = str(tmp_path / "sampler.pt2")
    export_sampler(model, cfg, params, n=3, path=path)
    serve = load_exported(path, device="cpu")
    assert serve.noise_spec == sample_noise(cfg, 3)
    got = serve(7)
    want = make_sampler(model, cfg)(params, torch.Generator().manual_seed(7), 3)
    assert got.shape == (3,) + cfg.image_shape and got.dtype == torch.uint8
    assert torch.equal(got, want)
    # a generator works as a seed does
    assert torch.equal(serve(torch.Generator().manual_seed(7)), want)


@pytest.mark.parametrize("name", ["model01", "model05"])
def test_reconstructor_and_encoder_export(tmp_path, name):
    cfg, model, params = _model(name)
    x = _images(cfg, 2)

    blob = export_reconstructor(model, cfg, params, x.shape, path=str(tmp_path / "r.pt2"))
    serve = load_exported(blob, device="cpu")
    assert serve.noise_spec == reconstruct_noise(cfg, 2)
    got = serve(3, x)
    want = make_reconstructor(model, cfg)(params, torch.Generator().manual_seed(3), x)
    assert got.shape == x.shape and torch.equal(got, want)

    blob = export_encoder(model, cfg, params, x.shape)
    serve = load_exported(blob, device="cpu")
    assert serve.noise_spec == encode_noise(cfg, 2)
    got = serve(3, x.numpy())
    want = make_encoder_fn(model)(params, torch.Generator().manual_seed(3), x)
    assert len(got) == len(want) == 1 and torch.equal(got[0], want[0])


def test_export_hierarchical_family(tmp_path):
    """model06's two stochastic layers: the encoder's second latent depends
    on the first's draw, an input of the program."""
    cfg, model, params = _model("model06")
    x = _images(cfg, 2, seed=1)
    serve = load_exported(export_encoder(model, cfg, params, x.shape), device="cpu")
    got = serve(5, x)
    want = make_encoder_fn(model)(params, torch.Generator().manual_seed(5), x)
    assert [tuple(t.shape) for t in got] == [(2, 20), (1, 2, 20)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("what", ["sampler", "reconstructor", "encoder"])
def test_exported_graph_holds_only_aten_and_operator(what):
    """A call outside ``aten`` and ``operator`` (a custom kernel, a
    higher-order grad-mode switch) fails here; so does a random op, and a
    program whose inputs are not the recorded noise and the data."""
    cfg, model, params = _model("model05")
    shape = (2,) + cfg.image_shape
    if what == "sampler":
        blob, spec = export_sampler(model, cfg, params, n=2), sample_noise(cfg, 2)
    elif what == "reconstructor":
        blob = export_reconstructor(model, cfg, params, shape)
        spec = reconstruct_noise(cfg, 2)
    else:
        blob, spec = export_encoder(model, cfg, params, shape), encode_noise(cfg, 2)
    targets = _call_targets(blob)
    assert targets
    for target in targets:
        ok = (isinstance(target, torch._ops.OpOverload) and target.namespace == "aten") or (
            getattr(target, "__module__", None) in ("_operator", "operator")
            and target is operator.getitem)
        assert ok, f"{what}: call to {target} outside aten/operator"
        assert not any(word in str(target) for word in ("rand", "normal", "bernoulli",
                                                        "uniform", "multinomial")), target
    inputs = [s for s in _program(blob).graph_signature.input_specs
              if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    assert len(inputs) == len(spec) + (0 if what == "sampler" else 1)


def test_load_exported_moves_the_program_to_the_device(tmp_path, monkeypatch):
    """``load_exported(path, "cpu")`` goes through ``move_to_device_pass``
    (the place of the JAX export's ``platforms``); ``device=None`` means the
    card and raises where there is none."""
    from torch.export import passes

    cfg, model, params = _model("model01")
    path = str(tmp_path / "s.pt2")
    export_sampler(model, cfg, params, n=2, path=path)
    seen = []
    real = passes.move_to_device_pass

    def spy(program, location):
        seen.append(torch.device(location))
        return real(program, location)

    monkeypatch.setattr(passes, "move_to_device_pass", spy)
    imgs = load_exported(path, device="cpu")(0)
    assert seen == [torch.device("cpu")] and imgs.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_exported(path)


def test_mesh_raises():
    """``mesh=`` exports the sharded layout, which needs a process group
    (tests/test_torch_export_mesh.py runs it over gloo ranks): without one
    it raises, naming that need."""
    cfg, model, params = _model("model01")
    with pytest.raises(RuntimeError, match="needs a process group.*init_distributed"):
        export_sampler(model, cfg, params, n=2, mesh=object())
    with pytest.raises(RuntimeError, match="needs a process group.*init_distributed"):
        export_encoder(model, cfg, params, (2, 28, 28, 1), mesh=object())


def test_server_subprocess_imports_only_torch(tmp_path):
    """The serving example's server script, in its own process: it loads the
    ``.pt2``, draws the recorded noise and samples, importing torch alone,
    and gets what ``load_exported`` gets here."""
    from vae_mdl_tpu_torch.examples.serve_model import serve

    cfg, model, params = _model("model05")
    path = str(tmp_path / "m05.pt2")
    export_sampler(model, cfg, params, n=2, path=path)
    with open(path, "rb") as f:
        assert b"noise.json" in f.read()
    served = serve(path, "cpu", 4, str(tmp_path / "out.pt"))
    assert torch.equal(served, load_exported(path, device="cpu")(4))


def test_cli_export(tmp_path, monkeypatch, capsys):
    from vae_mdl_tpu_torch.cli.run import main

    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--dataset", "synthetic:mnist", "--batch-size", "8",
              "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "tb")]
    main(["export", "model01", "--what", "sampler", "--n", "4",
          "--out", str(tmp_path / "m01.pt2")] + common)
    out = capsys.readouterr().out
    assert "wrote sampler" in out and "single-device" in out and "device=cpu" in out
    imgs = load_exported(str(tmp_path / "m01.pt2"), device="cpu")(0)
    assert imgs.shape == (4, 28, 28, 1) and imgs.dtype == torch.uint8

    main(["export", "model01", "--what", "encoder", "--n", "8"] + common)
    out = capsys.readouterr().out
    assert os.path.exists(tmp_path / "assets" / "model01_encoder.pt2")
    latents = load_exported(str(tmp_path / "assets" / "model01_encoder.pt2"), "cpu")(
        0, torch.zeros(8, 28, 28, 1))
    assert latents[0].shape == (8, 100)
    # --mesh none stays the single-device program, as no --mesh does
    main(["export", "model01", "--what", "encoder", "--n", "8", "--mesh", "none"] + common)
    assert "layout=single-device" in capsys.readouterr().out


def test_cli_export_mesh_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m vae_mdl_tpu_torch
    export model01 --device cpu --mesh 2``: rank 0 alone prints the sharded
    layout of the two ranks and writes the file, which serves in two fresh
    gloo ranks and gives the single-device program's latents."""
    import re
    import subprocess
    import sys

    import torch_parallel_worker as W

    out = str(tmp_path / "enc.pt2")
    env = {k: v for k, v in os.environ.items() if k not in W._DROP}
    env.update(PYTHONPATH=W.REPO, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "vae_mdl_tpu_torch", "export", "model01", "--device", "cpu", "--mesh", "2",
         "--what", "encoder", "--n", "8", "--dataset", "synthetic:mnist", "--batch-size", "8",
         "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "tb"),
         "--out", out],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    assert re.findall(r"layout=(.*?)\) to", run.stdout) == ["sharded (2, 1)"], run.stdout
    x = _images(MODELS["model01"], 8, seed=2).numpy()
    served = W.spawn("export_mesh", 2, tmp_path / "serve",
                     {"phase": "load", "loads": [("enc", out, 5, x)]})
    cfg, model, params = _model("model01")
    want = make_encoder_fn(model)(params, torch.Generator().manual_seed(5), torch.from_numpy(x))
    for rank in served:
        np.testing.assert_allclose(rank["enc"][0].numpy(), want[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
