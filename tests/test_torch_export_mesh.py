"""Sharded serving (models/export.py ``mesh=``): the port's counterpart of
tests/test_export.py's sharded cases.

Each program is exported by a set of gloo rank processes on the CPU
(tests/torch_parallel_worker.py, scenario ``export_mesh``) and loaded and
run in a fresh set, so the file alone must suffice; its output is held
against the single-device program's on the same seed, here in the test
process. Meshes: ``(2,)`` on two ranks; ``(2, 2)`` (data x sample) and
``(2, 1, 2)`` (with ``model``: two ranks a shard) on four.

Tolerances: the encoder and the reconstructor within rtol = atol = 1e-5
(tests/test_export.py's sharded case): a shard runs its matmuls and
convolutions at a smaller batch, where the library may block the sums
otherwise, a few float32 ulps. The sampler's uint8 images equal, but for one
level on at most 0.1% of the pixels (a few-ulp difference across a rounding
boundary). Every rank returns the same global output, bit for bit, and a
file served with torch alone (no loader) gives the loader's. Only the
comparison with JAX's artifact needs JAX; the rest runs without it.
"""
import io
import json
import operator
import zipfile

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu_torch.models.export import (
    export_encoder,
    export_reconstructor,
    export_sampler,
    load_exported,
)
from vae_mdl_tpu_torch.models.inference import encode_noise, reconstruct_noise, sample_noise

torch.set_num_threads(1)

N = 8
SEED = 3
WHATS = ("sampler", "reconstructor", "encoder")
MODELS = ("model01", "narrow")
MESHES = {(2,): 2, (2, 2): 4, (2, 1, 2): 4}
ATOL = RTOL = 1e-5
PIXEL_SHARE = 1e-3


def _tag(mesh):
    return "x".join(map(str, mesh))


def _images(name):
    shape = (28, 28, 1) if name == "model01" else (8, 8, 3)
    return np.random.default_rng(1).random((N,) + shape, dtype=np.float32)


def _exports(world, workdir):
    out = []
    for mesh, size in MESHES.items():
        if size != world:
            continue
        for name in MODELS:
            for what in WHATS:
                out.append({"mesh": mesh, "model": name, "params": None, "what": what, "n": N,
                            "path": f"{workdir}/{name}_{what}_{_tag(mesh)}.pt2"})
    return out


def _loads(exports):
    return [(f"{e['model']}/{e['what']}/{_tag(e['mesh'])}", e["path"], SEED,
             None if e["what"] == "sampler" else _images(e["model"])) for e in exports]


@pytest.fixture(scope="module")
def jax_encoder():
    """model01's encoder exported by the JAX package on a (data=2, sample=2)
    mesh of host devices, run on sharded images; and its weights for the
    port. None without JAX or 4 host devices: the port's own 4-rank tests
    run all the same, and the comparison with JAX skips."""
    try:
        import jax
    except ImportError:
        return None
    if len(jax.devices()) < 4:
        return None
    import jax.numpy as jnp

    from vae_mdl_tpu.config import MeshConfig
    from vae_mdl_tpu.models import export as jexport
    from vae_mdl_tpu.models.vae import build_model
    from vae_mdl_tpu.models.zoo import experiment
    from vae_mdl_tpu.parallel.mesh import batch_sharding, make_mesh
    from vae_mdl_tpu_torch.utils.convert import params_from_flax

    cfg = experiment("model01")
    model = build_model(cfg.model)
    params = model.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                        jnp.zeros((2, 28, 28, 1), jnp.float32), 1)
    mesh = make_mesh(MeshConfig(data=2, sample=2), devices=jax.devices()[:4])
    x = _images("model01")
    serve = jexport.load_exported(jexport.export_encoder(model, cfg.model, params, x.shape,
                                                         mesh=mesh))
    got = serve(jax.random.PRNGKey(11), jax.device_put(jnp.asarray(x), batch_sharding(mesh)))
    return params_from_flax(params, cfg.model), np.asarray(got[0])


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh2")
    exports = _exports(2, work)
    # each rank passes its own path here: only rank 0's file may appear
    exports.append({"mesh": (2,), "model": "narrow", "params": None, "what": "encoder",
                    "n": N, "path": f"{work}/own_{{rank}}.pt2", "keep": True})
    written = W.spawn("export_mesh", 2, work / "export",
                      {"phase": "export", "exports": exports, "params": {}})
    raw = [(f"raw/{key}", path, seed, images) for key, path, seed, images
           in _loads(exports[:-1]) if key.startswith("narrow/")]
    served = W.spawn("export_mesh", 2, work / "load",
                     {"phase": "load", "loads": _loads(exports[:-1]), "raw": raw})
    return dict(work=work, exports=exports, written=written, served=served)


def _regrouped(path, out):
    """A copy of the sharded program at ``path`` whose gathers name process
    group "9", which no serving process has."""
    extra = {"noise.json": "", "mesh.json": ""}
    program = torch.export.load(path, extra_files=extra)
    for node in program.graph.nodes:
        if "all_gather" in str(node.target):
            node.args = node.args[:2] + ("9",)
    torch.export.save(program, out, extra_files=extra)
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory, two, jax_encoder):
    work = tmp_path_factory.mktemp("mesh4")
    exports = _exports(4, work)
    loads = _loads(exports)
    params = {}
    if jax_encoder is not None:
        params["jax"] = jax_encoder[0]
        exports.append({"mesh": (2, 2), "model": "model01", "params": "jax",
                        "what": "encoder", "n": N, "path": f"{work}/jax_encoder.pt2"})
        loads.append(("jax", f"{work}/jax_encoder.pt2", SEED, _images("model01")))
    W.spawn("export_mesh", 4, work / "export",
            {"phase": "export", "exports": exports, "params": params})
    two_ranks = f"{two['work']}/narrow_sampler_2.pt2"
    regrouped = _regrouped(f"{work}/narrow_sampler_2x2.pt2", f"{work}/regrouped.pt2")
    refusals = [("wrong world", two_ranks, SEED, None), ("wrong group", regrouped, SEED, None),
                ("odd batch", f"{work}/narrow_encoder_2x2.pt2", SEED, _images("narrow")[:6]),
                ("wrong batch", f"{work}/narrow_encoder_2x2.pt2", SEED,
                 np.concatenate([_images("narrow")] * 2))]
    served = W.spawn("export_mesh", 4, work / "load",
                     {"phase": "load", "loads": loads, "refusals": refusals})
    return dict(work=work, served=served)


_SINGLE = {}


def _single_device(name, what):
    """The single-device program's output on ``SEED`` (and the images)."""
    if (name, what) not in _SINGLE:
        cfg, model, params = W.serving_model(name)
        shape = (N,) + tuple(cfg.image_shape)
        if what == "sampler":
            blob, data = export_sampler(model, cfg, params, n=N), ()
        else:
            fn = export_reconstructor if what == "reconstructor" else export_encoder
            blob, data = fn(model, cfg, params, shape), (torch.from_numpy(_images(name)),)
        _SINGLE[name, what] = load_exported(blob, "cpu")(SEED, *data)
    return _SINGLE[name, what]


def _assert_close(got, want, what):
    if what == "sampler":
        assert got.dtype == torch.uint8 and got.shape == want.shape
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= PIXEL_SHARE
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("what", WHATS)
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("mesh", list(MESHES), ids=_tag)
def test_sharded_program_gives_the_single_device_output(two, four, mesh, name, what):
    served = (two if MESHES[mesh] == 2 else four)["served"]
    key = f"{name}/{what}/{_tag(mesh)}"
    outs = [rank[key] for rank in served]
    want = _single_device(name, what)
    _assert_close(outs[0], want, what)
    for other in outs[1:]:  # every rank returns the same global output
        first = outs[0] if isinstance(outs[0], tuple) else (outs[0],)
        other = other if isinstance(other, tuple) else (other,)
        assert all(torch.equal(a, b) for a, b in zip(first, other))


@pytest.mark.parametrize("what", WHATS)
def test_the_file_serves_with_torch_alone(two, what):
    """The gather is in the graph: ``torch.export.load`` and the program's
    ``module()``, fed this rank's rows as ``mesh.json`` says, return the
    global batch, the loader's output bit for bit."""
    key = f"narrow/{what}/2"
    for rank in two["served"]:
        got, loaded = rank[f"raw/{key}"], rank[key]
        got = got if isinstance(got, tuple) else (got,)
        loaded = loaded if isinstance(loaded, tuple) else (loaded,)
        assert len(got) == len(loaded)
        assert all(torch.equal(a, b) for a, b in zip(got, loaded))
    _assert_close(two["served"][0][f"raw/{key}"], _single_device("narrow", what), what)


def _program(path):
    return torch.export.load(path)


@pytest.mark.parametrize("what", WHATS)
def test_sharded_graph_holds_only_aten_and_the_gather(two, four, what):
    """aten, ``operator.getitem`` and the functional all-gather and wait,
    nothing else: no random op, no custom kernel; the gather over the whole
    group of the recorded size."""
    for work, world in ((two["work"], 2), (four["work"], 4)):
        path = f"{work}/model01_{what}_{'2' if world == 2 else '2x1x2'}.pt2"
        program = _program(path)
        gathers = 0
        for node in program.graph.nodes:
            if node.op != "call_function":
                continue
            target = node.target
            if isinstance(target, torch._ops.OpOverload) and target.namespace == "_c10d_functional":
                assert target.__name__ in ("all_gather_into_tensor.default",
                                           "wait_tensor.default"), target
                if target.__name__.startswith("all_gather"):
                    gathers += 1
                    assert node.args[1] == world and str(node.args[2]) == "0"
                continue
            ok = (isinstance(target, torch._ops.OpOverload) and target.namespace == "aten") or (
                target is operator.getitem)
            assert ok, f"{what}: call to {target}"
            assert not any(word in str(target) for word in ("rand", "normal", "bernoulli",
                                                            "uniform", "multinomial")), target
        assert gathers >= 1


def test_only_rank0_writes_and_every_rank_returns_its_bytes(two):
    work = two["work"]
    own = f"{work}/own_{{rank}}.pt2"
    first, second = (rank[own.format(rank=r)] for r, rank in enumerate(two["written"]))
    assert first[1] and not second[1]
    assert first[0] == second[0]
    with open(own.format(rank=0), "rb") as f:
        assert f.read() == first[0]


def test_mesh_json_records_the_layout(two, four):
    """The dimensions, the rank layout, the world, the global batch and each
    noise entry's batch axis (the sampler's draws 0, the encoder's ``[1, B,
    ...]`` 1, the MoDL reconstruction's ``[32, 1, B, ...]`` 2)."""
    def layout(path):
        with zipfile.ZipFile(path) as z:
            name = next(n for n in z.namelist() if n.endswith("mesh.json"))
            noise = next(n for n in z.namelist() if n.endswith("noise.json"))
            return json.loads(z.read(name)), json.loads(z.read(noise))

    cfg = W.narrow_model()
    rec, noise = layout(f"{four['work']}/narrow_reconstructor_2x1x2.pt2")
    assert rec["dims"] == ["data", "sample", "model"] and rec["sizes"] == [2, 1, 2]
    assert rec["ranks"] == [[[0, 1]], [[2, 3]]] and rec["world"] == 4
    assert rec["batch"] == N and rec["shards"] == 2
    assert rec["noise_batch_axes"] == [1, 2, 2]
    assert [tuple(e["shape"]) for e in noise["noise"]] == [s for _, s, _ in
                                                          reconstruct_noise(cfg, N)]
    enc, _ = layout(f"{four['work']}/narrow_encoder_2x2.pt2")
    assert enc["dims"] == ["data", "sample"] and enc["shards"] == 4
    assert enc["noise_batch_axes"] == [1] * len(encode_noise(cfg, N))
    smp, noise = layout(f"{two['work']}/narrow_sampler_2.pt2")
    assert smp["sizes"] == [2, 1] and smp["world"] == 2
    assert smp["noise_batch_axes"] == [0] * len(sample_noise(cfg, N))
    # a single-device program has no mesh.json and loads as before
    cfg01, model, params = W.serving_model("narrow")
    with zipfile.ZipFile(io.BytesIO(export_sampler(model, cfg01, params, n=2))) as z:
        assert not any(n.endswith("mesh.json") for n in z.namelist())


def test_loading_in_a_world_of_the_wrong_size_raises(two, four):
    kind, message = four["served"][0]["wrong world"]
    assert kind == "RuntimeError" and "world of 2" in message and "(4 here)" in message
    # and with no process group at all
    with pytest.raises(RuntimeError, match="world of 2 ranks"):
        load_exported(f"{two['work']}/narrow_sampler_2.pt2", "cpu")


def test_a_gather_over_another_group_raises(four):
    """Every group the graph gathers over must be the whole group: a program
    naming a group the serving process lacks is refused, with the name."""
    for rank in four["served"]:
        kind, message = rank["wrong group"]
        assert kind == "RuntimeError" and "['9']" in message and "whole group of 4" in message


def test_a_batch_that_does_not_divide_raises(four):
    for rank in four["served"]:
        kind, message = rank["odd batch"]
        assert kind == "ValueError" and "6 rows does not divide over 4" in message
        kind, message = rank["wrong batch"]
        assert kind == "ValueError" and f"serves a batch of {N}, not {2 * N}" in message


def test_sharded_encoder_on_bridged_weights_matches_jax_sharded_artifact(four, jax_encoder):
    """tests/test_export.py's sharded case on the port: model01's encoder
    on the JAX weights, exported over (data=2, sample=2) ranks and served in
    fresh ones, against JAX's own sharded artifact on the same images."""
    if jax_encoder is None:
        pytest.skip("needs JAX with 4 host devices (tests/conftest.py's XLA_FLAGS)")
    want = jax_encoder[1]
    for rank in four["served"]:
        got = rank["jax"]
        assert len(got) == 1 and got[0].shape == want.shape
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5)
