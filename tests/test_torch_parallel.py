"""The port's parallel paths on the CPU, in 2 and 4 gloo rank processes
(tests/torch_parallel_worker.py): the semantics tests/test_parallel.py pins
for the JAX package, held on the narrow model05 family and the tiny ladders.

Tolerances, each with its reason:
- across ranks: bit-equal (every rank applies the same averaged gradient);
- the data-parallel step against the single-rank step on the same rows and
  the same injected noise: rtol 1e-5, atol 1e-6 on every parameter leaf
  and every Adam moment (measured 4.5e-8: a mean over two ranks' float32
  gradient sums against one sum over all rows), the loss at rtol 1e-6. A
  sum where the mean belongs doubles every first moment;
- ZeRO-1 against the data-parallel step: rtol 1e-6, atol 1e-7 (measured
  bit-equal: the same gradient mean, sliced, and the same optimizer
  arithmetic per element); under a binding clip 1e-5 / 1e-7 (the norm is a
  sum of slice sums, in another order);
- the sharded evaluator against one rank: rtol 1e-6 (measured bit-equal:
  the same chunks' states combined with an exact max and a sum of
  partial sums);
- the tensor-parallel layout against the single-rank step: rtol 1e-5, atol
  1e-6 on the leaves, 1e-5 on the moments (measured 1.3e-7 and 1.9e-6).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu_torch.models.vae import build_model, latent_shapes
from vae_mdl_tpu_torch.parallel.mesh import _device_array
from vae_mdl_tpu_torch.parallel.tensor import _tp_specs
from vae_mdl_tpu_torch.evaluation.harness import make_batch_evaluator

torch.set_num_threads(1)


def _close(a, b, rtol, atol):
    """Two trees of tensors (dicts and lists) element-wise close."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _close(a[key], b[key], rtol, atol)
    elif isinstance(a, (list, tuple)):
        for u, v in zip(a, b):
            _close(u, v, rtol, atol)
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


def _inputs():
    rng = np.random.default_rng(0)
    cfg = W.experiment_of(W.narrow_model())
    _, _, state = W.setup(cfg)
    inputs = {"params": {n: p.detach().clone() for n, p in state.params.items()},
              "batch": rng.integers(0, 256, (8, 8, 8, 3), dtype=np.uint8),
              "eps": rng.standard_normal((5, 8, 4)).astype(np.float32),
              "eval_batch": rng.integers(0, 256, (8, 8, 8, 3), dtype=np.uint8),
              "eval_eps": rng.standard_normal((8, 4, 8, 4)).astype(np.float32),
              "batch32": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)}
    for family in ("ladder", "biladder"):
        inputs[f"eps_{family}"] = [rng.standard_normal((2, 4) + shape).astype(np.float32)
                                   for shape in latent_shapes(W.tiny_ladder(family))]
    return inputs


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def dp(inputs, tmp_path_factory):
    return W.spawn("dp_suite", 2, tmp_path_factory.mktemp("dp"), inputs)


@pytest.fixture(scope="module")
def ladders(inputs, tmp_path_factory):
    return W.spawn("ladder_suite", 2, tmp_path_factory.mktemp("ladders"), inputs)


@pytest.fixture(scope="module", params=[2, 4])
def evals(request, inputs, tmp_path_factory):
    world = request.param
    return world, W.spawn("eval_suite", world, tmp_path_factory.mktemp(f"eval{world}"), inputs)


# -- layout ----------------------------------------------------------------------


def test_mesh_shapes_and_errors(evals):
    world, outs = evals
    meshes = outs[0]["meshes"]
    assert meshes["MeshConfig(data=-1, sample=1, model=1)"][0] == {"data": world, "sample": 1}
    assert meshes[f"MeshConfig(data={world // 2}, sample=2, model=1)"][0] == {
        "data": world // 2, "sample": 2}
    assert meshes[f"MeshConfig(data=1, sample={world // 2}, model=2)"][0] == {
        "data": 1, "sample": world // 2, "model": 2}
    assert meshes["MeshConfig(data=3, sample=2, model=1)"] == f"mesh 3x2x1 != {world} ranks"
    assert meshes["MeshConfig(data=-1, sample=3, model=1)"].startswith("mesh ")
    # each rank its own batch shard over data x sample; the model ranks share one
    shards = [out["meshes"][f"MeshConfig(data=1, sample={world // 2}, model=2)"][1]
              for out in outs]
    assert shards == [(r // 2, world // 2) for r in range(world)]


def test_hybrid_mesh_slice_major_on_data_axis():
    """Ranks on two hosts of four: each data row lives on one host, host 0
    first, whatever order the hosts' ranks come in."""
    arr = _device_array(list(range(8)), 4, 2, 1, lambda r: r // 4)
    for row in range(4):
        assert {r // 4 for r in arr[row].flat} == {row // 2}
    col = [r % 2 for r in _device_array(list(range(8)), 8, 1, 1, lambda r: r % 2)[:, 0, 0]]
    assert col == [0, 0, 0, 0, 1, 1, 1, 1]
    assert _device_array(list(range(8)), 4, 2, 1, None).flatten().tolist() == list(range(8))


def test_hybrid_mesh_rejects_bad_slice_layouts():
    with pytest.raises(ValueError, match="multiple of the DCN slice count"):
        _device_array(list(range(8)), 2, 4, 1, lambda r: r // 2)
    with pytest.raises(ValueError, match="unequal DCN slice sizes"):
        _device_array(list(range(8)), 8, 1, 1, lambda r: 0 if r < 3 else 1)


# -- the data-parallel step and ZeRO-1 --------------------------------------------


@pytest.mark.parametrize("case", ["plain", "ema", "clip"])
def test_data_parallel_step_matches_single_rank(dp, case):
    single, m1 = dp[0][f"{case}/single"]
    state, m2 = dp[0][f"{case}/dp"]
    assert m2["loss"] == pytest.approx(m1["loss"], rel=1e-6)
    _close(state["params"], single["params"], 1e-5, 1e-6)
    _close(state["opt_state"], single["opt_state"], 1e-5, 1e-6)
    if case == "ema":  # the EMA copy follows the same update on every rank
        _close(state["ema"], single["ema"], 1e-5, 1e-6)


def test_moments_are_of_the_gradient_mean_not_its_sum(dp):
    """Adam is invariant to the gradient's scale in its parameters, not in
    its moments: a sum over the two ranks would double mu and quadruple nu."""
    single = dp[0]["plain/single"][0]["opt_state"]
    state = dp[0]["plain/dp"][0]["opt_state"]
    for key, power in (("mu", 1), ("nu", 2)):
        got = torch.cat([v.reshape(-1) for v in state[key].values()])
        want = torch.cat([v.reshape(-1) for v in single[key].values()])
        ratio = float(got.norm() / want.norm())
        assert ratio == pytest.approx(1.0, rel=1e-5), (key, ratio, 2 ** power)


@pytest.mark.parametrize("case", ["plain", "ema", "dp", "zero1"])
def test_replicas_stay_bit_equal(dp, case):
    key = "three/" + case if case in ("dp", "zero1") else f"{case}/dp"
    a, b = dp[0][key], dp[1][key]
    a, b = (a[0], b[0]) if isinstance(a, tuple) else (a, b)
    _close(a["params"], b["params"], 0, 0)
    if a["ema"] is not None:
        _close(a["ema"], b["ema"], 0, 0)


def test_zero1_matches_the_data_parallel_step(dp):
    """Three steps on the generators' own draws (both steps fold the rank
    into them), and one on injected noise."""
    losses = dp[0]["three/losses"]
    np.testing.assert_allclose(losses["zero1"], losses["dp"], rtol=1e-6)
    _close(dp[0]["three/zero1"]["params"], dp[0]["three/dp"]["params"], 1e-6, 1e-7)
    n = sum(p.numel() for p in dp[0]["three/dp"]["params"].values())
    mu_dp = torch.cat([v.reshape(-1) for v in dp[0]["three/dp"]["opt_state"]["mu"].values()])
    mu_z = dp[0]["three/zero1"]["opt_state"]["mu"]["flat"]
    torch.testing.assert_close(mu_z[:n], mu_dp, rtol=1e-6, atol=1e-7)
    assert not mu_z[n:].any()
    # the moments really live 1/2 per rank
    n_pad = mu_z.numel()
    assert n_pad % 2 == 0 and n_pad - n < 2
    for rank in (0, 1):
        local = dp[rank]["three/zero1"]["local_mu"]
        assert local.shape == (n_pad // 2,)
        torch.testing.assert_close(local, mu_z[rank * n_pad // 2:(rank + 1) * n_pad // 2],
                                   rtol=0, atol=0)
    _close(dp[0]["plain/zero1"][0]["params"], dp[0]["plain/dp"][0]["params"], 1e-6, 1e-7)


def test_zero1_clip_uses_the_collective_norm(dp):
    """With a binding clip (norm ~75 against 0.01) one ZeRO-1 step equals one
    data-parallel step, whose gradient is whole; a clip by the slice's own
    norm would scale the two slices differently."""
    z, mz = dp[0]["clip/zero1"]
    d, md = dp[0]["clip/dp"]
    assert md["grad_norm"] > 0.01
    assert mz["grad_norm"] == pytest.approx(md["grad_norm"], rel=1e-5)
    _close(z["params"], d["params"], 1e-5, 1e-7)


def test_grad_skip_under_both_paths(dp, inputs):
    """An always-exceeded threshold: parameters bit-equal to the initial
    ones, the step counted, the global norm the same on both paths."""
    for kind in ("dp", "zero1"):
        state, metrics = dp[0][f"skip/{kind}"]
        assert metrics["skipped"] == 1.0 and state["step"] == 1
        _close(state["params"], inputs["params"], 0, 0)
    assert dp[0]["skip/zero1"][1]["grad_norm"] == pytest.approx(
        dp[0]["skip/dp"][1]["grad_norm"], rel=1e-5)


@pytest.mark.parametrize("family", ["ladder", "biladder"])
def test_ladder_data_parallel_matches_single_rank(ladders, family):
    single, m1 = ladders[0][f"{family}/single"]
    state, m2 = ladders[0][f"{family}/dp"]
    assert m2["loss"] == pytest.approx(m1["loss"], rel=1e-6)
    _close(state["params"], single["params"], 1e-5, 1e-6)
    _close(ladders[0][f"{family}/dp"][0]["params"], ladders[1][f"{family}/dp"][0]["params"],
           0, 0)


@pytest.mark.parametrize("skip", [0.0, 1e-9])
def test_zero1_and_grad_skip_on_ladder(ladders, skip):
    state, metrics = ladders[0][f"biladder/zero1_skip{skip:g}"]
    init = ladders[0]["biladder/init"]
    assert state["step"] == 1
    changed = any(not torch.equal(state["params"][n], init[n]) for n in init)
    assert changed == (skip == 0.0)
    if skip:
        assert metrics["skipped"] == 1.0
    n = sum(p.numel() for p in init.values())
    assert state["local_mu"].numel() == -(-n // 2)


# -- the sharded evaluator --------------------------------------------------------


def test_sample_sharded_eval_matches_unsharded(evals, inputs):
    """Rows over data, k-chunks over sample, on every split of the ranks:
    the bound, the k-hat tails and the convergence curve of one rank, on
    injected noise and on a generator's."""
    world, outs = evals
    cfg = W.experiment_of(W.narrow_model())
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(inputs["params"])
    ev = make_batch_evaluator(model, cfg, n_samples=32, k_chunk=4, with_khat=True,
                              with_curve=True)
    batch = torch.from_numpy(inputs["eval_batch"])
    want = {"eps": ev(batch, eps=torch.from_numpy(inputs["eval_eps"])),
            "gen": ev(batch, torch.Generator().manual_seed(3))}
    splits = [k for k in outs[0] if k != "meshes"]
    assert len(splits) == (2 if world == 2 else 3) * 2
    for key in splits:
        for got in (outs[0][key], outs[-1][key]):
            for g, w in zip(got, want[key.split("/")[1]]):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


# -- tensor parallelism -----------------------------------------------------------


@pytest.mark.parametrize("name", ["model05", "model01"])
def test_tp_eligible_layers_by_type(name):
    """The output-channel dim by layer type: dim 1 of a transposed conv's
    IOHW weight (model05's decoder.conv_1: 128 in, 64 out), dim 0 of a conv
    or a dense layer; heads stay whole."""
    from vae_mdl_tpu_torch.models.zoo import MODELS

    model = build_model(MODELS[name], device="cpu")
    specs = _tp_specs(dict(model.named_parameters()), model, 2, 64)
    if name == "model05":
        assert tuple(model.decoder.conv_1.weight.shape) == (128, 64, 4, 4)
        assert specs["decoder.conv_1.weight"] == (None, "model", None, None)
        assert specs["encoder.conv_0.weight"] == ()  # 32 output channels: too narrow
        assert specs["encoder.Dense_0.weight"] == ()  # the latent head
        assert specs["decoder.conv_3.weight"] == ()  # the likelihood head
    else:
        assert specs["decoder.out.weight"] == () and specs["decoder.out.bias"] == ()
        assert specs["encoder.MLPBlock_0.Dense_2.weight"] == ()
        assert specs["encoder.MLPBlock_0.Dense_0.weight"] == ("model", None)
        assert specs["decoder.Dense_0.weight"] == ("model", None)


@pytest.mark.parametrize("family", ["ladder", "biladder"])
def test_tp_layout_on_ladder_keeps_heads_replicated(family):
    model = build_model(W.tiny_ladder(family), device="cpu")
    params = dict(model.named_parameters())
    specs = _tp_specs(params, model, 2, 8)
    import re

    head = re.compile(r"^(obs_head|q_top|p_\d+|q_\d+)$")
    heads = [n for n in params if any(head.match(p) for p in n.split("."))]
    named = {p for n in heads for p in n.split(".") if head.match(p)}
    assert named == ({"obs_head", "q_top", "p_0", "q_0"} if family == "biladder"
                     else {"obs_head"}), named
    assert heads and all(specs[n] == () for n in heads)
    assert any(specs[n] for n in params if n not in heads)


@pytest.fixture(scope="module")
def tp4(inputs, tmp_path_factory):
    return W.spawn("tp_suite", 4, tmp_path_factory.mktemp("tp4"), inputs)


@pytest.mark.parametrize("case", ["plain", "clip"])
def test_tensor_parallel_with_data_parallel_matches_single_rank(tp4, inputs, case):
    """A 2x2 (data, model) mesh: the data-parallel step on a state in the
    tensor-parallel layout equals the single-rank step; the global norm of
    a binding clip sums the channel slices over the model group."""
    train = {"grad_clip_norm": 0.01} if case == "clip" else {}
    cfg = W.experiment_of(W.narrow_model(), **train)
    model, tx, state = W.setup(cfg, inputs["params"])
    state, metrics = W.make_train_step(model, cfg, tx)(
        state, torch.from_numpy(inputs["batch"]), eps=torch.from_numpy(inputs["eps"]))
    for out in tp4:
        got, m = out[case]
        assert m["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-6)
        _close(got["params"], {n: p.detach() for n, p in state.params.items()}, 1e-5, 1e-6)
        _close(got["opt_state"], state.opt_state, 1e-5, 1e-5)
    shapes = tp4[0]["plain/local_shapes"]
    assert shapes["decoder.conv_0.weight"] == (16, 4, 4, 4)  # IOHW: 8 outputs -> 4
    assert shapes["encoder.conv_1.weight"] == (8, 8, 3, 3)
    assert shapes["decoder.conv_1.weight"] == (20, 8, 3, 3)  # the head, whole


def test_tensor_parallel_keeps_the_heads_kernel_layout(tp4):
    """The channel gather keeps a channels-last conv output channels-last,
    so the likelihood head after a sharded layer hands the MoDL kernel
    channel-minor parameters: its tile path, as on a single rank."""
    for out in tp4:
        assert out["plain/head_paths"] == ["tiled"]


def test_the_parallel_paths_import_no_jax():
    """parallel/, the CLI and the rank program import none of jax, flax,
    optax, orbax or the JAX package (tests/test_torch_trainer.py's check)."""
    code = """
import importlib.abc, sys
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "vae_mdl_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
import vae_mdl_tpu_torch.parallel, vae_mdl_tpu_torch.parallel.spmd
import vae_mdl_tpu_torch.parallel.distributed, vae_mdl_tpu_torch.cli.run
import torch_parallel_worker
"""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([W.REPO, os.path.join(W.REPO, "tests")])}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
