"""The port's parallel steps against the JAX package's on the same inputs:
the data-parallel and ZeRO-1 steps at 2 ranks against
``make_shard_map_train_step`` / ``make_zero1_train_step`` on a 2-device
submesh of the 8-device virtual mesh (tests/conftest.py), and the
tensor-parallel layout at ``model = 2`` against ``shard_state_tp`` on
``make_tp_mesh(1, 2)``. The port's ranks run in gloo processes
(tests/torch_parallel_worker.py) from the JAX initial weights, with JAX's
noise injected: per device ``fold_in(next_rngs(...)["sample"], device)``
for the shard_map steps, the unfolded stream for the jit step under the TP
layout, each drawn as the model's ``make_rng("sample")`` draws it.

Tolerances, each with its reason:
- the loss: rtol 1e-5 (a float32 sum of ~400 per-pixel terms in another
  order; tests/test_torch_grad.py's);
- the Adam moments, leaf by leaf in norm: mu 1e-4, nu 2e-4 (mu is 0.1 g
  and nu 1e-3 g^2 after one step: the gradients' 1e-4 of
  tests/test_torch_grad.py's narrow model, doubled for the square);
- the parameters: atol 3e-3 element-wise with 99% of the elements within
  1e-6. A first Adam step moves every element by lr * g / (|g| + eps) ~ lr:
  where a gradient element is ~0 its sign can differ between the two
  float32 sums, moving it by up to 2 lr (tests/test_parallel.py's TP atol
  for the same reason).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from vae_mdl_tpu import config as jconfig
from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.parallel import mesh as jmesh
from vae_mdl_tpu.parallel import spmd as jspmd
from vae_mdl_tpu.parallel import tensor as jtensor
from vae_mdl_tpu.train import state as jstate
from vae_mdl_tpu.train.steps import make_train_step as jax_make_train_step
from vae_mdl_tpu_torch.utils.convert import (
    flat_from_flax,
    flat_to_flax,
    params_from_flax,
    zero1_opt_state_from_flax,
    zero1_opt_state_to_flax,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device virtual mesh")

K = 5
BATCH = 8


@pytest.fixture(scope="module")
def jax_side():
    jcfg = jax_experiment("model05", model=W.narrow_model(jconfig))
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, batch_size=BATCH))
    cfg = W.experiment_of(W.narrow_model())
    jm = jax_build_model(jcfg.model)
    js = jstate.create_train_state(jm, jcfg.train, jnp.zeros((BATCH, 8, 8, 3)), K)
    tx = jstate.make_optimizer(jcfg.train)
    batch = np.random.default_rng(4).integers(0, 256, (BATCH, 8, 8, 3), dtype=np.uint8)

    def draw(key, rows):
        noise_key = jm.apply(js.params, rngs={"sample": key},
                             method=lambda m: m.make_rng("sample"))
        return np.array(jax.random.normal(noise_key, (K, rows, cfg.model.n_latent)))

    sample_key = js.next_rngs("sample")["sample"]
    eps_dp = np.concatenate([draw(jax.random.fold_in(sample_key, d), BATCH // 2)
                             for d in range(2)], axis=1)
    eps_tp = draw(sample_key, BATCH)

    mesh2 = jmesh.make_mesh(jconfig.MeshConfig(data=2, sample=1), devices=jax.devices()[:2])
    dp_state, dp_m = jspmd.make_shard_map_train_step(jm, jcfg, tx, mesh2)(
        jmesh.shard_state(mesh2, js), jmesh.shard_batch(mesh2, batch))
    z_state = js.replace(opt_state=jspmd.zero1_opt_state(tx, js.params, mesh2))
    z_state, z_m = jspmd.make_zero1_train_step(jm, jcfg, tx, mesh2)(
        z_state, jmesh.shard_batch(mesh2, batch))
    tp_mesh = jtensor.make_tp_mesh(1, 2, devices=jax.devices()[:2])
    tp_state, tp_m = jax_make_train_step(jm, jcfg, tx, donate=False)(
        jtensor.shard_state_tp(js, tp_mesh, min_features=8),
        jtensor.shard_batch_tp(batch, tp_mesh))
    return dict(jcfg=jcfg, cfg=cfg, js=js, batch=batch, eps_dp=eps_dp, eps_tp=eps_tp,
                params=params_from_flax(js.params, cfg.model),
                dp=(dp_state, float(dp_m["loss"])), zero1=(z_state, float(z_m["loss"])),
                tp=(tp_state, float(tp_m["loss"])))


@pytest.fixture(scope="module")
def port_dp(jax_side, tmp_path_factory):
    inputs = {"params": jax_side["params"], "batch": jax_side["batch"],
              "eps": jax_side["eps_dp"].astype(np.float32)}
    return W.spawn("dp_suite", 2, tmp_path_factory.mktemp("jdp"), inputs)


@pytest.fixture(scope="module")
def port_tp(jax_side, tmp_path_factory):
    inputs = {"params": jax_side["params"], "batch": jax_side["batch"],
              "eps": jax_side["eps_tp"].astype(np.float32)}
    return W.spawn("tp_suite", 2, tmp_path_factory.mktemp("jtp"), inputs)


def _adam(tree):
    """The optax Adam state (count, mu, nu) in a nest of tuples."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    for node in tree:
        found = _adam(node) if isinstance(node, tuple) else None
        if found is not None:
            return found
    return None


def _norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _check_params(got, want_flax, cfg):
    want = params_from_flax(want_flax, cfg.model)
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name].numpy(), want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-3, err_msg=name)
        assert np.mean(np.abs(g - w) <= 1e-6) >= 0.99, name


def _check_moments(got_mu, got_nu, adam, cfg):
    for got, want, rtol in ((got_mu, adam.mu, 1e-4), (got_nu, adam.nu, 2e-4)):
        want = params_from_flax(want, cfg.model)
        for name in want:
            assert _norm_rel(got[name], want[name]) <= rtol, name


def test_data_parallel_step_matches_jax_shard_map(jax_side, port_dp):
    state, metrics = port_dp[0]["plain/dp"]
    jstate_, jloss = jax_side["dp"]
    assert metrics["loss"] == pytest.approx(jloss, rel=1e-5)
    _check_params(state["params"], jstate_.params, jax_side["cfg"])
    adam = _adam(jstate_.opt_state)
    _check_moments(state["opt_state"]["mu"], state["opt_state"]["nu"], adam, jax_side["cfg"])


def test_zero1_step_matches_jax_zero1(jax_side, port_dp):
    """The flat moments compared through ``zero1_opt_state_from_flax``: JAX's
    ``ravel_pytree`` order and HWIO layouts mapped onto the port's."""
    state, metrics = port_dp[0]["plain/zero1"]
    jstate_, jloss = jax_side["zero1"]
    cfg = jax_side["cfg"]
    assert metrics["loss"] == pytest.approx(jloss, rel=1e-5)
    _check_params(state["params"], jstate_.params, cfg)
    params = jax_side["params"]
    want = zero1_opt_state_from_flax(jax.device_get(jstate_.opt_state), state["opt_state"],
                                     params, cfg)
    n = sum(p.numel() for p in params.values())
    assert want["mu"]["flat"].numel() == state["opt_state"]["mu"]["flat"].numel()
    for key, rtol in (("mu", 1e-4), ("nu", 2e-4)):
        assert _norm_rel(state["opt_state"][key]["flat"][:n], want[key]["flat"][:n]) <= rtol
        assert not want[key]["flat"][n:].any()
    assert int(want["count"]) == int(state["opt_state"]["count"]) == 1


def test_tensor_parallel_layout_matches_jax_shard_state_tp(jax_side, port_tp):
    """model = 2, min_features 8: every layer type of the narrow model is
    sharded on both sides (a conv, a transposed conv, a dense layer)."""
    jstate_, jloss = jax_side["tp"]
    cfg = jax_side["cfg"]
    sharded = dict(port_tp[0]["plain/sharded"])
    assert sharded["decoder.conv_0.weight"] == 1 and sharded["encoder.conv_1.weight"] == 0
    assert sharded["decoder.Dense_0.weight"] == 0
    # the same eligible set as JAX's PartitionSpecs (its layout's, not the
    # partitioner's choice for the step's outputs)
    from jax.sharding import PartitionSpec as P

    specs = jtensor.tp_state_sharding(jax_side["js"], jtensor.make_tp_mesh(
        1, 2, devices=jax.devices()[:2]), min_features=8).params
    jflat = jax.tree_util.tree_flatten_with_path(specs)[0]
    jax_sharded = {".".join(str(k.key) for k in path[1:]) for path, leaf in jflat
                   if leaf.spec != P()}
    port_sharded = {n.replace(".weight", ".kernel") for n in sharded}
    assert port_sharded == jax_sharded
    for out in port_tp:
        state, metrics = out["plain"]
        assert metrics["loss"] == pytest.approx(jloss, rel=1e-5)
        _check_params(state["params"], jax.device_get(jstate_.params), cfg)
        adam = _adam(jax.device_get(jstate_.opt_state))
        _check_moments(state["opt_state"]["mu"], state["opt_state"]["nu"], adam, cfg)


def test_zero1_flat_order_round_trip(jax_side):
    """ravel_pytree's order <-> the port's, both ways, on a vector whose
    every element names its place; the pad carried over."""
    from jax.flatten_util import ravel_pytree

    js, cfg = jax_side["js"], jax_side["cfg"]
    n = sum(x.size for x in jax.tree.leaves(js.params))
    _, unravel = ravel_pytree(js.params)
    marks = np.arange(n + 3, dtype=np.float32)
    leaves = params_from_flax(jax.device_get(unravel(jnp.asarray(marks[:n]))), cfg.model)
    port = flat_from_flax(marks, jax_side["params"], cfg.model)
    want = torch.cat([leaves[name].reshape(-1) for name in jax_side["params"]])
    torch.testing.assert_close(port[:n], want, rtol=0, atol=0)
    assert port[n:].tolist() == [n, n + 1, n + 2]
    np.testing.assert_array_equal(flat_to_flax(port, jax_side["params"], cfg.model), marks)
    # and the whole optimizer state back to JAX's structure
    like = jspmd.zero1_opt_state(jstate.make_optimizer(jax_side["jcfg"].train), js.params,
                                 jmesh.make_mesh(jconfig.MeshConfig(data=2),
                                                 devices=jax.devices()[:2]))
    like = jax.device_get(like)
    port_like = {"count": torch.zeros((), dtype=torch.int32),
                 "mu": {"flat": port}, "nu": {"flat": port * 2}}
    back = zero1_opt_state_to_flax(port_like, like, jax_side["params"], cfg)
    adam = _adam(back)
    np.testing.assert_array_equal(np.asarray(adam.mu)[:n], marks[:n])
    np.testing.assert_array_equal(np.asarray(adam.nu)[:n], 2 * marks[:n])
