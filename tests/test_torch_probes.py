"""The measurement path of the port against the JAX package's, on the CPU at
small sizes: the plain versions of the four probe kernels against the Pallas
kernels they replace (interpret mode), the timing harness against
``bench.py``'s, and the probes' plumbing.

How the Pallas sides run here:
- ``vpu_probe._loop_probe`` picks interpret mode itself off a TPU; it returns
  only element [0, 0], so the input is rolled to bring sixteen different
  elements there, and the whole tile is also held against the same op
  iterated in jnp;
- ``scripts/kernel_isolate.py`` ``make`` and
  ``scripts/kernel_structure_probe.py`` ``make_variant`` are loaded from their
  files and call ``pl.pallas_call`` without ``interpret=``: the tests wrap
  ``pl.pallas_call`` to pass ``interpret=True`` (a monkeypatch; nothing in
  the JAX package or ``scripts/`` changes);
- ``scripts/kernel_isolate2.py`` builds its kernel inside ``main`` at full
  size, so it cannot be called: the test rebuilds that ``pallas_call`` with
  the script's block specs and body at a small size.

Tolerances: the loop probe rtol 1e-5, atol 1e-6 (XLA's and PyTorch's CPU
exp, log, tanh differ by an ulp or two, compounded over 3 iterations; nan
must meet nan), and rtol 1e-4 for exp, whose third application multiplies the
second's ulp by its value, up to 88; channel sums rtol 1e-6, atol 1e-5 (50
float32 terms of O(1) in another order); ``0.5 p + g`` exact.
"""
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vae_mdl_tpu.ops.pallas import vpu_probe
from vae_mdl_tpu_torch.ops.cuda import io_probe, mdl_kernel, mdl_null, sfu_probe
from vae_mdl_tpu_torch.probes import kernel_structure
from vae_mdl_tpu_torch.utils import timing

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
PROBE_TOL = dict(rtol=1e-5, atol=1e-6)
EXP_TOL = dict(rtol=1e-4, atol=1e-6)
SUM_TOL = dict(rtol=1e-6, atol=1e-5)


def _load(relative: str):
    """A module of the repository that is no package member, by its path."""
    path = _REPO / relative
    name = "_probe_" + path.stem
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture
def interpreted(monkeypatch):
    """``pl.pallas_call`` passes ``interpret=True`` within the test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# -- K6: the loop probe ------------------------------------------------------------


def _probe_input():
    return np.random.default_rng(0).uniform(0.5, 1.5, (8, 128)).astype(np.float32)


@pytest.mark.parametrize("iters", [2, 3])
@pytest.mark.parametrize("op", sorted(vpu_probe.OPS))
def test_loop_probe_plain_matches_the_pallas_probe(op, iters):
    x = _probe_input()
    tol = EXP_TOL if op == "exp" else PROBE_TOL
    want_tile = jax.lax.fori_loop(0, iters, lambda i, v: vpu_probe.OPS[op](v), jnp.asarray(x))
    got_tile = sfu_probe.loop_probe(torch.from_numpy(x), op, iters).numpy()
    np.testing.assert_allclose(got_tile, np.asarray(want_tile), **tol)
    probe = vpu_probe._loop_probe(vpu_probe.OPS[op], iters, grid=1, block=(8, 128))
    for shift in range(16):
        rolled = np.roll(x.reshape(-1), -shift).reshape(8, 128)
        got = sfu_probe.loop_probe_plain(torch.from_numpy(rolled), op, iters)[0, 0]
        np.testing.assert_allclose(float(got), float(probe(jnp.asarray(rolled))), **tol)


def test_cascade_op_matches_the_roofline_scripts_cascade():
    from vae_mdl_tpu.distributions.discretized import discretized_logistic_log_prob

    x = _probe_input()
    x[0, :4] = (1.0, -1.0, 0.999, 1.5)
    v = jnp.asarray(x)
    want = discretized_logistic_log_prob(v, 0.9 * v, 0.1 * v, low=-1.0, high=1.0,
                                         interval_width=2.0 / 255.0)
    got = sfu_probe.loop_probe_plain(torch.from_numpy(x), "cascade", 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ops_and_reranging():
    assert set(sfu_probe.OPS) == set(vpu_probe.OPS) == {"exp", "log", "tanh", "sigmoid",
                                                        "softplus"}
    x = torch.from_numpy(_probe_input())
    for op, (scale, shift) in sfu_probe.RERANGE.items():
        # a re-ranged chain stays finite and settles; with 1 and 0 it is op^iters
        deep = sfu_probe.loop_probe(x, op, 200, scale=scale, shift=shift)
        assert torch.isfinite(deep).all() and float(deep.std()) < 1e-3, op
        once = sfu_probe.loop_probe(x, op, 1)
        torch.testing.assert_close(once, sfu_probe._ALL_OPS[op](x) * 1.0 + 0.0, rtol=0, atol=0)
    inside = sfu_probe.loop_probe(x, "cascade", 200, scale=-0.1, shift=0.0)
    assert (inside.abs() < 1.0).all()  # within the bins: the CDF-difference branch


def test_measure_op_rate_plumbing_through_the_plain_version():
    rate = sfu_probe.measure_op_rate("exp", blocks=1, chains=1, iters=(1, 2001), repeats=2,
                                     device="cpu")
    assert rate > 0
    raw = {"none": 10.0, "exp": 2.0, "log": 5.0}
    rates = sfu_probe.subtract_identity(raw)
    assert rates == {"exp": pytest.approx(2.5), "log": pytest.approx(10.0)}


def test_measuring_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sfu_probe.measure_op_rate("exp")


def test_floor_equals_the_jax_floor():
    from vae_mdl_tpu.models.zoo import experiment as jax_experiment
    from vae_mdl_tpu.utils.flops import mdl_train_transcendentals as jax_counts
    from vae_mdl_tpu_torch.models.zoo import experiment
    from vae_mdl_tpu_torch.utils.flops import mdl_train_transcendentals

    counts = mdl_train_transcendentals(experiment("model05").model, 128)
    assert counts == jax_counts(jax_experiment("model05").model, 128)
    rates = {"exp": 3.1e12, "log": 1.2e12, "tanh": 1.8e12, "sigmoid": 1.4e12, "softplus": 8e11}
    assert sfu_probe.sfu_floor_seconds(counts, rates) == vpu_probe.vpu_floor_seconds(counts, rates)
    assert sfu_probe.vpu_floor_seconds is sfu_probe.sfu_floor_seconds


def test_probe_kernel_refuses_cpu_tensors_and_odd_sizes():
    x = torch.from_numpy(_probe_input())
    before = sfu_probe.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sfu_probe.loop_probe_cuda(x, "exp", 2)
    assert sfu_probe.launches == before and sfu_probe._library.cache_info().currsize == 0


# -- P1, P2: the channel sums --------------------------------------------------------


@pytest.mark.parametrize("body", ["dma_only", "transpose_sum"])
def test_channel_sum_plain_matches_kernel_isolate(interpreted, body):
    script = _load("scripts/kernel_isolate.py")
    k, p, bp, ch = 3, 256, 128, 50
    params = np.random.default_rng(1).standard_normal((k, p, ch)).astype(np.float32)
    want = script.make(getattr(script, body), k, p, bp, ch)(jnp.asarray(params))
    assert want.shape == (k, p // bp, 1, bp)
    got = io_probe.channel_sum(torch.from_numpy(params), "channel_minor")
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(k, p), **SUM_TOL)


def test_channel_sum_plain_matches_kernel_isolate2s_kernel():
    k, p, bp, ch = 3, 256, 128, 50
    params_t = np.random.default_rng(2).standard_normal((k, ch, p)).astype(np.float32)

    def body(p_ref, out_ref):  # scripts/kernel_isolate2.py:39-41
        pt = p_ref[0]
        out_ref[:] = jnp.sum(pt, axis=0, keepdims=True).reshape(out_ref.shape)

    want = pl.pallas_call(  # scripts/kernel_isolate2.py:43-51, interpreted
        body,
        out_shape=jax.ShapeDtypeStruct((k, p // bp, 1, bp), jnp.float32),
        grid=(k, p // bp),
        in_specs=[pl.BlockSpec((1, ch, bp), lambda ik, ib: (ik, 0, ib),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, 1, bp), lambda ik, ib: (ik, ib, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(params_t))
    got = io_probe.channel_sum(torch.from_numpy(params_t), "channel_first")
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(k, p), **SUM_TOL)


def test_channel_sum_kernel_refuses_cpu_tensors_and_bad_arguments():
    params = torch.zeros(2, 8, 5)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        io_probe.channel_sum_cuda(params)
    with pytest.raises(ValueError, match="layout"):
        io_probe.channel_sum(params, "nhwc")
    with pytest.raises(ValueError, match="path"):
        io_probe.channel_sum_cuda(params, path="tma")
    assert io_probe.launches == 0 and io_probe.library.cache_info().currsize == 0


# -- P3: the null-body MoDL kernels ----------------------------------------------------


def _null_inputs(dtype=np.float32):
    rng = np.random.default_rng(3)
    x = rng.random((2, 8, 8, 3)).astype(np.float32)
    p = rng.standard_normal((3, 2, 8, 8, 50)).astype(dtype)
    g = rng.standard_normal((3, 2, 8, 8, 1)).astype(np.float32)
    return x, p, g


@pytest.mark.parametrize("variant,bodies", [("dma", ("fwd_dma", "bwd_dma")),
                                            ("staged", ("fwd_tr", "bwd_tr"))])
def test_null_kernels_plain_versions_match_make_variant(interpreted, variant, bodies):
    script = _load("scripts/kernel_structure_probe.py")
    f = script.make_variant(*(getattr(script, body) for body in bodies))
    x, p, g = _null_inputs()
    want = f(jnp.asarray(x), jnp.asarray(p))
    want_dx, want_dp = jax.grad(lambda a, b: jnp.sum(f(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(p))

    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(p).requires_grad_(True)
    before = mdl_null.launches, mdl_null.backward_launches
    got = mdl_null.mdl_null_log_prob(xt, pt, variant)
    assert got.shape == want.shape == (3, 2, 8, 8, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUM_TOL)
    dx, dp = torch.autograd.grad(got, [xt, pt], torch.from_numpy(g))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(want_dp))
    np.testing.assert_array_equal(dp.numpy(), 0.5 * p + g)
    np.testing.assert_array_equal(dx.numpy(), np.asarray(want_dx))
    assert not dx.any()
    assert (mdl_null.launches, mdl_null.backward_launches) == before  # plain on the CPU


def test_null_backward_rounds_once_to_the_parameters_dtype():
    x, p, g = _null_inputs()
    pb = torch.from_numpy(p).bfloat16()
    got = mdl_null.mdl_null_backward(torch.from_numpy(x), pb, torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    want = (pb.float() * 0.5 + torch.from_numpy(g)).bfloat16()
    assert torch.equal(got, want)
    fwd = mdl_null.mdl_null_forward(torch.from_numpy(x), pb, "staged")
    assert fwd.dtype == torch.float32 and fwd.shape == (3, 2, 8, 8, 1)


def test_null_kernels_refuse_cpu_tensors_and_unknown_variants():
    x, p, g = (torch.from_numpy(a) for a in _null_inputs())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mdl_null.mdl_null_forward_cuda(x, p)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mdl_null.mdl_null_backward_cuda(x, p, g, "staged")
    with pytest.raises(ValueError, match="variant"):
        mdl_null.mdl_null_forward(x, p, "transpose")


def test_likelihood_swap_is_put_back_whatever_happens():
    real = mdl_kernel.mdl_log_prob
    with kernel_structure.likelihood_swapped("staged"):
        assert mdl_kernel.mdl_log_prob is not real
        x, p, _ = (torch.from_numpy(a) for a in _null_inputs())
        np.testing.assert_allclose(mdl_kernel.mdl_log_prob(x, p).numpy(),
                                   mdl_null.mdl_null_forward_plain(x, p).numpy())
    assert mdl_kernel.mdl_log_prob is real
    with pytest.raises(KeyError):
        with kernel_structure.likelihood_swapped("dma"):
            raise KeyError("inside")
    assert mdl_kernel.mdl_log_prob is real


def test_decomposition_reads_the_four_differences():
    steps = {"full": {"busy_ms": 10.0}, "staged": {"busy_ms": 9.5}, "dma": {"busy_ms": 9.25},
             "dl_head": {"busy_ms": 9.0}}
    assert kernel_structure.decomposition(steps, "busy_ms") == {
        "launch + traffic": 0.25, "staging": 0.25, "math": 0.5, "total mixture": 1.0}


# -- the timing harness ------------------------------------------------------------------


@pytest.mark.parametrize("name,over", [("model01", None), ("model05", None),
                                       ("model05", {"likelihood": "dl"})])
def test_setup_scanned_step_makes_bench_pys_batches(name, over):
    bench = _load("bench.py")
    data_over = {"batch_size": 2}
    _, _, want, jcfg, jflops = bench.setup_scanned_step(name, spc=3, model_over=over,
                                                        data_over=data_over)
    step, state, batch, cfg, flops = timing.setup_scanned_step(
        name, spc=3, model_over=over, data_over=data_over, device="cpu")
    assert batch.dtype == torch.uint8 and batch.device.type == "cpu"
    np.testing.assert_array_equal(batch.numpy(), np.asarray(want))
    assert flops == jflops
    assert cfg.data.dataset == jcfg.data.dataset and cfg.model.likelihood == jcfg.model.likelihood
    state, metrics = step(state, batch)
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))


def test_time_scanned_step_and_rate_stats():
    bench = _load("bench.py")
    step, state, batch, cfg, _ = timing.setup_scanned_step(
        "model01", spc=2, data_over={"batch_size": 4}, device="cpu")
    rates = timing.time_scanned_step(step, state, batch, 2, 4, n_iters=1, n_repeats=3)
    assert rates.shape == (2,) and (rates > 0).all()
    assert state.step == (2 + 3) * 2  # two warm-up calls, three timed blocks of one call
    assert timing.rate_stats("imgs", rates) == bench.rate_stats("imgs", rates)
    assert timing.rate_stats("x", [3.0]) == bench.rate_stats("x", [3.0])


def test_resident_step_gathers_its_batches_on_the_device():
    step, state, data, cfg = timing.resident_step("model01", spc=2, n_data=16, device="cpu")
    assert data.shape == (16, 28, 28, 1) and data.dtype == torch.uint8
    want = np.random.default_rng(0).integers(0, 256, (16, 28, 28, 1), dtype=np.uint8)
    np.testing.assert_array_equal(data.numpy(), want)  # bench.py:178-179
    state, metrics = step(state, data)
    assert state.step == 2 and np.isfinite(float(metrics["loss"]))


def test_the_harness_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timing.setup_scanned_step("model01")


def test_kernel_classes():
    assert timing.kernel_class("void (anonymous namespace)::mdl_log_prob_backward_kernel<float, 5>"
                               ) == "MoDL backward"
    assert timing.kernel_class("mdl_null_forward_staged_kernel<float>") == "null forward"
    assert timing.kernel_class("sm90_xmma_fprop_implicit_gemm") == "conv/gemm"
    assert timing.kernel_class("multi_tensor_apply_kernel") == "optimizer"
    assert timing.kernel_class("vectorized_elementwise_kernel") == "elementwise"
    by_class = timing.device_ms_by_class({"dl_log_prob_kernel<int, 4>": (2, 0.5),
                                          "elementwise_a": (3, 1.0), "elementwise_b": (1, 0.25)})
    assert by_class == {"DL forward": 0.5, "elementwise": 1.25}
