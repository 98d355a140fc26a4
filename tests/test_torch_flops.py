"""``vae_mdl_tpu_torch/utils/flops.py`` against ``vae_mdl_tpu/utils/flops.py``:
every function the port mirrors gives exactly the JAX package's number
(closed-form arithmetic on the same config fields, so equality, no
tolerance), for the six zoo models, with ``n_samples`` overridden to 5000, and
for a config whose head is not folded into the conv stack. The CUDA census
(what the hand-written kernels evaluate by branch) is held against the source
it was read from, and ``FlopCounterMode`` against the analytic count on
model05's forward: it counts a transposed convolution at its multiply-adds
(input positions x taps), the analytic count at output positions x taps,
stride^2 = 4 times as many, so the two differ by exactly 3/4 of the analytic
count's transposed-conv terms.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.utils import flops as jflops
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS
from vae_mdl_tpu_torch.utils import flops

torch.set_num_threads(1)

ZOO = ["model01", "model02", "model03", "model04", "model05", "model06"]


@pytest.mark.parametrize("name", ZOO)
def test_analytic_model_flops_equal_jax(name):
    for batch in (1, 128):
        assert flops.analytic_model_flops(MODELS[name], batch) == \
            jflops.analytic_model_flops(JAX_MODELS[name], batch)
    assert flops.analytic_model_flops(MODELS[name]) > 0


@pytest.mark.parametrize("name", ZOO)
def test_forward_and_train_step_flops_equal_jax(name):
    assert flops.forward_flops(MODELS[name], 128) == jflops.forward_flops(JAX_MODELS[name], 128)
    assert flops.forward_flops(MODELS[name], 1, n_samples=5000) == \
        jflops.forward_flops(JAX_MODELS[name], 1, n_samples=5000)
    assert flops.train_step_flops(MODELS[name], 128) == \
        jflops.train_step_flops(JAX_MODELS[name], 128)
    assert flops.train_step_flops(MODELS[name], 128) == 3.0 * flops.forward_flops(MODELS[name], 128)


@pytest.mark.parametrize("likelihood", ["dl", "gaussian", "bernoulli", "pmdl"])
def test_unfolded_head_is_counted_as_in_jax(likelihood):
    """model05's stack ends in 50 channels; with another likelihood the head
    is a standalone conv after it, a FLOPs term of its own."""
    cfg = dataclasses.replace(MODELS["model05"], likelihood=likelihood)
    jcfg = dataclasses.replace(JAX_MODELS["model05"], likelihood=likelihood)
    got = flops.analytic_model_flops(cfg, 4)
    assert got == jflops.analytic_model_flops(jcfg, 4)
    # "pmdl" takes the stack's 50 channels as they are: its head stays folded
    n_head = {"dl": 6, "gaussian": 6, "bernoulli": 3, "pmdl": 0}[likelihood]
    head = 2.0 * 32 * 32 * n_head * 9 * 50  # 3x3 conv from the stack's 50 channels
    assert got - flops.analytic_model_flops(MODELS["model05"], 4) == 4 * 5 * head


@pytest.mark.parametrize("n_mix", [5, 10])
def test_census_equals_jax(n_mix):
    assert flops.mdl_transcendental_census(n_mix) == jflops.mdl_transcendental_census(n_mix)


@pytest.mark.parametrize("n_mix", [5, 10])
def test_train_transcendentals_equal_jax(n_mix):
    cfg = dataclasses.replace(MODELS["model05"], n_mix=n_mix)
    jcfg = dataclasses.replace(JAX_MODELS["model05"], n_mix=n_mix)
    assert flops.mdl_train_transcendentals(cfg, 128) == jflops.mdl_train_transcendentals(jcfg, 128)


def test_cuda_census_follows_the_cuda_sources():
    """With every cascade in the CDF-difference branch the CUDA forward makes
    the Pallas census' calls less its softplus (the CUDA cascade branches,
    ``jnp.where`` evaluates every side); the backward kernel recomputes the
    forward's weights, so its own census holds them too; what its second pass
    writes again unconditionally (tanh, exp(-logscale), the softmaxes'
    exponentials) counts once."""
    n, pixels = 5, 7
    cdf = {"right": 0, "left": 0, "cdf": 3 * n * pixels, "pdf": 0}
    census = flops.mdl_transcendental_census(n)
    fwd = flops.mdl_cuda_transcendentals(cdf, pixels, n)
    assert fwd == {op: float(0 if op == "softplus" else c * pixels)
                   for op, c in census["fwd"].items()}
    bwd = flops.mdl_cuda_transcendentals(cdf, pixels, n, backward=True)
    assert bwd == {"tanh": 3.0 * n * pixels, "exp": 5.0 * n * pixels,
                   "sigmoid": 12.0 * n * pixels, "softplus": 0.0,
                   "log": (3.0 * n + 1) * pixels}
    # by branch, as csrc/dl_cascade.cuh reads: an edge bin is an exp and a
    # softplus; the PDF branch two sigmoids and a softplus
    mixed = {"right": 2, "left": 3, "cdf": 5, "pdf": 7}
    assert flops.cascade_transcendentals(mixed) == {
        "tanh": 0.0, "exp": 17.0, "sigmoid": 24.0, "softplus": 12.0, "log": 5.0}
    assert flops.cascade_transcendentals(mixed, backward=True) == {
        "tanh": 0.0, "exp": 17.0, "sigmoid": 2.0 + 3.0 + 10.0 + 21.0, "softplus": 0.0,
        "log": 0.0}


def test_mufu_instructions_charge_each_call_its_fewest():
    """The special-function bound's count: an exp, the sigmoid's exp and
    reciprocal, the softplus' exp; logf and tanhf's small-argument path are
    polynomials and charge none."""
    calls = {"tanh": 15.0, "exp": 25.0, "sigmoid": 30.0, "softplus": 3.0, "log": 17.0}
    assert flops.mufu_instructions(calls) == 25.0 + 2 * 30.0 + 3.0
    assert flops.mufu_instructions(dict.fromkeys(calls, 0.0)) == 0.0
    assert set(flops.MUFU_PER_CALL) == set(flops.mdl_transcendental_census(5)["fwd"])


def test_branch_counts_partition_the_cascades():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 4, 4, 3)).astype(np.float32) / 255.0)
    x.reshape(-1)[:2] = torch.tensor([0.0, 1.0])
    p = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 50)).astype(np.float32) * 3.0)
    counts = flops.modl_branch_counts(x, p)
    assert sum(counts.values()) == 3 * 2 * 4 * 4 * 15
    assert counts["right"] >= 3 * 5 and counts["left"] >= 3 * 5 and counts["pdf"] > 0


def test_flop_counter_on_model05_forward_against_the_analytic_count():
    cfg = MODELS["model05"]
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        counted = flops.compiled_flops(lambda: model(x, 3, generator=torch.Generator()))
    analytic = flops.analytic_model_flops(dataclasses.replace(cfg, n_samples=3), 2)
    # the decoder's three stride-2 transposed convs, at output positions
    hw, ch, transposed = (4, 4), 128, 0.0
    for (f, k, s, t, _a) in cfg.decoder.conv_layers:
        fl, hw = flops._conv_flops(hw, ch, f, k, s, t)
        transposed += fl if t else 0.0
        ch = f
    assert counted == analytic - 0.75 * (2 * 3) * transposed


def test_compiled_flops_is_none_where_nothing_is_counted():
    assert flops.compiled_flops(lambda: torch.ones(3) + 1) is None


def test_device_peaks_table():
    peaks = flops.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"float32": 67e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12}
    with pytest.raises(ValueError, match="no published peaks"):
        flops.device_peaks("some other card")
