"""The port's distributions, MoDL plain version and streaming logmeanexp
against the JAX package, on the same numpy inputs.

Tolerances: rtol/atol 1e-5 where both sides evaluate the same float32
formula in a different operation order (XLA's fusion against PyTorch's
kernels). The discretized logistic adds one term: log(sigmoid(stop) -
sigmoid(start)) is ill-conditioned where the CDF difference ``prob`` is
small, and XLA's and PyTorch's float32 exp differ by one ulp on about 0.4%
of inputs, so each side may be off by up to 2 ulps of 1.0 in each sigmoid:
the log then moves by up to 4 * 2**-24 / prob (``prob`` taken in float64,
floored at the 1e-5 branch threshold). The Pallas kernel runs in interpret
mode on the CPU, as tests/test_pallas.py runs it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu.distributions import continuous as jcont
from vae_mdl_tpu.distributions import mixture as jmix
from vae_mdl_tpu.distributions.discretized import (
    discretized_logistic_log_prob as j_dl_log_prob,
)
from vae_mdl_tpu.ops import math as jmath
from vae_mdl_tpu.ops.pallas.mdl_kernel import mdl_log_prob as pallas_mdl_log_prob
from vae_mdl_tpu_torch.distributions import (
    Logistic,
    MixtureDiscretizedLogistic,
    Normal,
    discretized_logistic_log_prob,
    mixture_log_prob,
)
from vae_mdl_tpu_torch.distributions.continuous import softplus
from vae_mdl_tpu_torch.distributions.mixture import autoregressive_locs, split_mixture_params
from vae_mdl_tpu_torch.ops import math as tmath
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import mdl_log_prob

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# one compiled program per reference instead of many op-by-op ones
j_mixture_log_prob = jax.jit(jmix.mixture_log_prob)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _binned01(rng, shape):
    """Pixel values k/255, with the edge values 0 and 1 forced in."""
    x = rng.integers(0, 256, shape).astype(np.float32) / 255.0
    flat = x.reshape(-1)
    flat[0], flat[1] = 0.0, 1.0
    return x


def _mdl_params(rng, shape, n_mix):
    """Random MoDL parameters hitting every branch: logscales below the -7
    clamp, far-off locs (approximation branch) and ordinary ones."""
    sub = shape + (3, n_mix)
    logits = rng.standard_normal(shape + (n_mix,)) * 2.0
    loc = rng.standard_normal(sub) * 0.5
    loc.reshape(-1)[::5] += 4.0
    logscale = rng.standard_normal(sub) - 3.0
    logscale.reshape(-1)[::7] = -9.0
    coeffs = rng.standard_normal(sub)
    rest = np.concatenate([loc, logscale, coeffs], axis=-1).reshape(shape + (9 * n_mix,))
    return np.concatenate([logits, rest], axis=-1).astype(np.float32)


def _gap_tolerance(x, loc, logscale):
    """Per-element conditioning term of log P(bin): 4 ulps(1.0) / prob."""
    x, loc = np.asarray(x, np.float64), np.asarray(loc, np.float64)
    inv_std = np.exp(-np.maximum(np.asarray(logscale, np.float64), -7.0))
    with np.errstate(over="ignore"):
        cdf = lambda t: 1.0 / (1.0 + np.exp(-t))  # noqa: E731
        prob = cdf((x - loc + 1 / 255) * inv_std) - cdf((x - loc - 1 / 255) * inv_std)
    tol = 4 * 2.0 ** -24 / np.maximum(prob, 1e-5)
    return np.where((x <= -1) | (x >= 1), 0.0, tol)


def _modl_tolerance(x01, params, want):
    """Per-pixel tolerance of a MoDL log-prob: 1e-5 (1 + |want|) plus the
    worst mixture's summed sub-pixel conditioning terms (logsumexp moves
    by at most its largest input's change)."""
    x = np.asarray(x01, np.float64) * 2 - 1
    n = params.shape[-1] // 10
    rest = np.asarray(params, np.float64)[..., n:].reshape(params.shape[:-1] + (3, 3 * n))
    loc, logscale, coeffs = rest[..., :n], rest[..., n:2 * n], np.tanh(rest[..., 2 * n:])
    x = np.broadcast_to(x, loc.shape[:-2] + (3,))
    loc = loc.copy()
    loc[..., 1, :] += coeffs[..., 0, :] * x[..., 0, None]
    loc[..., 2, :] += coeffs[..., 1, :] * x[..., 0, None] + coeffs[..., 2, :] * x[..., 1, None]
    cond = _gap_tolerance(x[..., None], loc, logscale).sum(axis=-2).max(axis=-1)
    return 1e-5 * (1 + np.abs(np.asarray(want)[..., 0])) + cond


def _assert_modl_close(got, want, x01, params):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)[..., 0]
    tol = _modl_tolerance(x01, params, want)
    assert (err <= tol).all(), f"max excess {np.max(err - tol)} at {np.argmax(err - tol)}"


def test_softplus_is_jax_softplus():
    x = np.linspace(-40.0, 40.0, 1001, dtype=np.float32)
    np.testing.assert_allclose(softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6, atol=1e-7)


def test_discretized_logistic_matches_jax_on_every_branch():
    rng = np.random.default_rng(0)
    n = 4096
    x = rng.integers(0, 256, n).astype(np.float32) / 127.5 - 1.0
    x[:64] = -1.0  # left edge
    x[64:128] = 1.0  # right edge
    loc = rng.standard_normal(n).astype(np.float32) * 0.5
    loc[128:512] += 3.0  # far off: the PDF * width approximation
    logscale = (rng.standard_normal(n) * 2.0 - 3.0).astype(np.float32)
    got = discretized_logistic_log_prob(_t(x), _t(loc), _t(logscale),
                                        interval_width=2.0 / 255.0).numpy()
    want = np.asarray(j_dl_log_prob(x, loc, logscale, interval_width=2.0 / 255.0))
    tol = 1e-5 * (1 + np.abs(want)) + _gap_tolerance(x, loc, logscale)
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("cls", ["Normal", "Logistic"])
def test_continuous_log_prob_matches_jax(cls):
    rng = np.random.default_rng(1)
    x, loc = rng.standard_normal((2, 5, 7)).astype(np.float32)
    scale = np.exp(rng.standard_normal((5, 7))).astype(np.float32)
    ours = {"Normal": Normal, "Logistic": Logistic}[cls](_t(loc), _t(scale))
    theirs = getattr(jcont, cls)(jnp.asarray(loc), jnp.asarray(scale))
    np.testing.assert_allclose(ours.log_prob(_t(x)).numpy(),
                               np.asarray(theirs.log_prob(x)), **TOL)
    np.testing.assert_allclose(ours.reduced_log_prob(_t(x)).numpy(),
                               np.asarray(theirs.reduced_log_prob(x)), **TOL)


def test_normal_sample_uses_injected_noise_and_generator():
    rng = np.random.default_rng(2)
    loc, eps = rng.standard_normal((2, 3, 4)).astype(np.float32)
    scale = np.exp(rng.standard_normal((3, 4))).astype(np.float32)
    q = Normal(_t(loc), _t(scale))
    z = q.sample(None, (2,), noise=_t(np.stack([eps, -eps])))
    np.testing.assert_allclose(z.numpy(), loc + scale * np.stack([eps, -eps]), rtol=1e-6)
    a = q.sample(torch.Generator().manual_seed(3), (5,))
    b = q.sample(torch.Generator().manual_seed(3), (5,))
    assert a.shape == (5, 3, 4) and torch.equal(a, b)


def test_split_and_autoregressive_locs_match_jax():
    rng = np.random.default_rng(3)
    p = rng.standard_normal((2, 4, 4, 50)).astype(np.float32)
    x = rng.random((2, 4, 4, 3)).astype(np.float32) * 2 - 1
    ours = split_mixture_params(_t(p))
    theirs = jmix.split_mixture_params(jnp.asarray(p))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(
        autoregressive_locs(ours[0], ours[2], _t(x)).numpy(),
        np.asarray(jmix.autoregressive_locs(theirs[0], theirs[2], jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("n_mix", [1, 5])
def test_mixture_log_prob_matches_jax(n_mix):
    rng = np.random.default_rng(4 + n_mix)
    x = _binned01(rng, (3, 6, 6, 3))
    p = _mdl_params(rng, (2, 3, 6, 6), n_mix)  # leading k broadcasts over x
    got = mixture_log_prob(_t(x), _t(p))
    want = j_mixture_log_prob(jnp.asarray(x), jnp.asarray(p))
    assert got.shape == (2, 3, 6, 6, 1)
    _assert_modl_close(got, want, x, p)


@pytest.mark.parametrize("n_mix", [1, 5])
def test_plain_modl_matches_the_pallas_kernel(n_mix):
    """The port's plain version against the TPU kernel itself, run in
    interpret mode at tests/test_pallas.py's shape."""
    rng = np.random.default_rng(10 + n_mix)
    x = _binned01(rng, (2, 3, 6, 6, 3))
    p = _mdl_params(rng, (2, 3, 6, 6), n_mix)
    want = pallas_mdl_log_prob(jnp.asarray(x), jnp.asarray(p))
    got = mixture_log_prob(_t(x), _t(p))
    _assert_modl_close(got, want, x, p)


def test_bf16_boundary_contract():
    """bf16 parameters are upcast exactly and the math runs float32: the
    result is JAX's f32 math on the bf16-rounded parameters."""
    rng = np.random.default_rng(20)
    x = _binned01(rng, (2, 5, 5, 3))
    p = _mdl_params(rng, (3, 2, 5, 5), 5)
    p_bf16 = torch.from_numpy(p).to(torch.bfloat16)
    got = MixtureDiscretizedLogistic(p_bf16).log_prob(_t(x))
    rounded = jnp.asarray(p).astype(jnp.bfloat16).astype(jnp.float32)
    want = j_mixture_log_prob(jnp.asarray(x), rounded)
    _assert_modl_close(got, want, x, np.asarray(rounded))


def test_kernel_wrapper_takes_the_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(21)
    x = _t(_binned01(rng, (2, 4, 4, 3)))
    p = _t(_mdl_params(rng, (3, 2, 4, 4), 5))
    assert torch.equal(mdl_log_prob(x, p), mixture_log_prob(x, p))


def test_mixture_reduced_log_prob_matches_jax():
    rng = np.random.default_rng(22)
    x = _binned01(rng, (2, 4, 4, 3))
    p = _mdl_params(rng, (3, 2, 4, 4), 5)
    got = MixtureDiscretizedLogistic(_t(p)).reduced_log_prob(_t(x)).numpy()
    want = np.asarray(jax.jit(
        lambda x, p: jmix.MixtureDiscretizedLogistic(p).reduced_log_prob(x))(x, p))
    assert got.shape == (3, 2)
    per_pixel = np.asarray(j_mixture_log_prob(jnp.asarray(x), jnp.asarray(p)))
    tol = _modl_tolerance(x, p, per_pixel).sum(axis=(-1, -2))
    assert (np.abs(got - want) <= tol).all()


def test_mixture_sample_shape_range_and_injected_noise():
    rng = np.random.default_rng(23)
    p = _t(_mdl_params(rng, (2, 4, 4), 5))
    d = MixtureDiscretizedLogistic(p)
    s = d.sample(torch.Generator().manual_seed(0), (3,))
    assert s.shape == (3, 2, 4, 4, 3)
    assert float(s.min()) >= 0.0 and float(s.max()) <= 1.0
    noise = (_t(rng.random((3, 2, 4, 4, 3, 5)).astype(np.float32)),
             _t(rng.random((3, 2, 4, 4, 5)).astype(np.float32)))
    assert torch.equal(d.sample(None, (3,), noise=noise), d.sample(None, (3,), noise=noise))


def test_logmeanexp_and_log_softmax_match_jax():
    rng = np.random.default_rng(24)
    a = (rng.standard_normal((7, 5)) * 30).astype(np.float32)
    np.testing.assert_allclose(tmath.logmeanexp(_t(a), 0).numpy(),
                               np.asarray(jmath.logmeanexp(a, 0)), **TOL)
    np.testing.assert_allclose(tmath.log_prob_from_logits(_t(a)).numpy(),
                               np.asarray(jmath.log_prob_from_logits(a)), **TOL)


def test_streaming_logmeanexp_equals_one_shot_and_jax():
    rng = np.random.default_rng(25)
    lw = (rng.standard_normal((20, 6)) * 50 - 3000).astype(np.float32)
    state = tmath.streaming_logmeanexp_init((6,))
    jstate = jmath.streaming_logmeanexp_init((6,))
    for chunk in np.split(lw, 4):
        state = tmath.streaming_logmeanexp_update(state, _t(chunk), dim=0)
        jstate = jmath.streaming_logmeanexp_update(jstate, jnp.asarray(chunk), axis=0)
    got = tmath.streaming_logmeanexp_finalize(state).numpy()
    np.testing.assert_allclose(got, tmath.logmeanexp(_t(lw), 0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jmath.streaming_logmeanexp_finalize(jstate)),
                               rtol=1e-6)


def test_streaming_logmeanexp_all_neg_inf_column_stays_neg_inf():
    state = tmath.streaming_logmeanexp_init((3,))
    inf = float("inf")
    for chunk in ([[-inf, 0.0, -inf], [-inf, 1.0, -inf]],
                  [[-inf, 2.0, 5.0], [-inf, 3.0, 6.0]]):
        state = tmath.streaming_logmeanexp_update(state, torch.tensor(chunk), dim=0)
    out = tmath.streaming_logmeanexp_finalize(state).numpy()
    assert out[0] == -np.inf
    np.testing.assert_allclose(out[1], np.logaddexp.reduce([0.0, 1.0, 2.0, 3.0]) - np.log(4),
                               rtol=1e-6)
    np.testing.assert_allclose(out[2], np.logaddexp(5.0, 6.0) - np.log(4), rtol=1e-6)
