"""The discretized-logistic likelihood of model03, model04 and model06
against the JAX package: the port's ``dl_log_prob`` (its plain version on the
CPU) against the Pallas kernel in interpret mode, its analytic backward
against ``jax.grad``, the ``DiscretizedLogistic`` class, the "dl" head of
``make_observation`` and the dispatch rule.

Tolerances, each with its reason:
- log-probs: 1e-5 (1 + |want|) plus the conditioning of
  log(sigmoid(stop) - sigmoid(start)): XLA's and PyTorch's float32 exp differ
  by an ulp now and then, so each sigmoid may be off by 2 ulps of 1.0 and the
  log by 4 * 2**-24 / prob (tests/test_torch_distributions.py has the same
  rule for the MoDL);
- the analytic backward in float64 against ``jax.grad`` of the jnp function
  (which is what the Pallas kernel's ``_bwd`` differentiates): rtol 1e-6.
  The formulas are the same up to reassociation, and the float32 log-width
  constant of the JAX cascade has no gradient;
- the same in float32 against ``jax.grad`` of the Pallas ``dl_log_prob``:
  both sides evaluate da * start - ds * stop and (da - ds) / std, which
  cancel over a 1/255-wide bin, from sigmoids that may differ by 2 ulps of
  1.0 each; with prob = the CDF difference and scale = exp(-logscale) the
  gradients move by up to 8 * 2**-24 * (1 + |start| + |stop|) * scale / prob
  (d loc) and the same without the scale factor times (|start| + |stop|)
  (d logscale), on top of rtol 1e-4; in an edge bin JAX differentiates
  x - softplus(x) as 1 - sigmoid(x), which cancels to a few ulps of 1.0
  (measured 8; 16 * 2**-24 allowed) where the analytic sigmoid(-x) does not;
- samples and means: rtol/atol 1e-5 (same float32 formula, other op order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu.distributions.discretized import DiscretizedLogistic as JaxDL
from vae_mdl_tpu.distributions.discretized import (
    discretized_logistic_log_prob as j_dl_log_prob,
)
from vae_mdl_tpu.nn.decoders import make_observation as jax_make_observation
from vae_mdl_tpu.ops.pallas.dl_kernel import dl_log_prob as pallas_dl_log_prob
from vae_mdl_tpu_torch.distributions import DiscretizedLogistic, discretized_logistic_log_prob
from vae_mdl_tpu_torch.nn.decoders import make_observation, resolve_use_pallas
from vae_mdl_tpu_torch.ops.cuda import dl_kernel
from vae_mdl_tpu_torch.ops.cuda.dl_kernel import (
    dl_backward,
    dl_backward_plain,
    dl_log_prob,
    kernel_layout,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# (low, high, interval_width): the model's head on [0, 1], the MoDL's bins
BINS = [(0.0, 1.0, 1.0 / 255.0), (-1.0, 1.0, 2.0 / 255.0)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(rng, low, high, k=3, batch=2, hw=6, dtype=np.float32):
    """x ``[B, h, w, 3]`` on the 256 levels of [low, high], broadcast over
    loc and logscale ``[k, B, h, w, 3]``, hitting all four branches: both
    edge bins, the CDF difference and, with far-off locations and small
    scales, the PDF * width approximation."""
    x = (low + (high - low) * rng.integers(0, 256, (batch, hw, hw, 3)) / 255.0).astype(dtype)
    x[0, 0] = low
    x[0, 1] = high
    shape = (k, batch, hw, hw, 3)
    loc = (0.5 * (low + high) + 0.3 * (high - low) * rng.standard_normal(shape)).astype(dtype)
    far = rng.random(shape) < 0.2
    loc = np.where(far, loc + 2.0 * (high - low), loc).astype(dtype)
    logscale = (rng.standard_normal(shape) * 1.5 - 3.0).astype(dtype)
    logscale = np.where(rng.random(shape) < 0.1, -9.0, logscale).astype(dtype)
    return x, loc, logscale


def _terms(x, loc, logscale, low, high, width):
    """float64 (prob, start, stop, inv_std, edge mask) of every element."""
    x, loc, ls = (np.asarray(a, np.float64) for a in (x, loc, logscale))
    inv_std = np.exp(-ls)
    start, stop = (x - loc - width / 2) * inv_std, (x - loc + width / 2) * inv_std
    with np.errstate(over="ignore"):
        cdf = lambda t: 1.0 / (1.0 + np.exp(-t))  # noqa: E731
        prob = cdf(stop) - cdf(start)
    edge = np.broadcast_to((x <= low) | (x >= high), prob.shape)
    return prob, start, stop, inv_std, edge


def _branches(x, loc, logscale, low, high, width):
    prob, _, _, _, edge = _terms(x, loc, logscale, low, high, width)
    x = np.broadcast_to(x, prob.shape)
    return {"left": int((x <= low).sum()), "right": int((x >= high).sum()),
            "cdf": int((~edge & (prob > 1e-5)).sum()), "pdf": int((~edge & (prob <= 1e-5)).sum())}


def _value_tolerance(x, loc, logscale, want, low, high, width):
    prob, _, _, _, edge = _terms(x, loc, logscale, low, high, width)
    cond = np.where(edge, 0.0, 4 * 2.0 ** -24 / np.maximum(prob, 1e-5))
    return 1e-5 * (1 + np.abs(want)) + cond


@pytest.mark.parametrize("low,high,width", BINS)
def test_dl_log_prob_matches_the_pallas_kernel_and_the_jnp_function(low, high, width):
    rng = np.random.default_rng(int(high - low))
    x, loc, logscale = _inputs(rng, low, high)
    assert min(_branches(x, loc, logscale, low, high, width).values()) > 10
    before = dl_kernel.launches
    got = dl_log_prob(_t(x), _t(loc), _t(logscale), low, high, width)
    assert dl_kernel.launches == before  # CPU tensors take the plain version
    assert got.shape == loc.shape and got.dtype == torch.float32
    plain = discretized_logistic_log_prob(_t(x), _t(loc), _t(logscale), low=low, high=high,
                                          interval_width=width)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    pallas = np.asarray(pallas_dl_log_prob(x, loc, logscale, low, high, width))
    jnp_value = np.asarray(j_dl_log_prob(x, loc, logscale, low=low, high=high,
                                         interval_width=width))
    for want in (pallas, jnp_value):
        assert want.shape == got.shape
        tol = _value_tolerance(x, loc, logscale, want, low, high, width)
        assert (np.abs(got.numpy() - want) <= tol).all()


@pytest.mark.parametrize("low,high,width", BINS)
def test_dl_backward_plain_matches_jax_grad_in_float64(low, high, width):
    rng = np.random.default_rng(3)
    x, loc, logscale = _inputs(rng, low, high, dtype=np.float64)
    g = rng.standard_normal(loc.shape)
    d_loc, d_ls = dl_backward_plain(_t(x), _t(loc), _t(logscale), _t(g), low, high, width)
    assert d_loc.dtype == d_ls.dtype == torch.float64
    jax.config.update("jax_enable_x64", True)
    try:
        want_loc, want_ls = jax.grad(
            lambda l, s: jnp.sum(jnp.asarray(g) * j_dl_log_prob(
                jnp.asarray(x), l, s, low=low, high=high, interval_width=width)),
            argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(logscale))
        want_loc, want_ls = np.asarray(want_loc), np.asarray(want_ls)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want_loc.dtype == np.float64
    for got, want in ((d_loc, want_loc), (d_ls, want_ls)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("low,high,width", BINS)
def test_dl_backward_matches_jax_grad_of_the_pallas_kernel_in_float32(low, high, width):
    rng = np.random.default_rng(4)
    x, loc, logscale = _inputs(rng, low, high)
    g = rng.standard_normal(loc.shape).astype(np.float32)
    before = dl_kernel.backward_launches
    d_loc, d_ls = dl_backward(_t(x), _t(loc), _t(logscale), _t(g), low, high, width)
    assert dl_kernel.backward_launches == before
    want_loc, want_ls = jax.grad(
        lambda l, s: jnp.sum(g * pallas_dl_log_prob(x, l, s, low, high, width)),
        argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(logscale))
    prob, start, stop, inv_std, edge = _terms(x, loc, logscale, low, high, width)
    cancel = np.where(edge | (prob <= 1e-5), 0.0,
                      8 * 2.0 ** -24 * (1 + np.abs(start) + np.abs(stop)) / np.maximum(prob, 1e-5))
    cancel = np.where(edge, 16 * 2.0 ** -24, cancel)  # an edge bin's 1 - sigmoid
    for got, want, scale in ((d_loc, want_loc, inv_std), (d_ls, want_ls, np.abs(start) + np.abs(stop))):
        want = np.asarray(want)
        tol = 1e-4 * np.abs(want) + 1e-6 + np.abs(g) * cancel * scale
        assert (np.abs(got.numpy() - want) <= tol).all()


def test_autograd_of_the_plain_version_equals_the_analytic_backward():
    """On the CPU the model differentiates the plain version; its autograd
    and the analytic formulas agree, also where x sits on an edge bin with
    interval_stop = 0 (softplus at 0: 0.5 in both)."""
    low, high, width = BINS[0]
    rng = np.random.default_rng(5)
    x, loc, logscale = _inputs(rng, low, high, dtype=np.float64)
    loc[0, 0, 0] = x[0, 0] + width / 2  # left edge bin, interval_stop = 0
    g = rng.standard_normal(loc.shape)
    leaves = [_t(loc).requires_grad_(True), _t(logscale).requires_grad_(True)]
    out = dl_log_prob(_t(x), *leaves, low, high, width)
    got = torch.autograd.grad(out, leaves, _t(g))
    want = dl_backward_plain(_t(x), _t(loc), _t(logscale), _t(g), low, high, width)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


def test_kernel_layout_addresses_every_element_once():
    """The layout the wrapper hands the kernels, emulated with as_strided:
    channel slices of an NCHW head are walked along W, x is broadcast over k
    by a zero stride, and a thread's linear index is the dense output's
    offset."""
    k, b, h, w = 2, 3, 4, 5
    head = torch.arange(k * b * 6 * h * w, dtype=torch.float32).reshape(k * b, 6, h, w)
    loc, logscale = head.reshape(k, b, 6, h, w).permute(0, 1, 3, 4, 2).chunk(2, dim=-1)
    x = torch.arange(b * h * w * 3, dtype=torch.float32).reshape(b, h, w, 3)
    shape = torch.broadcast_shapes(loc.shape, x.shape)
    views = [t.expand(shape) for t in (loc, x, logscale)]
    order, merged_shape, merged = kernel_layout(shape, [v.stride() for v in views])
    assert order == [0, 1, 4, 2, 3] and merged_shape == [k, b, 3, h * w]
    assert merged[0][-1] == 1 and merged[1][0] == 0  # loc walks W; x broadcasts over k
    for view, strides in zip(views, merged):
        walked = torch.as_strided(view, merged_shape, strides, view.storage_offset())
        assert torch.equal(walked.reshape(-1), view.permute(order).reshape(-1))
    out = dl_kernel._dense_like(shape, order, "cpu")
    assert out.shape == shape and out.permute(order).is_contiguous()
    # contiguous operands merge into one dimension; a single element is one
    a = torch.zeros(4, 1, 6)
    assert kernel_layout(a.shape, [a.stride(), a.stride()]) == ([0, 2], [24], [[1], [1]])
    assert kernel_layout((1, 1), [(0, 0)]) == ([], [1], [[0]])


@pytest.mark.parametrize("low,high,width", BINS)
def test_discretized_logistic_class_matches_jax(low, high, width):
    rng = np.random.default_rng(6)
    x, loc, logscale = _inputs(rng, low, high)
    ours = DiscretizedLogistic(_t(loc), _t(logscale), low=low, high=high)
    theirs = JaxDL(jnp.asarray(loc), jnp.asarray(logscale), low=low, high=high)
    assert ours.interval_width == theirs.interval_width == width
    assert ours.event_axes == theirs.event_axes and ours.levels == theirs.levels
    want = np.asarray(theirs.log_prob(x))
    tol = _value_tolerance(x, loc, logscale, want, low, high, width)
    assert (np.abs(ours.log_prob(_t(x)).numpy() - want) <= tol).all()
    want_reduced = np.asarray(theirs.reduced_log_prob(x))
    np.testing.assert_allclose(ours.reduced_log_prob(_t(x)).numpy(), want_reduced,
                               rtol=1e-5, atol=tol.sum(axis=(-1, -2, -3)).max())
    np.testing.assert_allclose(ours.mean().numpy(), np.asarray(theirs.mean()), rtol=0, atol=0)

    # the uniforms JAX's sample draws from this key, injected into the port's
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, (2,) + loc.shape, minval=np.finfo(np.float32).tiny,
                                    maxval=1.0))
    want_sample = np.asarray(theirs.sample(key, (2,)))
    got_sample = ours.sample(sample_shape=(2,), noise=_t(u)).numpy()
    assert got_sample.shape == (2,) + loc.shape
    assert got_sample.min() >= low and got_sample.max() <= high
    assert (got_sample == low).any() and (got_sample == high).any()  # the clip is active
    np.testing.assert_allclose(got_sample, want_sample, **TOL)
    drawn = ours.sample(torch.Generator().manual_seed(0), (2,))
    assert drawn.shape == (2,) + loc.shape and torch.isfinite(drawn).all()


@pytest.mark.parametrize("bound_logstd", [False, True])
def test_make_observation_dl_matches_jax(bound_logstd):
    rng = np.random.default_rng(8)
    out = rng.standard_normal((3, 2, 4, 4, 6)).astype(np.float32)
    x = rng.integers(0, 256, (2, 4, 4, 3)).astype(np.float32) / 255.0
    ours = make_observation(_t(out), "dl", bound_logstd)
    theirs = jax_make_observation(jnp.asarray(out), "dl", bound_logstd, use_pallas=False)
    assert isinstance(ours, DiscretizedLogistic) and ours.use_pallas is False
    assert (ours.low, ours.high, ours.levels) == (theirs.low, theirs.high, theirs.levels)
    assert ours.event_axes == theirs.event_axes == (-1, -2, -3)
    np.testing.assert_allclose(ours.loc.numpy(), np.asarray(theirs.loc), rtol=0, atol=0)
    np.testing.assert_allclose(ours.logscale.numpy(), np.asarray(theirs.logscale), **TOL)
    assert (np.abs(ours.logscale.numpy()) <= 1.0).all() == bound_logstd
    want = np.asarray(theirs.log_prob(x))
    tol = _value_tolerance(x, ours.loc.numpy(), ours.logscale.numpy(), want, 0.0, 1.0, 1 / 255)
    assert (np.abs(ours.log_prob(_t(x)).numpy() - want) <= tol).all()
    # without the bound, the halves are views of the head's output: no copy
    if not bound_logstd:
        head = _t(out)
        obs = make_observation(head, "dl")
        assert obs.loc.data_ptr() == head.data_ptr() and obs.logscale.stride() == head.stride()


def test_dispatch_none_on_cpu_is_plain_and_true_on_cpu_raises():
    rng = np.random.default_rng(9)
    x, loc, logscale = _inputs(rng, 0.0, 1.0)
    assert resolve_use_pallas(None, "dl", _t(loc)) is False
    assert resolve_use_pallas(True, "dl", _t(loc)) is True
    assert resolve_use_pallas(None, "dl", torch.empty(1, device="meta")) is False
    auto = make_observation(_t(np.concatenate([loc, logscale], axis=-1)), "dl")
    forced = dataclasses.replace(auto, use_pallas=True)
    before = dl_kernel.launches
    plain = auto.log_prob(_t(x))
    assert dl_kernel.launches == before
    torch.testing.assert_close(plain, discretized_logistic_log_prob(
        _t(x), _t(loc), _t(logscale), low=0.0, high=1.0, interval_width=1.0 / 255.0),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="use_pallas=True"):
        forced.log_prob(_t(x))
