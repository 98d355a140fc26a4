"""Property-based tests (hypothesis) of the port's likelihood and
log-mean-exp (``distributions/discretized.py``, ``ops/math.py``): the
mirror of ``tests/test_properties.py``, each value held against the JAX
package's on the same input where JAX has one.

- The discretized logistic is a probability measure over the 256-level bin
  grid for any (loc, logscale): its probabilities sum to 1 (rtol 5e-4, as
  JAX's property), and each bin's probability equals JAX's within 1e-6 plus
  1e-4 of itself (float32 sigmoids in another library: a few ulps, and a
  difference of two of them where a bin is narrow against the scale).
- The streaming logmeanexp equals the direct one for every chunking of the
  sample axis (rtol, atol 1e-5, as JAX's), and equals JAX's streaming value
  (the same tolerance).
- An all -inf column finalises to -inf, not NaN.
- ``logmeanexp`` is shift-invariant (rtol 1e-5, atol 1e-3, as JAX's) and
  equals JAX's (rtol, atol 1e-5).

Every example is drawn deterministically (``derandomize``), so the file
runs the same examples each time, eagerly on the CPU in float32.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from vae_mdl_tpu.distributions.discretized import (  # noqa: E402
    discretized_logistic_log_prob as jax_dl_log_prob,
)
from vae_mdl_tpu.ops import math as jmath  # noqa: E402
from vae_mdl_tpu_torch.distributions.discretized import (  # noqa: E402
    discretized_logistic_log_prob,
)
from vae_mdl_tpu_torch.ops.math import (  # noqa: E402
    logmeanexp,
    streaming_logmeanexp_finalize,
    streaming_logmeanexp_init,
    streaming_logmeanexp_update,
)

torch.set_num_threads(1)

_SETTINGS = dict(max_examples=25, deadline=None, derandomize=True)


@settings(**_SETTINGS)
@given(
    loc=st.floats(-0.5, 1.5),
    logscale=st.floats(-9.0, 1.0),
    low=st.sampled_from([0.0, -1.0]),
)
def test_discretized_logistic_normalizes_over_bins(loc, logscale, low):
    high, levels = 1.0, 256
    bins = np.linspace(low, high, levels).astype(np.float32)
    lp = discretized_logistic_log_prob(torch.from_numpy(bins), torch.tensor(loc),
                                       torch.tensor(logscale), low=low, high=high,
                                       levels=float(levels)).numpy().astype(np.float64)
    np.testing.assert_allclose(np.exp(lp).sum(), 1.0, rtol=5e-4)
    want = np.asarray(jax_dl_log_prob(jnp.asarray(bins), jnp.float32(loc),
                                      jnp.float32(logscale), low=low, high=high,
                                      levels=float(levels)), np.float64)
    np.testing.assert_allclose(np.exp(lp), np.exp(want), rtol=1e-4, atol=1e-6)


@settings(**_SETTINGS)
@given(
    data=st.data(),
    n=st.integers(2, 40),
    b=st.integers(1, 4),
)
def test_streaming_logmeanexp_equals_direct_for_any_chunking(data, n, b):
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    log_w = (rng.standard_normal((n, b)) * 30.0).astype(np.float32)
    cuts = sorted(data.draw(st.sets(st.integers(1, n - 1), max_size=min(6, n - 1))))
    bounds = [0] + cuts + [n]

    state = streaming_logmeanexp_init((b,))
    jax_state = jmath.streaming_logmeanexp_init((b,))
    for s, e in zip(bounds[:-1], bounds[1:]):
        state = streaming_logmeanexp_update(state, torch.from_numpy(log_w[s:e]))
        jax_state = jmath.streaming_logmeanexp_update(jax_state, jnp.asarray(log_w[s:e]))
    got = streaming_logmeanexp_finalize(state).numpy()

    want = logmeanexp(torch.from_numpy(log_w), dim=0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jmath.streaming_logmeanexp_finalize(jax_state)),
                               rtol=1e-5, atol=1e-5)


def test_streaming_logmeanexp_all_neg_inf_column():
    state = streaming_logmeanexp_init((2,))
    chunk = torch.tensor([[-np.inf, 0.0], [-np.inf, 1.0]], dtype=torch.float32)
    out = streaming_logmeanexp_finalize(streaming_logmeanexp_update(state, chunk)).numpy()
    assert out[0] == -np.inf and np.isfinite(out[1])


@settings(**_SETTINGS)
@given(
    seed=st.integers(0, 2**31),
    shift=st.floats(-1e4, 1e4),
)
def test_logmeanexp_shift_invariance(seed, shift):
    rng = np.random.default_rng(seed)
    log_w = (rng.standard_normal((7, 3)) * 5.0).astype(np.float32)
    base = logmeanexp(torch.from_numpy(log_w), dim=0).numpy().astype(np.float64)
    shifted = logmeanexp(torch.from_numpy(log_w + np.float32(shift)), dim=0).numpy()
    np.testing.assert_allclose(shifted.astype(np.float64) - float(np.float32(shift)), base,
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(base, np.asarray(jmath.logmeanexp(jnp.asarray(log_w), axis=0)),
                               rtol=1e-5, atol=1e-5)
