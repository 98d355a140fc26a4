"""The discretized-logistic kernels' tile path, as far as the CPU reaches it:
the dispatch by layout (``dl_kernel.forward_path`` / ``backward_path``: the
halves of a channels-last head against every other layout), the head-level
entry ``dl_log_prob_head`` (its plain version, log-prob and the gradient into
the head) against the Pallas kernel in interpret mode, the tile walk's
schedule replayed with the plain version as the body, ``DiscretizedLogistic``
carrying its head, and model03 at a narrow width with the likelihood taken
through the head-level entry, against JAX in loss and every gradient leaf.

Tolerances, each with its reason:
- log-probs and the gradient into the head against the Pallas kernel: the
  rules ``tests/test_torch_dl.py`` states for the same comparison
  (``_value_tolerance``; rtol 1e-4 plus the cancellation of the CDF
  difference's derivative over a 1/255-wide bin, and an edge bin's
  1 - sigmoid);
- the replayed walk and the head-level entry's plain version against the
  plain version on the halves: the same float32 operations on the same
  values, so exactly (atol 0);
- the narrow model03: the loss and gradient tolerances of
  ``tests/test_torch_families.py`` (``LOSS_RTOL``, ``_grad_rtol``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_dl import BINS, _inputs, _t, _terms, _branches, _value_tolerance
from test_torch_families import LOSS_RTOL, _both, _grad_rtol, _pair, _rel
from vae_mdl_tpu.ops.pallas.dl_kernel import dl_log_prob as pallas_dl_log_prob
from vae_mdl_tpu_torch.distributions import DiscretizedLogistic, discretized_logistic_log_prob
from vae_mdl_tpu_torch.nn.decoders import make_observation
from vae_mdl_tpu_torch.ops.cuda import dl_kernel
from vae_mdl_tpu_torch.ops.cuda.dl_kernel import (
    TILE_THREADS,
    backward_path,
    dl_log_prob_head,
    forward_path,
)
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import tiles_of
from vae_mdl_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

K, B, SIDE = 2, 2, 8
# pixels a thread of the read-only walk as it is built: the MoDL forward's
# one and the discretized-logistic forward's two (csrc/dl_log_prob.cu
# kForwardPixels); the backward walks one
WALK_PIXELS = (1, 2)


def _head(k=K, b=B, side=SIDE, channels=6, seed=0):
    """A head conv's output ``[k * B, C, H, W]`` in channels-last memory, as
    the decoder hands it on: an ``[k, B, H, W, C]`` view."""
    rng = np.random.default_rng(seed)
    conv = torch.from_numpy(rng.standard_normal((k * b, channels, side, side)).astype(np.float32))
    conv = conv.contiguous(memory_format=torch.channels_last)
    return conv.reshape(k, b, channels, side, side).permute(0, 1, 3, 4, 2)


def _x(b=B, side=SIDE, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, side, side, 3)).astype(np.float32) / 255.0)


def _misaligned_head(k=K, b=B, side=SIDE):
    """A dense channel-minor head one float past a 16-byte boundary."""
    n = k * b * side * side * 6
    flat = torch.zeros(n + 16)
    lead = (-flat.data_ptr() % 16) // flat.element_size()
    head = flat[lead + 1:lead + 1 + n].view(k, b, side, side, 6)
    assert head.data_ptr() % 16 == 4
    return head


def _operands(case):
    """(x, loc, logscale) of one layout, and the path both directions take."""
    x = _x()
    head = _head()
    if case == "observation":  # what make_observation("dl") makes
        obs = make_observation(head, "dl")
        return x, obs.loc, obs.logscale, "tiled"
    loc, logscale = torch.chunk(head, 2, dim=-1)
    if case == "one_sample":  # K = 1: x need not be broadcast, any K stride
        one = _head(k=1)
        loc, logscale = torch.chunk(one, 2, dim=-1)
        return x[None], loc, logscale, "tiled"
    if case == "x_broadcast_over_b":  # a zero stride elsewhere than K is read in place
        return x[:1], loc, logscale, "tiled"
    if case == "contiguous":
        return x, loc.contiguous(), logscale.contiguous(), "direct"
    if case == "nchw":
        conv = torch.randn(K * B, 6, SIDE, SIDE)
        loc, logscale = torch.chunk(conv.reshape(K, B, 6, SIDE, SIDE).permute(0, 1, 3, 4, 2),
                                    2, dim=-1)
        return x, loc, logscale, "direct"
    if case == "sliced":  # six of a wider head's channels: rows 8 floats apart
        wide = _head(channels=8)[..., :6]
        loc, logscale = torch.chunk(wide, 2, dim=-1)
        return x, loc, logscale, "direct"
    if case == "misaligned":
        loc, logscale = torch.chunk(_misaligned_head(), 2, dim=-1)
        return x, loc, logscale, "direct"
    if case == "bound_logstd":
        obs = make_observation(head, "dl", bound_logstd=True)
        return x, obs.loc, obs.logscale, "direct"
    if case == "x_not_broadcast":
        return x.expand(K, *x.shape).contiguous(), loc, logscale, "direct"
    if case == "swapped":  # logscale before loc in the row
        return x, logscale, loc, "direct"
    if case == "empty":
        loc, logscale = torch.chunk(torch.zeros(0, B, SIDE, SIDE, 6), 2, dim=-1)
        return x, loc, logscale, "direct"
    if case == "float64":
        loc, logscale = torch.chunk(head.double(), 2, dim=-1)
        return x.double(), loc, logscale, "direct"
    raise ValueError(case)


_CASES = ["observation", "one_sample", "x_broadcast_over_b", "contiguous", "nchw", "sliced",
          "misaligned", "bound_logstd", "x_not_broadcast", "swapped", "empty", "float64"]


@pytest.mark.parametrize("case", _CASES)
def test_paths_take_the_tile_path_for_the_halves_of_a_channels_last_head_alone(case):
    x, loc, logscale, want = _operands(case)
    assert forward_path(x, loc, logscale) == want
    # the cotangent as the event sum expands it, and as a dense tensor
    expanded = torch.ones(loc.shape[:2] + (1, 1, 1), dtype=loc.dtype).expand(loc.shape)
    assert backward_path(x, loc, logscale, expanded) == want
    assert backward_path(x, loc, logscale, torch.ones(loc.shape, dtype=loc.dtype)) == want


def test_backward_path_is_direct_for_a_cotangent_that_does_not_fit():
    x, loc, logscale, _ = _operands("observation")
    assert backward_path(x, loc, logscale, torch.ones(loc.shape)) == "tiled"
    assert backward_path(x, loc, logscale, torch.ones(loc.shape).double()) == "direct"
    assert backward_path(x, loc, logscale, torch.ones(loc.shape[1:])) == "direct"


@pytest.mark.parametrize("low,high,width", BINS)
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_head_entry_matches_the_pallas_kernel_in_value_and_gradient(layout, low, high, width):
    """The head-level entry's plain version (CPU tensors) against JAX's
    ``dl_log_prob`` (the Pallas kernel in interpret mode): the log-prob, and
    the gradient into the head against ``jax.vjp`` of the kernel on the
    head's halves, on inputs that hit all four branches."""
    rng = np.random.default_rng(11)
    x, loc, logscale = _inputs(rng, low, high)
    assert min(_branches(x, loc, logscale, low, high, width).values()) > 10
    head = np.concatenate([loc, logscale], axis=-1)
    g = rng.standard_normal(loc.shape).astype(np.float32)

    leaf = _t(head)
    if layout == "channels_last":
        k, b, h, w, c = head.shape
        leaf = leaf.permute(0, 1, 4, 2, 3).reshape(k * b, c, h, w).contiguous(
            memory_format=torch.channels_last).reshape(k, b, c, h, w).permute(0, 1, 3, 4, 2)
        assert leaf.stride()[-1] == 1
    leaf = leaf.detach().requires_grad_(True)
    before = dl_kernel.launches, dl_kernel.backward_launches
    got = dl_log_prob_head(_t(x), leaf, low, high, width)
    (got_grad,) = torch.autograd.grad(got, leaf, _t(g))
    assert (dl_kernel.launches, dl_kernel.backward_launches) == before  # the CPU: plain
    assert got.shape == loc.shape and got_grad.shape == head.shape

    want, vjp = jax.vjp(lambda h: pallas_dl_log_prob(x, h[..., :3], h[..., 3:], low, high, width),
                        head)
    (want_grad,) = vjp(g)
    want, want_grad = np.asarray(want), np.asarray(want_grad)
    tol = _value_tolerance(x, loc, logscale, want, low, high, width)
    assert (np.abs(got.detach().numpy() - want) <= tol).all()

    # the gradient's rule of tests/test_torch_dl.py, half by half
    prob, start, stop, inv_std, edge = _terms(x, loc, logscale, low, high, width)
    cancel = np.where(edge | (prob <= 1e-5), 0.0,
                      8 * 2.0 ** -24 * (1 + np.abs(start) + np.abs(stop)) / np.maximum(prob, 1e-5))
    cancel = np.where(edge, 16 * 2.0 ** -24, cancel)
    halves = zip(np.split(got_grad.numpy(), 2, axis=-1), np.split(want_grad, 2, axis=-1),
                 (inv_std, np.abs(start) + np.abs(stop)))
    for got_half, want_half, scale in halves:
        limit = 1e-4 * np.abs(want_half) + 1e-6 + np.abs(g) * cancel * scale
        assert (np.abs(got_half - want_half) <= limit).all()


def test_head_entry_is_the_plain_version_on_the_halves_exactly():
    x, head = _x(), _head()
    loc, logscale = torch.chunk(head, 2, dim=-1)
    want = discretized_logistic_log_prob(x, loc, logscale, low=0.0, high=1.0,
                                         interval_width=1.0 / 255.0)
    for path in (None, "tiled", "direct"):  # the CPU takes the plain version whatever the path
        got = dl_log_prob_head(x, head, 0.0, 1.0, 1.0 / 255.0, path)
        assert torch.equal(got, want)


def test_head_entry_refuses_what_it_does_not_take_on_the_cpu():
    x, head = _x(), _head()
    with pytest.raises(ValueError, match="path"):
        dl_log_prob_head(x, head, 0.0, 1.0, 1.0 / 255.0, "staged")
    with pytest.raises(ValueError, match="even number"):
        dl_log_prob_head(x, head[..., :5], 0.0, 1.0, 1.0 / 255.0)
    for path in (None, "tiled", "direct"):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dl_kernel.dl_log_prob_cuda(x, *torch.chunk(head, 2, dim=-1), 0.0, 1.0, 1.0 / 255.0,
                                       path)
    assert set(dl_kernel.launches_by_path) == set(dl_kernel.backward_launches_by_path) == {
        "tiled", "direct"}
    assert dl_kernel._library.cache_info().currsize == 0  # nothing built here


def _walk(x, head, pixels, blocks):
    """The tile path's read-only walk (``csrc/mdl_tile.cuh``
    ``for_each_tile_read``) replayed on the CPU: each block's tiles of
    ``TILE_THREADS * pixels`` pixels, thread t taking pixels j * 128 + t of a
    tile, each storing its three values from its own row. -> (output, how
    often each pixel was written)."""
    k, b, h, w, c = head.shape
    rows = head.reshape(-1, c)
    images = x.expand(k, b, h, w, 3).reshape(-1, 3)
    out = torch.full((rows.shape[0], 3), float("nan"))
    writes = torch.zeros(rows.shape[0], dtype=torch.int64)
    for tiles in tiles_of(rows.shape[0], TILE_THREADS * pixels, blocks):
        for first, n in tiles:
            for j in range(pixels):  # past a ragged tile's end no thread has a pixel j
                mine = torch.arange(first + min(n, j * TILE_THREADS),
                                    first + min(n, (j + 1) * TILE_THREADS))
                out[mine] = discretized_logistic_log_prob(
                    images[mine], rows[mine, :3], rows[mine, 3:], low=0.0, high=1.0,
                    interval_width=1.0 / 255.0)
                writes[mine] += 1
    return out.reshape(k, b, h, w, 3), writes


@pytest.mark.parametrize("pixels", WALK_PIXELS)
@pytest.mark.parametrize("shape,blocks", [((2, 2, 8, 8), 3), ((3, 7, 31, 31), 132 * 16),
                                          ((1, 1, 1, 1), 2)])
def test_tile_walk_writes_every_pixel_once_and_equals_the_plain_version(shape, blocks, pixels):
    k, b, h, w = shape
    x, head = _x(b, h, seed=k), _head(k, b, h, seed=b).contiguous()
    got, writes = _walk(x, head, pixels, blocks)
    assert (writes == 1).all()
    loc, logscale = torch.chunk(head, 2, dim=-1)
    assert torch.equal(got, discretized_logistic_log_prob(x, loc, logscale, low=0.0, high=1.0,
                                                          interval_width=1.0 / 255.0))


def test_tile_of_the_head_is_whole_16_byte_chunks():
    """A tile of ``TILE_THREADS * pixels`` rows of six float32 values is a
    bulk copy's multiple of 16 bytes at the sizes each direction takes."""
    for pixels in WALK_PIXELS:
        assert TILE_THREADS * pixels * 6 * 4 % 16 == 0


def test_observation_carries_its_head_where_loc_and_logscale_are_its_halves():
    head = _head()
    obs = make_observation(head, "dl")
    assert obs.head is head and obs._halves_of_head()
    assert obs.loc.data_ptr() == head.data_ptr()
    bounded = make_observation(head, "dl", bound_logstd=True)
    assert bounded.head is None and not bounded._halves_of_head()
    # a replaced parameter no longer is the head's half
    moved = dataclasses.replace(obs, loc=obs.loc.clone())
    assert not moved._halves_of_head()
    x = _x()
    torch.testing.assert_close(moved.log_prob(x), obs.log_prob(x), rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("route", ["halves", "head"])
def test_narrow_model03_matches_jax_with_the_likelihood_on_the_head(route, k, monkeypatch):
    """model03 at a narrow width on bridged weights and injected noise: the
    loss and every gradient leaf against JAX (whose likelihood runs the
    Pallas kernel in interpret mode), with the port's likelihood evaluated on
    loc and logscale ("halves", the CPU path) or through the head-level entry
    with the head as its operand ("head", what the card's path
    differentiates)."""
    if route == "head":
        taken = []

        def log_prob(self, x):
            assert self._halves_of_head()
            taken.append(self.head.shape)
            return dl_log_prob_head(x, self.head, self.low, self.high, self.interval_width)

        monkeypatch.setattr(DiscretizedLogistic, "log_prob", log_prob)
    pair = _pair("model03")
    x, eps = pair.inputs(np.random.default_rng(5 + k), batch=4, k=k)
    loss, grads = pair.jax_loss_and_grad(pair.variables, x, eps)
    want = {name: t.numpy() for name, t in params_from_flax(grads, pair.cfg).items()}
    got_loss, got, _ = pair.port_loss_and_grads(x, eps)
    if route == "head":
        assert taken and all(shape[-1] == 6 for shape in taken)
    want_loss = float(loss)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    for leaf in want:
        assert got[leaf].shape == want[leaf].shape
        assert _rel(got[leaf], want[leaf]) <= _grad_rtol(k, want_loss), leaf
    # the same as the family test's own run of this pair
    if route == "halves":
        assert got_loss == _both("model03", k)[0]
