"""Receptive fields of the port's building blocks (``nn/blocks.py``): the
mirror of ``tests/test_receptive_field.py``.

The support of d(one output pixel)/d(input) must equal the block's analytic
receptive field, and equals the JAX block's support on the same input
(SAME padding, 3x3 convs reach one pixel a side):

- ResidualBlock (1x1, 3x3, 3x3, 1x1) -> 5x5;
- GLU (3x3, 3x3) -> 5x5;
- EncoderBlock (N blocks, then an r x r average pool, stride r): output
  pixel o covers rows r*o - 2N .. r*o + r - 1 + 2N;
- DecoderBlock (bilinear upsample, then N blocks): inside the bilinear
  bound, the centre source pixel reached;
- a rezero block is the identity at init (gate 0), its field one pixel.

The supports are boolean: no tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from vae_mdl_tpu.nn import blocks as jblocks
from vae_mdl_tpu_torch.nn import blocks

torch.set_num_threads(1)

H = W = 16


def _support(module, x: np.ndarray, pick, nchw: bool = False) -> np.ndarray:
    """Boolean [H, W] support of d(pick(output))/d(input), ``x`` NHWC."""
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) if nchw else module(xt)
    pick(out).sum().backward()
    return np.any(np.abs(xt.grad.numpy()) > 0, axis=(0, 3))


def _jax_support(module, x: np.ndarray, pick) -> np.ndarray:
    params = module.init(jax.random.PRNGKey(0), x)
    g = np.asarray(jax.grad(lambda xin: pick(module.apply(params, xin)).sum())(x))
    return np.any(np.abs(g) > 0, axis=(0, 3))


def _box(r0, r1, c0, c1):
    m = np.zeros((H, W), bool)
    m[r0:r1, c0:c1] = True
    return m


def _center_pick(row, col):
    return lambda y: y[:, row, col, :]


def _x(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, H, W, 8)).astype(np.float32)


def _gen():
    return torch.Generator().manual_seed(0)


def test_residual_block_rf_is_5x5():
    x = _x(1)
    support = _support(blocks.ResidualBlock(8, 16, 8, generator=_gen()), x, _center_pick(8, 8))
    np.testing.assert_array_equal(support, _box(6, 11, 6, 11))
    np.testing.assert_array_equal(
        support, _jax_support(jblocks.ResidualBlock(hidden_width=16, out_width=8), x,
                              _center_pick(8, 8)))


def test_glu_rf_is_5x5():
    x = _x(2)
    support = _support(blocks.GLU(8, features=32, generator=_gen()), x, _center_pick(8, 8),
                       nchw=True)
    np.testing.assert_array_equal(support, _box(6, 11, 6, 11))
    np.testing.assert_array_equal(
        support, _jax_support(jblocks.GLU(features=32), x, _center_pick(8, 8)))


@pytest.mark.parametrize("n_blocks,rate", [(1, 2), (2, 2)])
def test_encoder_block_rf(n_blocks, rate):
    x = _x(3)
    o = 3  # output pixel, away from borders
    support = _support(blocks.EncoderBlock(8, 16, 8, n_blocks, rate, generator=_gen()), x,
                       _center_pick(o, o))
    reach = 2 * n_blocks
    lo, hi = rate * o - reach, rate * o + rate - 1 + reach + 1
    np.testing.assert_array_equal(support, _box(lo, hi, lo, hi))
    np.testing.assert_array_equal(
        support, _jax_support(jblocks.EncoderBlock(hidden_width=16, out_width=8,
                                                   n_blocks=n_blocks, downscale_rate=rate),
                              x, _center_pick(o, o)))


def test_decoder_block_rf_within_bilinear_bound():
    """Upsample, then convs: the support stays inside the analytic bound
    (bilinear output u samples source (u + 0.5) / r - 0.5, floor and ceil)
    and includes the centre source pixel."""
    r, n_blocks = 2, 1
    x = _x(4)
    u = 16  # output pixel in the 32x32 upsampled map
    support = _support(blocks.DecoderBlock(8, 16, 8, n_blocks, r, generator=_gen()), x,
                       _center_pick(u, u))
    reach = 2 * n_blocks
    lo = int(np.floor((u - reach + 0.5) / r - 0.5))
    hi = int(np.ceil((u + reach + 0.5) / r - 0.5)) + 1
    bound = _box(lo, hi, lo, hi)
    assert not np.any(support & ~bound), "gradient leaks outside the RF bound"
    assert support[u // r, u // r], "centre source pixel not reached"
    np.testing.assert_array_equal(
        support, _jax_support(jblocks.DecoderBlock(hidden_width=16, out_width=8,
                                                   n_blocks=n_blocks, upscale_rate=r),
                              x, _center_pick(u, u)))


def test_rezero_block_is_identity_at_init():
    """gate = 0 at init: the block is the identity, its receptive field the
    single centre pixel."""
    x = _x(5)
    block = blocks.ResidualBlock(8, 16, 8, rezero=True, generator=_gen())
    with torch.no_grad():
        np.testing.assert_array_equal(block(torch.from_numpy(x)).numpy(), x)
    support = _support(block, x, _center_pick(8, 8))
    expected = np.zeros((H, W), bool)
    expected[8, 8] = True
    np.testing.assert_array_equal(support, expected)
    np.testing.assert_array_equal(
        support, _jax_support(jblocks.ResidualBlock(hidden_width=16, out_width=8, rezero=True),
                              x, _center_pick(8, 8)))
