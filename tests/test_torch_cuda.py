"""The MoDL and discretized-logistic CUDA kernels on the card: forward and
backward against their plain versions, their input checks, their launch
counts, the two memory paths of each MoDL kernel against each other bit for
bit, and the gradient's layout; the probe kernel, the channel sum and the
null-body MoDL kernels against theirs; the default device of ``build_model``
and the timing harness; the evaluator's Bernoulli binarisation; and one
biladder_celeba loss and gradient through the DL kernels against the plain
version.
Needs a CUDA card and nvcc; skipped elsewhere. On a machine without
jax, run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, as in chip_smoke.py (same float32 formulas and libdevice
functions, sums in another order): forward per pixel |kernel - plain| <=
2e-4 + 1e-5 |plain|; backward per element <= 2e-5 + 2e-4 |plain| for a
float32 gradient and 2e-5 + 8e-3 |plain| for a bf16 one (one bf16 ulp is
2^-8 of the value). The two memory paths of each MoDL kernel run one body,
the same float32 operations in the same order, and are held to each other
exactly; so are the channel sum's three kernels and the null forward's two
variants, which add each pixel's channels in one order. The
discretized-logistic kernels run the plain
version's float32 operations one for one, without fused multiply-adds (on
the H100 they agreed bit for bit); they are held to the same forward and
float32 backward tolerances. The probe kernel calls the same libdevice
functions as PyTorch's elementwise kernels (rtol 1e-5, atol 1e-6 over three
iterations; nan meets nan); the channel sums add 50 to 100 float32 terms in
another order (atol 1e-4); ``0.5 p + g`` is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.data.preprocess import binarize
from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.evaluation.harness import _batch_seed, evaluate_llh, make_batch_evaluator
from vae_mdl_tpu_torch.models.objective import training_loss_fn
from vae_mdl_tpu_torch.models.vae import build_model, latent_shapes, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.ops.cuda import dl_kernel, io_probe, mdl_kernel, mdl_null, sfu_probe
from vae_mdl_tpu_torch.utils.timing import setup_scanned_step

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(device, k=3, b=2, h=5, w=7, n_mix=5, dtype=torch.float32):
    rng = np.random.default_rng(n_mix)
    x = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32) / 255.0
    x.reshape(-1)[:2] = (0.0, 1.0)
    p = rng.standard_normal((k, b, h, w, 10 * n_mix)).astype(np.float32) * 3.0
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(p).to(device=device, dtype=dtype))


@pytest.mark.parametrize("n_mix", [1, 2, 5, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchw", [False, True])
def test_kernel_matches_plain_version(cuda, n_mix, dtype, nchw):
    x, p = _inputs(cuda, n_mix=n_mix, dtype=dtype)
    if nchw:
        p = p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    before = mdl_kernel.launches
    got = mdl_kernel.mdl_log_prob(x, p)
    assert mdl_kernel.launches == before + 1
    want = mixture_log_prob(x, p.float())
    assert got.shape == want.shape == (3, 2, 5, 7, 1)
    assert ((got - want).abs() <= 2e-4 + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("bad", ["x_dtype", "p_dtype", "channels", "shape", "x_rank", "p_rank"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    x, p = _inputs(cuda)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "p_dtype":
        p = p.half()
    elif bad == "channels":
        p = p[..., :45]
    elif bad == "shape":
        x = x[:, :4]
    elif bad == "x_rank":
        x = x[0]
    else:
        p = p[0]
    with pytest.raises((TypeError, ValueError)):
        mdl_kernel.mdl_log_prob(x, p)


_BWD_RTOL = {torch.float32: 2e-4, torch.bfloat16: 8e-3}


def _nchw(p):
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def _cotangent(device, shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("n_mix", [1, 2, 5, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchw", [False, True])
def test_backward_kernel_matches_plain_version(cuda, n_mix, dtype, nchw):
    x, p = _inputs(cuda, n_mix=n_mix, dtype=dtype)
    if nchw:
        p = _nchw(p)
    g = _cotangent(cuda, (3, 2, 5, 7, 1), n_mix)
    before = mdl_kernel.backward_launches
    got = mdl_kernel.mdl_backward(x, p, g)
    assert mdl_kernel.backward_launches == before + 1
    want = mdl_kernel.mdl_backward_plain(x, p, g)
    assert got.dtype == want.dtype == dtype and got.shape == p.shape
    err = (got.float() - want.float()).abs()
    assert (err <= 2e-5 + _BWD_RTOL[dtype] * want.float().abs()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_keeps_the_parameters_strides_and_dtype(cuda, dtype):
    """Through autograd, as the model differentiates it: an NCHW-strided
    parameter view gets an NCHW-strided gradient of its dtype, from a
    cotangent the sum's backward expands with zero strides."""
    x, p = _inputs(cuda, dtype=dtype)
    p = _nchw(p).requires_grad_(True)
    mdl_kernel.mdl_log_prob(x, p).sum(dim=(-1, -2, -3)).sum().backward()
    assert p.grad.dtype == dtype and p.grad.stride() == p.stride()
    want = mdl_kernel.mdl_backward_plain(x, p.detach(), torch.ones(3, 2, 5, 7, 1, device=cuda))
    err = (p.grad.float() - want.float()).abs()
    assert (err <= 2e-5 + _BWD_RTOL[dtype] * want.float().abs()).all()


def test_images_gradient_goes_through_the_plain_version(cuda):
    x, p = _inputs(cuda)
    x.requires_grad_(True)
    g = _cotangent(cuda, (3, 2, 5, 7, 1))
    (dx,) = torch.autograd.grad(mdl_kernel.mdl_log_prob(x, p), x, g)
    x_plain = x.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(mixture_log_prob(x_plain, p), x_plain, g)
    torch.testing.assert_close(dx, want)


@pytest.mark.parametrize("bad", ["g_dtype", "g_shape", "g_device", "p_dtype", "channels"])
def test_backward_refuses_what_it_does_not_take(cuda, bad):
    x, p = _inputs(cuda)
    g = _cotangent(cuda, (3, 2, 5, 7, 1))
    if bad == "g_dtype":
        g = g.double()
    elif bad == "g_shape":
        g = g[:, :, :4]
    elif bad == "g_device":
        g = g.cpu()
    elif bad == "p_dtype":
        p = p.half()
    else:
        p = p[..., :45]
    with pytest.raises((TypeError, ValueError)):
        mdl_kernel.mdl_backward(x, p, g)


# (k, B, H, W): one full and one ragged tile; many tiles a block with a ragged
# last one (649,605 pixels: 5,076 tiles of 128 over the card's persistent blocks)
_TILE_SHAPES = [(3, 2, 5, 7), (5, 127, 31, 33)]


def _misaligned_like(p):
    """A dense copy of ``p`` one element past a 16-byte boundary."""
    flat = torch.empty(p.numel() + 16, device=p.device, dtype=p.dtype)
    lead = (-flat.data_ptr() % 16) // flat.element_size() + 1
    view = flat[lead:lead + p.numel()].view(p.shape)
    view.copy_(p)
    return view


@pytest.mark.parametrize("n_mix", [1, 5, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _TILE_SHAPES)
def test_backward_paths_agree_bit_for_bit(cuda, shape, dtype, n_mix):
    """Channel-minor operands take the tile path; forced onto the direct one
    they give the same bits, and agree with the plain version. The cotangent is the one the sum over the image's axes
    expands."""
    k, b, h, w = shape
    x, p = _inputs(cuda, k=k, b=b, h=h, w=w, n_mix=n_mix, dtype=dtype)
    g = _cotangent(cuda, (k, b, 1, 1, 1), n_mix).expand(k, b, h, w, 1)
    assert mdl_kernel.backward_path(p, torch.empty_like(p)) == "tiled"
    before = dict(mdl_kernel.backward_launches_by_path)
    tiled = mdl_kernel.mdl_backward(x, p, g)
    direct = mdl_kernel.mdl_backward(x, p, g, path="direct")
    torch.cuda.synchronize()
    assert mdl_kernel.backward_launches_by_path == {"tiled": before["tiled"] + 1,
                                                    "direct": before["direct"] + 1}
    assert tiled.stride() == direct.stride() == p.stride()
    assert torch.equal(tiled, direct)
    assert 1 <= mdl_kernel.tile_blocks_per_sm(dtype, n_mix) <= 16
    want = mdl_kernel.mdl_backward_plain(x, p, g)
    err = (tiled.float() - want.float()).abs()
    assert (err <= 2e-5 + _BWD_RTOL[dtype] * want.float().abs()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nchw", "misaligned", "sliced"])
def test_backward_takes_the_direct_path_off_the_tile_layout(cuda, layout, dtype):
    """NCHW strides, a view one element off a 16-byte boundary and a channel
    slice take the direct path and agree with the plain version; asked for
    the tile path they are refused, and nothing is launched."""
    x, p = _inputs(cuda, dtype=dtype)
    if layout == "nchw":
        p = _nchw(p)
    elif layout == "misaligned":
        p = _misaligned_like(p)
    else:
        wide = torch.zeros((3, 2, 5, 7, 60), device=cuda, dtype=dtype)
        wide[..., :50] = p
        p = wide[..., :50]
    g = _cotangent(cuda, (3, 2, 5, 7, 1))
    assert mdl_kernel.backward_path(p, torch.empty_like(p)) == "direct"
    before = dict(mdl_kernel.backward_launches_by_path)
    got = mdl_kernel.mdl_backward(x, p, g)
    assert mdl_kernel.backward_launches_by_path == {**before, "direct": before["direct"] + 1}
    want = mdl_kernel.mdl_backward_plain(x, p, g)
    err = (got.float() - want.float()).abs()
    assert (err <= 2e-5 + _BWD_RTOL[dtype] * want.float().abs()).all()
    if layout != "sliced":  # a slice's gradient buffer is dense: only the parameters misfit
        assert got.stride() == p.stride()
    with pytest.raises(RuntimeError, match="tiled path"):
        mdl_kernel.mdl_backward(x, p, g, path="tiled")
    assert mdl_kernel.backward_launches_by_path == {**before, "direct": before["direct"] + 1}
    # the null twin has the same dispatch: staged is the direct path here
    before = dict(mdl_null.backward_launches_by_path)
    null = mdl_null.mdl_null_backward(x, p, g, "staged")
    assert mdl_null.backward_launches_by_path == {**before, "direct": before["direct"] + 1}
    assert torch.equal(null, mdl_null.mdl_null_backward_plain(x, p, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_layout_gradient_goes_through_the_tile_path(cuda, dtype):
    """Through autograd on the layout the model hands on: a conv output in
    channels-last memory viewed as ``[k, B, H, W, C]``."""
    x, p = _inputs(cuda, dtype=dtype)
    head = p.reshape(6, 5, 7, 50).permute(0, 3, 1, 2)  # NCHW shape, channels-last memory
    assert head.is_contiguous(memory_format=torch.channels_last)
    leaf = head.detach().requires_grad_(True)
    view = leaf.reshape(3, 2, 50, 5, 7).permute(0, 1, 3, 4, 2)
    before = dict(mdl_kernel.backward_launches_by_path)
    mdl_kernel.mdl_log_prob(x, view).sum(dim=(-1, -2, -3)).sum().backward()
    assert mdl_kernel.backward_launches_by_path == {**before, "tiled": before["tiled"] + 1}
    want = mdl_kernel.mdl_backward_plain(x, p, torch.ones(3, 2, 5, 7, 1, device=cuda))
    got = leaf.grad.permute(0, 2, 3, 1).reshape(3, 2, 5, 7, 50)
    err = (got.float() - want.float()).abs()
    assert (err <= 2e-5 + _BWD_RTOL[dtype] * want.float().abs()).all()


# (k, B, H, W) of the forward's contracts: the train shape, the eval chunk and
# a ragged one (20,181 pixels, no multiple of the 128-pixel tile)
_FORWARD_SHAPES = [(5, 128, 32, 32), (100, 128, 32, 32), (3, 7, 31, 31)]


def _card_inputs(device, k, b, h, w, dtype, seed=0):
    """``_inputs``' distributions at the contracts' sizes, drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=device).float() / 255.0
    x[0, 0, 0] = torch.tensor([0.0, 1.0, 0.0], device=device)
    p = torch.randn((k, b, h, w, 50), generator=gen, device=device) * 3.0
    return x, p.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _FORWARD_SHAPES)
def test_forward_paths_agree_bit_for_bit(cuda, shape, dtype):
    """Channel-minor parameters take the forward's tile path; forced onto the
    direct one they give the same bits, and agree with the plain version."""
    k, b, h, w = shape
    x, p = _card_inputs(cuda, k, b, h, w, dtype)
    assert mdl_kernel.forward_path(p) == "tiled"
    before = dict(mdl_kernel.launches_by_path)
    tiled = mdl_kernel.mdl_log_prob(x, p)
    direct = mdl_kernel.mdl_log_prob(x, p, path="direct")
    torch.cuda.synchronize()
    assert mdl_kernel.launches_by_path == {"tiled": before["tiled"] + 1,
                                           "direct": before["direct"] + 1}
    assert torch.equal(tiled, direct)
    assert 1 <= mdl_kernel.tile_blocks_per_sm(dtype, 5, forward=True) <= 16
    ks = slice(0, min(k, 5))  # the plain version at the eval chunk's size is slow
    want = mixture_log_prob(x, p[ks].float())
    assert ((tiled[ks] - want).abs() <= 2e-4 + 1e-5 * want.abs()).all()
    del tiled, direct, p


@pytest.mark.parametrize("n_mix", [1, 2, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_tile_path_takes_every_mixture_count(cuda, dtype, n_mix):
    x, p = _inputs(cuda, k=5, b=127, h=31, w=33, n_mix=n_mix, dtype=dtype)
    tiled = mdl_kernel.mdl_log_prob(x, p, path="tiled")
    assert torch.equal(tiled, mdl_kernel.mdl_log_prob(x, p, path="direct"))
    want = mixture_log_prob(x, p.float())
    assert ((tiled - want).abs() <= 2e-4 + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nchw", "misaligned", "sliced"])
def test_forward_takes_the_direct_path_off_the_tile_layout(cuda, layout, dtype):
    """NCHW strides, a view one element off a 16-byte boundary and a channel
    slice take the direct path and agree with the tile path on the same
    values bit for bit; asked for the tile path they are refused, and
    nothing is launched."""
    x, dense = _inputs(cuda, dtype=dtype)
    if layout == "nchw":
        p = _nchw(dense)
    elif layout == "misaligned":
        p = _misaligned_like(dense)
    else:
        wide = torch.zeros((3, 2, 5, 7, 60), device=cuda, dtype=dtype)
        wide[..., :50] = dense
        p = wide[..., :50]
    assert mdl_kernel.forward_path(p) == "direct"
    before = dict(mdl_kernel.launches_by_path)
    got = mdl_kernel.mdl_log_prob(x, p)
    assert mdl_kernel.launches_by_path == {**before, "direct": before["direct"] + 1}
    assert torch.equal(got, mdl_kernel.mdl_log_prob(x, dense, path="tiled"))
    before = dict(mdl_kernel.launches_by_path)
    with pytest.raises(RuntimeError, match="tiled path"):
        mdl_kernel.mdl_log_prob(x, p, path="tiled")
    assert mdl_kernel.launches_by_path == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [5, 100])
def test_direct_backward_equals_the_tile_path_on_nchw(cuda, k, dtype):
    """The same values as NCHW (direct path, gradient parked through its own
    strides in f32, in registers in bf16) and channel-minor (tile path): one
    gradient, bit for bit."""
    x, p = _card_inputs(cuda, k, 128, 32, 32, dtype, seed=k)
    g = torch.randn((k, 128, 32, 32, 1), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    nchw = _nchw(p)
    assert mdl_kernel.backward_path(nchw, torch.empty_like(nchw)) == "direct"
    before = dict(mdl_kernel.backward_launches_by_path)
    tiled = mdl_kernel.mdl_backward(x, p, g)
    direct = mdl_kernel.mdl_backward(x, nchw, g)
    torch.cuda.synchronize()
    assert mdl_kernel.backward_launches_by_path == {"tiled": before["tiled"] + 1,
                                                    "direct": before["direct"] + 1}
    assert direct.stride() == nchw.stride()
    assert torch.equal(tiled, direct)


@pytest.mark.parametrize("n_mix", [1, 5, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _TILE_SHAPES)
def test_null_backward_on_the_tile_path_is_exact(cuda, shape, dtype, n_mix):
    k, b, h, w = shape
    x, p = _inputs(cuda, k=k, b=b, h=h, w=w, n_mix=n_mix, dtype=dtype)
    g = _cotangent(cuda, (k, b, 1, 1, 1), n_mix).expand(k, b, h, w, 1)
    before = dict(mdl_null.backward_launches_by_path)
    staged = mdl_null.mdl_null_backward(x, p, g, "staged")
    dma = mdl_null.mdl_null_backward(x, p, g, "dma")
    torch.cuda.synchronize()
    assert mdl_null.backward_launches_by_path == {"tiled": before["tiled"] + 1,
                                                  "direct": before["direct"] + 1}
    want = mdl_null.mdl_null_backward_plain(x, p, g)
    assert torch.equal(staged, want) and torch.equal(dma, want)
    assert 1 <= mdl_null.tile_blocks_per_sm(dtype, n_mix) <= 16


# -- the discretized-logistic kernels ------------------------------------------------

_BINS = [(0.0, 1.0, 1.0 / 255.0), (-1.0, 1.0, 2.0 / 255.0)]


def _dl_inputs(device, layout, low, high, k=3, b=2, h=5, w=7):
    """x on the 256 levels with both edges in it; loc and logscale hitting
    every branch, as contiguous tensors, as channel slices of an NCHW head,
    or broadcasting (a per-channel logscale, x over k)."""
    rng = np.random.default_rng(h * w)
    x = (low + (high - low) * rng.integers(0, 256, (b, h, w, 3)) / 255.0).astype(np.float32)
    x.reshape(-1)[:2] = (low, high)
    head = rng.standard_normal((k * b, 6, h, w)).astype(np.float32)
    head[:, :3] = 0.5 * (low + high) + 0.3 * (high - low) * head[:, :3]
    head[:, :3] += 2.0 * (high - low) * (rng.random((k * b, 3, h, w)) < 0.2)
    head[:, 3:] = head[:, 3:] * 1.5 - 3.0
    head[:, 3:][rng.random((k * b, 3, h, w)) < 0.1] = -9.0
    head = torch.from_numpy(head).to(device)
    loc, logscale = head.reshape(k, b, 6, h, w).permute(0, 1, 3, 4, 2).chunk(2, dim=-1)
    if layout == "contiguous":
        loc, logscale = loc.contiguous(), logscale.contiguous()
    elif layout == "broadcast":
        loc, logscale = loc.contiguous(), logscale[0, 0, 0, 0].contiguous()
    return torch.from_numpy(x).to(device), loc, logscale


@pytest.mark.parametrize("low,high,width", _BINS)
@pytest.mark.parametrize("layout", ["contiguous", "nchw_slices", "broadcast"])
def test_dl_kernel_matches_plain_version(cuda, layout, low, high, width):
    x, loc, logscale = _dl_inputs(cuda, layout, low, high)
    before = dl_kernel.launches
    got = dl_kernel.dl_log_prob(x, loc, logscale, low, high, width)
    assert dl_kernel.launches == before + 1
    want = discretized_logistic_log_prob(x, loc, logscale, low=low, high=high,
                                         interval_width=width)
    assert got.shape == want.shape == (3, 2, 5, 7, 3) and got.dtype == torch.float32
    assert ((got - want).abs() <= 2e-4 + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("shape", [(1,), (257,), (3, 1, 5), (2, 3, 4, 5, 6, 7), (2, 1, 3, 1, 2, 2, 3)])
def test_dl_kernel_takes_odd_shapes_and_ranks(cuda, shape):
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32) / 255.0).to(cuda)
    loc = torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda)
    logscale = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) - 3.0).to(cuda)
    got = dl_kernel.dl_log_prob(x, loc, logscale, 0.0, 1.0, 1.0 / 255.0)
    want = discretized_logistic_log_prob(x, loc, logscale, low=0.0, high=1.0,
                                         interval_width=1.0 / 255.0)
    assert got.shape == want.shape
    assert ((got - want).abs() <= 2e-4 + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("low,high,width", _BINS)
@pytest.mark.parametrize("layout", ["contiguous", "nchw_slices", "broadcast"])
def test_dl_backward_kernel_matches_plain_version(cuda, layout, low, high, width):
    x, loc, logscale = _dl_inputs(cuda, layout, low, high)
    # the cotangent as the sum over the image's axes expands it
    g = _cotangent(cuda, (3, 2, 1, 1, 1)).expand(3, 2, 5, 7, 3)
    before = dl_kernel.backward_launches
    got = dl_kernel.dl_backward(x, loc, logscale, g, low, high, width)
    assert dl_kernel.backward_launches == before + 1
    want = dl_kernel.dl_backward_plain(x, loc, logscale, g, low, high, width)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (3, 2, 5, 7, 3)
        assert ((a - b).abs() <= 2e-5 + 2e-4 * b.abs()).all()


@pytest.mark.parametrize("layout", ["nchw_slices", "broadcast"])
def test_dl_gradients_through_autograd(cuda, layout):
    """As the model differentiates it: the halves of an NCHW head get their
    gradients in one backward launch; an operand that was broadcast gets its
    gradient summed back to its shape."""
    x, loc, logscale = _dl_inputs(cuda, layout, 0.0, 1.0)
    leaves = [loc.detach().clone().requires_grad_(True),
              logscale.detach().clone().requires_grad_(True)]
    if layout == "nchw_slices":  # keep the strides of the head's slices
        leaves = [t.detach().requires_grad_(True) for t in (loc, logscale)]
    before = dl_kernel.backward_launches
    out = dl_kernel.dl_log_prob(x, *leaves, 0.0, 1.0, 1.0 / 255.0)
    g = _cotangent(cuda, out.shape)
    got = torch.autograd.grad(out, leaves, g)
    assert dl_kernel.backward_launches == before + 1
    d_loc, d_ls = dl_kernel.dl_backward_plain(x, loc, logscale, g, 0.0, 1.0, 1.0 / 255.0)
    want = (d_loc, d_ls.sum_to_size(logscale.shape))
    for a, b, leaf in zip(got, want, leaves):
        assert a.shape == leaf.shape
        scale = float(b.abs().max())
        assert ((a - b).abs() <= 2e-5 + 2e-4 * b.abs() + 1e-6 * scale).all()


def test_dl_x_gradient_goes_through_the_plain_version(cuda):
    x, loc, logscale = _dl_inputs(cuda, "contiguous", 0.0, 1.0)
    x.requires_grad_(True)
    out = dl_kernel.dl_log_prob(x, loc, logscale, 0.0, 1.0, 1.0 / 255.0)
    g = _cotangent(cuda, out.shape)
    (dx,) = torch.autograd.grad(out, x, g)
    x_plain = x.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(discretized_logistic_log_prob(
        x_plain, loc, logscale, low=0.0, high=1.0, interval_width=1.0 / 255.0), x_plain, g)
    torch.testing.assert_close(dx, want)


@pytest.mark.parametrize("bad", ["x_dtype", "loc_dtype", "ls_device", "shape", "g_shape",
                                 "g_dtype", "too_many_dims"])
def test_dl_kernels_refuse_what_they_do_not_take(cuda, bad):
    x, loc, logscale = _dl_inputs(cuda, "contiguous", 0.0, 1.0)
    g = torch.ones_like(loc)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "loc_dtype":
        loc = loc.bfloat16()
    elif bad == "ls_device":
        logscale = logscale.cpu()
    elif bad == "shape":
        x = x[:, :4]
    elif bad == "g_shape":
        g = g[0]
    elif bad == "g_dtype":
        g = g.double()
    else:
        # seven dimensions, none of which merges with its neighbour
        loc = torch.rand((3,) * 7, device=cuda)[(slice(0, 2),) * 7]
        x = logscale = torch.zeros((), device=cuda)
    before = dl_kernel.launches, dl_kernel.backward_launches
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        if bad.startswith("g_"):
            dl_kernel.dl_backward(x, loc, logscale, g, 0.0, 1.0, 1.0 / 255.0)
        else:
            dl_kernel.dl_log_prob(x, loc, logscale, 0.0, 1.0, 1.0 / 255.0)
    assert (dl_kernel.launches, dl_kernel.backward_launches) == before


# the discretized-logistic kernels' two memory paths: (k, B, H, W) of the
# train shape, the eval chunk, a ragged one (20,181 pixels, no multiple of a
# tile), 384 pixels (three whole tiles of the backward's 128, a whole and
# a ragged one of the forward's 256), and biladder_celeba's train shape and
# eval chunk
_DL_TILE_SHAPES = [(5, 128, 32, 32), (100, 128, 32, 32), (3, 7, 31, 31), (1, 3, 8, 16),
                   (5, 128, 64, 64), (100, 32, 64, 64)]
_DL_BIN = (0.0, 1.0, 1.0 / 255.0)


def _dl_head(device, k, b, h, w, seed=0):
    """x on the 256 levels with both edges in it, and a head conv's output
    ``[k * b, 6, h, w]`` in channels-last memory, viewed as ``[k, b, h, w, 6]``
    as the decoder hands it on, whose halves hit every branch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=device).float() / 255.0
    x[:, 0] = 0.0
    x[:, -1] = 1.0
    half = (k * b, 3, h, w)
    far = (torch.rand(half, generator=gen, device=device) < 0.2).float()
    loc = torch.randn(half, generator=gen, device=device) * 0.25 + 0.5 + 2.0 * far
    logscale = torch.randn(half, generator=gen, device=device) - 3.0
    logscale[torch.rand(half, generator=gen, device=device) < 0.1] = -9.0
    conv = torch.cat([loc, logscale], dim=1).contiguous(memory_format=torch.channels_last)
    return x, conv.reshape(k, b, 6, h, w).permute(0, 1, 3, 4, 2)


def _dl_close(got, want, rtol):
    return bool(((got - want).abs() <= 2e-5 + rtol * want.abs()).all())


@pytest.mark.parametrize("shape", _DL_TILE_SHAPES)
def test_dl_paths_agree_bit_for_bit(cuda, shape):
    """The halves of a channels-last head take the tile path in both
    directions; forced onto the direct path they give the same bits, and
    both agree with the plain version. The backward's tile path hands loc's
    and logscale's gradients as the halves of one head gradient."""
    k, b, h, w = shape
    x, head = _dl_head(cuda, k, b, h, w)
    loc, logscale = torch.chunk(head, 2, dim=-1)
    g = _cotangent(cuda, (k, b, 1, 1, 1)).expand(loc.shape)
    assert dl_kernel.forward_path(x, loc, logscale) == "tiled"
    assert dl_kernel.backward_path(x, loc, logscale, g) == "tiled"
    before = dict(dl_kernel.launches_by_path), dict(dl_kernel.backward_launches_by_path)
    tiled = dl_kernel.dl_log_prob(x, loc, logscale, *_DL_BIN)
    direct = dl_kernel.dl_log_prob(x, loc, logscale, *_DL_BIN, path="direct")
    d_tiled = dl_kernel.dl_backward(x, loc, logscale, g, *_DL_BIN)
    d_direct = dl_kernel.dl_backward(x, loc, logscale, g, *_DL_BIN, path="direct")
    torch.cuda.synchronize()
    for counts, was in zip((dl_kernel.launches_by_path, dl_kernel.backward_launches_by_path),
                           before):
        assert counts == {"tiled": was["tiled"] + 1, "direct": was["direct"] + 1}
    assert tiled.is_contiguous() and torch.equal(tiled, direct)
    for a, c in zip(d_tiled, d_direct):
        assert torch.equal(a, c)
    assert d_tiled[1].data_ptr() == d_tiled[0].data_ptr() + 3 * 4  # one [.., 6] gradient
    assert 1 <= dl_kernel.tile_blocks_per_sm() <= 16
    assert 1 <= dl_kernel.tile_blocks_per_sm(backward=True) <= 16
    ks = slice(0, min(k, 5))  # the plain version at the eval chunk's size is slow
    want = discretized_logistic_log_prob(x, loc[ks], logscale[ks], low=0.0, high=1.0,
                                         interval_width=1.0 / 255.0)
    assert _dl_close(tiled[ks], want, 1e-5)
    for a, c in zip(d_tiled, dl_kernel.dl_backward_plain(x, loc[ks], logscale[ks], g[ks],
                                                         *_DL_BIN)):
        assert _dl_close(a[ks], c, 2e-4)


@pytest.mark.parametrize("layout", ["misaligned", "nchw", "sliced", "x_not_broadcast"])
def test_dl_tile_path_refuses_operands_that_do_not_fit(cuda, layout):
    """A misaligned copy of the head, NCHW halves, six of eight channels and
    an x that is not broadcast over K take the direct path and agree with
    the plain version; asked for the tile path they are refused, forward and
    backward, and nothing is launched."""
    x, head = _dl_head(cuda, 3, 2, 5, 7)
    if layout == "misaligned":
        head = _misaligned_like(head.contiguous())
    elif layout == "nchw":
        head = head.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    elif layout == "sliced":
        wide = torch.zeros((3, 2, 5, 7, 8), device=cuda)
        wide[..., :6] = head
        head = wide[..., :6]
    else:
        x = x.expand(3, *x.shape).contiguous()
    loc, logscale = torch.chunk(head, 2, dim=-1)
    g = _cotangent(cuda, loc.shape)
    assert dl_kernel.forward_path(x, loc, logscale) == "direct"
    assert dl_kernel.backward_path(x, loc, logscale, g) == "direct"
    before = dict(dl_kernel.launches_by_path), dict(dl_kernel.backward_launches_by_path)
    got = dl_kernel.dl_log_prob(x, loc, logscale, *_DL_BIN)
    d_got = dl_kernel.dl_backward(x, loc, logscale, g, *_DL_BIN)
    after = ({**before[0], "direct": before[0]["direct"] + 1},
             {**before[1], "direct": before[1]["direct"] + 1})
    assert (dl_kernel.launches_by_path, dl_kernel.backward_launches_by_path) == after
    want = discretized_logistic_log_prob(x, loc, logscale, low=0.0, high=1.0,
                                         interval_width=1.0 / 255.0)
    assert _dl_close(got, want, 1e-5)
    for a, c in zip(d_got, dl_kernel.dl_backward_plain(x, loc, logscale, g, *_DL_BIN)):
        assert _dl_close(a, c, 2e-4)
    with pytest.raises(RuntimeError, match="tiled path"):
        dl_kernel.dl_log_prob(x, loc, logscale, *_DL_BIN, path="tiled")
    with pytest.raises(RuntimeError, match="tiled path"):
        dl_kernel.dl_backward(x, loc, logscale, g, *_DL_BIN, path="tiled")
    with pytest.raises(RuntimeError, match="tiled path"):
        dl_kernel.dl_log_prob_head(x, head, *_DL_BIN, path="tiled")
    assert (dl_kernel.launches_by_path, dl_kernel.backward_launches_by_path) == after


@pytest.mark.parametrize("shape", [(5, 128, 32, 32), (3, 7, 31, 31)])
def test_dl_head_gradient_through_autograd_is_the_direct_paths_joined_halves(cuda, shape):
    """As the model differentiates it: the head conv's output is the leaf,
    ``dl_log_prob_head`` takes its ``[k, B, H, W, 6]`` view. On the tile path
    autograd's gradient is the backward kernel's output, with no ``cat``
    after it; it equals, bit for bit, the direct path's (loc's and
    logscale's gradients joined) and the joined halves of ``dl_backward``."""
    k, b, h, w = shape
    x, head = _dl_head(cuda, k, b, h, w)
    conv = head.permute(0, 1, 4, 2, 3).reshape(k * b, 6, h, w)
    weights = _cotangent(cuda, (k, b), 1)

    def grad_of(path):
        leaf = conv.detach().requires_grad_(True)
        view = leaf.reshape(k, b, 6, h, w).permute(0, 1, 3, 4, 2)
        out = dl_kernel.dl_log_prob_head(x, view, *_DL_BIN, path=path)
        (out.sum(dim=(-1, -2, -3)) * weights).sum().backward()
        return leaf.grad.reshape(k, b, 6, h, w).permute(0, 1, 3, 4, 2)

    before = dict(dl_kernel.launches_by_path), dict(dl_kernel.backward_launches_by_path)
    tiled = grad_of(None)
    assert dl_kernel.launches_by_path == {**before[0], "tiled": before[0]["tiled"] + 1}
    assert dl_kernel.backward_launches_by_path == {**before[1],
                                                   "tiled": before[1]["tiled"] + 1}
    direct = grad_of("direct")
    assert torch.equal(tiled, direct)
    loc, logscale = torch.chunk(head, 2, dim=-1)
    g = weights[:, :, None, None, None].expand(loc.shape)
    joined = torch.cat(dl_kernel.dl_backward(x, loc, logscale, g, *_DL_BIN, path="direct"), -1)
    assert torch.equal(tiled, joined)


def test_model03_takes_the_dl_tile_path_in_both_directions(cuda):
    """model03's head hands the likelihood the halves of a channels-last
    head: a forward and backward launch the DL kernels on the tile path
    alone, and the observation carries its head."""
    model = build_model(MODELS["model03"], torch.Generator().manual_seed(0))
    x = torch.randint(0, 256, (4, 32, 32, 3), device=cuda).float() / 255.0
    for counts in (dl_kernel.launches_by_path, dl_kernel.backward_launches_by_path):
        counts.update(dict.fromkeys(dl_kernel.PATHS, 0))
    pxz = model(x, 2, generator=torch.Generator(cuda).manual_seed(0))[2].dist
    assert pxz.head is not None and pxz._halves_of_head()
    pxz.reduced_log_prob(x).sum().backward()
    assert dl_kernel.launches_by_path == {"tiled": 1, "direct": 0}
    assert dl_kernel.backward_launches_by_path == {"tiled": 1, "direct": 0}


@pytest.mark.parametrize("compute_dtype,grad_rtol", [("bfloat16", 8e-3), ("float32", 2e-4)])
def test_biladder_celeba_train_step_through_the_kernels_matches_the_plain_version(
        cuda, compute_dtype, grad_rtol):
    """One biladder_celeba loss and gradient (64 x 64, k = 5, 16 images,
    every rezero gate opened to a seeded value so that every leaf has a
    gradient) through the DL kernels, both on the tile path, against the
    same through the plain version: the loss within rtol 1e-5, each gradient
    leaf in norm within chip_smoke.py's tolerance, 2e-4 with a float32 body
    and 8e-3 (two bf16 ulps, ``GRAD_RTOL_BF16``) with the config's bf16 one,
    where the head's float32 gradients round to bf16 on their way into the
    body's backward (measured 1.1e-3 on stem.weight)."""
    base = dataclasses.replace(MODELS["biladder_celeba"], compute_dtype=compute_dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(0, 256, (16, 64, 64, 3), generator=gen, device=cuda).float() / 255.0
    eps = [torch.randn((5, 16) + shape, generator=gen, device=cuda)
           for shape in latent_shapes(base)]
    # the same conv algorithms in both runs, and float32 convolutions in a
    # float32 body (cuDNN's default is TF32)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    results = {}
    try:
        for use in (None, False):
            cfg = experiment("biladder_celeba", model=dataclasses.replace(base, use_pallas=use))
            model = build_model(cfg.model, torch.Generator().manual_seed(0))
            gates = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith(".gate"):
                        p.fill_(0.5 + float(torch.rand((), generator=gates)))
            for counts in (dl_kernel.launches_by_path, dl_kernel.backward_launches_by_path):
                counts.update(dict.fromkeys(dl_kernel.PATHS, 0))
            params = dict(model.named_parameters())
            loss, _ = training_loss_fn(model, cfg, prior_for(cfg.model, cuda), x, 5,
                                       eps=eps)(params)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            results[use] = (float(loss.detach()), grads, dict(dl_kernel.launches_by_path),
                            dict(dl_kernel.backward_launches_by_path))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = flags
    (loss_k, grads_k, fwd_k, bwd_k), (loss_p, grads_p, fwd_p, bwd_p) = results[None], results[False]
    assert fwd_k == bwd_k == {"tiled": 1, "direct": 0}
    assert fwd_p == bwd_p == {"tiled": 0, "direct": 0}
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for name, want in grads_p.items():
        assert want.norm() > 0, name
        assert (grads_k[name] - want).norm() <= grad_rtol * want.norm(), name


def test_build_model_lands_on_the_card_by_default(cuda):
    model = build_model(MODELS["model03"], torch.Generator().manual_seed(0))
    assert all(p.is_cuda for p in model.parameters())
    on_cpu = build_model(MODELS["model03"], torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(model.parameters(), on_cpu.parameters()):
        assert torch.equal(a.cpu(), b)  # one seed, the same weights on both


# -- the probe kernels -----------------------------------------------------------------


@pytest.mark.parametrize("chains", sfu_probe.CHAINS)
@pytest.mark.parametrize("op", ["none", "exp", "log", "tanh", "sigmoid", "softplus", "cascade"])
def test_probe_kernel_matches_plain_version(cuda, op, chains):
    x = sfu_probe.probe_input(3, chains, cuda)
    for iters, (scale, shift) in ((0, (1.0, 0.0)), (2, (1.0, 0.0)), (3, sfu_probe.RERANGE[op])):
        before = sfu_probe.launches
        got = sfu_probe.loop_probe(x, op, iters, chains, scale, shift)
        assert sfu_probe.launches == before + 1
        want = sfu_probe.loop_probe_plain(x, op, iters, scale, shift)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("bad", ["dtype", "size", "chains", "op", "strides", "iters"])
def test_probe_kernel_refuses_what_it_does_not_take(cuda, bad):
    x = sfu_probe.probe_input(2, 4, cuda)
    op, chains, iters = "exp", 4, 2
    if bad == "dtype":
        x = x.double()
    elif bad == "size":
        x = x[:-1]
    elif bad == "chains":
        chains = 3
    elif bad == "op":
        op = "cosh"
    elif bad == "strides":
        x = x.repeat(2)[::2]
    else:
        iters = -1
    before = sfu_probe.launches
    with pytest.raises((TypeError, ValueError)):
        sfu_probe.loop_probe(x, op, iters, chains)
    assert sfu_probe.launches == before


def test_measure_rates_on_the_card(cuda):
    raw = sfu_probe.measure_raw_rates(("exp", "sigmoid"), blocks=264, repeats=2)
    rates = sfu_probe.subtract_identity(raw)
    assert set(rates) == {"exp", "sigmoid"}
    assert all(r > 0 for r in raw.values()) and rates["exp"] > raw["exp"]
    assert rates["exp"] > rates["sigmoid"]  # one special-function result against two


@pytest.mark.parametrize("shape", [(3, 1000, 50), (1, 255, 7), (2, 513, 100)])
@pytest.mark.parametrize("layout,path", [
    ("channel_minor", "direct"), ("channel_minor", "staged"), ("channel_first", "direct")])
def test_channel_sum_matches_plain_version(cuda, shape, layout, path):
    rng = np.random.default_rng(shape[1])
    params = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    if layout == "channel_first":
        params = params.transpose(1, 2).contiguous()
    before = io_probe.launches
    got = io_probe.channel_sum(params, layout, path)
    assert io_probe.launches == before + 1
    want = io_probe.channel_sum_plain(params, layout)
    assert got.shape == want.shape == shape[:2] and got.is_contiguous()
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.parametrize("shape", [(3, 1000, 50), (1, 255, 7), (2, 513, 100)])
def test_channel_sum_staged_is_the_strided_kernels_bits(cuda, shape):
    """The read walk adds each pixel's channels in the strided kernel's
    order, at ragged pixel counts (255, 513 and 3000 pixels against tiles of
    ``io_probe.SUM_TILE``) and 7 to 100 channels."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    params = torch.randn(shape, generator=gen, device=cuda)
    before = dict(io_probe.launches_by_kernel)
    staged = io_probe.channel_sum(params, path="staged")
    strided = io_probe.channel_sum(params, kernel="strided")
    assert io_probe.launches_by_kernel == {**before, "tiled": before["tiled"] + 1,
                                           "strided": before["strided"] + 1}
    assert torch.equal(staged, strided)
    assert (staged - params.sum(-1)).abs().max() <= 1e-4
    assert 1 <= io_probe.tile_blocks_per_sm(shape[2]) <= 16


def test_channel_sum_staged_refuses_a_sliced_or_misaligned_view(cuda):
    """Refused in Python before any launch, and by the C entry point itself."""
    whole = torch.randn((3, 1000, 60), device=cuda)
    flat = torch.empty(3 * 1000 * 50 + 16, device=cuda)
    lead = (-flat.data_ptr() % 16) // 4 + 1
    misaligned = flat[lead:lead + 3 * 1000 * 50].view(3, 1000, 50)
    out = torch.empty((3, 1000), device=cuda)
    for view in (whole[..., :50], misaligned):
        before = io_probe.launches
        with pytest.raises(ValueError, match="staged path takes"):
            io_probe.channel_sum(view, path="staged")
        assert io_probe.launches == before
        err = io_probe.library().channel_sum(  # kernel 1, the read walk
            view.data_ptr(), out.data_ptr(), 1, 3, 1000, 50, *view.stride(),
            torch.cuda.current_stream().cuda_stream)
        assert err == 1  # cudaErrorInvalidValue


def test_channel_sum_staged_and_its_entry_point_agree_on_the_widest_row(cuda):
    """Python and the C entry point refuse the same rows: the widest that
    fits the walk's tile in shared memory runs and gives the strided bits,
    one of 300 channels is refused by both."""
    widest = io_probe.SUM_MAX_CHANNELS
    params = torch.randn((2, 513, widest), device=cuda)
    assert torch.equal(io_probe.channel_sum(params, path="staged"),
                       io_probe.channel_sum(params, kernel="strided"))
    wide = torch.randn((2, 513, 300), device=cuda)
    out = torch.empty((2, 513), device=cuda)
    before = io_probe.launches
    with pytest.raises(ValueError, match="staged path takes"):
        io_probe.channel_sum(wide, path="staged")
    assert io_probe.launches == before
    for t in (torch.randn((2, 513, widest + 1), device=cuda), wide):
        err = io_probe.library().channel_sum(  # kernel 1, the read walk
            t.data_ptr(), out.data_ptr(), 1, *t.shape, *t.stride(),
            torch.cuda.current_stream().cuda_stream)
        assert err == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("shape", [(3, 50, 1024), (100, 50, 102400), (2, 7, 4096)])
def test_channel_first_sum_takes_the_vec4_kernel(cuda, shape):
    """A channel-first tensor with contiguous pixels in rows of a multiple of
    512 takes the vec4 kernel and gives the strided kernel's bits; off its
    layout it is refused."""
    k, c, p = shape
    gen = torch.Generator(device=cuda).manual_seed(p)
    params = torch.randn(shape, generator=gen, device=cuda)
    assert io_probe.direct_kernel(params, "channel_first") == "vec4"
    before = dict(io_probe.launches_by_kernel)
    got = io_probe.channel_sum(params, "channel_first")
    strided = io_probe.channel_sum(params, "channel_first", kernel="strided")
    assert io_probe.launches_by_kernel == {**before, "vec4": before["vec4"] + 1,
                                           "strided": before["strided"] + 1}
    assert torch.equal(got, strided)
    assert (got - io_probe.channel_sum_plain(params, "channel_first")).abs().max() <= 1e-4
    del params
    odd = torch.randn((k, c, p + 2), generator=gen, device=cuda)
    for view in (odd[..., :p - 1], odd[..., 1:p + 1], odd[..., :p + 2]):
        assert io_probe.direct_kernel(view, "channel_first") == "strided"
        got = io_probe.channel_sum(view, "channel_first")
        assert (got - io_probe.channel_sum_plain(view, "channel_first")).abs().max() <= 1e-4
        with pytest.raises(RuntimeError, match="vec4"):
            io_probe.channel_sum(view, "channel_first", kernel="vec4")


def test_channel_sum_direct_reads_through_any_strides(cuda):
    rng = np.random.default_rng(0)
    whole = torch.from_numpy(rng.standard_normal((3, 40, 60)).astype(np.float32)).to(cuda)
    view = whole[:, ::2, 5:55]  # strided pixels, offset channels
    got = io_probe.channel_sum(view, "channel_minor")
    assert (got - view.sum(-1)).abs().max() <= 1e-4
    with pytest.raises(ValueError, match="staged"):
        io_probe.channel_sum(view, "channel_minor", "staged")


@pytest.mark.parametrize("n_mix", [1, 5, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("variant", mdl_null.VARIANTS)
def test_null_kernels_match_plain_versions(cuda, variant, nchw, dtype, n_mix):
    """At a pixel count that is no multiple of the block (3 * 2 * 5 * 7 = 210
    and, with k = 11, 770): the ragged tile of the staged path."""
    for k in (3, 11):
        x, p = _inputs(cuda, k=k, n_mix=n_mix, dtype=dtype)
        if nchw:
            p = _nchw(p)
        g = _cotangent(cuda, (k, 2, 1, 1, 1), n_mix).expand(k, 2, 5, 7, 1)
        before = mdl_null.launches, mdl_null.backward_launches
        fwd = mdl_null.mdl_null_forward(x, p, variant)
        bwd = mdl_null.mdl_null_backward(x, p, g, variant)
        assert (mdl_null.launches, mdl_null.backward_launches) == (before[0] + 1, before[1] + 1)
        want = mdl_null.mdl_null_forward_plain(x, p)
        assert fwd.shape == want.shape == (k, 2, 5, 7, 1) and fwd.dtype == torch.float32
        assert (fwd - want).abs().max() <= 1e-4
        assert bwd.dtype == dtype and bwd.stride() == p.stride()
        assert torch.equal(bwd, mdl_null.mdl_null_backward_plain(x, p, g))


@pytest.mark.parametrize("n_mix", [1, 5, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchw", [False, True])
def test_null_forward_staged_is_the_dma_variants_bits(cuda, nchw, dtype, n_mix):
    """The staged null forward takes the path ``mdl_kernel.forward_path``
    names (the read walk on NHWC, direct on NCHW), counted by path, and adds
    each pixel's channels in the direct kernel's order: at k = 3 (210
    pixels) and the ragged k = 11 (770) equal to ``dma`` bit for bit."""
    for k in (3, 11):
        x, p = _inputs(cuda, k=k, n_mix=n_mix, dtype=dtype)
        if nchw:
            p = _nchw(p)
        path = mdl_kernel.forward_path(p)
        assert path == ("direct" if nchw else "tiled") == mdl_null.forward_path(p, "staged")
        before = dict(mdl_null.launches_by_path)
        staged = mdl_null.mdl_null_forward(x, p, "staged")
        dma = mdl_null.mdl_null_forward(x, p, "dma")
        want = dict(before)
        want[path] += 1
        want["direct"] += 1
        assert mdl_null.launches_by_path == want
        assert torch.equal(staged, dma)
        assert (staged - mdl_null.mdl_null_forward_plain(x, p)).abs().max() <= 1e-4
    assert 1 <= mdl_null.tile_blocks_per_sm(dtype, n_mix, forward=True) <= 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_null_forward_tile_path_refuses_a_misaligned_view(cuda, dtype):
    x, p = _inputs(cuda, dtype=dtype)
    flat = torch.empty(p.numel() + 16, device=cuda, dtype=dtype)
    lead = (-flat.data_ptr() % 16) // flat.element_size() + 1
    view = flat[lead:lead + p.numel()].view(p.shape)
    view.copy_(p)
    assert mdl_null.forward_path(view, "staged") == "direct"
    assert torch.equal(mdl_null.mdl_null_forward(x, view, "staged"),
                       mdl_null.mdl_null_forward(x, p, "staged"))
    out = torch.empty(p.shape[:4], device=cuda)
    err = io_probe.library().mdl_null_forward(  # asked for the tile path
        x.data_ptr(), view.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16), 5, 1,
        *p.shape[:4], *x.stride(), *view.stride(), torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("variant", mdl_null.VARIANTS)
def test_null_gradient_through_autograd(cuda, variant):
    x, p = _inputs(cuda)
    p = _nchw(p).requires_grad_(True)
    x.requires_grad_(True)
    out = mdl_null.mdl_null_log_prob(x, p, variant)
    out.sum(dim=(-1, -2, -3)).sum().backward()
    assert p.grad.stride() == p.stride()
    assert torch.equal(p.grad, 0.5 * p.detach() + 1.0)
    assert x.grad is not None and not x.grad.any()


@pytest.mark.parametrize("bad", ["variant", "p_dtype", "g_shape", "x_rank"])
def test_null_kernels_refuse_what_they_do_not_take(cuda, bad):
    x, p = _inputs(cuda)
    g = _cotangent(cuda, (3, 2, 5, 7, 1))
    variant = "dma"
    if bad == "variant":
        variant = "transpose"
    elif bad == "p_dtype":
        p = p.half()
    elif bad == "g_shape":
        g = g[..., 0]
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        mdl_null.mdl_null_backward(x, p, g, variant)


def test_evaluate_llh_binarizes_a_bernoulli_model_once_a_batch(cuda):
    """model01 on the card: ``evaluate_llh`` equals the evaluator with the
    binarisation off fed the batch binarised by the same draw, and the draw
    moves the result off that of the grey images."""
    model = build_model(MODELS["model01"], torch.Generator().manual_seed(0)).eval()
    ecfg = experiment("model01")
    images = np.random.default_rng(0).integers(0, 256, (8, 28, 28, 1)).astype(np.uint8)
    _, per_image, _ = evaluate_llh(model, ecfg, images, n_samples=200, k_chunk=100,
                                   batch_size=8, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(_batch_seed(3, 0))
    x = torch.as_tensor(images, device=cuda).float() / 255.0
    binary = binarize(gen, x)
    off = dataclasses.replace(ecfg, data=dataclasses.replace(ecfg.data,
                                                           dynamic_binarization=False))
    want = make_batch_evaluator(model, off, 200, 100)(binary, gen).cpu().numpy()
    np.testing.assert_array_equal(per_image, want)
    grey = make_batch_evaluator(model, off, 200, 100)(
        x, torch.Generator(device=cuda).manual_seed(_batch_seed(3, 0))).cpu().numpy()
    assert np.isfinite(per_image).all() and not np.allclose(per_image, grey)


def test_timing_harness_lands_on_the_card_by_default(cuda):
    step, state, batch, cfg, flops = setup_scanned_step("model01", spc=2)
    assert batch.is_cuda and all(p.is_cuda for p in state.params.values())
    state, metrics = step(state, batch)
    assert state.step == 2 and np.isfinite(float(metrics["loss"])) and flops > 0
