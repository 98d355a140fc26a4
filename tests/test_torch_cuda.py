"""The MoDL and discretized-logistic CUDA kernels on the card: forward and
backward against their plain versions, their input checks, their launch
counts, the two memory paths of each MoDL kernel against each other bit for
bit, and the gradient's layout; the probe kernel, the channel sum and the
null-body MoDL kernels against theirs; the default device of ``build_model``
and the timing harness; the evaluator's Bernoulli binarisation; one
biladder_celeba loss and gradient through the DL kernels against the plain
version; and the training run's card pieces: ``device_prefetch`` against
synchronous copies (each tensor's use recorded on the consumer's stream), a
checkpoint of CUDA state restored onto the card and the CPU, and the
streamed top log-weights on the card against the CPU's; the mesh steps
captured over NCCL at a world of one against their eager bodies; the
evaluator's batch captured against its eager loop bit for bit (a second
``evaluate_llh``, ``params=`` after train steps); model05 with ``head_pad``
through the kernels' direct path against the plain version; the
polyphase transposed conv against ``F.conv_transpose2d``; the phase
route's epilogue kernel against its plain version, the route against
``F.conv_transpose2d``, model05's captured evaluation through it and its
train steps off it; and the residual block's epilogue kernels against their
plain versions at the ladders' shapes, bit for bit run to run, a routed
block against its plain body and their launches in a captured
biladder_celeba step.
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
import os

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


def test_device_prefetch_on_the_card_equals_synchronous_copies(cuda, monkeypatch):
    """Each batch staged on the producer's stream is bit-equal to a plain
    synchronous copy, and was handed on after the consumer's stream was made
    to wait on its copy and recorded on the tensor."""
    from vae_mdl_tpu_torch.data import pipeline

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (128, 32, 32, 3), dtype=np.uint8) for _ in range(12)]
    recorded = []
    real = torch.Tensor.record_stream

    def spy(tensor, stream):
        recorded.append((tensor.data_ptr(), stream))
        return real(tensor, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", spy)
    stream = pipeline.device_prefetch(iter(batches), size=2)
    got = []
    for batch in stream:
        # a kernel on the consumer's stream reads the batch at once
        got.append(batch.float().sum(dtype=torch.float64))
        assert batch.device.type == "cuda"
        assert recorded[-1] == (batch.data_ptr(), torch.cuda.current_stream())
    want = [torch.as_tensor(b).to("cuda").float().sum(dtype=torch.float64) for b in batches]
    assert len(got) == len(want) == len(recorded) == 12
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = list(pipeline.device_prefetch(iter(batches), size=2))
    for a, b in zip(again, batches):
        assert torch.equal(a.cpu(), torch.as_tensor(b))


def test_a_cuda_checkpoint_restores_with_map_location(cuda, tmp_path):
    """A state saved from the card restores onto the card and onto the CPU,
    each tensor landing on its target's device with the same values."""
    from vae_mdl_tpu_torch.train.checkpoint import Checkpointer
    from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer, tree_map
    from vae_mdl_tpu_torch.train.steps import make_train_step

    cfg = experiment("model01")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=0.9))
    model = build_model(cfg.model, torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    batch = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (8, 28, 28, 1),
                                                              dtype=np.uint8), device="cuda")
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt = Checkpointer(str(tmp_path), "model01")
    ckpt.save(state, "latest")
    for device in ("cuda", "cpu"):
        target_model = build_model(cfg.model, torch.Generator().manual_seed(1), device=device)
        target = create_train_state(target_model, cfg.train)
        ckpt.restore(target, "latest")
        assert target.step == 2
        for tree, want in ((target.params, state.params), (target.opt_state, state.opt_state),
                           (target.ema_params, state.ema_params)):
            tree_map(lambda a, b: (a.device.type == device
                                   and torch.equal(a.cpu(), b.cpu())) or pytest.fail(
                                       "restored tensor differs or lies elsewhere"), tree, want)
        for name, p in target_model.named_parameters():
            assert p is target.params[name] and p.device.type == device


def test_top_lw_update_on_the_card_equals_the_cpu(cuda):
    from vae_mdl_tpu_torch.evaluation import psis

    rng = np.random.default_rng(3)
    chunks = np.round(rng.standard_normal((50, 100, 64)).astype(np.float32) * 4) / 4
    chunks[rng.random(chunks.shape) < 0.05] = -np.inf
    m = psis.tail_size(5000) + 1
    cpu = psis.top_lw_init((64,), m)
    gpu = psis.top_lw_init((64,), m, device="cuda")
    for chunk in chunks:
        cpu = psis.top_lw_update(cpu, torch.from_numpy(chunk))
        gpu = psis.top_lw_update(gpu, torch.from_numpy(chunk).cuda())
    assert gpu.shape == (m, 64)
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.parametrize("what", ["sampler", "reconstructor", "encoder"])
def test_exported_programs_on_the_card_equal_live(cuda, monkeypatch, what):
    """model05's exported sampler, reconstructor and encoder, loaded onto the
    card (``load_exported``'s default), against the live functions on the
    same draws: uint8 images equal, floats within 1e-6; no likelihood
    kernel launches. A traced call keeps ``F.conv_transpose2d``
    (``takes_phase_route`` says no under ``torch.export``), so the program
    holds ``aten`` operations only and is held to the live function with
    the phase route off; the live decoder takes the route (3 epilogue
    launches, none in the export)."""
    from vae_mdl_tpu_torch.models import export as mexport
    from vae_mdl_tpu_torch.models import inference
    from vae_mdl_tpu_torch.nn import encoders
    from vae_mdl_tpu_torch.probes.kernel_structure import launch_counts, reset_counts

    cfg = MODELS["model05"]
    model = build_model(cfg, torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    x = torch.rand((8,) + cfg.image_shape, generator=torch.Generator().manual_seed(1)).cuda()
    reset_counts()
    if what == "sampler":
        blob = mexport.export_sampler(model, cfg, params, n=8)
        call = lambda: inference.make_sampler(model, cfg)(  # noqa: E731
            params, torch.Generator(device="cuda").manual_seed(3), 8)
    else:
        export = (mexport.export_reconstructor if what == "reconstructor"
                  else mexport.export_encoder)
        make = (inference.make_reconstructor(model, cfg) if what == "reconstructor"
                else inference.make_encoder_fn(model))
        blob = export(model, cfg, params, tuple(x.shape))
        call = lambda: make(params, torch.Generator(device="cuda").manual_seed(3), x)  # noqa: E731
    assert not any(launch_counts().values())
    with monkeypatch.context() as m:
        m.setattr(encoders, "takes_phase_route", lambda *args: False)
        live = call()
    assert not any(launch_counts().values())
    call()  # the live decoder on the phase route
    if what == "sampler":
        got = mexport.load_exported(blob)(3)
        assert got.dtype == torch.uint8 and got.is_cuda and torch.equal(got, live)
    else:
        got = mexport.load_exported(blob)(3, x)
        for a, b in zip(*((got, live) if what == "encoder" else ((got,), (live,)))):
            assert a.is_cuda and float((a - b).abs().max()) <= 1e-6
    routed = 0 if what == "encoder" else 3
    assert launch_counts() == dict.fromkeys(launch_counts(), 0) | {"phase_shuffle": routed}


def test_cli_train_and_eval_take_the_tile_path(cuda, tmp_path, monkeypatch):
    """The CLI's model05 train and eval on the card (the default device):
    every train step's MoDL launch, forward and backward, on the tile path;
    the validations' and the evaluation's forwards on the direct path, since
    the phase route hands on an NCHW head at float32."""
    from vae_mdl_tpu_torch.cli.run import main
    from vae_mdl_tpu_torch.probes.kernel_structure import launch_counts, reset_counts

    monkeypatch.chdir(tmp_path)
    common = ["--dataset", "synthetic:svhn_cropped", "--batch-size", "32",
              "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "tb")]
    reset_counts()
    main(["train", "model05", "--n-updates", "4", "--eval-interval", "2", "--n-samples", "100"]
         + common)
    main(["eval", "model05", "--n-samples", "100"] + common)
    counts = launch_counts()
    assert mdl_kernel.launches_by_path["tiled"] == counts["mdl_log_prob_backward"]
    assert mdl_kernel.launches_by_path["direct"] > 0
    assert mdl_kernel.backward_launches_by_path["direct"] == 0
    assert counts["mdl_log_prob"] > 0 and counts["mdl_log_prob_backward"] == 4
    assert os.path.exists(tmp_path / "assets" / "model05_samples.png")


def test_captured_window_equals_eager_steps_bit_for_bit(cuda):
    """On the card ``make_multi_train_step`` is one CUDA graph of its window
    (``train/capture.py``): two calls of 2 steps equal 4 eager single steps
    bit for bit (cuDNN's deterministic algorithms), with one capture, fresh
    draws at each replay and the MoDL kernels' launches counted at each."""
    from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer, tree_map
    from vae_mdl_tpu_torch.train.steps import (
        make_multi_train_step,
        make_train_step,
        reduce_scan_metrics,
    )

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = experiment("model05")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=16),
                                  train=dataclasses.replace(cfg.train, ema_decay=0.99))
        pool = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (4, 16, 32, 32, 3),
                                                                 dtype=np.uint8), device=cuda)

        def fresh():
            model = build_model(cfg.model, torch.Generator().manual_seed(0))
            return model, create_train_state(model, cfg.train)

        model, eager = fresh()
        single = make_train_step(model, cfg, make_optimizer(cfg.train))
        window = []
        for batch in pool:
            eager, metrics = single.eager(eager, batch)
            window.append(metrics)
        model, captured = fresh()
        multi = make_multi_train_step(model, cfg, make_optimizer(cfg.train), 2)
        captured, _ = multi(captured, pool[:2])
        before = mdl_kernel.launches_by_path["tiled"]
        captured, metrics = multi(captured, pool[2:])
        torch.cuda.synchronize()
        assert mdl_kernel.launches_by_path["tiled"] - before == 2
        assert multi.cache_size() == 1 and captured.step == 4
        for a, b in ((captured.params, eager.params), (captured.opt_state, eager.opt_state),
                     (captured.ema_params, eager.ema_params),
                     (metrics, reduce_scan_metrics(window[2:]))):
            tree_map(lambda u, v: torch.testing.assert_close(u, v, rtol=0, atol=0), a, b)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def test_mesh_steps_captured_over_nccl_equal_eager_steps_bit_for_bit(cuda, tmp_path):
    """At a world of one over NCCL the mesh steps are CUDA graphs with their
    collectives inside (``train/capture.py``): two calls of a 2-step
    ``make_multi_train_step(mesh=)`` window equal 4 eager steps of the
    data-parallel body, and 2 calls of ``make_zero1_train_step`` 2 eager ones,
    bit for bit (cuDNN's deterministic algorithms), one capture each, the
    MoDL kernels' launches counted at each replay."""
    import torch.distributed as dist

    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.distributed import init_distributed
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh
    from vae_mdl_tpu_torch.parallel.spmd import (
        make_shard_map_train_step,
        make_zero1_train_step,
        zero1_opt_state,
    )
    from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer, tree_map
    from vae_mdl_tpu_torch.train.steps import make_multi_train_step, reduce_scan_metrics

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    init_distributed(f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        assert "nccl" in str(dist.get_backend())
        mesh = make_mesh(MeshConfig())
        cfg = experiment("model05")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=16),
                                  train=dataclasses.replace(cfg.train, ema_decay=0.99))
        pool = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (4, 16, 32, 32, 3),
                                                                 dtype=np.uint8), device=cuda)

        def fresh(zero1=False):
            model = build_model(cfg.model, torch.Generator().manual_seed(0))
            tx = make_optimizer(cfg.train)
            state = create_train_state(model, cfg.train)
            if zero1:
                state.opt_state = zero1_opt_state(tx, state.params, mesh)
            return model, tx, state

        def same(a, b):
            tree_map(lambda u, v: torch.testing.assert_close(u, v, rtol=0, atol=0), a, b)

        model, tx, eager = fresh()
        single = make_shard_map_train_step(model, cfg, tx, mesh)
        window = []
        for batch in pool:
            eager, metrics = single.eager(eager, batch)
            window.append(metrics)
        model, tx, captured = fresh()
        multi = make_multi_train_step(model, cfg, tx, 2, mesh=mesh)
        captured, _ = multi(captured, pool[:2])
        before = mdl_kernel.launches_by_path["tiled"]
        captured, metrics = multi(captured, pool[2:])
        torch.cuda.synchronize()
        assert mdl_kernel.launches_by_path["tiled"] - before == 2
        assert multi.cache_size() == 1 and captured.step == 4
        for a, b in ((captured.params, eager.params), (captured.opt_state, eager.opt_state),
                     (captured.ema_params, eager.ema_params),
                     (metrics, reduce_scan_metrics(window[2:]))):
            same(a, b)

        runs = []
        for how in ("eager", "captured"):
            model, tx, state = fresh(zero1=True)
            step = make_zero1_train_step(model, cfg, tx, mesh)
            for batch in pool[:2]:
                state, metrics = (step.eager if how == "eager" else step)(state, batch)
            runs.append((state, metrics, step))
        (eager, want, _), (captured, got, step) = runs
        torch.cuda.synchronize()
        assert step.cache_size() == 1 and captured.step == 2
        for a, b in ((captured.params, eager.params), (captured.opt_state, eager.opt_state),
                     (captured.ema_params, eager.ema_params), (got, want)):
            same(a, b)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


# -- the evaluator's batch as one program, head_pad, the polyphase form --------------


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms and float32 convolutions (no TF32),
    as chip_smoke.py's phase 20 runs."""
    backends = torch.backends
    flags = (backends.cudnn.deterministic, backends.cudnn.benchmark, backends.cudnn.allow_tf32,
             backends.cuda.matmul.allow_tf32)
    backends.cudnn.deterministic, backends.cudnn.benchmark = True, False
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    yield
    (backends.cudnn.deterministic, backends.cudnn.benchmark, backends.cudnn.allow_tf32,
     backends.cuda.matmul.allow_tf32) = flags


def _eval_inputs(name, n, device):
    cfg = experiment(name)
    model = build_model(cfg.model, torch.Generator().manual_seed(0))
    images = np.random.default_rng(0).integers(0, 256, (n,) + tuple(cfg.model.image_shape),
                                               dtype=np.uint8)
    return model, cfg, images, torch.as_tensor(images, device=device)


@pytest.mark.parametrize("name", ["model01", "model05", "model03", "ladder_svhn"])
def test_captured_evaluation_equals_the_eager_loop_bit_for_bit(cuda, deterministic, name):
    """On the card a batch's evaluation is one CUDA graph (``BatchEvaluator``):
    the capturing call and a replay equal the eager loop bit for bit (llh, the
    top set, the curve), each leaves the caller's generator at the eager
    loop's offset, ``generator=None`` draws from the default generator as the
    eager loop does, and the likelihood kernel's launches are counted at each
    replay (the capturing call's warm-up, one chunk, counts too)."""
    from vae_mdl_tpu_torch.evaluation import harness

    model, cfg, _, batch = _eval_inputs(name, 8, cuda)
    evaluator = make_batch_evaluator(model, cfg, 200, 100, with_khat=True, with_curve=True)
    kernels = {"mdl": mdl_kernel, "dl": dl_kernel}.get(cfg.model.likelihood)
    for seed, launched in ((5, 3), (6, 2)):
        eager_gen = torch.Generator(cuda).manual_seed(seed)
        want = evaluator.eager(batch, eager_gen)
        gen = torch.Generator(cuda).manual_seed(seed)
        before = None if kernels is None else kernels.launches
        got = evaluator(batch, gen)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert gen.get_offset() == eager_gen.get_offset()
        if kernels is not None:
            assert kernels.launches - before == launched
    assert evaluator.cache_size() == 1 and harness.cache_size(model) == 1
    default = torch.cuda.default_generators[torch.cuda.current_device()]
    torch.cuda.manual_seed(9)
    want = evaluator.eager(batch)
    offset = default.get_offset()
    torch.cuda.manual_seed(9)
    got = evaluator(batch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert default.get_offset() == offset


def test_a_second_evaluate_llh_captures_nothing(cuda, deterministic):
    """The graphs outlive the evaluator: a second ``evaluate_llh`` on the same
    model and shape replays the first one's graph (the padded tail batch
    too) and returns what the eager loop returns for each batch's seed."""
    from vae_mdl_tpu_torch.evaluation import harness

    model, cfg, images, _ = _eval_inputs("model05", 12, cuda)
    first = evaluate_llh(model, cfg, images, n_samples=200, k_chunk=100, batch_size=8)
    assert harness.cache_size(model) == 1
    second = evaluate_llh(model, cfg, images, n_samples=200, k_chunk=100, batch_size=8)
    assert harness.cache_size(model) == 1
    np.testing.assert_array_equal(first[1], second[1])
    evaluator = make_batch_evaluator(model, cfg, 200, 100)
    want = evaluator.eager(torch.as_tensor(images[:8], device=cuda),
                           torch.Generator(cuda).manual_seed(_batch_seed(0, 0)))
    np.testing.assert_array_equal(first[1][:8], want.cpu().numpy())


def test_captured_evaluation_reads_params_as_given_after_a_train_step(cuda, deterministic):
    """``params=`` (the EMA copy) and the model's own parameters after train
    steps, which write them in place or anew: each captured evaluation equals
    the eager one on the same weights."""
    from vae_mdl_tpu_torch.train.state import create_train_state, eval_params, make_optimizer
    from vae_mdl_tpu_torch.train.steps import make_train_step

    model, cfg, _, batch = _eval_inputs("model05", 8, cuda)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=0.9))
    state = create_train_state(model, cfg.train)
    evaluator = make_batch_evaluator(model, cfg, 200, 100)
    for kind in ("captured", "eager", "captured"):
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        state, _ = (step if kind == "captured" else step.eager)(state, batch)
        for params in (eval_params(cfg.train, state), None):
            want = evaluator.eager(batch, torch.Generator(cuda).manual_seed(1), params=params)
            got = evaluator(batch, torch.Generator(cuda).manual_seed(1), params=params)
            assert torch.equal(got, want)


def test_captured_evaluation_follows_parameters_given_new_storage(cuda, deterministic):
    """Parameters loaded with ``assign=True`` after the capture live in new
    storage: a replay copies them into the storage the graph reads and
    equals the eager loop on the new weights."""
    model, cfg, _, batch = _eval_inputs("model05", 8, cuda)
    evaluator = make_batch_evaluator(model, cfg, 200, 100)
    evaluator(batch, torch.Generator(cuda).manual_seed(1))
    model.load_state_dict({name: p.detach() * 1.01 for name, p in model.named_parameters()},
                          assign=True)
    want = evaluator.eager(batch, torch.Generator(cuda).manual_seed(1))
    got = evaluator(batch, torch.Generator(cuda).manual_seed(1))
    assert torch.equal(got, want)


def test_head_pad_model05_through_the_kernels_equals_the_plain_version(cuda, deterministic):
    """model05 with ``head_pad=64``: the head's 50 of 64 channels are a view
    that is not dense, which the MoDL kernels take on their direct path; the
    loss and every gradient leaf equal the plain version's (the train step's
    tolerances with float32 convolutions, on images of the 256 levels: the
    loss within 1e-5, each leaf within 2e-4 in norm)."""
    base = MODELS["model05"]
    base = dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, head_pad=64))
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randint(0, 256, (16, 32, 32, 3), generator=gen, device=cuda).float() / 255.0
    eps = torch.randn((5, 16, base.n_latent), generator=gen, device=cuda)
    results = {}
    for which, use in (("kernel", None), ("plain", False)):
        mcfg = dataclasses.replace(base, use_pallas=use)
        model = build_model(mcfg, torch.Generator().manual_seed(0))
        params = dict(model.named_parameters())
        before = dict(mdl_kernel.launches_by_path), dict(mdl_kernel.backward_launches_by_path)
        loss, _ = training_loss_fn(model, experiment("model05", model=mcfg),
                                   prior_for(mcfg, "cuda"), x, 5, eps=eps)(params)
        grads = torch.autograd.grad(loss, list(params.values()))
        results[which] = float(loss.detach()), dict(zip(params, grads))
        if which == "kernel":
            assert mdl_kernel.launches_by_path["direct"] - before[0]["direct"] == 1
            assert mdl_kernel.backward_launches_by_path["direct"] - before[1]["direct"] == 1
    (loss_k, grads_k), (loss_p, grads_p) = results["kernel"], results["plain"]
    assert loss_k == pytest.approx(loss_p, rel=1e-5)
    for leaf, g in grads_p.items():
        assert float((grads_k[leaf] - g).norm() / g.norm().clamp_min(1e-30)) <= 2e-4, leaf


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,side", [(128, 128, 4), (128, 64, 8), (64, 32, 16)])
def test_polyphase_equals_conv_transpose2d_on_the_card(cuda, cin, cout, side, dtype):
    """The polyphase form (cuDNN's 3x3 conv and a depth-to-space step)
    against ``F.conv_transpose2d`` at model05's three decoder shapes: float32
    within 1e-5 + 1e-5 |y| (TF32 off; the same products summed in another
    order); bf16 within 1e-5 + 2^-7 (|y| + |b|): the polyphase form rounds the
    conv's sum to bf16 and then its sum with the bias, the library rounds
    once, each rounding within half an ulp (2^-8 relative)."""
    import torch.nn.functional as F

    from vae_mdl_tpu_torch.nn.encoders import ConvLayer, ConvSpec, polyphase_conv_transpose

    gen = torch.Generator().manual_seed(side)
    layer = ConvLayer(ConvSpec(cout, 4, 2, True, "none"), cin, gen).to(cuda)
    x = torch.randn(64, cin, side, side, generator=gen).to(cuda)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                                  stride=2, padding=1).float()
        got = polyphase_conv_transpose(x, layer.weight, layer.bias, dtype).float()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if dtype == torch.float32:
        bound = 1e-5 + 1e-5 * want.abs()
    else:
        bound = 1e-5 + 2 ** -7 * (want.abs() + layer.bias.abs()[:, None, None])
    assert bool(((got - want).abs() <= bound).all())


# -- the phase route: a 2x2 conv over the four phases and the epilogue kernel --------

# (in, out, input side, activation): every kernel-4 stride-2 transposed layer of
# the zoo (tests/test_torch_phase_route.py zoo_shapes) and of examples/custom_model.py
_PHASE_SHAPES = [(128, 128, 4, "relu"), (128, 64, 8, "relu"), (64, 32, 16, "relu"),
                 (64, 128, 8, "relu"), (128, 6, 16, "none"), (128, 128, 4, "gelu"),
                 (128, 64, 8, "gelu"), (64, 32, 16, "gelu"), (32, 16, 8, "gelu"),
                 (16, 30, 16, "none")]


@pytest.mark.parametrize("cin,f,side,act", _PHASE_SHAPES)
def test_phase_shuffle_kernel_matches_its_plain_version(cuda, cin, f, side, act):
    """The epilogue kernel against its plain version on the card, on the
    NCHW float32 grid the route's 2x2 conv writes: the same add and
    activation in the same rounding, exact for relu and none; gelu within
    one ulp on |y| + 1e-6 (the same libdevice erff, compiled by another
    hand). The output is contiguous; each launch is counted."""
    from vae_mdl_tpu_torch.ops.cuda import phase_shuffle

    gen = torch.Generator(cuda).manual_seed(cin + f)
    grid = torch.randn(64, 4 * f, side + 1, side + 1, device=cuda, generator=gen) * 3
    bias = torch.randn(f, device=cuda, generator=gen)
    before = phase_shuffle.launches
    got = phase_shuffle.phase_shuffle(grid, bias, act)
    want = phase_shuffle.phase_shuffle_plain(grid, bias, act)
    torch.cuda.synchronize()
    assert phase_shuffle.launches - before == 1
    assert got.shape == (64, f, 2 * side, 2 * side) and got.is_contiguous()
    if act == "gelu":
        assert bool(((got - want).abs() <= 1e-6 + 2 ** -23 * want.abs()).all())
    else:
        assert torch.equal(got, want)


def test_phase_shuffle_kernel_refuses_what_it_does_not_take(cuda):
    from vae_mdl_tpu_torch.ops.cuda import phase_shuffle

    grid, bias = torch.zeros(2, 8, 3, 3, device=cuda), torch.zeros(2, device=cuda)
    with pytest.raises(TypeError):
        phase_shuffle.phase_shuffle_cuda(grid.bfloat16(), bias.bfloat16(), "relu")
    with pytest.raises(ValueError):
        phase_shuffle.phase_shuffle_cuda(grid, bias.cpu(), "relu")
    with pytest.raises(ValueError):
        phase_shuffle.phase_shuffle_cuda(grid, bias, "tanh")
    with pytest.raises(ValueError, match="contiguous"):
        phase_shuffle.phase_shuffle_cuda(grid.contiguous(memory_format=torch.channels_last),
                                         bias, "relu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,f,side,act", _PHASE_SHAPES)
def test_phase_route_equals_conv_transpose2d_on_the_card(cuda, deterministic, cin, f, side,
                                                         act, dtype):
    """A transposed ``ConvLayer`` of 8 output channels or more on the card
    at float32 outside autograd takes the route (one epilogue launch;
    model04's 6-channel head none) and equals ``F.conv_transpose2d`` and its
    activation within 1e-5 + 1e-5 |y| (TF32 off; the same products summed in
    another order), its output NCHW. At bf16, and with autograd recording,
    the layer is the library's call, bit for bit under cuDNN's
    deterministic algorithms, and launches nothing."""
    import torch.nn.functional as F

    from vae_mdl_tpu_torch.nn.blocks import _activation
    from vae_mdl_tpu_torch.nn.encoders import ConvLayer, ConvSpec
    from vae_mdl_tpu_torch.ops.cuda import phase_shuffle

    gen = torch.Generator().manual_seed(side)
    layer = ConvLayer(ConvSpec(f, 4, 2, True, act), cin, gen).to(cuda)
    with torch.no_grad():
        layer.bias.normal_()
    x = torch.randn(256, side, side, cin, generator=gen).to(cuda).permute(0, 3, 1, 2)
    with torch.no_grad():
        w, b = layer.weight.to(dtype), layer.bias.to(dtype)
        want = _activation(act)(F.conv_transpose2d(x.to(dtype), w, b, stride=2, padding=1))
    before = phase_shuffle.launches
    with torch.no_grad():
        got = layer(x, dtype)
    routed = int(f >= 8 and dtype == torch.float32)
    assert phase_shuffle.launches - before == routed
    recorded = layer(x, dtype)
    assert phase_shuffle.launches - before == routed and recorded.grad_fn is not None
    assert torch.equal(recorded, want)
    if not routed:
        assert torch.equal(got, want)
        return
    assert got.is_contiguous()
    excess = (got - want).abs() - (1e-5 + 1e-5 * want.abs())
    worst = int(excess.argmax())
    assert float(excess.max()) <= 0, (float(got.flatten()[worst]), float(want.flatten()[worst]))


def test_captured_model05_evaluation_takes_the_phase_route(cuda, deterministic):
    """model05's float32 5000-IS batch (k-chunks of 100): the capturing call
    and a replay equal the eager loop bit for bit, and each batch launches
    the epilogue 3 layers x 50 chunks = 150 times."""
    from vae_mdl_tpu_torch.ops.cuda import phase_shuffle

    model, cfg, _, batch = _eval_inputs("model05", 8, cuda)
    evaluator = make_batch_evaluator(model, cfg, 5000, 100)
    for seed in (5, 6):
        before = phase_shuffle.launches
        want = evaluator.eager(batch, torch.Generator(cuda).manual_seed(seed))
        assert phase_shuffle.launches - before == 150
        before = phase_shuffle.launches
        got = evaluator(batch, torch.Generator(cuda).manual_seed(seed))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        # the capturing call's warm-up runs one chunk: 3 launches more
        assert phase_shuffle.launches - before == 150 + (3 if seed == 5 else 0)
    assert evaluator.cache_size() == 1


def test_model05_train_steps_leave_the_phase_route(cuda):
    """model05's train step, captured and eager: autograd records the
    decoder, so its transposed convs stay on ``F.conv_transpose2d`` and the
    epilogue launches nothing."""
    from vae_mdl_tpu_torch.ops.cuda import phase_shuffle
    from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
    from vae_mdl_tpu_torch.train.steps import make_train_step

    cfg = experiment("model05")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=16))
    model = build_model(cfg.model, torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    batch = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (16, 32, 32, 3),
                                                              dtype=np.uint8), device=cuda)
    phase_shuffle.launches = 0
    state, _ = step.eager(state, batch)
    for _ in range(3):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert state.step == 4 and bool(torch.isfinite(metrics["loss"]))
    assert phase_shuffle.launches == 0


# -- the residual block's epilogue route ----------------------------------------------

# (N, C, H, W, dtype): biladder_celeba's blocks in its bf16 train step (obs_up's two
# at 640 x 64 x 64 x 64, enc_0's at 128 x 64 x 64 x 64, the upsamplers' at 640 and
# 32 x 32 or 16 x 16, the encoder's smallest) and ladder_svhn's float32 widths
_EPILOGUE_SHAPES = [(640, 64, 64, 64, torch.bfloat16), (128, 64, 64, 64, torch.bfloat16),
                    (640, 64, 16, 16, torch.bfloat16), (128, 64, 8, 8, torch.bfloat16),
                    (640, 48, 32, 32, torch.float32), (640, 8, 8, 8, torch.float32),
                    (5, 24, 3, 7, torch.bfloat16)]
_EPILOGUE_MODES = ["inner", "gate", "shortcut_gate"]


def _epilogue_operands(device, n, c, h, w, dtype, mode, seed=0):
    gen = torch.Generator(device).manual_seed(seed)

    def act_map():
        return torch.randn(n, h, w, c, device=device, generator=gen).mul(2).to(dtype).permute(
            0, 3, 1, 2)

    conv, grad = act_map(), act_map()
    bias = torch.randn(c, device=device, generator=gen) * 0.1
    residual = act_map() if mode != "inner" else None
    s_bias = torch.randn(c, device=device, generator=gen) * 0.1 if "shortcut" in mode else None
    gate = torch.tensor(0.3, device=device) if "gate" in mode else None
    return conv, grad, bias, residual, s_bias, gate


def _within_one_rounding(got, want, scale=None):
    """Per element within one ulp of ``got``'s dtype (at most 2^-7 of |want|
    at bf16, 2^-22 at float32) plus 1e-6, and 1e-6 of ``scale`` where given:
    for ``c``'s gradient |grad g|, since near act''s zero its two terms
    cancel and a few float32 ulps of theirs (PyTorch's gelu_backward
    contracts mul+add, the kernel does not) are all of the difference."""
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -22
    bound = 1e-6 + ulp * want.float().abs()
    if scale is not None:
        bound = bound + 1e-6 * scale
    excess = (got.float() - want.float()).abs() - bound
    return float(excess.max()) <= 0


@pytest.mark.parametrize("mode", _EPILOGUE_MODES)
@pytest.mark.parametrize("n,c,h,w,dtype", _EPILOGUE_SHAPES)
def test_block_epilogue_kernels_match_their_plain_versions(cuda, n, c, h, w, dtype, mode):
    """The forward and backward kernels against their plain versions on the
    card, at the ladders' shapes: values and ``c``'s gradient within one
    rounding of the output dtype (``_within_one_rounding``: the same float32
    formulas; PyTorch's gelu kernels contract mul+add, these do not), the bias, shortcut-bias and
    gate sums within 1e-5 of the sum of their terms' magnitudes (float32
    terms added in another order); outputs channels-last; one forward and
    two backward launches a call."""
    from vae_mdl_tpu_torch.ops.cuda import block_epilogue as be

    conv, grad, bias, residual, s_bias, gate = _epilogue_operands(cuda, n, c, h, w, dtype, mode)
    act = "gelu_tanh" if mode != "gate" else "gelu"
    before = be.launches, be.backward_launches
    got = be.epilogue_cuda(conv, bias, act, residual, s_bias, gate)
    got_grads = be.epilogue_backward_cuda(grad, conv, bias, act, gate, residual is not None)
    torch.cuda.synchronize()
    assert (be.launches - before[0], be.backward_launches - before[1]) == (1, 2)
    want = be.epilogue_plain(conv, bias, act, residual, s_bias, gate)
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == dtype
    assert _within_one_rounding(got, want)
    want_grads = be.epilogue_backward_plain(grad, conv, bias, act, gate, residual is not None)
    assert got_grads[0].is_contiguous(memory_format=torch.channels_last)
    scaled = grad.float().abs() * (1.0 if gate is None else abs(float(gate)))
    assert _within_one_rounding(got_grads[0], want_grads[0], scaled)
    a = be._act(conv.float() + bias[:, None, None], act)
    magnitudes = [want_grads[0].float().abs().sum((0, 2, 3)),
                  grad.float().abs().sum((0, 2, 3)), (grad.float() * a).abs().sum()]
    for got_sum, want_sum, scale in zip(got_grads[1:], want_grads[1:], magnitudes):
        if want_sum is None:
            assert got_sum is None
            continue
        assert got_sum.shape == want_sum.shape and got_sum.dtype == torch.float32
        assert bool(((got_sum - want_sum).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("mode", _EPILOGUE_MODES)
def test_block_epilogue_kernels_give_the_same_bits_twice(cuda, mode):
    """Two runs of each kernel on the same operands give the same bits,
    the sums included: no atomics, a grid fixed by the card."""
    from vae_mdl_tpu_torch.ops.cuda import block_epilogue as be

    conv, grad, bias, residual, s_bias, gate = _epilogue_operands(cuda, 640, 64, 32, 32,
                                                                  torch.bfloat16, mode)
    runs = [(be.epilogue_cuda(conv, bias, "gelu_tanh", residual, s_bias, gate),
             be.epilogue_backward_cuda(grad, conv, bias, "gelu_tanh", gate,
                                       residual is not None)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_block_epilogue_kernels_refuse_what_they_do_not_take(cuda):
    from vae_mdl_tpu_torch.ops.cuda import block_epilogue as be

    conv = torch.zeros(2, 8, 3, 3, device=cuda).contiguous(memory_format=torch.channels_last)
    bias = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        be.epilogue_cuda(conv.contiguous(), bias, "gelu_tanh")
    with pytest.raises(TypeError):
        be.epilogue_cuda(conv.half(), bias, "gelu_tanh")
    with pytest.raises(ValueError, match="16-byte"):
        be.epilogue_cuda(torch.zeros(2, 12, 3, 3, device=cuda, dtype=torch.bfloat16)
                         .contiguous(memory_format=torch.channels_last), bias[:1].expand(12)
                         .contiguous(), "gelu_tanh")
    with pytest.raises(TypeError):
        be.epilogue_cuda(conv, bias.bfloat16(), "gelu_tanh")
    with pytest.raises(ValueError):
        be.epilogue_cuda(conv, bias, "gelu_tanh", conv.contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shortcut", [False, True])
def test_a_routed_block_on_the_card_equals_its_plain_body(cuda, deterministic, shortcut, dtype):
    """A ``ResidualBlock`` on the card takes the route (4 forward launches, 8
    backward) and equals its plain body (the route off) within the CPU
    test's tolerances (``tests/test_torch_block_epilogue.py``): values and
    the gradients of the input and every parameter."""
    from vae_mdl_tpu_torch.nn import blocks
    from vae_mdl_tpu_torch.ops.cuda import block_epilogue as be

    block = blocks.ResidualBlock(32 if shortcut else 64, 64, 64, rezero=True, dtype=dtype,
                                 activation="gelu_tanh",
                                 generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.no_grad():
        block.gate.fill_(0.6)
        for name, p in block.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.1, 0.1)
    x = torch.randn(64, 16, 16, block.Conv_0.weight.shape[1], device=cuda).to(dtype)
    x = x.permute(0, 3, 1, 2).detach().requires_grad_()
    leaves = [x] + list(block.parameters())
    cotangent = torch.randn(64, 16, 16, 64, device=cuda).to(dtype).permute(0, 3, 1, 2)
    before = be.launches, be.backward_launches
    got = block.forward_nchw(x)
    got_grads = torch.autograd.grad(got, leaves, cotangent)
    assert (be.launches - before[0], be.backward_launches - before[1]) == (4, 8)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(blocks, "EPILOGUE_DTYPES", ())
        want = block.forward_nchw(x)
        want_grads = torch.autograd.grad(want, leaves, cotangent)
    assert be.launches - before[0] == 4
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2e-2)
    torch.testing.assert_close(got, want, **tol)
    for a, b in zip(got_grads, want_grads):
        scale = float(b.abs().max()) + 1e-6
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)
        else:
            assert float((a.float() - b.float()).abs().max()) <= 0.05 * scale


def test_captured_biladder_celeba_step_launches_the_epilogues(cuda):
    """biladder_celeba's captured train step launches the epilogue kernels
    of its 13 residual blocks at each replay (4 forwards a block, 4
    backwards of two launches each); model05's, which has no residual
    block, launches none."""
    from vae_mdl_tpu_torch.ops.cuda import block_epilogue as be
    from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
    from vae_mdl_tpu_torch.train.steps import make_train_step

    for name, blocks_in_model in (("biladder_celeba", 13), ("model05", 0)):
        cfg = experiment(name)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=8))
        model = build_model(cfg.model, torch.Generator().manual_seed(0))
        state = create_train_state(model, cfg.train)
        step = make_train_step(model, cfg, make_optimizer(cfg.train))
        shape = (8,) + tuple(cfg.model.image_shape)
        batch = torch.as_tensor(np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8),
                                device=cuda)
        state, _ = step(state, batch)  # warm-up and capture
        before = be.launches, be.backward_launches
        for _ in range(2):
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(metrics["loss"]))
        assert be.launches - before[0] == 2 * 4 * blocks_in_model
        assert be.backward_launches - before[1] == 2 * 8 * blocks_in_model
