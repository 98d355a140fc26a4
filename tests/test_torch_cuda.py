"""The MoDL and discretized-logistic CUDA kernels on the card: forward and
backward against their plain versions, their input checks, their launch
counts, and the gradient's layout; the probe kernel, the channel sum and the
null-body MoDL kernels against theirs; and the default device of
``build_model`` and the timing harness.
Needs a CUDA card and nvcc; skipped elsewhere. On a machine without
jax, run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, as in chip_smoke.py (same float32 formulas and libdevice
functions, sums in another order): forward per pixel |kernel - plain| <=
2e-4 + 1e-5 |plain|; backward per element <= 2e-5 + 2e-4 |plain| for a
float32 gradient and 2e-5 + 8e-3 |plain| for a bf16 one (one bf16 ulp is
2^-8 of the value). The discretized-logistic kernels run the plain
version's float32 operations one for one, without fused multiply-adds (on
the H100 they agreed bit for bit); they are held to the same forward and
float32 backward tolerances. The probe kernel calls the same libdevice
functions as PyTorch's elementwise kernels (rtol 1e-5, atol 1e-6 over three
iterations; nan meets nan); the channel sums add 50 to 100 float32 terms in
another order (atol 1e-4); ``0.5 p + g`` is exact.
"""
import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS
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
@pytest.mark.parametrize("layout,path,tile", [
    ("channel_minor", "direct", 256), ("channel_minor", "staged", 32),
    ("channel_minor", "staged", 256), ("channel_minor", "staged", 1024),
    ("channel_first", "direct", 256)])
def test_channel_sum_matches_plain_version(cuda, shape, layout, path, tile):
    rng = np.random.default_rng(shape[1])
    params = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    if layout == "channel_first":
        params = params.transpose(1, 2).contiguous()
    before = io_probe.launches
    if path == "staged" and tile * (shape[2] | 1) * 4 > io_probe.MAX_SHARED_BYTES:
        with pytest.raises(ValueError, match="shared memory"):  # 1024 rows of 100 channels
            io_probe.channel_sum(params, layout, path, tile)
        assert io_probe.launches == before
        return
    got = io_probe.channel_sum(params, layout, path, tile)
    assert io_probe.launches == before + 1
    want = io_probe.channel_sum_plain(params, layout)
    assert got.shape == want.shape == shape[:2] and got.is_contiguous()
    assert (got - want).abs().max() <= 1e-4


def test_channel_sum_direct_reads_through_any_strides(cuda):
    rng = np.random.default_rng(0)
    whole = torch.from_numpy(rng.standard_normal((3, 40, 60)).astype(np.float32)).to(cuda)
    view = whole[:, ::2, 5:55]  # strided pixels, offset channels
    got = io_probe.channel_sum(view, "channel_minor")
    assert (got - view.sum(-1)).abs().max() <= 1e-4
    with pytest.raises(ValueError, match="staged"):
        io_probe.channel_sum(view, "channel_minor", "staged")
    with pytest.raises(ValueError, match="tile"):
        io_probe.channel_sum(whole, "channel_minor", "staged", tile=48)


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


def test_timing_harness_lands_on_the_card_by_default(cuda):
    step, state, batch, cfg, flops = setup_scanned_step("model01", spc=2)
    assert batch.is_cuda and all(p.is_cuda for p in state.params.values())
    state, metrics = step(state, batch)
    assert state.step == 2 and np.isfinite(float(metrics["loss"])) and flops > 0
