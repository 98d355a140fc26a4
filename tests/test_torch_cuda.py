"""The MoDL CUDA kernels on the card: forward and backward against their
plain versions, their input checks, their launch counts, and the gradient's
layout. Needs a CUDA card and nvcc; skipped elsewhere. On a machine without
jax, run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, as in chip_smoke.py (same float32 formulas and libdevice
functions, sums in another order): forward per pixel |kernel - plain| <=
2e-4 + 1e-5 |plain|; backward per element <= 2e-5 + 2e-4 |plain| for a
float32 gradient and 2e-5 + 8e-3 |plain| for a bf16 one (one bf16 ulp is
2^-8 of the value).
"""
import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel

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
