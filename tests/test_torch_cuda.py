"""The MoDL CUDA kernel on the card: against its plain version, its input
checks, its launch count and its missing backward. Needs a CUDA card and
nvcc; skipped elsewhere. On a machine without jax, run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: per pixel |kernel - plain| <= 2e-4 + 1e-5 |plain|, as in
chip_smoke.py (same float32 formula and libdevice functions, sums in another
order).
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


def test_backward_through_the_kernel_raises(cuda):
    x, p = _inputs(cuda)
    p.requires_grad_(True)
    out = mdl_kernel.mdl_log_prob(x, p).sum()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.backward()
