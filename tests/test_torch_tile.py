"""The MoDL backward's tile path, as far as the CPU reaches it: the dispatch
by layout (``mdl_kernel.backward_path``), the persistent blocks' schedule
(``mdl_kernel.tiles_of``, the Python mirror of ``csrc/mdl_tile.cuh``'s loop)
and the fused cascade (``dl_kernel.dl_value_and_grads_plain``, the plain
version of ``csrc/dl_cascade.cuh``'s ``dl_value_and_grads``).

Tolerances: the fused cascade runs the very float32 operations of
``discretized_logistic_log_prob`` and ``dl_grads_plain`` in their order, so
it equals them exactly (atol 0). Against JAX's ``_dl_grads`` in float64 the
formulas are the same up to reassociation: rtol 1e-6, as
tests/test_torch_dl.py holds ``dl_backward_plain``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu.ops.pallas import mdl_kernel as pallas
from vae_mdl_tpu_torch.distributions.discretized import discretized_logistic_log_prob
from vae_mdl_tpu_torch.ops.cuda import mdl_kernel, mdl_null
from vae_mdl_tpu_torch.ops.cuda.dl_kernel import dl_grads_plain, dl_value_and_grads_plain
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import TILE_PIXELS, backward_path, tiles_of
from vae_mdl_tpu_torch.probes import kernel_outputs

torch.set_num_threads(1)

BINS = [(0.0, 1.0, 1.0 / 255.0), (-1.0, 1.0, 2.0 / 255.0)]


def _nchw(p):
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def _misaligned(shape, dtype):
    """A dense tensor of ``shape`` one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 16, dtype=dtype)
    lead = (-flat.data_ptr() % 16) // flat.element_size()  # to the boundary, then one more
    view = flat[lead + 1:lead + 1 + n].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == flat.element_size()
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_path_takes_the_tile_path_for_dense_channel_minor_operands(dtype):
    p = torch.zeros((3, 2, 5, 7, 50), dtype=dtype)
    assert backward_path(p, torch.empty_like(p)) == "tiled"
    # the model's head: an NCHW-shaped conv output in channels-last memory, viewed NHWC
    head = torch.zeros((6, 50, 5, 7), dtype=dtype).contiguous(memory_format=torch.channels_last)
    view = head.reshape(3, 2, 50, 5, 7).permute(0, 1, 3, 4, 2)
    assert view.stride() == (2 * 5 * 7 * 50, 5 * 7 * 50, 7 * 50, 50, 1)
    assert backward_path(view, torch.empty_like(view)) == "tiled"
    # a dimension of one element may have any stride
    one = torch.zeros((1, 2, 5, 7, 50), dtype=dtype).as_strided((1, 2, 5, 7, 50),
                                                                 (7, 1750, 350, 50, 1))
    assert backward_path(one, torch.empty_like(one)) == "tiled"


@pytest.mark.parametrize("case", ["nchw", "sliced_channels", "sliced_rows", "strided_pixels",
                                  "misaligned_parameters", "misaligned_gradient", "nchw_gradient",
                                  "dtypes_differ", "float16", "shapes_differ", "empty"])
def test_backward_path_takes_the_direct_path_for_anything_else(case):
    p = torch.zeros((3, 2, 5, 8, 50))
    dp = None
    if case == "nchw":
        p = _nchw(p)
    elif case == "sliced_channels":
        p = torch.zeros((3, 2, 5, 8, 60))[..., :50]
    elif case == "sliced_rows":
        p = torch.zeros((3, 2, 6, 8, 50))[:, :, :5]
    elif case == "strided_pixels":
        p = torch.zeros((3, 2, 5, 16, 50))[:, :, :, ::2]
    elif case == "misaligned_parameters":
        p = _misaligned((3, 2, 5, 8, 50), torch.float32)
    elif case == "misaligned_gradient":
        dp = _misaligned((3, 2, 5, 8, 50), torch.bfloat16)
        p = p.bfloat16()
    elif case == "nchw_gradient":
        dp = _nchw(torch.zeros_like(p))
    elif case == "dtypes_differ":
        dp = torch.zeros_like(p, dtype=torch.bfloat16)
    elif case == "float16":
        p = p.half()
    elif case == "shapes_differ":
        dp = torch.zeros((3, 2, 5, 4, 100))
    else:
        p = torch.zeros((0, 2, 5, 8, 50))
    dp = torch.empty_like(p) if dp is None else dp
    assert backward_path(p, dp) == "direct"


def test_backward_path_is_what_the_gradient_buffer_of_each_layout_gets():
    """``torch.empty_like`` keeps a dense view's strides, so the model's
    channel-minor head gets the tile path and an NCHW view the direct one; a
    sliced view gets a dense gradient but stays on the direct path."""
    p = torch.zeros((3, 2, 5, 7, 50))
    for view, want in ((p, "tiled"), (_nchw(p), "direct"),
                       (torch.zeros((3, 2, 5, 7, 60))[..., :50], "direct")):
        assert backward_path(view, torch.empty_like(view)) == want


@pytest.mark.parametrize("total,tile,blocks", [
    (655360, 128, 528), (20181, 128, 528), (20181, 128, 7), (210, 128, 2), (127, 128, 4),
    (128, 128, 1), (129, 128, 1), (1, 128, 3), (13107200, 128, 528), (1000, 32, 5)])
def test_tiles_of_covers_every_pixel_exactly_once(total, tile, blocks):
    schedule = tiles_of(total, tile, blocks)
    assert len(schedule) == blocks
    covered = np.zeros(total, dtype=np.int32)
    short = []
    for b, tiles in enumerate(schedule):
        for i, (first, n) in enumerate(tiles):
            assert first == (b + i * blocks) * tile and 1 <= n <= tile
            covered[first:first + n] += 1
            if n < tile:
                short.append((first, n))
    assert (covered == 1).all()
    # only the last tile of all is short, and it ends at the last pixel
    assert len(short) == (1 if total % tile else 0)
    if short:
        assert short[0] == (total - total % tile, total % tile)
    # blocks differ by at most one tile
    counts = [len(tiles) for tiles in schedule]
    assert max(counts) - min(counts) <= 1


def test_tile_is_one_run_of_whole_16_byte_chunks():
    """What the bulk copies need of a full tile, for every mixture count the
    kernels take, in float32 and bfloat16."""
    for n_mix in range(1, mdl_kernel.MAX_MIX + 1):
        for element in (4, 2):
            assert (TILE_PIXELS * 10 * n_mix * element) % 16 == 0


def _dl_inputs(rng, low, high, dtype=np.float32):
    x = (low + (high - low) * rng.integers(0, 256, (2, 6, 6, 3)) / 255.0).astype(dtype)
    x[0, 0] = low
    x[0, 1] = high
    shape = (4, 2, 6, 6, 3)
    loc = (0.5 * (low + high) + 0.3 * (high - low) * rng.standard_normal(shape)).astype(dtype)
    loc = np.where(rng.random(shape) < 0.2, loc + 2.0 * (high - low), loc).astype(dtype)
    logscale = (rng.standard_normal(shape) * 1.5 - 3.0).astype(dtype)
    logscale = np.where(rng.random(shape) < 0.1, -9.0, logscale).astype(dtype)
    return torch.from_numpy(x), torch.from_numpy(loc), torch.from_numpy(logscale)


def _branch_masks(x, loc, logscale, low, high, width):
    inv_std = torch.exp(-logscale.double())
    centered = x.double() - loc.double()
    prob = (torch.sigmoid((centered + width / 2) * inv_std)
            - torch.sigmoid((centered - width / 2) * inv_std))
    right = (x >= high).expand(prob.shape)
    left = (x <= low).expand(prob.shape) & ~right
    inner = ~(left | right)
    return {"right": right, "left": left, "cdf": inner & (prob > 1e-5),
            "pdf": inner & (prob <= 1e-5)}


@pytest.mark.parametrize("low,high,width", BINS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_cascade_equals_the_value_and_the_derivative_on_every_branch(low, high, width, dtype):
    x, loc, logscale = _dl_inputs(np.random.default_rng(0), low, high, dtype)
    lp, d_loc, d_ls = dl_value_and_grads_plain(x, loc, logscale, low, high, width)
    want_lp = discretized_logistic_log_prob(x, loc, logscale, low=low, high=high,
                                            interval_width=width)
    want_loc, want_ls = dl_grads_plain(x, loc, logscale, low, high, width)
    for branch, mask in _branch_masks(x, loc, logscale, low, high, width).items():
        assert int(mask.sum()) > 0, branch
        for got, want in ((lp, want_lp), (d_loc, want_loc), (d_ls, want_ls)):
            assert torch.isfinite(got[mask]).all()
            torch.testing.assert_close(got[mask], want[mask], rtol=0, atol=0)


def test_fused_cascade_matches_jax_dl_grads_in_float64():
    """Through ``dl_grads_plain`` the fused derivatives are the Pallas MoDL
    kernel's ``_dl_grads``; held here directly, on the MoDL's bins."""
    x, loc, logscale = _dl_inputs(np.random.default_rng(1), -1.0, 1.0, np.float64)
    _, d_loc, d_ls = dl_value_and_grads_plain(x, loc, logscale, -1.0, 1.0, 2.0 / 255.0)
    jax.config.update("jax_enable_x64", True)
    try:
        want_loc, want_ls, _ = pallas._dl_grads(
            jnp.asarray(np.broadcast_to(x.numpy(), loc.shape)), jnp.asarray(loc.numpy()),
            jnp.asarray(logscale.numpy()))
        want_loc, want_ls = np.asarray(want_loc), np.asarray(want_ls)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want_loc.dtype == np.float64
    np.testing.assert_allclose(d_loc.numpy(), want_loc, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(d_ls.numpy(), want_ls, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("path", [None, "tiled", "direct"])
def test_backward_on_the_cpu_is_the_plain_version_whatever_the_path(path):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 256, (2, 4, 4, 3)).astype(np.float32) / 255.0)
    p = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 50)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 1)).astype(np.float32))
    before = dict(mdl_kernel.backward_launches_by_path)
    got = mdl_kernel.mdl_backward(x, p, g, path)
    torch.testing.assert_close(got, mdl_kernel.mdl_backward_plain(x, p, g), rtol=0, atol=0)
    assert mdl_kernel.backward_launches_by_path == before  # no launch on the CPU


def test_backward_refuses_an_unknown_path_and_a_cuda_path_for_cpu_tensors():
    x, p, g = torch.zeros(2, 4, 4, 3), torch.zeros(3, 2, 4, 4, 50), torch.zeros(3, 2, 4, 4, 1)
    with pytest.raises(ValueError, match="path"):
        mdl_kernel.mdl_backward(x, p, g, "staged")
    with pytest.raises(ValueError, match="path"):
        mdl_kernel.mdl_backward_cuda(x, p, g, "dma")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mdl_kernel.mdl_backward_cuda(x, p, g, "tiled")
    with pytest.raises(ValueError, match="variant"):
        mdl_null.mdl_null_backward(x, p, g, "tiled")
    for variant in mdl_null.VARIANTS:  # the CPU takes the plain version all the same
        assert torch.equal(mdl_null.mdl_null_backward(x, p, g, variant), g + 0.5 * p)
    assert set(mdl_kernel.backward_launches_by_path) == set(mdl_kernel.PATHS)
    assert set(mdl_null.backward_launches_by_path) == set(mdl_kernel.PATHS)


def test_kernel_outputs_are_seeded_and_compare_bit_for_bit(tmp_path, monkeypatch, capsys):
    """``probes.kernel_outputs`` at a small size on the CPU (the plain
    versions): two runs give the same outputs, every kernel and case is
    there, and ``compare`` tells an altered file from an equal one."""
    size = dict(k=2, batch=3, side=4, k_eval=3, batch_eval=2, sum_shape=(2, 5, 8))
    small = kernel_outputs.outputs("cpu", **size)
    again = kernel_outputs.outputs("cpu", **size)
    assert len(small) == 20 and set(small) == set(again)
    for name, value in small.items():
        assert torch.isfinite(value.float()).all(), name
        assert torch.equal(value, again[name]), name
    assert small["mdl_log_prob_backward bfloat16 nchw"].dtype == torch.bfloat16
    assert small["mdl_log_prob float32 nhwc"].shape == (2, 3, 4, 4, 1)
    assert small["mdl_log_prob k=3 bfloat16 nchw"].shape == (3, 2, 4, 4, 1)
    assert small["channel_sum channel_first"].shape == (2, 8)
    assert small["dl_log_prob_backward float32 head halves d_loc"].shape == (2, 3, 4, 4, 3)
    assert small["dl_log_prob k=3 float32 head halves"].shape == (3, 2, 4, 4, 3)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernel_outputs, "outputs", lambda: small)
    path = str(tmp_path / "outputs.pt")
    assert kernel_outputs.main(["kernel_outputs", "write", path]) == 0
    assert kernel_outputs.main(["kernel_outputs", "compare", path]) == 0
    assert "DIFFERS" not in capsys.readouterr().out
    altered = dict(small)
    altered["dl_log_prob float32"] = small["dl_log_prob float32"] + 1.0
    monkeypatch.setattr(kernel_outputs, "outputs", lambda: altered)
    assert kernel_outputs.main(["kernel_outputs", "compare", path]) == 1
    assert "dl_log_prob float32: DIFFERS" in capsys.readouterr().out
    assert kernel_outputs.main(["kernel_outputs"]) == 2
