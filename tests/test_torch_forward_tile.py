"""The MoDL forward's tile path and P2's channel-first kernel, as far as the
CPU reaches them: the forward's dispatch by layout
(``mdl_kernel.forward_path``), its read-only walk over the persistent
blocks' schedule (``mdl_kernel.tiles_of``, the Python mirror of
``csrc/mdl_tile.cuh``'s loop) replayed with the plain version as the body,
the wrapper on CPU tensors, and the channel sum's choice of direct kernel
(``io_probe.direct_kernel``) with its plain version against the Pallas body
of ``scripts/kernel_isolate2.py`` in interpret mode.

Tolerances: the replayed walk computes each pixel from its own row with the
plain version's float32 operations, so it equals the plain version over the
whole tensor exactly (atol 0); the channel sums rtol 1e-6, atol 1e-5 (50
float32 terms of O(1) in another order), as tests/test_torch_probes.py
holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob
from vae_mdl_tpu_torch.ops.cuda import io_probe, mdl_kernel
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import TILE_PIXELS, forward_path, tiles_of
from vae_mdl_tpu_torch.probes import ab_times, kernel_outputs

torch.set_num_threads(1)

SUM_TOL = dict(rtol=1e-6, atol=1e-5)


def _nchw(p):
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def _misaligned(shape, dtype):
    """A dense tensor of ``shape`` one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 16, dtype=dtype)
    lead = (-flat.data_ptr() % 16) // flat.element_size()
    view = flat[lead + 1:lead + 1 + n].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == flat.element_size()
    return view


@pytest.mark.parametrize("case", ["nhwc", "head_view", "bf16", "one_sample_any_stride"])
def test_forward_path_takes_the_tile_path_for_dense_channel_minor_parameters(case):
    p = torch.zeros((3, 2, 5, 7, 50))
    if case == "head_view":  # an NCHW-shaped conv output in channels-last memory
        head = torch.zeros((6, 50, 5, 7)).contiguous(memory_format=torch.channels_last)
        p = head.reshape(3, 2, 50, 5, 7).permute(0, 1, 3, 4, 2)
        assert p.stride() == (2 * 5 * 7 * 50, 5 * 7 * 50, 7 * 50, 50, 1)
    elif case == "bf16":
        p = p.bfloat16()
    elif case == "one_sample_any_stride":
        p = torch.zeros((1, 2, 5, 7, 50)).as_strided((1, 2, 5, 7, 50), (7, 1750, 350, 50, 1))
    assert forward_path(p) == "tiled"


@pytest.mark.parametrize("case", ["nchw", "sliced_channels", "sliced_rows", "strided_pixels",
                                  "misaligned", "misaligned_bf16", "float16", "empty"])
def test_forward_path_takes_the_direct_path_for_anything_else(case):
    p = torch.zeros((3, 2, 5, 8, 50))
    if case == "nchw":
        p = _nchw(p)
    elif case == "sliced_channels":
        p = torch.zeros((3, 2, 5, 8, 60))[..., :50]
    elif case == "sliced_rows":
        p = torch.zeros((3, 2, 6, 8, 50))[:, :, :5]
    elif case == "strided_pixels":
        p = torch.zeros((3, 2, 5, 16, 50))[:, :, :, ::2]
    elif case == "misaligned":
        p = _misaligned((3, 2, 5, 8, 50), torch.float32)
    elif case == "misaligned_bf16":
        p = _misaligned((3, 2, 5, 8, 50), torch.bfloat16)
    elif case == "float16":
        p = p.half()
    else:
        p = torch.zeros((0, 2, 5, 8, 50))
    assert forward_path(p) == "direct"


def test_forward_and_backward_dispatch_agree_on_the_model_layouts():
    """The gradient buffer ``torch.empty_like`` gives each layout takes the
    backward down the path the forward took."""
    p = torch.zeros((3, 2, 5, 7, 50))
    for view in (p, _nchw(p), torch.zeros((3, 2, 5, 7, 60))[..., :50], p.bfloat16()):
        assert forward_path(view) == mdl_kernel.backward_path(view, torch.empty_like(view))


def _walk(x01, params, blocks):
    """``mdlt::for_each_tile_read`` replayed on the CPU: block ``b`` takes its
    tiles in turn, a tile's rows are ``TILE_PIXELS`` consecutive pixels of
    the dense channel-minor parameters, and each pixel's value is written to
    ``out[first + t]``; the body is the plain version on that row."""
    k, b, h, w, c = params.shape
    total = k * b * h * w
    rows = params.reshape(total, c)
    # the image of each pixel, broadcast over k as the kernel indexes it
    images = x01.reshape(1, b * h * w, 3).expand(k, -1, -1).reshape(total, 3)
    out = torch.full((total,), float("nan"))
    writes = torch.zeros(total, dtype=torch.int64)
    for tiles in tiles_of(total, TILE_PIXELS, blocks):
        for first, n in tiles:
            tile = rows[first:first + n]
            value = mixture_log_prob(images[first:first + n].reshape(n, 1, 1, 3),
                                     tile.reshape(n, 1, 1, c).float())
            out[first:first + n] = value.reshape(n)
            writes[first:first + n] += 1
    return out.reshape(k, b, h, w, 1), writes


@pytest.mark.parametrize("shape,blocks", [((3, 2, 5, 7), 4), ((3, 7, 31, 31), 132 * 8),
                                          ((5, 4, 8, 8), 5), ((1, 1, 1, 1), 3)])
def test_read_only_walk_writes_every_pixel_once_and_equals_the_plain_version(shape, blocks):
    k, b, h, w = shape
    rng = np.random.default_rng(k * b)
    x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3)).astype(np.float32) / 255.0)
    p = torch.from_numpy((rng.standard_normal((k, b, h, w, 50)) * 3.0).astype(np.float32))
    got, writes = _walk(x, p, blocks)
    assert (writes == 1).all()
    assert torch.equal(got, mixture_log_prob(x, p))
    ragged = (k * b * h * w) % TILE_PIXELS
    last = tiles_of(k * b * h * w, TILE_PIXELS, blocks)
    short = [n for tiles in last for _, n in tiles if n < TILE_PIXELS]
    assert short == ([ragged] if ragged else [])


@pytest.mark.parametrize("path", [None, "tiled", "direct"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_on_the_cpu_is_the_plain_version_whatever_the_path(path, dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (2, 4, 4, 3)).astype(np.float32) / 255.0)
    p = torch.from_numpy(rng.standard_normal((3, 2, 4, 4, 50)).astype(np.float32)).to(dtype)
    before = mdl_kernel.launches, dict(mdl_kernel.launches_by_path)
    got = mdl_kernel.mdl_log_prob(x, p, path)
    torch.testing.assert_close(got, mixture_log_prob(x, p.float()), rtol=0, atol=0)
    assert (mdl_kernel.launches, mdl_kernel.launches_by_path) == before  # no launch on the CPU


def test_forward_refuses_an_unknown_path_and_cuda_paths_for_cpu_tensors():
    x, p = torch.zeros(2, 4, 4, 3), torch.zeros(3, 2, 4, 4, 50)
    with pytest.raises(ValueError, match="path"):
        mdl_kernel.mdl_log_prob(x, p, "staged")
    for path in (None, "tiled", "direct"):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            mdl_kernel.mdl_log_prob_cuda(x, p, path)
    assert set(mdl_kernel.launches_by_path) == set(mdl_kernel.PATHS)
    assert mdl_kernel._library.cache_info().currsize == 0  # nothing built here


# -- P2: the channel-first channel sum -------------------------------------------------


def _channel_first(case):
    """A channel-first ``[K, C, P]`` float32 tensor in one of the layouts the
    dispatch tells apart, and the kernel it should get."""
    rng = np.random.default_rng(len(case))
    whole = torch.from_numpy(rng.standard_normal((3, 50, 520)).astype(np.float32))
    if case == "contiguous":
        return whole[..., :512].contiguous(), "vec4"
    if case == "row_slice":  # pixel, channel and sample strides all multiples of 4
        return whole[..., 4:516], "vec4"
    if case == "short_rows":  # rows of fewer pixels than a warp of the vec4 kernel sums
        return whole[..., :256].contiguous(), "strided"
    if case == "odd_pixels":
        return whole[..., :511].contiguous(), "strided"
    if case == "odd_row_stride":
        return torch.from_numpy(rng.standard_normal((3, 50, 514)).astype(np.float32))[..., :512], \
            "strided"
    if case == "misaligned":
        return whole[..., 1:513], "strided"
    if case == "strided_pixels":
        return whole[..., ::2][..., :256], "strided"
    if case == "channel_minor_memory":
        return torch.from_numpy(rng.standard_normal((3, 512, 50)).astype(np.float32)) \
            .transpose(1, 2), "strided"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["contiguous", "row_slice", "short_rows", "odd_pixels",
                                  "odd_row_stride", "misaligned", "strided_pixels",
                                  "channel_minor_memory"])
def test_channel_first_sum_dispatch_by_strides_and_alignment(case):
    params, want = _channel_first(case)
    assert io_probe.direct_kernel(params, "channel_first") == want
    # the channel-minor probe and other dtypes never take the vec4 kernel
    assert io_probe.direct_kernel(params.transpose(1, 2), "channel_minor") == "strided"
    assert io_probe.direct_kernel(params.double(), "channel_first") == "strided"


@pytest.mark.parametrize("case", ["contiguous", "odd_pixels", "misaligned"])
def test_channel_first_sum_plain_matches_kernel_isolate2s_body(case):
    """The plain version on each dispatch case against the Pallas body of
    ``scripts/kernel_isolate2.py`` (lines 39-51), interpreted at a small size
    on the same values made contiguous (its blocks need whole 128-pixel
    runs, so the odd case's 511 pixels are padded with a zero pixel)."""
    params, _ = _channel_first(case)
    k, ch, p = params.shape
    bp = 128
    padded = -(-p // bp) * bp
    dense = np.zeros((k, ch, padded), np.float32)
    dense[..., :p] = params.numpy()

    def body(p_ref, out_ref):  # scripts/kernel_isolate2.py:39-41
        pt = p_ref[0]
        out_ref[:] = jnp.sum(pt, axis=0, keepdims=True).reshape(out_ref.shape)

    want = pl.pallas_call(  # scripts/kernel_isolate2.py:43-51, interpreted
        body,
        out_shape=jax.ShapeDtypeStruct((k, padded // bp, 1, bp), jnp.float32),
        grid=(k, padded // bp),
        in_specs=[pl.BlockSpec((1, ch, bp), lambda ik, ib: (ik, 0, ib),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, 1, bp), lambda ik, ib: (ik, ib, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(dense))
    got = io_probe.channel_sum(params, "channel_first")
    assert got.shape == (k, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(k, padded)[:, :p],
                               **SUM_TOL)


def test_channel_sum_refuses_a_kernel_off_the_direct_path():
    params = torch.zeros(2, 50, 256)
    with pytest.raises(ValueError, match="kernel"):
        io_probe.channel_sum_cuda(params, "channel_first", "staged", kernel="vec4")
    with pytest.raises(ValueError, match="kernel"):
        io_probe.channel_sum_cuda(params, "channel_first", kernel="staged")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        io_probe.channel_sum_cuda(params, "channel_first", kernel="vec4")
    # the CPU takes the plain version whatever the kernel
    assert torch.equal(io_probe.channel_sum(params, "channel_first", kernel="vec4"),
                       io_probe.channel_sum_plain(params, "channel_first"))
    assert set(io_probe.launches_by_kernel) == set(io_probe.KERNELS)
    assert io_probe.launches == 0


def test_the_checkout_probes_need_a_card_and_name_their_usage(capsys):
    """``probes/ab_times.py`` and ``probes/kernel_outputs.py``, which time
    and hold two checkouts against each other, refuse to run on the CPU and
    print their usage when called wrongly."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ab_times.main(["ab_times", "new"])
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_outputs.main(["kernel_outputs", "write", "outputs.pt"])
    assert ab_times.main(["ab_times"]) == 2
    assert "PYTHONPATH=<old checkout>" in capsys.readouterr().out
    assert {contract for contract, _, _ in ab_times.CONTRACTS} == {
        "K1f/K1b", "K2f/K2b", "K3f", "K4f/K4b"}
