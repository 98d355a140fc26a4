"""The two probe kernels on the read walk, as far as the CPU reaches them:
P3's staged null forward (``ops/cuda/mdl_null.py``) takes the MoDL forward's
dispatch by layout (``mdl_kernel.forward_path``, from ``mdl_kernel.path_for``
on strides, dtype and address), P1's staged channel sum
(``ops/cuda/io_probe.py``) takes only a contiguous channel-minor tensor on a
16-byte aligned address with rows that fit its tile (``io_probe.staged_takes``), and
``csrc/mdl_tile.cuh``'s read walk, replayed over the persistent blocks'
schedule (``mdl_kernel.tiles_of``) with each kernel's body, writes every
pixel once. The null forward's body is also held against the Pallas probe it
replaces (``scripts/kernel_structure_probe.py`` ``fwd_tr``, interpret mode).

Tolerances: the replay with the plain version as the body equals the plain
version exactly (atol 0); the kernels' own bodies add a row's channels in
channel order, c = 0 .. C-1, which the direct kernels do too (so the paths
give the same bits), against the plain version's sum in another order: rtol
1e-6, atol 1e-5 (50-100 float32 terms of O(1)), as
tests/test_torch_probes.py holds the sums.
"""
import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_mdl_tpu_torch.ops.cuda import io_probe, mdl_kernel, mdl_null
from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import TILE_PIXELS, tiles_of
from vae_mdl_tpu_torch.probes import kernel_structure

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
SUM_TOL = dict(rtol=1e-6, atol=1e-5)
DTYPES = [torch.float32, torch.bfloat16]


def _nchw(p):
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def _offset(shape, dtype, elements):
    """A dense tensor of ``shape`` ``elements`` past a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 16, dtype=dtype)
    lead = (-flat.data_ptr() % 16) // flat.element_size()
    view = flat[lead + elements:lead + elements + n].view(shape)
    assert view.is_contiguous()
    return view


def _layout(case, dtype):
    """``[3, 2, 5, 8, 50]`` parameters in a named layout -> (tensor, the
    path the tile dispatch must choose)."""
    shape = (3, 2, 5, 8, 50)
    if case == "nhwc":
        return torch.zeros(shape, dtype=dtype), "tiled"
    if case == "head_view":  # an NCHW conv output in channels-last memory
        head = torch.zeros((6, 50, 5, 8), dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        return head.reshape(3, 2, 50, 5, 8).permute(0, 1, 3, 4, 2), "tiled"
    if case == "nchw":
        return _nchw(torch.zeros(shape, dtype=dtype)), "direct"
    if case == "sliced_channels":
        return torch.zeros((3, 2, 5, 8, 60), dtype=dtype)[..., :50], "direct"
    if case == "sliced_rows":
        return torch.zeros((3, 2, 6, 8, 50), dtype=dtype)[:, :, :5], "direct"
    if case == "one_element_off":
        return _offset(shape, dtype, 1), "direct"
    assert case == "sixteen_bytes_off"
    return _offset(shape, dtype, 16 // torch.tensor([], dtype=dtype).element_size()), "tiled"


LAYOUTS = ["nhwc", "head_view", "nchw", "sliced_channels", "sliced_rows", "one_element_off",
           "sixteen_bytes_off"]


@pytest.mark.parametrize("case", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_null_forward_staged_takes_the_modl_forwards_path(case, dtype):
    p, want = _layout(case, dtype)
    assert mdl_kernel.forward_path(p) == want
    assert mdl_null.forward_path(p, "staged") == want
    assert mdl_null.forward_path(p, "dma") == "direct"
    # the same choice from the description alone
    assert mdl_kernel.path_for(p.shape, p.stride(), p.dtype, p.data_ptr()) == want
    # and the backward's twin keeps the MoDL backward's
    dp = torch.empty_like(p)
    assert mdl_null.backward_path(p, dp, "staged") == mdl_kernel.backward_path(p, dp)
    with pytest.raises(ValueError, match="variant"):
        mdl_null.forward_path(p, "transpose")


@pytest.mark.parametrize("address,dtype,want", [
    (0, torch.float32, "tiled"), (4096, torch.bfloat16, "tiled"), (4100, torch.float32, "direct"),
    (4098, torch.bfloat16, "direct"), (0, torch.float16, "direct"), (0, torch.float64, "direct")])
def test_path_for_is_a_function_of_strides_dtype_and_address(address, dtype, want):
    shape = (3, 2, 5, 8, 50)
    dense = (4000, 2000, 400, 50, 1)
    assert mdl_kernel.path_for(shape, dense, dtype, address) == want
    # a dimension of one element may have any stride; an empty tensor launches nothing
    assert mdl_kernel.path_for((1,) + shape[1:], (7,) + dense[1:], torch.float32, 0) == "tiled"
    assert mdl_kernel.path_for((0,) + shape[1:], dense, torch.float32, 0) == "direct"
    assert mdl_kernel.path_for(shape, (4000, 2000, 400, 1, 8), torch.float32, 0) == "direct"


def test_dense_aligned_is_is_contiguous_on_aligned_memory():
    """``mdl_kernel.dense_aligned`` against torch's own rule on many views."""
    rng = np.random.default_rng(0)
    base = torch.zeros(4 * 3 * 5 * 6 * 2)
    for _ in range(300):
        shape = tuple(int(n) for n in rng.integers(1, 4, 4)) + (int(rng.integers(1, 3)),)
        t = base[:int(np.prod(shape))].view(shape)
        t = t.permute(*[int(i) for i in rng.permutation(5)]) if rng.random() < 0.5 else t
        if rng.random() < 0.3:
            dim = int(rng.integers(0, 5))
            t = t.narrow(dim, 0, max(1, t.shape[dim] - 1))
        want = t.numel() > 0 and t.is_contiguous() and t.data_ptr() % 16 == 0
        assert mdl_kernel.dense_aligned(t.shape, t.stride(), t.data_ptr()) == want


@pytest.mark.parametrize("case,takes", [
    ("contiguous", True), ("transposed", False), ("sliced_channels", False),
    ("sliced_pixels", False), ("strided_pixels", False), ("one_element_off", False),
    ("sixteen_bytes_off", True), ("one_sample_any_stride", True), ("float64", False),
    ("two_dims", False), ("empty", False), ("widest_row", True), ("too_wide", False)])
def test_channel_sum_staged_takes_only_contiguous_aligned_channel_minor(case, takes):
    before = io_probe.launches, dict(io_probe.launches_by_kernel)
    t = torch.zeros((3, 40, 50))
    if case == "transposed":  # a channel-first tensor read as channel-minor
        t = torch.zeros((3, 50, 40)).transpose(1, 2)
    elif case == "sliced_channels":
        t = torch.zeros((3, 40, 60))[..., :50]
    elif case == "sliced_pixels":
        t = torch.zeros((3, 48, 50))[:, :40]
    elif case == "strided_pixels":
        t = torch.zeros((3, 80, 50))[:, ::2]
    elif case == "one_element_off":
        t = _offset((3, 40, 50), torch.float32, 1)
    elif case == "sixteen_bytes_off":
        t = _offset((3, 40, 50), torch.float32, 4)
    elif case == "one_sample_any_stride":
        t = torch.zeros((1, 40, 50)).as_strided((1, 40, 50), (3, 50, 1))
    elif case == "float64":
        t = t.double()
    elif case == "two_dims":
        t = t[0]
    elif case == "empty":
        t = torch.zeros((0, 40, 50))
    elif case == "widest_row":  # 256 rows of 226 float32 and the barrier: 231,432 B
        t = torch.zeros((3, 40, io_probe.SUM_MAX_CHANNELS))
    elif case == "too_wide":  # a tile of 300-channel rows overflows shared memory
        t = torch.zeros((3, 40, 300))
    assert io_probe.staged_takes(t.shape, t.stride(), t.dtype, t.data_ptr()) == takes
    if not takes:  # refused before the device is even looked at: nothing launches
        with pytest.raises(ValueError, match="staged path takes"):
            io_probe.channel_sum_cuda(t, path="staged")
    assert (io_probe.launches, io_probe.launches_by_kernel) == before


def test_channel_sum_staged_is_channel_minor_only():
    before = io_probe.launches, dict(io_probe.launches_by_kernel)
    with pytest.raises(ValueError, match="staged path takes"):
        io_probe.channel_sum_cuda(torch.zeros((3, 50, 512)), "channel_first", "staged")
    # the CPU takes the plain version on any path
    t = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 9, 7)).astype(np.float32))
    assert torch.equal(io_probe.channel_sum(t, path="staged"), t.sum(-1))
    assert (io_probe.launches, io_probe.launches_by_kernel) == before
    assert set(io_probe.launches_by_kernel) == {"strided", "tiled", "vec4"}


# -- the read walk replayed --------------------------------------------------------


def _read_walk(total, pixels, blocks, body):
    """``mdlt::for_each_tile_read`` with ``kPixels = pixels`` replayed on the
    CPU: block ``b`` takes tiles ``b, b + blocks, ...`` of ``128 * pixels``
    pixels; in a tile, thread ``t`` takes pixels ``j * 128 + t`` for
    ``j < pixels`` below the tile's length, each written once by
    ``body(pixel indices) -> values``. Returns (out, writes per pixel)."""
    out = torch.full((total,), float("nan"))
    writes = torch.zeros(total, dtype=torch.int64)
    thread_pixels = (np.arange(pixels)[:, None] * TILE_PIXELS
                     + np.arange(TILE_PIXELS)[None, :]).ravel()
    for tiles in tiles_of(total, TILE_PIXELS * pixels, blocks):
        for first, n in tiles:
            index = torch.from_numpy(first + thread_pixels[thread_pixels < n])
            out[index] = body(index)
            writes[index] += 1
    return out, writes


def _in_order(rows):
    """A row's sum as the kernels' bodies take it: c = 0 .. C-1 in float32."""
    acc = torch.zeros(rows.shape[0])
    for c in range(rows.shape[1]):
        acc = acc + rows[:, c].float()
    return acc


def _images(x01, k):
    """Each pixel's image values, broadcast over k as the kernel indexes them."""
    return x01.reshape(1, -1, 3).expand(k, -1, -1).reshape(-1, 3)


@pytest.mark.parametrize("shape,blocks", [((3, 7, 31, 31), 132 * 8), ((5, 2, 8, 8), 5),
                                          ((1, 1, 1, 1), 3), ((3, 2, 5, 7), 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_null_forward_walk_writes_every_pixel_once_and_equals_the_plain_version(shape, blocks,
                                                                               dtype):
    k, b, h, w = shape
    rng = np.random.default_rng(k * b * h)
    x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3)).astype(np.float32) / 255.0)
    p = torch.from_numpy(rng.standard_normal((k, b, h, w, 50)).astype(np.float32)).to(dtype)
    rows, images = p.reshape(-1, 50), _images(x, k)
    want = mdl_null.mdl_null_forward_plain(x, p).reshape(-1)

    def plain(i):
        return mdl_null.mdl_null_forward_plain(images[i], rows[i]).reshape(-1)

    def body(i):  # csrc/io_probe.cu NullForward: the row in order, then the image's sum
        xi = images[i]
        return _in_order(rows[i]) + ((xi[:, 0] + xi[:, 1]) + xi[:, 2])

    got, writes = _read_walk(k * b * h * w, 1, blocks, plain)
    assert (writes == 1).all() and torch.equal(got, want)
    got, writes = _read_walk(k * b * h * w, 1, blocks, body)
    assert (writes == 1).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SUM_TOL)
    # the direct kernel's order is the body's: one pixel at a time in index order
    np.testing.assert_array_equal(got.numpy(), body(torch.arange(k * b * h * w)).numpy())


@pytest.mark.parametrize("shape", [(3, 1000, 50), (1, 255, 7), (2, 513, 100), (100, 3, 50)])
@pytest.mark.parametrize("blocks", [1, 7, 132 * 8])
def test_channel_sum_walk_writes_every_pixel_once_and_equals_the_plain_version(shape, blocks):
    k, p, c = shape
    pixels = io_probe.SUM_PIXELS
    params = torch.from_numpy(np.random.default_rng(p).standard_normal(shape).astype(np.float32))
    rows = params.reshape(-1, c)
    want = io_probe.channel_sum_plain(params).reshape(-1)
    got, writes = _read_walk(k * p, pixels, blocks, lambda i: rows[i].sum(-1))
    assert (writes == 1).all() and torch.equal(got, want)
    got, writes = _read_walk(k * p, pixels, blocks, lambda i: _in_order(rows[i]))
    assert (writes == 1).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SUM_TOL)


def test_the_python_constants_mirror_the_sources():
    tile = (_REPO / "vae_mdl_tpu_torch/csrc/mdl_tile.cuh").read_text()
    probe = (_REPO / "vae_mdl_tpu_torch/csrc/io_probe.cu").read_text()
    assert re.search(r"constexpr int kTilePixels = (\d+);", tile).group(1) == str(TILE_PIXELS)
    assert re.search(r"constexpr int kSumPixels = (\d+);", probe).group(1) == str(
        io_probe.SUM_PIXELS)
    assert io_probe.SUM_TILE == TILE_PIXELS * io_probe.SUM_PIXELS
    shared = int(re.search(r"constexpr size_t kMaxSharedBytes = (\d+);", probe).group(1))
    widest = io_probe.SUM_MAX_CHANNELS
    assert io_probe.SUM_TILE * widest * 4 + 8 <= shared < io_probe.SUM_TILE * (widest + 1) * 4 + 8


# -- the null forward against the Pallas probe, the counts -----------------------


def _load(relative: str):
    path = _REPO / relative
    name = "_probe_" + path.stem
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def test_null_forward_body_matches_the_pallas_staged_probe(monkeypatch):
    """The walk with the kernel's body at a ragged pixel count (3 * 2 * 9 * 9
    = 486, no multiple of the 128-pixel tile) against ``make_variant(fwd_tr,
    bwd_tr)`` in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    script = _load("scripts/kernel_structure_probe.py")
    rng = np.random.default_rng(5)
    x = rng.random((2, 9, 9, 3)).astype(np.float32)
    p = rng.standard_normal((3, 2, 9, 9, 50)).astype(np.float32)
    want = script.make_variant(script.fwd_tr, script.bwd_tr)(jnp.asarray(x), jnp.asarray(p))
    rows, images = torch.from_numpy(p).reshape(-1, 50), _images(torch.from_numpy(x), 3)
    got, writes = _read_walk(486, 1, 4, lambda i: _in_order(rows[i]) + (
        (images[i][:, 0] + images[i][:, 1]) + images[i][:, 2]))
    assert (writes == 1).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1), **SUM_TOL)


def test_null_forward_counts_by_path_and_the_probe_resets_them():
    x = torch.rand((2, 4, 4, 3))
    p = torch.randn((3, 2, 4, 4, 50))
    before = mdl_null.launches, dict(mdl_null.launches_by_path)
    got = mdl_null.mdl_null_forward(x, p, "staged")  # the plain version on the CPU
    assert torch.equal(got, mdl_null.mdl_null_forward_plain(x, p))
    assert (mdl_null.launches, mdl_null.launches_by_path) == before
    assert set(mdl_null.launches_by_path) == set(mdl_kernel.PATHS)
    mdl_null.launches_by_path["tiled"] = 3
    mdl_null.backward_launches_by_path["direct"] = 2
    kernel_structure.reset_counts()
    assert mdl_null.launches_by_path == mdl_null.backward_launches_by_path == dict.fromkeys(
        mdl_kernel.PATHS, 0)

