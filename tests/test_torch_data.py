"""The port's data layer against the JAX package's: sources, splits, the
epoch streams and their seek, sharding, the bilinear resize, the TFRecord
reader and its checksum, the native parser, and the device prefetch.

Tolerance: none. Every array, batch and parsed record is compared for
equality (the same numpy code on the same seeds on both sides).
"""
import shutil
import struct
import threading

import numpy as np
import pytest
import torch

from tests.test_data import _make_example
from vae_mdl_tpu.data import pipeline as jpipeline
from vae_mdl_tpu.data import sources as jsources
from vae_mdl_tpu.data import tfrecord as jtfrecord
from vae_mdl_tpu_torch.data import native, pipeline, sources, tfrecord

torch.set_num_threads(1)


def _equal_arrays(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("name", ["mnist", "svhn_cropped", "cifar10", "celeba"])
def test_load_synthetic_matches_jax(name):
    shape = sources._SHAPES[name]
    assert shape == jsources._SHAPES[name]
    got = sources.load_synthetic(shape, n_train=64, n_test=16, seed=3)
    want = jsources.load_synthetic(shape, n_train=64, n_test=16, seed=3)
    for split in ("train", "test"):
        _equal_arrays(got[split], want[split])


@pytest.mark.parametrize("dataset", ["synthetic", "synthetic:mnist", "synthetic:svhn_cropped",
                                     "synthetic:cifar10", "synthetic:celeba", "digits",
                                     "svhn_cropped"])
def test_make_splits_match_jax(dataset, tmp_path):
    """The splits of each dataset, the svhn fallback (no files under an
    empty directory) among them, equal to JAX's."""
    if dataset == "digits":
        pytest.importorskip("sklearn")
    got = pipeline.make_splits(dataset, str(tmp_path))
    want = jpipeline.make_splits(dataset, str(tmp_path))
    for split in ("train", "val", "test"):
        _equal_arrays(getattr(got, split), getattr(want, split))
    assert got.image_shape == want.image_shape


def test_load_digits_matches_jax():
    pytest.importorskip("sklearn")
    got, want = sources.load_digits(), jsources.load_digits()
    assert set(got) == set(want) == {"train", "val", "test"}
    for split in got:
        _equal_arrays(got[split], want[split])


def test_strict_refuses_the_fallback(tmp_path, capsys):
    with pytest.raises(FileNotFoundError):
        pipeline.make_splits("mnist", str(tmp_path), allow_synthetic_fallback=False)
    pipeline.make_splits("mnist", str(tmp_path))  # the fallback says so on stderr
    assert "falling back to synthetic" in capsys.readouterr().err


def test_epoch_batches_over_three_epochs_match_jax():
    x = np.random.default_rng(0).integers(0, 256, (22, 2, 2, 1), dtype=np.uint8)
    arrays = (x, np.zeros(22, np.int32))
    for shuffle in (True, False):
        got = pipeline.epoch_batches(arrays, 4, seed=5, shuffle=shuffle)
        want = jpipeline.epoch_batches(arrays, 4, seed=5, shuffle=shuffle)
        for _ in range(3 * 5):  # 5 batches an epoch
            np.testing.assert_array_equal(next(got), next(want))


@pytest.mark.parametrize("start_step", [0, 7, 63, 200])
def test_epoch_batches_seek_matches_jax(start_step):
    x = np.random.default_rng(1).integers(0, 256, (50, 2, 2, 1), dtype=np.uint8)
    arrays = (x, np.zeros(50, np.int32))
    got = pipeline.epoch_batches(arrays, 8, seed=9, start_step=start_step)
    want = jpipeline.epoch_batches(arrays, 8, seed=9, start_step=start_step)
    plain = pipeline.epoch_batches(arrays, 8, seed=9)
    for _ in range(start_step):
        next(plain)
    for _ in range(8):  # crosses an epoch boundary (6 batches an epoch)
        batch = next(got)
        np.testing.assert_array_equal(batch, next(want))
        np.testing.assert_array_equal(batch, next(plain))


def test_epoch_batches_refuses_a_batch_larger_than_the_split():
    with pytest.raises(ValueError, match="exceeds the split size"):
        next(pipeline.epoch_batches((np.zeros((3, 1, 1, 1), np.uint8), np.zeros(3)), 4, 0))


def test_iterators_from_splits_match_jax():
    splits = pipeline.make_splits("synthetic:mnist")
    got = pipeline.iterators_from_splits(splits, 16, 700, seed=4, start_step=130)
    want = jpipeline.iterators_from_splits(jpipeline.make_splits("synthetic:mnist"), 16, 700,
                                           seed=4, start_step=130)
    for _ in range(3):
        np.testing.assert_array_equal(next(got[0]), next(want[0]))
        val = next(got[1])
        assert val.shape[0] == 512  # the whole 512-image split, one batch
        np.testing.assert_array_equal(val, next(want[1]))
    _equal_arrays(got[2], want[2])


def test_shard_arrays_match_jax():
    x = np.arange(10, dtype=np.uint8).reshape(10, 1, 1, 1)
    y = np.arange(10, dtype=np.int32)
    for count in (1, 3, 4):
        for index in range(count):
            _equal_arrays(pipeline.shard_arrays((x, y), index, count),
                          jpipeline.shard_arrays((x, y), index, count))


@pytest.mark.parametrize("shape", [(256, 256, 3), (100, 80, 3), (6, 5, 3)])
def test_resize_bilinear_matches_jax(shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(sources._resize_bilinear(img, 64),
                                  jsources._resize_bilinear(img, 64))


def _write_shard(path, records, crc=True):
    with open(path, "wb") as f:
        for record in records:
            header = struct.pack("<Q", len(record))
            f.write(header)
            f.write(struct.pack("<I", tfrecord.masked_crc(header)) if crc else b"\x00" * 4)
            f.write(record)
            f.write(struct.pack("<I", tfrecord.masked_crc(record)) if crc else b"\x00" * 4)


def _examples(n=7, seed=1):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (6, 5, 3), dtype=np.uint8) for _ in range(n)]
    return imgs, [_make_example(list(img.shape), img.tobytes(), 100 + i)
                  for i, img in enumerate(imgs)]


def test_tfrecord_round_trip_and_crc_match_jax(tmp_path):
    """Records framed with the port's masked CRC-32C pass both packages'
    verifying readers and parse to the same Examples; one flipped payload
    byte fails both."""
    imgs, records = _examples()
    path = str(tmp_path / "shard.tfrecords")
    _write_shard(path, records)
    for data in (b"", b"a", b"hello tfrecord", bytes(range(256))):
        assert tfrecord.masked_crc(data) == jtfrecord.masked_crc(data)
    got = list(tfrecord.read_records(path, verify_crc=True))
    assert got == list(jtfrecord.read_records(path, verify_crc=True)) == records
    for i, record in enumerate(got):
        ex, jex = tfrecord.parse_example(record), jtfrecord.parse_example(record)
        assert sorted(ex) == sorted(jex) == ["data", "label", "shape"]
        np.testing.assert_array_equal(ex["shape"], jex["shape"])
        assert ex["data"] == jex["data"] == [imgs[i].tobytes()]
        assert int(ex["label"][0]) == 100 + i

    blob = bytearray(open(path, "rb").read())
    blob[14] ^= 0xFF  # a payload byte of the first record
    bad = str(tmp_path / "bad.tfrecords")
    open(bad, "wb").write(bytes(blob))
    for reader in (tfrecord.read_records, jtfrecord.read_records):
        with pytest.raises(ValueError, match="checksum"):
            list(reader(bad, verify_crc=True))
        assert len(list(reader(bad))) == 7


def test_load_celeba_matches_jax(tmp_path):
    """Glow-layout shards through both packages' loaders (native or Python
    parser, then the resize)."""
    for split, seed in (("train", 1), ("validation", 2)):
        (tmp_path / "celeba-tfr" / split).mkdir(parents=True)
        _write_shard(str(tmp_path / "celeba-tfr" / split / "0.tfrecords"),
                     _examples(seed=seed)[1])
    got = sources.load_celeba(str(tmp_path), size=8)
    want = jsources.load_celeba(str(tmp_path), size=8)
    for split in ("train", "validation"):
        assert got[split][0].shape == (7, 8, 8, 3)
        _equal_arrays(got[split], want[split])


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain available")
    lib = native.get_lib()
    assert lib is not None, "g++ is here and the native parser did not build"
    return lib


def test_native_parser_matches_python_parser(lib, tmp_path):
    imgs, records = _examples()
    path = str(tmp_path / "shard.tfrecords")
    _write_shard(path, records, crc=False)
    assert native.count_records(path) == 7
    got = native.parse_celeba_file(path)
    assert got is not None and len(got) == 7
    for (img, label), record, want in zip(got, tfrecord.read_records(path), imgs):
        ex = tfrecord.parse_example(record)
        ref = np.frombuffer(ex["data"][0], np.uint8).reshape([int(v) for v in ex["shape"]])
        np.testing.assert_array_equal(img, ref)
        np.testing.assert_array_equal(img, want)
        assert label == int(ex["label"][0])
    assert native.count_records(str(tmp_path / "missing")) is None
    assert native.parse_celeba_file(str(tmp_path / "missing")) is None


def test_native_build_is_keyed_and_stays_in_the_port(lib):
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "vae_mdl_tpu_torch"
    assert native.SOURCE.parent.name == "csrc"


def test_device_prefetch_raises_a_producer_error_in_the_consumer():
    def bad_source():
        yield np.zeros((2, 2), np.uint8)
        raise RuntimeError("disk on fire")

    stream = pipeline.device_prefetch(bad_source(), size=2, device="cpu")
    first = next(stream)
    assert isinstance(first, torch.Tensor) and first.device.type == "cpu"
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(stream)


def test_device_prefetch_yields_the_batches_in_order_and_stops_on_close():
    batches = [np.full((2, 3), i, np.uint8) for i in range(5)]
    stream = pipeline.device_prefetch(iter(batches), size=2, device="cpu")
    assert [int(b[0, 0]) for b in stream] == list(range(5))
    with pytest.raises(StopIteration):
        next(stream)

    def endless():
        i = 0
        while True:
            yield np.full((1,), i % 256, np.uint8)
            i += 1

    stream = pipeline.device_prefetch(endless(), size=2, device="cpu")
    next(stream)
    stream.close()
    assert not stream._thread.is_alive()
    with pytest.raises(StopIteration):
        next(stream)
    # a stream dropped without close() stops its producer when collected
    stream = pipeline.device_prefetch(endless(), size=2, device="cpu")
    thread = stream._thread
    del stream
    thread.join(timeout=5)
    assert not thread.is_alive()
    assert all(t.is_alive() for t in threading.enumerate())


def test_device_prefetch_uses_put_as_given():
    stream = pipeline.device_prefetch(iter([np.ones(2), np.zeros(2)]), put=lambda b: ("put", b),
                                      device="cpu")
    tags = [item[0] for item in stream]
    assert tags == ["put", "put"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_device_prefetch_runs_on_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.device_prefetch(iter([np.zeros(2)]))
