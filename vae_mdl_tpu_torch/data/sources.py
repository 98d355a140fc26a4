"""Dataset sources: raw numpy uint8 arrays from local files.

Port of ``vae_mdl_tpu/data/sources.py`` (numpy, with scipy for SVHN's .mat
files and scikit-learn for ``digits``, each imported by its loader only).
Images stay uint8 on the host; dequantisation and binarisation run on the
device inside the train step (``data/preprocess.py``).

Supported file layouts under ``data_dir``:
  mnist        : train-images-idx3-ubyte[.gz], t10k-images-idx3-ubyte[.gz] (IDX)
  svhn_cropped : train_32x32.mat, test_32x32.mat, extra_32x32.mat (optional)
  cifar10      : cifar-10-batches-py/data_batch_1..5, test_batch (pickle)
  celeba       : celeba-tfr/{train,validation}/*.tfrecords (OpenAI Glow shards,
                 read by the native parser or the pure-Python one)
  synthetic    : no files: deterministic random images for tests and
                 benchmarks; ``synthetic:<name>`` has ``<name>``'s shape.

If the files for a named dataset are absent, loading falls back to a
deterministic synthetic set of the right shape and says so on stderr, as the
JAX package does; ``strict`` (``allow_synthetic_fallback=False``) refuses.
This is a data fallback: the device the data goes to is not affected.
"""
from __future__ import annotations

import glob
import gzip
import os
import pickle
import struct
import sys
from typing import Dict, Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]  # (images uint8 [N,H,W,C], labels int32 [N])

_SHAPES = {
    "mnist": (28, 28, 1),
    "svhn_cropped": (32, 32, 3),
    "cifar10": (32, 32, 3),
    "celeba": (64, 64, 3),
}


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _find(data_dir: str, names) -> Optional[str]:
    for name in names:
        for cand in (os.path.join(data_dir, name), os.path.join(data_dir, name + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _read_idx(path: str) -> np.ndarray:
    """IDX format: magic(2 zero bytes, dtype byte, ndim byte), dims, data."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(data_dir: str) -> Dict[str, Arrays]:
    train_x = _find(data_dir, ["train-images-idx3-ubyte", "train-images.idx3-ubyte"])
    test_x = _find(data_dir, ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
    if train_x is None or test_x is None:
        raise FileNotFoundError("mnist IDX files not found")
    train_y = _find(data_dir, ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"])
    test_y = _find(data_dir, ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])

    def labels(path, n):
        return (_read_idx(path).astype(np.int32) if path else np.zeros(n, np.int32))

    xtr = _read_idx(train_x)[..., None]
    xte = _read_idx(test_x)[..., None]
    return {
        "train": (xtr, labels(train_y, len(xtr))),
        "test": (xte, labels(test_y, len(xte))),
    }


def load_svhn(data_dir: str) -> Dict[str, Arrays]:
    from scipy.io import loadmat

    out: Dict[str, Arrays] = {}
    for split in ("train", "test", "extra"):
        path = os.path.join(data_dir, f"{split}_32x32.mat")
        if not os.path.exists(path):
            if split == "extra":
                continue
            raise FileNotFoundError(f"svhn file missing: {path}")
        mat = loadmat(path)
        x = np.transpose(mat["X"], (3, 0, 1, 2)).astype(np.uint8)
        y = mat["y"].reshape(-1).astype(np.int32) % 10
        out[split] = (x, y)
    return out


def load_cifar10(data_dir: str) -> Dict[str, Arrays]:
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = data_dir

    def read_batch(path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.uint8)
        y = np.asarray(d[b"labels"], dtype=np.int32)
        return x, y

    train_paths = sorted(glob.glob(os.path.join(base, "data_batch_*")))
    test_path = os.path.join(base, "test_batch")
    if not train_paths or not os.path.exists(test_path):
        raise FileNotFoundError("cifar10 pickle batches not found")
    xs, ys = zip(*(read_batch(p) for p in train_paths))
    return {
        "train": (np.concatenate(xs), np.concatenate(ys)),
        "test": read_batch(test_path),
    }


def load_celeba(data_dir: str, size: int = 64) -> Dict[str, Arrays]:
    """OpenAI Glow TFRecord shards; images resized to 64x64. The random
    horizontal flip runs on the device inside the train step
    (``DataConfig.augment_flip``), never at load time."""
    from vae_mdl_tpu_torch.data import native
    from vae_mdl_tpu_torch.data.tfrecord import parse_example, read_records

    def parse_file(path):
        fast = native.parse_celeba_file(path)  # C++ core; None -> fallback
        if fast is not None:
            return fast
        out = []
        for record in read_records(path):
            ex = parse_example(record)
            shape = ex["shape"]
            img = np.frombuffer(ex["data"][0], np.uint8).reshape(
                int(shape[0]), int(shape[1]), int(shape[2])
            )
            out.append((img, int(ex["label"][0])))
        return out

    out: Dict[str, Arrays] = {}
    for split in ("train", "validation"):
        files = sorted(glob.glob(os.path.join(data_dir, "celeba-tfr", split, "*")))
        if not files:
            raise FileNotFoundError(f"celeba shards not found for split {split}")
        imgs, labels = [], []
        for path in files:
            for img, label in parse_file(path):
                if img.shape[0] != size:
                    img = _resize_bilinear(img, size)
                imgs.append(img)
                labels.append(label)
        out[split] = (np.stack(imgs), np.asarray(labels, np.int32))
    return out


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize with half-pixel centers, no antialias (the semantics
    of ``tf.image.resize``'s default), rounded back to uint8: host arrays
    stay uint8 and dequantisation happens on the device, which quantises the
    interpolated values by at most half a level."""
    h, w = img.shape[:2]

    def axis(n_in: int):
        c = (np.arange(size, dtype=np.float64) + 0.5) * (n_in / size) - 0.5
        c = np.clip(c, 0.0, n_in - 1)
        lo = np.floor(c).astype(np.int32)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (c - lo).astype(np.float32)

    rlo, rhi, rf = axis(h)
    clo, chi, cf = axis(w)
    x = img.astype(np.float32)
    cf = cf[None, :, None]
    top = x[rlo][:, clo] * (1 - cf) + x[rlo][:, chi] * cf
    bot = x[rhi][:, clo] * (1 - cf) + x[rhi][:, chi] * cf
    rf = rf[:, None, None]
    res = top * (1 - rf) + bot * rf
    return np.round(res).clip(0, 255).astype(np.uint8)


def load_digits() -> Dict[str, Arrays]:
    """scikit-learn's bundled 8x8 handwritten-digits set (1797 images), a
    real image dataset that needs no download; upscaled to 16x16 so
    stride-2 conv stacks have room."""
    from sklearn.datasets import load_digits as _ld

    d = _ld()
    imgs = (d.images / 16.0 * 255.0).astype(np.uint8)[..., None]
    imgs = np.repeat(np.repeat(imgs, 2, axis=1), 2, axis=2)  # 8x8 -> 16x16
    labels = d.target.astype(np.int32)
    # three disjoint slices: "best"-checkpoint selection runs on val, so the
    # test images are never seen before the last evaluation
    n_train, n_val = 1400, 197
    return {
        "train": (imgs[:n_train], labels[:n_train]),
        "val": (imgs[n_train:n_train + n_val], labels[n_train:n_train + n_val]),
        "test": (imgs[n_train + n_val:], labels[n_train + n_val:]),
    }


def load_synthetic(
    image_shape: Tuple[int, int, int],
    n_train: int = 2048,
    n_test: int = 512,
    seed: int = 0,
) -> Dict[str, Arrays]:
    """Deterministic low-entropy images: smooth random blobs quantised to
    uint8 (pure noise would make the likelihood meaningless)."""
    def make(n, s):
        rng = np.random.default_rng(s)
        h, w, c = image_shape
        base = rng.normal(size=(n, 4, 4, c))
        up = np.repeat(np.repeat(base, (h + 3) // 4, axis=1), (w + 3) // 4, axis=2)
        up = up[:, :h, :w, :]
        up = (up - up.min()) / (up.max() - up.min() + 1e-9)
        return (up * 255).astype(np.uint8), rng.integers(0, 10, n).astype(np.int32)

    return {"train": make(n_train, seed), "test": make(n_test, seed + 1)}


def load_dataset(
    dataset: str,
    data_dir: Optional[str] = None,
    allow_synthetic_fallback: bool = True,
) -> Dict[str, Arrays]:
    """Load raw splits for a named dataset (the split policy lives in
    ``pipeline.make_splits``)."""
    data_dir = data_dir or os.environ.get("VAE_MDL_DATA_DIR", "/tmp/nsbi/data")
    loaders = {
        "mnist": load_mnist,
        "svhn_cropped": load_svhn,
        "cifar10": load_cifar10,
        "celeba": load_celeba,
    }
    if dataset == "digits":
        return load_digits()
    if dataset == "synthetic":
        return load_synthetic((32, 32, 3))
    if dataset.startswith("synthetic:"):  # synthetic:mnist etc.
        return load_synthetic(_SHAPES[dataset.split(":", 1)[1]])
    try:
        return loaders[dataset](data_dir)
    except FileNotFoundError as e:
        if not allow_synthetic_fallback:
            raise
        print(
            f"[vae_mdl_tpu_torch.data] {e}; falling back to synthetic "
            f"{_SHAPES[dataset]} data",
            file=sys.stderr,
        )
        return load_synthetic(_SHAPES[dataset])
