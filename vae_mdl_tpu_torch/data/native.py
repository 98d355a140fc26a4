"""ctypes bindings for the native TFRecord parser (``csrc/io_native.cc``).

Port of ``vae_mdl_tpu/data/native.py`` with the port's own copy of the C++
source. It is compiled with ``g++`` at first use into
``vae_mdl_tpu_torch/_build/io_native-<hash>.so``, the hash taken over the
source and the flags as ``ops/cuda/build.py`` keys its builds, so an edited
source is a new build and nothing is written beside the source. Where the
build fails (no compiler), one stderr line says so and the callers fall back
to the pure-Python parser in ``data/tfrecord.py``, which is the oracle:
``tests/test_torch_data.py`` holds the two equal.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "io_native.cc"
BUILD_DIR = _PACKAGE / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build of the current source with the current flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"io_native-{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except Exception as e:  # no compiler or a failed build: the Python parser
        print(f"[vae_mdl_tpu_torch.data.native] build failed ({e}); using the "
              "pure-Python parser", file=sys.stderr)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        lib.parse_celeba_tfrecord.restype = ctypes.c_long
        lib.parse_celeba_tfrecord.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long,
            ctypes.c_long,
        ]
        lib.count_tfrecords.restype = ctypes.c_long
        lib.count_tfrecords.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def count_records(path: str) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    n = lib.count_tfrecords(path.encode())
    return None if n < 0 else int(n)


def parse_celeba_file(
    path: str, max_side: int = 256
) -> Optional[List[Tuple[np.ndarray, int]]]:
    """Parse one Glow-CelebA TFRecord shard natively.

    Returns ``[(uint8 image [H, W, C], label)]``, or None where the native
    path is unavailable (the caller falls back to ``data.tfrecord``). The
    per-record buffer starts at ``max_side``² (Glow shards are 256x256) and
    doubles on the C core's too-small error.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = lib.count_tfrecords(path.encode())
    if n <= 0:
        return None if n < 0 else []

    got = -5
    while got == -5 and max_side <= 4096:  # -5: record larger than buffer
        img_bytes = max_side * max_side * 3
        imgs = np.empty((n, img_bytes), dtype=np.uint8)
        shapes = np.empty((n, 3), dtype=np.int64)
        labels = np.empty((n,), dtype=np.int64)
        got = lib.parse_celeba_tfrecord(
            path.encode(),
            imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            img_bytes,
        )
        if got == -5:
            max_side *= 2
    if got < 0:
        return None
    out = []
    for i in range(got):
        h, w, c = (int(v) for v in shapes[i])
        out.append((imgs[i, : h * w * c].reshape(h, w, c).copy(), int(labels[i])))
    return out
