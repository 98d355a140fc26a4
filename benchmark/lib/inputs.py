"""What a run feeds both sides, made from ``--seed``: the image pools, the
batch streams and the weights.

The images follow the recipe of the program's synthetic source (smooth
random blobs, each a 4x4 grid of normals repeated up to the image's size,
scaled by the pool's range and quantised to uint8), frozen here so that the
benchmark makes its own inputs: pure noise would make the likelihood
meaningless.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed; ``tags`` are ints or
    names."""
    words = [seed % 2 ** 63] + [t if isinstance(t, int) else
                                int.from_bytes(str(t).encode()[:8].ljust(8, b"\0"), "little")
                                for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def image_pool(seed: int, n: int, shape: Sequence[int]) -> np.ndarray:
    """``n`` uint8 images ``[n, H, W, C]``: 4x4 grids of normals repeated up
    to the image's size, scaled by the pool's range."""
    h, w, c = shape
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 4, 4, c)).astype(np.float32)
    up = np.repeat(np.repeat(base, (h + 3) // 4, axis=1), (w + 3) // 4, axis=2)[:, :h, :w, :]
    lo, hi = up.min(), up.max()
    return ((up - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)


class Batches:
    """Batches of ``batch`` rows of ``pool``, an epoch at a time in an order
    drawn from ``seed``: no row repeats within an epoch. Keeps the first
    ``keep`` batches it yields."""

    def __init__(self, pool: np.ndarray, batch: int, seed: int, keep: int = 0):
        if batch > len(pool):
            raise ValueError(f"a batch of {batch} from a pool of {len(pool)}")
        self.pool, self.batch, self.keep = pool, batch, keep
        self.rng = np.random.default_rng(seed)
        self.kept: List[np.ndarray] = []
        self.yielded = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        per_epoch = len(self.pool) // self.batch
        at = self.yielded % per_epoch
        if at == 0:
            self.order = self.rng.permutation(len(self.pool))
        out = self.pool[self.order[at * self.batch:(at + 1) * self.batch]]
        self.yielded += 1
        if len(self.kept) < self.keep:
            self.kept.append(out.copy())
        return out


class Repeat:
    """The same batch every time: a validation set of one batch."""

    def __init__(self, batch: np.ndarray):
        self.batch = batch

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self.batch


def make_weights(spec, seed: int, device, init: Dict[str, dict] = None) -> Dict[str, torch.Tensor]:
    """Float32 weights for ``spec`` (``(name, shape, kind, fan_in,
    fan_out)``), one uniform draw on ``device`` cut into leaves: a kernel
    glorot-uniform (U(-l, l), l = sqrt(6 / (fan_in + fan_out))), a bias
    U(-0.1, 0.1), a rezero gate U(0.1, 0.3), so that every branch carries
    signal and gradient from the first step. ``init`` (a configuration's)
    adds ``{"add": value, "channels": [...]}`` to the named leaves' entries."""
    sizes = [math.prod(shape) for _, shape, *_ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for (name, shape, kind, fan_in, fan_out), size in zip(spec, sizes):
        u = flat[at:at + size].view(shape)
        at += size
        if kind == "kernel":
            out[name] = u * math.sqrt(6.0 / (fan_in + fan_out))
        elif kind == "bias":
            out[name] = u * 0.1
        elif kind == "gate":
            out[name] = u * 0.1 + 0.2
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
    for name, rule in (init or {}).items():
        out[name][rule["channels"]] += rule["add"]
    return out
