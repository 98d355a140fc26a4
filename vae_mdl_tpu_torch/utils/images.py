"""Image grids for the trainer's reports: inputs, reconstructions and prior
samples. Port of ``vae_mdl_tpu/utils/images.py`` (numpy only)."""
from __future__ import annotations

import numpy as np


def fill_canvas(images, n: int = 8) -> np.ndarray:
    """The first ``n * n`` images ``[N, H, W, C]`` tiled row by row into one
    ``[n * H, n * W, C]`` canvas; cells past the last image stay 0."""
    images = np.asarray(images)
    _, h, w, c = images.shape
    canvas = np.zeros((n * h, n * w, c), dtype=images.dtype)
    for i in range(n):
        for j in range(n):
            idx = i * n + j
            if idx >= len(images):
                break
            canvas[i * h:(i + 1) * h, j * w:(j + 1) * w] = images[idx]
    return canvas


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Floats in [0, 1] -> uint8, rounded (not truncated); uint8 passes."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def save_png(img: np.ndarray, path: str) -> None:
    """Write an image (float [0, 1] or uint8) to PNG; squeezes mono channels.
    PIL is imported here, not at module import."""
    from PIL import Image

    arr = to_uint8(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)
