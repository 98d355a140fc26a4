"""Memory paths of a channel-minor read: direct against staged.

Port of ``scripts/kernel_isolate.py``: the per-pixel channel sum of a
``[K, P, C]`` float32 tensor (K = 100 samples, P = 100 * 32 * 32 pixels, C =
50 channels: 2.05 GB) through the two memory paths of
``ops/cuda/io_probe.py``: threads reading their pixel's channels straight
from device memory, as the MoDL kernels do on an NHWC tensor, and tiles of
64, 128 and 256 pixels staged through shared memory with coalesced loads.
Prints each path's time and the bytes read per second against the card's
published memory rate.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.kernel_isolate``.
"""
from __future__ import annotations

from typing import Callable

import torch

from vae_mdl_tpu_torch.ops.cuda import io_probe
from vae_mdl_tpu_torch.utils.flops import device_peaks
from vae_mdl_tpu_torch.utils.timing import cuda_ms

K, P, CH = 100, 100 * 32 * 32, 50
TILES = (64, 128, 256)


def probe_params(layout: str, k: int = K, p: int = P, ch: int = CH) -> torch.Tensor:
    """Seeded standard-normal parameters on the card, made there."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (k, p, ch) if layout == "channel_minor" else (k, ch, p)
    return torch.randn(shape, generator=gen, device="cuda")


def run(reps: int = 5, say: Callable[[str], None] = print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA card; torch.cuda.is_available() is False")
    peak = device_peaks()["bytes_per_s"]
    params = probe_params("channel_minor")
    gb = params.numel() * 4 / 1e9
    out = {}
    out["direct"] = t = cuda_ms(lambda: io_probe.channel_sum(params, path="direct"), reps)
    say(f"direct reads                 {t:9.3f} ms  {gb / t * 1e3:7.0f} GB/s "
        f"({gb / t * 1e12 / peak:.0%} of {peak / 1e12:.2f} TB/s)")
    for tile in TILES:
        out[f"staged tile={tile}"] = t = cuda_ms(
            lambda: io_probe.channel_sum(params, path="staged", tile=tile), reps)
        say(f"staged, tile of {tile:4d} pixels  {t:9.3f} ms  {gb / t * 1e3:7.0f} GB/s "
            f"({gb / t * 1e12 / peak:.0%})")
    out["library sum(-1)"] = t = cuda_ms(lambda: params.sum(-1), reps)
    say(f"library params.sum(-1)       {t:9.3f} ms  {gb / t * 1e3:7.0f} GB/s")
    return out


if __name__ == "__main__":
    run()
