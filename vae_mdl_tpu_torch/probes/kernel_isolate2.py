"""Memory path of a channel-first read, and what a transpose costs.

Port of ``scripts/kernel_isolate2.py``: the per-pixel channel sum of a
channel-first ``[K, C, P]`` float32 tensor (100 x 50 x 102400: 2.05 GB),
whose rows are pixel-contiguous, so neighbouring threads of
``ops/cuda/io_probe.py``'s direct path read neighbouring addresses, as the
MoDL kernels do on the head conv's NCHW output (the vec4 kernel: 16-byte
loads, a warp walking 2 KB of each row), timed in turns with the library's
``sum(1)``; and beside it the library's
transpose of the channel-minor tensor into that layout (a PyTorch copy, as
it was an XLA op in the JAX script), alone and followed by the sum.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.kernel_isolate2``.
"""
from __future__ import annotations

from typing import Callable

import torch

from vae_mdl_tpu_torch.ops.cuda import io_probe
from vae_mdl_tpu_torch.probes.kernel_isolate import probe_params
from vae_mdl_tpu_torch.utils.flops import device_peaks
from vae_mdl_tpu_torch.utils.timing import cuda_ms, in_turns


def run(reps: int = 5, say: Callable[[str], None] = print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA card; torch.cuda.is_available() is False")
    peak = device_peaks()["bytes_per_s"]
    params_t = probe_params("channel_first")
    gb = params_t.numel() * 4 / 1e9
    # the kernel the wrapper picks (vec4 here) and the library's sum, in
    # turns in one stretch, after a turn of each that is not counted: a
    # process's first passes over a fresh 2 GB tensor run slow
    fns = {"channel-first direct": lambda: io_probe.channel_sum(params_t, layout="channel_first"),
           "library sum(1)": lambda: params_t.sum(1)}
    in_turns(fns, tuple(fns), reps)
    out = in_turns(fns, ("channel-first direct", "library sum(1)", "library sum(1)",
                         "channel-first direct") * 2, reps)
    kernel = io_probe.direct_kernel(params_t, "channel_first")
    for label, what in (("channel-first direct", f"channel-first direct ({kernel})"),
                        ("library sum(1)", "library params.sum(1)")):
        t = out[label]
        say(f"{what:35s} {t:9.3f} ms  {gb / t * 1e3:7.0f} GB/s "
            f"({gb / t * 1e12 / peak:.0%} of {peak / 1e12:.2f} TB/s)")
    del params_t

    params = probe_params("channel_minor")
    out["library transpose"] = t = cuda_ms(lambda: params.transpose(-1, -2).contiguous(), reps)
    say(f"library transpose NHWC->CF          {t:9.3f} ms  {2 * gb / t * 1e3:7.0f} GB/s "
        f"read + written")
    out["library transpose + reduce"] = t = cuda_ms(
        lambda: params.transpose(-1, -2).contiguous().sum(dim=(1, 2)), reps)
    say(f"library transpose + reduce          {t:9.3f} ms")
    return out


if __name__ == "__main__":
    run()
