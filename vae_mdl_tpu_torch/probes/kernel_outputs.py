"""The likelihood kernels' outputs on seeded inputs, written to a file or
held against such a file bit for bit.

How a change to the CUDA sources is shown to leave a kernel's results as they
were: run ``write`` on a checkout of the old sources and ``compare`` on the
new ones, on the same card. The inputs come from numpy seeds, so two
checkouts see the same values: the MoDL forward and backward and the
discretized-logistic forward and backward, each at the model's train shape
(k = 5, batch 128, 32 x 32) in float32 and, for the MoDL, bfloat16, in the
channel-minor layout the model hands on and in NCHW. Only the public wrappers
are called, so the module runs against any checkout that has them.

Run on a CUDA card:

    python -m vae_mdl_tpu_torch.probes.kernel_outputs write outputs.pt
    python -m vae_mdl_tpu_torch.probes.kernel_outputs compare outputs.pt

``compare`` prints one line a kernel and case and exits with code 1 if any
output differs.
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from vae_mdl_tpu_torch.ops.cuda import dl_kernel, mdl_kernel

K, BATCH, SIDE, N_MIX = 5, 128, 32, 5


def _nchw(p: torch.Tensor) -> torch.Tensor:
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def outputs(device: str = "cuda", k: int = K, batch: int = BATCH,
            side: int = SIDE) -> Dict[str, torch.Tensor]:
    """``{kernel and case: output}``, brought to the CPU. On CPU tensors the
    wrappers take their plain versions."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (batch, side, side, 3)).astype(np.float32) / 255.0
    x[:, 0] = 0.0
    x[:, -1] = 1.0
    lead = (k, batch, side, side)
    p = (rng.standard_normal(lead + (10 * N_MIX,)) * 2.0).astype(np.float32)
    p[..., 2 * N_MIX:3 * N_MIX] -= 4.0  # red logscales towards the clamp
    p[..., 3 * N_MIX:4 * N_MIX] += 5.0 * (rng.random(lead + (N_MIX,)) < 0.2)  # far locations
    g = rng.standard_normal(lead + (1,)).astype(np.float32)
    loc = (0.5 + 0.3 * rng.standard_normal(lead + (3,))).astype(np.float32)
    loc += 2.0 * (rng.random(loc.shape) < 0.2)
    logscale = (rng.standard_normal(lead + (3,)) * 1.5 - 3.0).astype(np.float32)
    x, p, g, loc, logscale = (torch.from_numpy(a).to(device) for a in (x, p, g, loc, logscale))

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("nhwc", "nchw"):
            params = p.to(dtype)
            params = _nchw(params) if layout == "nchw" else params
            tag = f"{str(dtype).split('.')[1]} {layout}"
            out[f"mdl_log_prob {tag}"] = mdl_kernel.mdl_log_prob(x, params)
            # the gradient in the layout's own memory order, then made dense
            out[f"mdl_log_prob_backward {tag}"] = mdl_kernel.mdl_backward(x, params, g).contiguous()
    bin_ = (0.0, 1.0, 1.0 / 255.0)
    out["dl_log_prob float32"] = dl_kernel.dl_log_prob(x, loc, logscale, *bin_)
    d_loc, d_ls = dl_kernel.dl_backward(x, loc, logscale, g.expand(loc.shape), *bin_)
    out["dl_log_prob_backward float32 d_loc"] = d_loc
    out["dl_log_prob_backward float32 d_logscale"] = d_ls
    return {name: t.cpu() for name, t in out.items()}


def main(argv) -> int:
    if len(argv) != 3 or argv[1] not in ("write", "compare"):
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        raise RuntimeError("the kernels run on a CUDA card; torch.cuda.is_available() is False")
    got = outputs()
    if argv[1] == "write":
        torch.save(got, argv[2])
        print(f"wrote {len(got)} outputs to {argv[2]}")
        return 0
    want = torch.load(argv[2])
    differing = 0
    for name in sorted(set(got) | set(want)):
        if name not in got or name not in want:
            print(f"{name}: only in {'this run' if name in got else 'the file'}")
            differing += 1
            continue
        equal = got[name].shape == want[name].shape and torch.equal(got[name], want[name])
        worst = "" if equal else (f", max |d| "
                                  f"{float((got[name].float() - want[name].float()).abs().max()):.3e}")
        print(f"{name}: {'equal bit for bit' if equal else 'DIFFERS'}{worst} "
              f"({got[name].numel()} elements)")
        differing += not equal
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
