"""The likelihood kernels' and the channel sum's outputs on seeded inputs,
written to a file or held against such a file bit for bit.

How a change to the CUDA sources is shown to leave a kernel's results as they
were: run ``write`` on a checkout of the old sources and ``compare`` on the
new ones, on the same card. The inputs come from numpy seeds, so two
checkouts see the same values: the MoDL forward and backward and the
discretized-logistic forward and backward, each at the model's train shape
(k = 5, batch 128, 32 x 32) in float32 and, for the MoDL, bfloat16, in the
channel-minor layout the model hands on and in NCHW; the MoDL forward also at
the eval chunk's k = 100 (batch 16) in both dtypes and both layouts; the
discretized-logistic pair also on the two halves of one dense channel-minor
head ``[k, B, 32, 32, 6]`` (what model03's head hands on: the tile path,
where a checkout has one), the forward at k = 100 (batch 16) too; and the
channel-first channel sum at ``[100, 50, 1024]``. Only the public wrappers
are called with their default paths, so the module runs against any checkout
that has them, and each checkout takes its own paths. Run as a file, this
module uses the package ``PYTHONPATH`` names, so one list of outputs can be
made by two checkouts:

    PYTHONPATH=<old checkout> python vae_mdl_tpu_torch/probes/kernel_outputs.py write old.pt
    PYTHONPATH=. python vae_mdl_tpu_torch/probes/kernel_outputs.py compare old.pt

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

from vae_mdl_tpu_torch.ops.cuda import dl_kernel, io_probe, mdl_kernel

K, BATCH, SIDE, N_MIX = 5, 128, 32, 5
K_EVAL, BATCH_EVAL = 100, 16  # the eval chunk's samples, at a batch that keeps the file small
SUM_SHAPE = (100, 50, 1024)  # channel-first [K, C, P]


def _nchw(p: torch.Tensor) -> torch.Tensor:
    return p.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)


def _modl_params(rng, lead) -> np.ndarray:
    p = rng.standard_normal(lead + (10 * N_MIX,), dtype=np.float32) * 2.0
    p[..., 2 * N_MIX:3 * N_MIX] -= 4.0  # red logscales towards the clamp
    p[..., 3 * N_MIX:4 * N_MIX] += 5.0 * (rng.random(lead + (N_MIX,)) < 0.2)  # far locations
    return p


def outputs(device: str = "cuda", k: int = K, batch: int = BATCH, side: int = SIDE,
            k_eval: int = K_EVAL, batch_eval: int = BATCH_EVAL,
            sum_shape=SUM_SHAPE) -> Dict[str, torch.Tensor]:
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
    p_eval = _modl_params(rng, (k_eval, batch_eval, side, side))
    summed = rng.standard_normal(sum_shape, dtype=np.float32)
    head_eval = np.concatenate([0.5 + 0.3 * rng.standard_normal((k_eval, batch_eval, side, side, 3)),
                                rng.standard_normal((k_eval, batch_eval, side, side, 3)) - 3.0],
                               axis=-1).astype(np.float32)
    x, p, g, loc, logscale, p_eval, summed, head_eval = (
        torch.from_numpy(a).to(device)
        for a in (x, p, g, loc, logscale, p_eval, summed, head_eval))

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("nhwc", "nchw"):
            params = p.to(dtype)
            params = _nchw(params) if layout == "nchw" else params
            tag = f"{str(dtype).split('.')[1]} {layout}"
            out[f"mdl_log_prob {tag}"] = mdl_kernel.mdl_log_prob(x, params)
            # the gradient in the layout's own memory order, then made dense
            out[f"mdl_log_prob_backward {tag}"] = mdl_kernel.mdl_backward(x, params, g).contiguous()
            params = p_eval.to(dtype)
            params = _nchw(params) if layout == "nchw" else params
            out[f"mdl_log_prob k={k_eval} {tag}"] = mdl_kernel.mdl_log_prob(x[:batch_eval], params)
    bin_ = (0.0, 1.0, 1.0 / 255.0)
    out["dl_log_prob float32"] = dl_kernel.dl_log_prob(x, loc, logscale, *bin_)
    d_loc, d_ls = dl_kernel.dl_backward(x, loc, logscale, g.expand(loc.shape), *bin_)
    out["dl_log_prob_backward float32 d_loc"] = d_loc
    out["dl_log_prob_backward float32 d_logscale"] = d_ls
    # the halves of one dense channel-minor head, as model03's head hands them on
    head_loc, head_ls = torch.chunk(torch.cat([loc, logscale], dim=-1), 2, dim=-1)
    out["dl_log_prob float32 head halves"] = dl_kernel.dl_log_prob(x, head_loc, head_ls, *bin_)
    d_loc, d_ls = dl_kernel.dl_backward(x, head_loc, head_ls, g.expand(head_loc.shape), *bin_)
    out["dl_log_prob_backward float32 head halves d_loc"] = d_loc
    out["dl_log_prob_backward float32 head halves d_logscale"] = d_ls
    out[f"dl_log_prob k={k_eval} float32 head halves"] = dl_kernel.dl_log_prob(
        x[:batch_eval], *torch.chunk(head_eval, 2, dim=-1), *bin_)
    out["channel_sum channel_first"] = io_probe.channel_sum(summed, "channel_first")
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
