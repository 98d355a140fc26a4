"""Train -> export -> serve, as two decoupled processes.

The port's twin of ``examples/serve_model.py``: the trained model ships as
one ``torch.export`` program (``.pt2``, the weights in it), and the server
is a separate process that imports torch alone, never this package. The
program takes its randomness as inputs; the server reads their names, shapes
and kinds from the file's ``noise.json`` and draws them itself. Run on the
card:

    python -m vae_mdl_tpu_torch.examples.serve_model

or on the CPU with ``main(device="cpu")``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile

import torch


def trainer_process(artifact: str, device=None) -> None:
    """The training side: fit briefly, then export the sampler."""
    from vae_mdl_tpu_torch.config import DataConfig
    from vae_mdl_tpu_torch.models.export import export_sampler
    from vae_mdl_tpu_torch.models.zoo import experiment
    from vae_mdl_tpu_torch.train.trainer import Trainer

    cfg = experiment("model01")
    root = os.path.dirname(artifact)
    cfg = dataclasses.replace(
        cfg,
        data=DataConfig(dataset="synthetic:mnist", batch_size=32),
        train=dataclasses.replace(cfg.train, n_updates=50, eval_interval=25,
                                  checkpoint_dir=os.path.join(root, "ckpt"),
                                  log_dir=os.path.join(root, "tb")),
    )
    trainer = Trainer(cfg, device=device)
    state = trainer.fit(progress=False)
    export_sampler(trainer.model, cfg.model, state.params, n=16, path=artifact)
    print(f"[trainer] exported sampler ({os.path.getsize(artifact)} bytes) to {artifact}")


# The serving side, as a literal script run in its own process: it imports
# torch alone. argv: the program, the device, the seed, an output file.
SERVER = """
import json, sys, torch
from torch.export.passes import move_to_device_pass
path, device, seed, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
extra = {"noise.json": ""}
program = torch.export.load(path, extra_files=extra)
program = move_to_device_pass(program, device).module()
gen = torch.Generator(device=device).manual_seed(seed)
noise = []
for entry in json.loads(extra["noise.json"])["noise"]:
    if entry["kind"] == "normal":
        noise.append(torch.randn(entry["shape"], generator=gen, device=device))
    else:
        u = torch.rand(entry["shape"], generator=gen, device=device)
        noise.append(u.clamp_min_(torch.finfo(torch.float32).tiny))
imgs = program(*noise)
assert not any(m.startswith("vae_mdl_tpu") for m in sys.modules), "the server imported the package"
torch.save(imgs.cpu(), out)
print(f"[server] sampled {tuple(imgs.shape)} {imgs.dtype} images "
      f"(mean pixel {imgs.float().mean().item():.1f})")
"""


def serve(artifact: str, device: str, seed: int, out: str) -> torch.Tensor:
    """Run ``SERVER`` on ``artifact`` in a new process; its images."""
    subprocess.run([sys.executable, "-c", SERVER, artifact, device, str(seed), out],
                   check=True)
    return torch.load(out)


def main(device=None) -> None:
    """``device``: where both sides run (default: the card)."""
    from vae_mdl_tpu_torch.data.pipeline import resolve_device
    from vae_mdl_tpu_torch.models.export import load_exported

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        artifact = os.path.join(d, "model01_sampler.pt2")
        trainer_process(artifact, device)
        served = serve(artifact, str(device), 1, os.path.join(d, "served.pt"))
        # the same program loaded in this process through the library
        imgs = load_exported(artifact, device)(1)
        assert imgs.shape == (16, 28, 28, 1) and imgs.dtype == torch.uint8
        assert torch.equal(imgs.cpu(), served), "the server and load_exported disagree"
        print("[main] in-process load_exported agrees with the server:", tuple(imgs.shape))


if __name__ == "__main__":
    main()
