"""How far the float32 gradients of the tensor-parallel layout's sharded
layers sit from float64, by the number of slices.

Under ``parallel/tensor.py`` each ``model`` rank runs a sharded layer on its
share of the output channels, and the ranks' input gradients are summed. For
each layer of the model that ``tp_state_sharding`` shards, the probe takes
the layer's own input and output gradient from one training step on seeded
weights, images and noise, recomputes the layer's input and weight gradients
slice by slice for 1, 2 and 4 slices of its output channels, as that many
ranks would, in float32 with cuDNN's deterministic algorithms and no TF32,
and reports each result's relative error in norm against the same
computation in float64. A slice count whose error stands far above one
slice's names a layer whose narrower shape makes the library pick a less
exact algorithm; every gradient upstream of it carries that error.

Run on a CUDA card: ``python -m vae_mdl_tpu_torch.probes.tp_precision``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from vae_mdl_tpu_torch.config import ExperimentConfig
from vae_mdl_tpu_torch.models.vae import build_model, latent_shapes
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.nn.blocks import Dense
from vae_mdl_tpu_torch.parallel.tensor import _tp_specs
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step


@contextlib.contextmanager
def _exact_float32():
    """cuDNN's deterministic algorithms, no TF32; the flags put back after."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags


def _layer_tensors(model, cfg: ExperimentConfig, owners: Sequence[str], batch: int,
                   device: str) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{layer: (its input, its output's gradient)} from one training step."""
    modules = dict(model.named_modules())
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen[name] = [args[0].detach(), None]
            out.register_hook(lambda g: seen[name].__setitem__(1, g.detach()))
        return hook

    handles = [modules[name].register_forward_hook(record(name)) for name in owners]
    images = np.random.default_rng(0).integers(
        0, 256, (batch,) + tuple(cfg.model.image_shape), dtype=np.uint8)
    gen = torch.Generator(device=device).manual_seed(0)
    eps = [torch.randn((cfg.model.n_samples, batch) + shape, generator=gen, device=device)
           for shape in latent_shapes(cfg.model)]
    tx = make_optimizer(cfg.train)
    state = create_train_state(model, cfg.train)
    try:
        make_train_step(model, cfg, tx)(state, torch.as_tensor(images, device=device),
                                        eps=eps[0] if len(eps) == 1 else eps)
    finally:
        for handle in handles:
            handle.remove()
    return {name: tuple(seen[name]) for name in owners}


def _sliced_grads(layer, x, g, out_dim: int, n: int, dtype: torch.dtype):
    """The layer's input gradient summed over ``n`` slices of its output
    channels (in slice order) and its weight gradient, the slices joined."""
    x = x.to(dtype).requires_grad_(True)
    w, b = layer.weight.detach().to(dtype), layer.bias.detach().to(dtype)
    g_dim = -1 if isinstance(layer, Dense) else 1  # [..., F] or NCHW
    dx, dws = torch.zeros_like(x), []
    for ws, bs, gs in zip(w.chunk(n, out_dim), b.chunk(n, 0), g.to(dtype).chunk(n, g_dim)):
        ws = ws.clone().requires_grad_(True)
        y = functional_call(layer, {"weight": ws, "bias": bs}, (x, dtype))
        gs = gs.contiguous(memory_format=torch.channels_last) if gs.dim() == 4 else \
            gs.contiguous()
        gx, gw = torch.autograd.grad(y, (x, ws), gs)
        dx = dx + gx
        dws.append(gw)
    return dx, torch.cat(dws, out_dim)


def run(cfg: Optional[ExperimentConfig] = None, slices: Sequence[int] = (1, 2, 4),
        batch: int = 128, min_features: int = 64, device: Optional[str] = None,
        say: Callable[[str], None] = print) -> Dict[str, Dict[int, Tuple[float, float]]]:
    """-> {layer: {slices: (input-gradient error, weight-gradient error)}}
    for ``cfg`` (model05's experiment by default) at ``batch`` rows; on the
    card unless ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the probe measures a CUDA card; torch.cuda.is_available() "
                               "is False (pass device='cpu' for the CPU)")
        device = "cuda"
    cfg = cfg or experiment("model05")
    model = build_model(cfg.model, torch.Generator().manual_seed(0), device=device)
    specs = _tp_specs(dict(model.named_parameters()), model, max(slices), min_features)
    owners = sorted({name.rpartition(".")[0] for name, spec in specs.items() if spec})
    modules = dict(model.named_modules())
    with _exact_float32():
        tensors = _layer_tensors(model, cfg, owners, batch, device)
        out = {}
        for name in owners:
            layer, (x, g) = modules[name], tensors[name]
            out_dim = specs[f"{name}.weight"].index("model")
            dx64, dw64 = _sliced_grads(layer, x, g, out_dim, 1, torch.float64)
            out[name] = {}
            for n in slices:
                dx, dw = _sliced_grads(layer, x, g, out_dim, n, torch.float32)
                out[name][n] = tuple(float((a.double() - b).norm() / b.norm())
                                     for a, b in ((dx, dx64), (dw, dw64)))
            say(f"{name:18s} {str(tuple(layer.weight.shape)):18s} " + "  ".join(
                f"{n} slices: dx {e[0]:.2e} dw {e[1]:.2e}" for n, e in out[name].items()))
    return out


if __name__ == "__main__":
    print(torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no CUDA card")
    run()
