"""Ahead-of-time export for serving: ``torch.export`` programs in a ``.pt2``.

Port of ``vae_mdl_tpu/models/export.py``. A trained model exports to one
self-contained file: the weights are stored in the program, so a serving
process needs only torch (no import of this package, no config, no
checkpoint):

    from vae_mdl_tpu_torch.models.export import export_sampler, load_exported
    export_sampler(model, cfg.model, params, n=64, path="model05_sampler.pt2")
    # ... in the serving process:
    sample = load_exported("model05_sampler.pt2")
    imgs = sample(0)                               # uint8 [64, H, W, C]

CLI: ``vae-mdl-tpu-torch export <model> --what sampler|reconstructor|encoder``.

A ``torch.Generator`` cannot be an input of an exported program, so every
program takes its randomness as tensors, before the data: the draws that
``models/inference.py`` lists (the prior's normals, each layer's normals,
then the observation's uniforms). Their names, shapes and kinds are saved
beside the program (``extra_files``, ``noise.json``), and ``load_exported``
draws them on the program's device from a generator or a seed. A program
exported on the card runs on the card; ``load_exported(path, "cpu")`` moves
it to the CPU with ``torch.export.passes.move_to_device_pass``, which takes
the place of the JAX export's ``platforms``. The sampling, reconstruction and
encoding paths evaluate no log-likelihood, so no custom kernel is in a
program: its graph holds ``aten`` operations only. ``mesh=`` raises: a
program carries no sharding, and a data-parallel server loads one
single-device program on each rank.
"""
from __future__ import annotations

import io
import json
import os
from typing import Callable, Optional, Sequence

import torch

NOISE_FILE = "noise.json"


class _Program(torch.nn.Module):
    """``fn(params, noise, data)`` as a module. The weights are plain tensor
    attributes, neither parameters nor buffers, so the exported program
    carries them as constants."""

    def __init__(self, fn: Callable, params, n_noise: int):
        super().__init__()
        self.fn = fn
        self.n_noise = n_noise
        self.weights = {name: p.detach() for name, p in (params or {}).items()}

    def forward(self, *inputs):
        return self.fn(self.weights, list(inputs[:self.n_noise]), list(inputs[self.n_noise:]))


MESH_REFUSAL = (
    "export(mesh=...): a torch.export program carries no sharding; a data-parallel "
    "server runs one single-device program on each rank (export for one device and "
    "load it on every card), and the JAX package's sharded GSPMD serving layout has "
    "no counterpart in the port yet (ROADMAP.md)")


def _check_single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(MESH_REFUSAL)


def export_callable(fn: Callable, example_args: Sequence[torch.Tensor],
                    path: Optional[str] = None, params=None, noise_spec=()) -> bytes:
    """Export ``fn(params, noise, data)`` at the example arguments' shapes
    and dtypes (the first ``len(noise_spec)`` of them the noise, the rest the
    data) and serialize it; ``params`` (``{name: tensor}``) are stored in the
    program. Writes ``path`` where given; returns the ``.pt2`` bytes.

    A ``fn`` of the data alone is ``lambda params, noise, data: f(*data)``
    with ``noise_spec=()``."""
    program = _Program(fn, params, len(noise_spec))
    # traced with autograd off, so the graph holds no grad-mode switches
    with torch.no_grad():
        exported = torch.export.export(program, tuple(example_args))
    exported.example_inputs = None  # the file carries the weights, not the example draws
    meta = {"noise": [{"name": name, "shape": list(shape), "kind": kind}
                      for name, shape, kind in noise_spec]}
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files={NOISE_FILE: json.dumps(meta)})
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(path_or_bytes, device=None) -> Callable:
    """Load an exported program into ``f(generator_or_seed, *data)``.

    ``path_or_bytes``: a file path or the ``.pt2`` bytes. ``device=None``
    serves on the card (it raises where there is none); ``"cpu"`` moves the
    program there. ``f`` draws the recorded noise on that device from the
    given ``torch.Generator`` (one of that device) or from a generator seeded
    with the given int, then calls the program on the noise and ``data``."""
    from torch.export.passes import move_to_device_pass

    from vae_mdl_tpu_torch.data.pipeline import resolve_device

    source = path_or_bytes
    if isinstance(path_or_bytes, (bytes, bytearray)):
        source = io.BytesIO(path_or_bytes)
    elif not isinstance(path_or_bytes, (str, os.PathLike)):
        raise TypeError(f"load_exported takes a path or bytes, not {type(path_or_bytes)}")
    extra = {NOISE_FILE: ""}
    exported = torch.export.load(source, extra_files=extra)
    meta = json.loads(extra[NOISE_FILE])
    target = resolve_device(device)
    module = move_to_device_pass(exported, target).module()
    spec = [(n["name"], tuple(n["shape"]), n["kind"]) for n in meta["noise"]]

    def run(generator_or_seed, *data):
        from vae_mdl_tpu_torch.models.inference import draw_noise

        generator = generator_or_seed
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=target).manual_seed(int(generator_or_seed or 0))
        noise = draw_noise(spec, generator, target)
        return module(*noise, *(torch.as_tensor(d).to(target) for d in data))

    run.noise_spec = spec
    return run


def export_sampler(model, config, params, n: int, path: Optional[str] = None,
                   mesh=None) -> bytes:
    """The prior sampler with the weights stored in it: ``f(*noise) -> uint8
    [n, H, W, C]``, noise as ``inference.sample_noise(config, n)``. Exported
    on the weights' device."""
    from vae_mdl_tpu_torch.models.inference import (
        draw_noise,
        make_sampler,
        params_device,
        sample_noise,
    )

    _check_single_device(mesh)
    sampler = make_sampler(model, config)
    spec = sample_noise(config, n)

    def fn(weights, noise, data):
        return sampler(weights, None, n, noise=noise)

    device = params_device(params)
    example = draw_noise(spec, torch.Generator(device=device).manual_seed(0), device)
    return export_callable(fn, example, path, params, spec)


def _export_image_fn(f: Callable, spec, params, image_shape, path, mesh) -> bytes:
    """Export ``f(params, generator, x01, noise=)`` at ``image_shape``."""
    from vae_mdl_tpu_torch.models.inference import draw_noise, params_device

    _check_single_device(mesh)
    device = params_device(params)

    def fn(weights, noise, data):
        return f(weights, None, data[0], noise=noise)

    example = draw_noise(spec, torch.Generator(device=device).manual_seed(0), device)
    example.append(torch.zeros(tuple(image_shape), device=device))
    return export_callable(fn, example, path, params, spec)


def export_reconstructor(model, config, params, image_shape, path: Optional[str] = None,
                         mesh=None) -> bytes:
    """Posterior-mean reconstruction: ``f(*noise, x01 [B, H, W, C]) ->
    float [B, H, W, C]``, noise as ``inference.reconstruct_noise``."""
    from vae_mdl_tpu_torch.models.inference import make_reconstructor, reconstruct_noise

    return _export_image_fn(make_reconstructor(model, config),
                            reconstruct_noise(config, image_shape[0]), params, image_shape,
                            path, mesh)


def export_encoder(model, config, params, image_shape, path: Optional[str] = None,
                   mesh=None) -> bytes:
    """Amortized posterior means: ``f(*noise, x01) -> tuple`` of latents,
    noise as ``inference.encode_noise``."""
    from vae_mdl_tpu_torch.models.inference import encode_noise, make_encoder_fn

    return _export_image_fn(make_encoder_fn(model), encode_noise(config, image_shape[0]),
                            params, image_shape, path, mesh)
