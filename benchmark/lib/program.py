"""The program under test as the benchmark sets it up: the configuration a
file names, resolved to the program's own config objects, and the weights
handed to it through its parameters.

Everything of the program is imported inside these functions, so that
loading the harness imports nothing of it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Dict

import torch


def _plain(value):
    """Tuples as lists, as a JSON file holds them."""
    return json.loads(json.dumps(value))


def model_config(config: dict):
    """The program's model config for a configuration file: the zoo entry
    ``config["zoo"]`` with the file's top-level ``model`` values put in, then
    held against every key of the file's ``model`` (a nested group whole).
    A key the program's config lacks, or one that differs, raises."""
    from vae_mdl_tpu_torch.models import zoo

    base = zoo.MODELS[config["zoo"]]
    fields = {f.name for f in dataclasses.fields(base)}
    want = config["model"]
    missing = sorted(set(want) - fields)
    if missing:
        raise ValueError(f"{config['name']}: the program's {config['zoo']} has no {missing}")
    scalars = {k: (tuple(v) if isinstance(v, list) else v) for k, v in want.items()
               if not isinstance(v, (dict, list)) or k in ("image_shape", "latent_sizes")}
    model = dataclasses.replace(base, **scalars)
    have = _plain(dataclasses.asdict(model))
    differ = sorted(k for k in want if have[k] != want[k])
    if differ:
        raise ValueError(f"{config['name']}: the program's {config['zoo']} differs from the "
                         f"file in {differ}")
    return model


def experiment(config: dict, data=None, **train):
    """The program's ``ExperimentConfig``: the zoo's experiment for the
    model, the file's ``data`` and ``train`` groups put in, then ``data``
    and ``train``."""
    from vae_mdl_tpu_torch.models import zoo

    cfg = zoo.experiment(config["zoo"])
    return dataclasses.replace(
        cfg, model=model_config(config),
        data=dataclasses.replace(cfg.data, **{**config.get("data", {}), **(data or {})}),
        train=dataclasses.replace(cfg.train, **{**config.get("train", {}), **train}))


def load_weights(params: Dict[str, torch.Tensor], weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's ``weights`` into the program's parameters
    ``{name: tensor}``, in place; the names and shapes have to be the same."""
    if set(params) != set(weights):
        raise ValueError("the program's parameters differ from the reference's: only the "
                         f"program has {sorted(set(params) - set(weights))[:5]}, only the "
                         f"reference {sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, reference "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for cuDNN's convolutions and cuBLAS's products, put
    back after."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
