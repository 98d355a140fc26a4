"""Config serialization: one JSON file reproduces a run.

Port of ``vae_mdl_tpu/config_io.py`` over the port's config classes
(``config.py`` and the ladder families' ``LadderConfig`` and
``BiLadderConfig``), in the same format: a ``config.json`` written by either
package loads in the other, field for field.

- ``save_config`` / ``load_config``: the JSON round trip of an
  ``ExperimentConfig``, the model's class named by a ``model_class`` tag;
- the trainer writes ``config.json`` beside its checkpoints at every
  ``fit()`` and warns with ``diff_configs``' dotted paths when a resumed
  run's live config differs from the recorded one.

The ``mesh`` section holds ``MeshConfig``'s fields under the JAX package's
names (``data``, ``sample``, ``model``); a file without one gets the
default. JSON has no tuples, so every list decodes back to a tuple; an
unknown field fails with its section's name.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

from vae_mdl_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

FORMAT = "vae-mdl-tpu/config/v1"


def _model_classes() -> Dict[str, type]:
    from vae_mdl_tpu_torch.models.bidirectional import BiLadderConfig
    from vae_mdl_tpu_torch.models.ladder import LadderConfig

    return {"model": ModelConfig, "ladder": LadderConfig, "biladder": BiLadderConfig}


def _model_tag(model_cfg: Any) -> str:
    for tag, cls in _model_classes().items():
        if type(model_cfg) is cls:
            return tag
    raise TypeError(
        f"unknown model config class {type(model_cfg).__name__}; "
        "config_io knows ModelConfig, LadderConfig, BiLadderConfig")


def config_to_dict(cfg: ExperimentConfig) -> Dict[str, Any]:
    """Plain-JSON-types dict (tuples become lists) with class tags."""
    return {
        "format": FORMAT,
        "model_class": _model_tag(cfg.model),
        "model": dataclasses.asdict(cfg.model),
        "data": dataclasses.asdict(cfg.data),
        "train": dataclasses.asdict(cfg.train),
        "mesh": dataclasses.asdict(cfg.mesh),
    }


def _tupled(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_tupled(v) for v in value)
    return value


def _build(cls: type, d: Dict[str, Any], section: str):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise ValueError(
            f"config section {section!r}: unknown field(s) "
            f"{sorted(unknown)} for {cls.__name__} (known: "
            f"{sorted(fields)})")
    kwargs = {}
    for name, value in d.items():
        default = fields[name].default
        if isinstance(value, dict) and dataclasses.is_dataclass(default):
            # nested config (ModelConfig.encoder/.decoder)
            kwargs[name] = _build(type(default), value, f"{section}.{name}")
        else:
            kwargs[name] = _tupled(value)
    return cls(**kwargs)


def config_from_dict(d: Dict[str, Any]) -> ExperimentConfig:
    if not isinstance(d, dict) or "model" not in d:
        raise ValueError("not a vae-mdl-tpu config dict (no 'model' section)")
    fmt = d.get("format", FORMAT)
    if fmt != FORMAT:
        raise ValueError(f"unsupported config format {fmt!r} "
                         f"(this build reads {FORMAT!r})")
    tag = d.get("model_class", "model")
    classes = _model_classes()
    if tag not in classes:
        raise ValueError(f"unknown model_class {tag!r} "
                         f"(known: {sorted(classes)})")
    return ExperimentConfig(
        model=_build(classes[tag], d["model"], "model"),
        data=_build(DataConfig, d.get("data", {}), "data"),
        train=_build(TrainConfig, d.get("train", {}), "train"),
        mesh=_build(MeshConfig, d.get("mesh", {}), "mesh"),
    )


def save_config(cfg: ExperimentConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
        f.write("\n")


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        return config_from_dict(json.load(f))


def diff_configs(a: ExperimentConfig, b: ExperimentConfig) -> List[str]:
    """Dotted paths where two configs differ, with both values:
    ``["train.learning_rate: 0.001 -> 0.0005", ...]``."""
    da, db = config_to_dict(a), config_to_dict(b)

    out: List[str] = []

    def walk(pa: str, va: Any, vb: Any) -> None:
        if isinstance(va, dict) and isinstance(vb, dict):
            for key in sorted(set(va) | set(vb)):
                walk(f"{pa}.{key}" if pa else key,
                     va.get(key, "<absent>"), vb.get(key, "<absent>"))
        elif va != vb:
            out.append(f"{pa}: {va!r} -> {vb!r}")

    walk("", da, db)
    return out
