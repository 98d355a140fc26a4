"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

- the configuration: ``benchmark/configs/<config>.json`` (the file
  ``BENCHMARK.json`` names), with the program's model under ``"zoo"`` and
  the reference module under ``"reference"``
  (``benchmark/reference/<reference>.py``);
- the traffic mix: ``benchmark/mixes/<traffic>.json``, whose ``"driver"``
  names ``benchmark/drivers/<driver>.py``;
- each per-layer metric: ``benchmark/metrics/<name>.py`` or, for a family
  ``<base>.<suffix>``, ``benchmark/metrics/<base>.py`` (given the suffix);
- the limits of the numbers ``correct`` compares:
  ``benchmark/limits/<workload>.json``.

A new configuration, mix, metric or cell is new files and new entries; no
file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str]
    read: Optional[object] = None  # a per-layer metric's reader module


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    limits: Dict[str, float]
    driver: object
    reference: object
    peaks: Optional[Dict[str, float]] = None  # the card's, set by the harness


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench: Path = BENCH):
    """The module that reads per-layer metric ``name``: its own file, else
    its family's (the part before the first dot)."""
    own = bench / "metrics" / f"{name}.py"
    family = bench / "metrics" / f"{name.split('.')[0]}.py"
    path = own if own.exists() else family
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r}: neither {own} nor {family}")
    return _load_file(path, f"benchmark_metric_{path.stem.replace('.', '_').replace('-', '_')}")


def _applies(entry: dict, workload: str, reported: set) -> bool:
    if "workloads" in entry:
        return workload in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def load(root: Path, workload: str, bench: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((bench / "mixes" / f"{w['traffic']}.json").read_text())
    e2e = [Metric(m["name"], m["unit"], None) for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m.name for m in e2e}
    per_layer = [Metric(m["name"], m["unit"], m["moves"], metric_reader(m["name"], bench))
                 for m in spec["per_layer"] if _applies(m, workload, reported)]
    limits_path = bench / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())["limits"]
    return Cell(name=workload, config=config, mix=mix, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer, limits=limits,
                driver=_load_file(bench / "drivers" / f"{mix['driver']}.py",
                                  f"benchmark_driver_{mix['driver']}"),
                reference=importlib.import_module(f"benchmark.reference.{config['reference']}"))
