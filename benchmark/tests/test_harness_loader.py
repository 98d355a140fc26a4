"""The harness is driven by data: a cell's configuration, mix, per-layer
metrics and limits are files found by name, and a new configuration, mix,
metric and cell run as new files and new entries alone."""
from __future__ import annotations

import json
import shutil

import pytest

from benchmark.lib import cells, trace
from conftest import ROOT, drive_cpu, small_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_files_by_name(name):
    cell = cells.load(ROOT, name)
    w = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert cell.config["name"] == w["config"] and cell.chips == w["chips"] == 1
    assert cell.mix["driver"] in ("train", "eval")
    assert cell.reference.__name__ == f"benchmark.reference.{cell.config['reference']}"
    reported = {m.name for m in cell.end_to_end}
    assert {"setup_s", "peak_mem_gib"} <= reported and len(reported) == 3
    assert cell.per_layer and all(m.moves in reported for m in cell.per_layer)
    assert all(callable(m.read.read) for m in cell.per_layer)
    assert cell.limits


def test_a_family_reader_serves_every_suffix():
    a, b = cells.metric_reader("idle_share.train"), cells.metric_reader("idle_share.anything")
    assert a.__file__ == b.__file__


def test_contract_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []


def test_new_config_mix_metric_and_cell_need_only_new_files(tmp_path):
    """A copy of the benchmark in a scratch directory gains a configuration,
    a mix, a per-layer metric, limits and a cell as new files and entries;
    every file it had stays byte for byte, and the new cell runs."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    config = json.loads((bench / "configs" / "model05-f32.json").read_text())
    config["name"] = "model05-f32-narrow-batch"
    (bench / "configs" / "model05-f32-narrow-batch.json").write_text(json.dumps(config))
    mix = json.loads((bench / "mixes" / "train.json").read_text())
    mix.update(batch_size=2, pool_images=16, val_batch_size=2, probe_steps=1)
    (bench / "mixes" / "train-b2.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(sl, cell, suffix=None):\n    return float(sl.steps) if sl.steps else None\n")
    (bench / "limits" / "model05-f32-b2-train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-2, "change_gap": 1e-1}}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config["name"], "source": "https://github.com/nbip/vae-mdl",
                            "file": "benchmark/configs/model05-f32-narrow-batch.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "model05-f32-b2-train", "config": config["name"],
                              "traffic": "train-b2", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_imgs_per_s":
            m["workloads"].append("model05-f32-b2-train")
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "train step",
                              "moves": "train_imgs_per_s", "workloads": ["model05-f32-b2-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = cells.load(tmp_path, "model05-f32-b2-train", bench=bench)
    assert cell.mix["batch_size"] == 2 and cell.config["name"] == "model05-f32-narrow-batch"
    assert [m.name for m in cell.per_layer] == ["steps_traced"]
    assert cell.per_layer[0].read.read(trace.Slice([], [], 1.0, 0.0, steps=7), cell) == 7.0
    out = drive_cpu(cell, tmp_path / "run")
    assert out["correct"] and set(out["metrics"]) == {"train_imgs_per_s", "setup_s"}
    assert all(p.read_bytes() == data for p, data in before.items())


def test_small_cell_keeps_the_widths():
    cell = small_cell("biladder_celeba-bf16-train")
    assert cell.config["model"]["stages"][0][0] == 64 and cell.mix["batch_size"] == 2
