"""The port's bench entry (``vae_mdl_tpu_torch/bench.py``) against
``bench.py``: the same keys, the same configurations timed in the same order,
the same FLOP counts, the eval's log-likelihood on the same weights and
noise, and one parsable line from a run on the CPU.

Tolerances: keys, configs and FLOP counts exactly; the eval's per-image LLH
within rtol 1e-3, the bf16 tolerance of ``tests/test_torch_model05.py``
(both bodies compute in bf16 and round at every layer, each on its own
convolutions; the likelihood is float32 on both sides).
"""
import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair
from test_torch_probes import _load

import vae_mdl_tpu.evaluation.harness as jharness
import vae_mdl_tpu.train.state as jstate
import vae_mdl_tpu.train.steps as jsteps
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu.utils.flops import forward_flops as jax_forward_flops
from vae_mdl_tpu_torch import bench
from vae_mdl_tpu_torch.evaluation.harness import make_batch_evaluator
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.utils.flops import forward_flops, train_step_flops
from vae_mdl_tpu_torch.utils.timing import scanned_config

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
RENAMED = {"model05_vpu_floor_ms": "model05_sfu_floor_ms",
           "model05_vpu_bound_frac": "model05_sfu_bound_frac"}
ADDED = {"device", "power_limit_w"}
LLH_TOL = dict(rtol=1e-3)


def _jax_keys() -> set:
    """Every key ``bench.py``'s ``main`` puts in its line: the ``out`` dict's
    literal keys, each ``out["..."] = ``, and three a ``rate_stats`` call."""
    tree = ast.parse((_REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                        and t.value.id == "out":
                    keys.add(t.slice.value)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "rate_stats":
            prefix = node.args[0].value
            keys |= {prefix, f"{prefix}_min", f"{prefix}_sd"}
    return keys


def test_the_line_has_bench_pys_keys():
    jax_keys = _jax_keys()
    assert len(jax_keys) == 49 and set(RENAMED) <= jax_keys
    want = {RENAMED.get(k, k) for k in jax_keys} | ADDED
    assert set(bench.KEYS) == want
    assert len(bench.KEYS) == len(set(bench.KEYS))


@pytest.fixture
def jax_bench(monkeypatch):
    """``bench.py`` with the expensive parts of its setup stubbed: the train
    state and the scanned step are not built (the config is what is read)."""
    module = _load("bench.py")
    monkeypatch.setattr(jstate, "create_train_state", lambda *a, **k: None)
    monkeypatch.setattr(jsteps, "make_multi_train_step", lambda *a, **k: None)
    return module


def _same(port_cfg, jax_cfg):
    for part in ("model", "train", "data"):
        assert dataclasses.asdict(getattr(port_cfg, part)) == \
            dataclasses.asdict(getattr(jax_cfg, part)), part


@pytest.mark.parametrize("prefix,setup,timing", bench.TRAIN_RUNS,
                         ids=[run[0] for run in bench.TRAIN_RUNS])
def test_every_timed_config_equals_bench_pys(jax_bench, prefix, setup, timing):
    """Each config the port times is ``bench.setup_scanned_step(...)[3]`` of
    the same arguments, field by field, with ``train_step_flops`` equal."""
    setup = dict(setup)
    name = setup.pop("name")
    _, _, _, jcfg, jflops = jax_bench.setup_scanned_step(name, **setup)
    setup.pop("spc", None)
    cfg = scanned_config(name, **setup)
    _same(cfg, jcfg)
    assert train_step_flops(cfg.model, cfg.data.batch_size) == jflops


def test_the_runs_and_repeats_are_bench_pys():
    """bench.py's calls of ``_train_throughput`` in ``main``, in order, with
    their spc / n_iters / n_repeats: the port's table (the eval and the
    resident run apart)."""
    tree = ast.parse((_REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "_train_throughput"]
    calls.sort(key=lambda n: n.lineno)
    theirs = [(call.args[0].value, {k.arg: ast.literal_eval(k.value) for k in call.keywords})
              for call in calls]
    mine = [(setup["name"], {**{k: v for k, v in setup.items() if k != "name"}, **timing})
            for _, setup, timing in bench.TRAIN_RUNS]
    assert theirs == mine
    assert bench.RESIDENT == dict(name="model05", spc=20, n_data=10000)  # bench.py:154


def test_the_eval_config_and_flops_equal_bench_pys(jax_bench, monkeypatch):
    """``_eval_throughput``'s experiment, caught where it builds its
    evaluator: every field equal, ``use_pallas`` apart (True there, None
    here: the kernel for the card's tensors either way)."""
    caught = {}

    class Caught(Exception):
        pass

    def catch(model, cfg, n_samples, k_chunk, **kw):
        caught.update(cfg=cfg, n_samples=n_samples, k_chunk=k_chunk)
        raise Caught

    monkeypatch.setattr(jharness, "make_batch_evaluator", catch)
    with pytest.raises(Caught):
        jax_bench._eval_throughput()
    jcfg, cfg = caught["cfg"], bench.eval_config()
    assert (caught["n_samples"], caught["k_chunk"]) == (bench.EVAL["n_samples"],
                                                         bench.EVAL["k_chunk"])
    assert jcfg.model.use_pallas is True and cfg.model.use_pallas is None
    _same(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_pallas=True)), jcfg)
    assert forward_flops(experiment("model05").model, batch=1, n_samples=5000) == \
        jax_forward_flops(jax_experiment("model05").model, batch=1, n_samples=5000)


def test_the_eval_gives_jax_llh_under_bench_pys_config(jax_bench, monkeypatch):
    """B = 4, n_samples = 20, k-chunks of 10: the port's evaluator under the
    bench's eval config against JAX's ``make_batch_evaluator`` under
    bench.py's (its plain likelihood, ``use_pallas=False``, as the JAX tests
    run it on the CPU), on bridged weights and the noise JAX draws."""
    caught = {}

    def catch(model, cfg, n_samples, k_chunk, **kw):
        caught["cfg"] = cfg
        raise RuntimeError("caught")

    monkeypatch.setattr(jharness, "make_batch_evaluator", catch)
    with pytest.raises(RuntimeError, match="caught"):
        jax_bench._eval_throughput()
    monkeypatch.undo()
    jcfg = caught["cfg"]
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, use_pallas=False))
    cfg = bench.eval_config()
    pair = FamilyPair(jcfg.model, cfg.model, seed=3)
    n_samples, k_chunk, batch = 20, 10, 4
    images = np.random.default_rng(0).integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jharness.make_batch_evaluator(pair.jm, jcfg, n_samples, k_chunk)(
        pair.variables, jnp.asarray(images), key))
    chunk_keys = jax.random.split(jax.random.fold_in(key, 1), n_samples // k_chunk)
    eps = torch.from_numpy(np.stack([pair.jax_noise(k, k_chunk, batch)[0] for k in chunk_keys]))
    got = make_batch_evaluator(pair.model, cfg, n_samples, k_chunk)(
        torch.from_numpy(images), eps=eps).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LLH_TOL)


def test_run_on_the_cpu_prints_one_line(capsys):
    """At batch 4, one step a call and a short eval (20 samples of 4 images
    in k-chunks of 10), one block after the warm-up, the CPU run prints one
    JSON line with the port's keys, its device-only numbers null."""
    line = bench.run(device="cpu", spc=1, data_over={"batch_size": 4},
                     eval_over={"batch_size": 4, "n_samples": 20, "k_chunk": 10, "n_timed": 1},
                     n_iters=1, n_repeats=2, say=lambda _: None)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    parsed = json.loads(out[-1])
    assert tuple(parsed) == bench.KEYS and parsed == line
    assert parsed["device"] == "cpu" and parsed["power_limit_w"] is None
    assert parsed["mfu"] is None and parsed["model05_sfu_floor_ms"] is None
    assert parsed["flops_per_img"] == round(train_step_flops(experiment("model05").model, 4)
                                            / 4 / 1e6, 2)
    for key in bench.KEYS:
        if key.endswith("imgs_per_sec"):
            assert np.isfinite(parsed[key]) and parsed[key] > 0
