"""The general probes (``probes/objective_cost.py``,
``stability_overhead.py``, ``khat_overhead.py``, ``eval_sweep.py``,
``scale_probe.py``, ``perf_probe.py``, ``trace_profile.py``,
``kernel_bench.py``) against their JAX scripts: the same labels and
configs, read off the scripts by catching their calls (or, where the calls
sit under ``__main__``, by reading them with ``ast``), and each probe end to
end on the CPU at a tiny size. kernel_bench's plain arm is held against the
JAX package's ``mixture_log_prob`` on the same inputs.

Tolerances: labels and configs exactly; kernel_bench's per-image sums of
the plain MoDL log-prob within rtol 1e-5 (float32 sums of 64 per-pixel
terms in another order).
"""
import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import _load

from vae_mdl_tpu.distributions.mixture import mixture_log_prob as jax_mixture_log_prob
from vae_mdl_tpu_torch.bench import eval_config
from vae_mdl_tpu_torch.probes import (
    eval_sweep,
    kernel_bench,
    khat_overhead,
    objective_cost,
    perf_probe,
    scale_probe,
    stability_overhead,
    trace_profile,
)
from vae_mdl_tpu_torch.utils.timing import scanned_config

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
TINY = dict(spc=1, n_iters=1, n_repeats=2, data_over={"batch_size": 2})
QUIET = dict(say=lambda _: None)


def _same_model(port_cfg, jax_cfg, pallas_kernel=False):
    """Model configs field for field; with ``pallas_kernel`` JAX's forced
    kernel (``use_pallas=True``) stands against the port's None, the kernel
    for the card's tensors."""
    mine = dataclasses.asdict(port_cfg.model)
    theirs = dataclasses.asdict(jax_cfg.model)
    if pallas_kernel:
        assert (mine.pop("use_pallas"), theirs.pop("use_pallas")) == (None, True)
    assert mine == theirs


# -- the scripts' calls, caught -------------------------------------------------------


def test_objective_cost_variants_equal_the_scripts(monkeypatch):
    script = _load("scripts/objective_cost.py")
    calls = []
    monkeypatch.setattr(script, "_train_throughput", lambda name, model_over=None,
                        train_over=None: (calls.append((name, model_over, train_over)),
                                          (np.array([100.0 + len(calls)]),))[1])
    script.main()
    mine = []
    for name in objective_cost.MODELS:
        mine.append((name, None, None))
        mine += [(name, m, t) for _, m, t in objective_cost.VARIANTS]
    assert calls == mine


def test_stability_overhead_variants_equal_the_scripts(monkeypatch):
    script = _load("scripts/stability_overhead.py")
    calls = []
    monkeypatch.setattr(script, "throughput",
                        lambda clip, skip: (calls.append((clip, skip)), 100.0)[1])
    script.main()
    assert calls == [(clip, skip) for _, clip, skip in stability_overhead.VARIANTS]


def test_khat_overhead_variants_equal_the_scripts(monkeypatch):
    script = _load("scripts/khat_overhead.py")
    calls = []
    monkeypatch.setattr(script, "eval_throughput", lambda khat, with_curve=False: (
        calls.append((khat, with_curve)), 100.0)[1])
    script.main()
    assert calls == [(khat, curve) for _, khat, curve in khat_overhead.VARIANTS]


def test_scale_probe_probes_equal_the_scripts(monkeypatch):
    script = _load("scripts/scale_probe.py")
    calls = []
    monkeypatch.setattr(script, "probe", lambda name, batch_size=None, dtype="float32":
                        calls.append((name, batch_size, dtype)))
    script.main()
    assert calls == list(scale_probe.PROBES)


def _main_calls(relative: str) -> list:
    """(function name, positional args, keywords) of each call under the
    script's ``if __name__ == "__main__":``, read with ``ast``."""
    tree = ast.parse((_REPO / relative).read_text())
    block = next(n for n in tree.body if isinstance(n, ast.If))
    out = []
    for node in block.body:
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                and getattr(node.value.func, "id", None) in ("bench_train", "bench_eval"):
            call = node.value
            out.append((call.func.id, [ast.literal_eval(a) for a in call.args],
                        {k.arg: ast.literal_eval(k.value) for k in call.keywords}))
    return out


def test_perf_probe_variants_equal_the_scripts():
    calls = _main_calls("scripts/perf_probe.py")
    train = [(args[0], kw.get("bf16", False), kw.get("pallas", False))
             for fn, args, kw in calls if fn == "bench_train"]
    evals = [(args[0], kw["n_samples"], kw["k_chunk"], kw["batch"], kw.get("pallas", False))
             for fn, args, kw in calls if fn == "bench_eval"]
    assert train == list(perf_probe.TRAIN)
    assert evals == list(perf_probe.EVALS)


@pytest.mark.parametrize("bf16,pallas", [(False, False), (True, True)])
def test_perf_probe_configs_equal_the_scripts(bf16, pallas):
    """The script's train config: the zoo entry, ``use_pallas`` forced, bf16
    where asked, on synthetic SVHN."""
    from vae_mdl_tpu.config import DataConfig
    from vae_mdl_tpu.models.zoo import experiment as jax_experiment

    cfg = jax_experiment("model05")
    model = dataclasses.replace(cfg.model, use_pallas=pallas)
    if bf16:
        model = dataclasses.replace(model, compute_dtype="bfloat16")
    jcfg = dataclasses.replace(cfg, model=model, data=DataConfig(dataset="synthetic:svhn_cropped"))
    mine = perf_probe._config("model05", bf16, pallas)
    _same_model(mine, jcfg, pallas_kernel=pallas)
    assert dataclasses.asdict(mine.data) == dataclasses.asdict(jcfg.data)


def test_eval_sweep_grid_equals_the_scripts(monkeypatch):
    """The script's grid, caught where it builds each evaluator: (dtype,
    batch, k-chunk) in its order, its config and its sample count."""
    script = _load("scripts/eval_sweep.py")
    caught = []

    def catch(model, cfg, n_samples, k_chunk):
        caught.append((cfg, n_samples, k_chunk))
        return lambda params, batch, key: jnp.zeros(batch.shape[0])

    monkeypatch.setattr(script, "make_batch_evaluator", catch)
    monkeypatch.setattr(script, "create_train_state",
                        lambda *a, **k: type("S", (), {"params": None})())
    script.main()
    mine = [(dtype, bs, kc) for dtype, _ in eval_sweep.DTYPES for bs in eval_sweep.BATCHES
            for kc in eval_sweep.K_CHUNKS]
    assert [(cfg.model.compute_dtype, None, k) for cfg, _, k in caught] == \
        [(dtype, None, kc) for dtype, _, kc in mine]
    assert {n for _, n, _ in caught} == {5000}
    port = scanned_config("model05", compute_dtype="bfloat16", model_over={"use_pallas": None})
    _same_model(port, caught[0][0], pallas_kernel=True)


def test_eval_kchunk_sweep_equals_the_scripts(monkeypatch):
    script = _load("scripts/eval_kchunk_sweep.py")
    calls = []
    monkeypatch.setattr(script.bench, "_eval_throughput", lambda **kw: (
        calls.append(kw), np.array([1.0, 2.0, 3.0]))[1])
    script.main()
    assert calls == [dict(batch_size=128, k_chunk=kc, n_timed=3)
                     for kc in eval_sweep.KCHUNK_SWEEP]


def test_khat_overhead_config_is_the_scripts():
    """bf16 body, the kernel, no boundary dtype: ``eval_config({})``."""
    from vae_mdl_tpu.config import DataConfig
    from vae_mdl_tpu.models.zoo import experiment as jax_experiment

    cfg = jax_experiment("model05")
    jcfg = dataclasses.replace(cfg, data=DataConfig(dataset="synthetic:svhn_cropped"),
                               model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                                         use_pallas=True))
    _same_model(eval_config({}), jcfg, pallas_kernel=True)


def test_trace_profile_workload_is_the_scripts():
    """12 train steps and one eval of 100 images at 500 samples in k-chunks
    of 100, as ``run_traced_workload`` sets them."""
    import inspect

    tree = ast.parse((_REPO / "scripts/trace_profile.py").read_text())
    ev = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
              and getattr(n.func, "id", None) == "make_batch_evaluator")
    kw = {k.arg: ast.literal_eval(k.value) for k in ev.keywords}
    defaults = {k: p.default for k, p in
                inspect.signature(trace_profile.run_traced_workload).parameters.items()}
    assert (defaults["n_samples"], defaults["k_chunk"]) == (kw["n_samples"], kw["k_chunk"])
    assert defaults["n_steps"] == 12 and defaults["eval_batch"] == 100
    assert defaults["batch_size"] == 128


def test_kernel_bench_shape_is_the_scripts():
    tree = ast.parse((_REPO / "scripts/kernel_bench.py").read_text())
    assign = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  and isinstance(n.targets[0], ast.Tuple)
                  and [t.id for t in n.targets[0].elts] == ["K", "B", "n_mix"])
    assert ast.literal_eval(assign.value) == (kernel_bench.K, kernel_bench.B, kernel_bench.N_MIX)


def test_kernel_bench_plain_arm_matches_jax():
    x, p = kernel_bench.inputs(k=3, b=2, side=8, device="cpu")
    want = np.asarray(jnp.sum(jax_mixture_log_prob(jnp.asarray(x.numpy()),
                                                   jnp.asarray(p.numpy())), axis=(-1, -2, -3)))
    got = kernel_bench._plain(x, p).numpy()
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- end to end on the CPU ------------------------------------------------------------------


def test_objective_cost_and_stability_run_on_the_cpu():
    out = objective_cost.run(models=("model01",), device="cpu", **QUIET, **TINY)
    assert set(out["imgs_per_sec"]["model01"]) == {"iwae"} | {v for v, _, _ in
                                                              objective_cost.VARIANTS}
    out = stability_overhead.run(device="cpu", **QUIET, **TINY)
    assert list(out["imgs_per_sec"]) == [label for label, _, _ in stability_overhead.VARIANTS]
    assert out["launches"] == {}


def test_khat_overhead_runs_on_the_cpu():
    out = khat_overhead.run(device="cpu", batch_size=2, k_chunk=5, n_samples=30, **QUIET)
    assert list(out["imgs_per_sec"]) == [label for label, _, _ in khat_overhead.VARIANTS]
    assert all(r > 0 for r in out["imgs_per_sec"].values())


def test_eval_sweep_runs_both_modes_on_the_cpu():
    grid = eval_sweep.grid(10, (2,), (5,), device="cpu", **QUIET)
    assert list(grid) == ["dtype=bfloat16 pallas=1 bs=2 k_chunk=5"]
    assert np.isfinite(grid["dtype=bfloat16 pallas=1 bs=2 k_chunk=5"]["llh0"])
    sweep = eval_sweep.kchunk(10, (5, 10), batch_size=2, n_timed=2, device="cpu", **QUIET)
    assert list(sweep) == ["k5", "k10"]
    assert all(set(v) == {"median", "min", "sd", "launches"} for v in sweep.values())


def test_scale_and_perf_probe_run_on_the_cpu():
    out = scale_probe.run(probes=(("model05", 2, "float32"),), device="cpu", spc=1, n=1,
                          **QUIET)
    r = out["probes"]["model05 bs=2 float32"]
    assert r["imgs_per_s"] > 0 and r["mfu"] is None
    out = perf_probe.run(train=(("model01", False, False),), evals=(("model05", 5000, 100, 25,
                                                                     False),),
                         device="cpu", steps=1, batch=2, **QUIET,
                         eval_over=dict(n_samples=10, k_chunk=5, batch=2))
    assert list(out["imgs_per_sec"]) == ["model01 train bf16=0 pallas=0",
                                         "model05 10-IS eval pallas=0 kc=5"]


def test_trace_profile_runs_on_the_cpu():
    out = trace_profile.run(device="cpu", top=5, n_steps=2, batch_size=2, eval_batch=2,
                            n_samples=10, k_chunk=5, **QUIET)
    assert out["clock"] == "host" and len(out["ops"]) == 5 and out["busy_ms"] > 0


def test_kernel_bench_on_the_cpu_runs_the_plain_arm_alone():
    out = kernel_bench.run(arms=("plain",), k=2, b=2, device="cpu", **QUIET)
    assert out["plain"]["max_abs_diff"] == 0.0
    with pytest.raises(ValueError, match="plain arm"):
        kernel_bench.run(k=2, b=2, device="cpu", **QUIET)
