"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA cards. The
cell is ``BENCHMARK.json``'s workload ``<name>``; its configuration, traffic
mix, per-layer metrics and limits are files under ``benchmark/`` found by
name (``benchmark/lib/cells.py``). A run:

1. builds the program's objects on inputs and weights made from ``--seed``
   and warms up every shape it will use (set-up, ``setup_s``);
2. with ``--trace 0`` measures the cell's end-to-end metrics over a window of
   ``--seconds``; with ``--trace 1`` traces a slice of the same traffic under
   ``torch.profiler`` and reads the cell's per-layer metrics from it;
3. once the window has closed: reads the memory peak, frees the program's
   state and holds what the timed path produced against the plain
   reference;
4. refuses to go on, printing no result, if JAX or the JAX package has been
   imported by then;
5. prints each number compared beside its limit as its last lines on
   standard error, and one JSON line as its last line on standard output.

It exits with 2, printing no result, where the card or the cards are
missing. Checkpoints and logs go to a directory under ``$TMPDIR``, removed at
the end; the program's kernel builds stay in its checkout
(``vae_mdl_tpu_torch/_build/``).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "vae_mdl_tpu")


@dataclasses.dataclass
class Run:
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: Path
    t0: float = T0


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, compared
    by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def drive(cell, run: Run) -> dict:
    """Set-up, the window or the traced slice, the checks: the result line
    as a dict. Raises where JAX was imported."""
    import torch

    from benchmark.lib import compare, counts

    on_card = run.device.type == "cuda"
    name = torch.cuda.get_device_name(run.device) if on_card else "cpu"
    cell.peaks = counts.peaks(name)
    if cell.config.get("tf32") is False:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    prog = cell.driver.setup(cell, run)
    setup_s = time.perf_counter() - run.t0
    print(f"[bench] {cell.name}: set-up {setup_s:.3f} s", file=sys.stderr, flush=True)
    device = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": cell.chips}
    metrics, extra = {}, {}
    if run.trace:
        sl = cell.driver.traced(cell, run, prog)
        for m in cell.per_layer:
            value = m.read.read(sl, cell, m.name.partition(".")[2] or None)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        busy = sl.busy_s()
        device.update(busy_s=busy, window_s=sl.wall_s)
        extra["breakdown"] = sl.breakdown()
        attempted = sl.steps or sl.images
        failed = 0
    else:
        out = cell.driver.window(cell, run, prog)
        attempted, failed = out["attempted"], out["failed"]
        values = dict(out["metrics"], setup_s=setup_s)
        if on_card:
            values["peak_mem_gib"] = torch.cuda.max_memory_reserved(run.device) / 2 ** 30
        for m in cell.end_to_end:
            if m.name in values:
                metrics[m.name] = {"value": values[m.name], "unit": m.unit}
    device["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(run.device)
                                   if on_card else 0)
    device["power_limit_w"] = power_limit_w() if on_card else None
    cell.driver.release(prog)
    checks = compare.against(cell.driver.check(cell, run, prog), cell.limits)
    found = forbidden_modules()  # last: the check's path is searched too
    if found:
        raise RuntimeError(f"the run imported {found}")
    for check, value, limit in checks:
        print(f"[check] {check} {value!r} limit {limit!r}", file=sys.stderr)
    return {"correct": compare.passed(checks), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device, **extra,
            "checks": {c: {"value": v, "limit": lim} for c, v, lim in checks}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import cells

    cell = cells.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    tmp = Path(tempfile.mkdtemp(prefix="vae-bench-", dir=os.environ.get("TMPDIR")))
    try:
        result = drive(cell, Run(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                                 device=torch.device("cuda", 0), tmp=tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
