"""The readings that set a cell's limits, with no program in the run: the
plain reference put in the program's place, computed as the control or with
a fault planted, against the reference itself, on the inputs a run of each
seed makes.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--as control|half]

``control`` computes the reference in the nearest precision below the one
the configuration states (its ``"control"``: ``tf32``, TF32 on for a float32
configuration; ``fp8``, float8 e4m3 for the layers a bfloat16 one runs in
bfloat16). ``half`` leaves half of each training batch out and takes the
mean over the rest. Each seed prints one JSON line of the numbers compared.
The benchmark's own runs never run this; ``benchmark/tests/test_harness_card.py``
does, on a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, mode: str, device) -> dict:
    """The cell's numbers for the reference as ``mode`` against the
    reference, on the inputs a run seeded ``seed`` makes."""
    from benchmark.lib import compare, inputs, program
    from benchmark.reference import common

    low = mode == "control"
    prec = common.Precision("fp8" if low and cell.config["control"] == "fp8" else "float32")
    lowered = program.tf32(True) if low and cell.config["control"] == "tf32" else \
        contextlib.nullcontext()
    drv, mix = cell.driver, cell.mix
    if mix["driver"] == "train":
        weights, pool, _ = drv.make_inputs(cell, seed, device)
        feed = inputs.Batches(pool, mix["batch_size"], inputs.sub_seed(seed, "order"))
        batches = [next(feed) for _ in range(mix["check_steps"])]
        train_seed = inputs.sub_seed(seed, "steps")
        flip = cell.config.get("data", {}).get("augment_flip", False)
        ref = drv.reference_steps(cell, weights, batches, train_seed, common.Precision(), flip,
                                  device)
        if mode == "half":
            batches = [b[: len(b) // 2] for b in batches]
        with lowered:
            losses, grads, after = drv.reference_steps(cell, weights, batches, train_seed, prec,
                                                       flip, device)
        return drv.readings(cell, losses, grads, after, weights, ref)
    if mode != "control":
        raise ValueError(f"an evaluation cell has no {mode!r} reading here")
    weights, pool = drv.make_inputs(cell, seed, device)
    _, rows = drv.sample(cell, seed, 1)
    batch_seed = drv.batch_seed(seed, 0)
    images = pool[:mix["batch_size"]]
    ref = drv.reference_llh(cell, weights, images, batch_seed, rows, common.Precision(), device)
    with lowered:
        low_llh = drv.reference_llh(cell, weights, images, batch_seed, rows, prec, device)
    return compare.eval_numbers(low_llh, ref)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--as", dest="mode", choices=("control", "half"), default="control")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import cells, program

    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    with program.tf32(False):
        for seed in (int(s) for s in args.seeds.split(",")):
            out = readings(cell, seed, args.mode, torch.device("cuda", 0))
            print(json.dumps({"workload": cell.name, "as": args.mode, "seed": seed, **out}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
