"""Evaluation traffic: ``evaluate_llh`` at the mix's samples, one batch a
call, as long as the window lasts.

Set-up builds the model on the benchmark's weights and evaluates one batch,
which captures the evaluator's graph for the batch's shape. The window then
evaluates whole batches of the seeded test pool, each with its own seed,
until ``--seconds`` have passed, and its rate is the images evaluated over
the time that took. Every batch's per-image bounds are kept; once the window
has closed, the check draws one batch and ``check_images`` of its images from
the seed and holds their bounds against the reference's, on the same images
and the same noise.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.lib import compare, inputs, program, trace
from benchmark.reference import common


class Program:
    pass


def make_inputs(cell, seed: int, device):
    """The run's weights and test pool, from its seed."""
    weights = inputs.make_weights(cell.reference.parameter_spec(cell.config["model"]),
                                  inputs.sub_seed(seed, "weights"), device,
                                  cell.config.get("init"))
    pool = inputs.image_pool(inputs.sub_seed(seed, "test"), cell.mix["test_images"],
                             tuple(cell.config["model"]["image_shape"]))
    return weights, pool


def batch_seed(seed: int, index: int) -> int:
    return inputs.sub_seed(seed, "batch", index)


def setup(cell, run) -> Program:
    from vae_mdl_tpu_torch.models.vae import build_model

    prog = Program()
    prog.weights, prog.pool = make_inputs(cell, run.seed, run.device)
    prog.cfg = program.experiment(cell.config)
    prog.model = build_model(prog.cfg.model, torch.Generator().manual_seed(0), device=run.device)
    program.load_weights(dict(prog.model.named_parameters()), prog.weights)
    prog.batch, prog.done = cell.mix["batch_size"], []
    _evaluate(cell, prog, 0, inputs.sub_seed(run.seed, "warm-up"))
    prog.done.clear()
    return prog


def _evaluate(cell, prog, index: int, seed: int) -> None:
    from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh

    n, b = len(prog.pool), prog.batch
    at = (index * b) % n
    images = prog.pool[at:at + b]
    mix = cell.mix
    _, per_image, _ = evaluate_llh(prog.model, prog.cfg, images, n_samples=mix["n_samples"],
                                   k_chunk=mix["k_chunk"], batch_size=b, seed=seed)
    prog.done.append((at, seed, per_image))


def _run(cell, run, prog, seconds: float) -> float:
    t0 = time.perf_counter()
    while not prog.done or time.perf_counter() - t0 < seconds:
        index = len(prog.done)
        _evaluate(cell, prog, index, batch_seed(run.seed, index))
    return time.perf_counter() - t0


def window(cell, run, prog) -> dict:
    wall = _run(cell, run, prog, run.seconds)
    images = len(prog.done) * prog.batch
    failed = int(sum((~np.isfinite(llh)).sum() for _, _, llh in prog.done))
    return {"metrics": {"eval_imgs_per_s": images / wall}, "attempted": images,
            "failed": failed}


def traced(cell, run, prog) -> trace.Slice:
    _, sl = trace.traced(lambda: _run(cell, run, prog, cell.mix["trace_seconds"]))
    sl.batches, sl.images = len(prog.done), len(prog.done) * prog.batch
    return sl


def release(prog) -> None:
    prog.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(cell, seed: int, n_done: int):
    """The batch and the images of it the check compares, drawn from the
    seed."""
    rng = np.random.default_rng(inputs.sub_seed(seed, "check"))
    j = int(rng.integers(n_done))
    rows = np.sort(rng.choice(cell.mix["batch_size"], cell.mix["check_images"], replace=False))
    return j, torch.as_tensor(rows)


def reference_llh(cell, weights, images, seed: int, rows, prec, device) -> torch.Tensor:
    """The reference's bounds of ``rows`` of the batch ``images`` evaluated
    with ``evaluate_llh(seed=seed)``'s noise."""
    x = torch.as_tensor(images, device=device).float() / 255.0
    gen = common.generator(common.batch_seed(seed, 0), device)
    return cell.reference.eval_llh(weights, cell.config["model"], x, rows.to(device), gen,
                                   cell.mix["n_samples"], cell.mix["k_chunk"], prec)


def check(cell, run, prog) -> dict:
    j, rows = sample(cell, run.seed, len(prog.done))
    at, seed, llh = prog.done[j]
    images = prog.pool[at:at + prog.batch]
    ref = reference_llh(cell, prog.weights, images, seed, rows, common.Precision(), run.device)
    return compare.eval_numbers(torch.as_tensor(llh)[rows], ref)
