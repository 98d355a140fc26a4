"""Training traffic: ``Trainer.fit`` as users run it, one call a window.

Set-up builds one ``Trainer`` on the benchmark's weights and image pool and
drives it through its first ``check_steps`` steps with ``fit`` itself (its
own captured step and device prefetch, a validation, report and checkpoint
after each step), recording each step's loss, the optimizer's first moments
after the first step and the parameters after the last. Then ``probe_steps``
more steps time the rate that sizes the window. The window is one
``fit`` call of as many steps as the rate gives for ``--seconds``, with the
experiment's validations and checkpoints; its rate is the images it trained
over its wall time; ``failed`` is every step of it where the parameters or
Adam's moments hold a non-finite value after it (the configurations skip
no update, so a non-finite loss reaches them), else the reported losses
that are not finite. The traced slice is ``trace_seconds`` of steps inside
a longer ``fit`` call: ``trace_lead_seconds`` of steps before it, so that
the call's start (the prefetch thread's first batches) lies outside, and
one step after it, so that the call's final save does. Neither holds a
validation. The same object, the same feed, from set-up to the window.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from benchmark.lib import compare, inputs, program, trace
from benchmark.reference import common

B1 = 0.9  # the optimizer's first-moment decay (optax's Adam)


class Recorder:
    """The program's metric logger, with the losses of the first steps and
    the state after the first and last of them kept on the side."""

    def __init__(self, inner, n_check: int):
        self.inner, self.n_check = inner, n_check
        self.trainer = None
        self.losses, self.mu, self.params = [], None, None
        self.watching = True
        self.window_losses = []

    def scalars(self, step, metrics, prefix="Evaluation"):
        self.inner.scalars(step, metrics, prefix)
        if prefix != "Train":
            return
        loss = float(metrics["loss"])
        if not self.watching:
            self.window_losses.append(loss)
            return
        state = self.trainer.state
        self.losses.append(loss)
        if step == 0:
            self.mu = {k: v.detach().clone() for k, v in state.opt_state["mu"].items()}
        if len(self.losses) == self.n_check:
            self.params = {k: v.detach().clone() for k, v in state.params.items()}

    def image(self, *args, **kwargs):
        self.inner.image(*args, **kwargs)

    def close(self):
        self.inner.close()


class Program:
    pass


def _shape(cell):
    return tuple(cell.config["model"]["image_shape"])


def make_inputs(cell, seed: int, device):
    """The run's weights, image pool and validation batch, from its seed."""
    mix = cell.mix
    weights = inputs.make_weights(cell.reference.parameter_spec(cell.config["model"]),
                                  inputs.sub_seed(seed, "weights"), device,
                                  cell.config.get("init"))
    pool = inputs.image_pool(inputs.sub_seed(seed, "train"), mix["pool_images"], _shape(cell))
    val = inputs.image_pool(inputs.sub_seed(seed, "val"), mix["val_batch_size"], _shape(cell))
    return weights, pool, val


def setup(cell, run) -> Program:
    from vae_mdl_tpu_torch.train.trainer import Trainer
    from vae_mdl_tpu_torch.utils.logging import MetricLogger

    mix, prog = cell.mix, Program()
    n_check = mix["check_steps"]
    prog.weights, pool, val = make_inputs(cell, run.seed, run.device)
    prog.train_seed = inputs.sub_seed(run.seed, "steps")
    cfg = program.experiment(
        cell.config, data={"batch_size": mix["batch_size"],
                           "val_batch_size": mix["val_batch_size"]},
        seed=prog.train_seed, steps_per_call=mix["steps_per_call"],
        eval_interval=mix["eval_interval"], checkpoint_dir=str(run.tmp / "checkpoints"),
        log_dir=str(run.tmp / "logs"))
    prog.cfg, prog.batch = cfg, mix["batch_size"]
    prog.feed = inputs.Batches(pool, mix["batch_size"], inputs.sub_seed(run.seed, "order"),
                               keep=n_check)
    prog.recorder = Recorder(MetricLogger(cfg.train.log_dir, cfg.model.name), n_check)
    trainer = Trainer(cfg, data=(prog.feed, inputs.Repeat(val), (val, None)),
                      logger=prog.recorder, device=run.device)
    program.load_weights(trainer.state.params, prog.weights)
    if trainer.state.ema_params is not None:
        program.load_weights(trainer.state.ema_params, prog.weights)
    prog.trainer = prog.recorder.trainer = trainer
    trainer.fit(n_updates=n_check, eval_interval=1, progress=False)
    prog.recorder.watching = False
    if prog.recorder.params is None:
        raise RuntimeError(f"the first {n_check} steps logged {len(prog.recorder.losses)} losses")
    start, t0 = trainer.state.step, time.perf_counter()
    trainer.fit(n_updates=start + mix["probe_steps"], progress=False)
    prog.steps_per_s = mix["probe_steps"] / (time.perf_counter() - t0)
    return prog


def window(cell, run, prog) -> dict:
    trainer = prog.trainer
    n = max(1, round(run.seconds * prog.steps_per_s))
    target = trainer.state.step + n
    t0 = time.perf_counter()
    trainer.fit(n_updates=target, progress=False)
    wall = time.perf_counter() - t0
    if finite(trainer.state):
        failed = sum(1 for v in prog.recorder.window_losses if not math.isfinite(v))
    else:
        failed = n
    return {"metrics": {"train_imgs_per_s": n * prog.batch / wall},
            "attempted": n, "failed": failed}


def finite(state) -> bool:
    """Whether every parameter and every moment of Adam is finite."""
    leaves = list(state.params.values())
    for group in state.opt_state.values():
        if isinstance(group, dict):
            leaves += list(group.values())
    return bool(torch.stack([torch.isfinite(t).all() for t in leaves
                             if torch.is_floating_point(t)]).all())


def traced(cell, run, prog) -> trace.Slice:
    trainer, mix = prog.trainer, cell.mix
    n = max(1, round(mix["trace_seconds"] * prog.steps_per_s))
    lead = max(1, round(mix["trace_lead_seconds"] * prog.steps_per_s))
    target = trainer.state.step + lead + n + 1
    step, calls = trainer.train_step, [0]

    def marked(state, batch):  # a marker before the slice's first step and after its last
        if calls[0] in (lead, lead + n):
            trace.mark()
        calls[0] += 1
        return step(state, batch)

    trainer.train_step = marked
    try:
        _, whole = trace.traced(lambda: trainer.fit(n_updates=target, progress=False))
    finally:
        trainer.train_step = step
    sl = trace.between_marks(whole)
    sl.steps, sl.images = n, n * prog.batch
    return sl


def release(prog) -> None:
    """Drop the program's state (its graphs and their pools with it)."""
    prog.trainer = prog.recorder.trainer = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_steps(cell, weights, batches, train_seed: int, prec, flip: bool, device):
    """The reference's first steps from ``weights`` on ``batches``: (losses,
    first gradients, parameters after the last step)."""
    ref, model = cell.reference, cell.config["model"]
    k = model["n_samples"]

    def grads_of(params, step):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        x = torch.as_tensor(batches[step], device=device).float() / 255.0
        if flip:
            g = common.generator(common.stream_seed(train_seed, step, "flip"), device)
            coin = torch.rand((x.shape[0], 1, 1, 1), generator=g, device=device) < 0.5
            x = torch.where(coin, torch.flip(x, dims=(-2,)), x)
        g = common.generator(common.stream_seed(train_seed, step, "sample"), device)
        eps = [torch.randn((k, x.shape[0]) + tuple(s), generator=g, device=device)
               for s in ref.latent_shapes(model)]
        loss = ref.train_loss(leaves, model, x, eps, prec)
        return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    return common.adam_steps({n: w.clone() for n, w in weights.items()}, grads_of,
                             len(batches))


def readings(cell, losses, grads, after, weights, ref) -> dict:
    """The numbers compared, from the program's (or the control's) losses,
    first gradients and parameters after the steps, against the
    reference's ``(losses, first gradients, parameters after)``."""
    ref_losses, ref_grads, ref_after = ref
    change = {n: after[n] - weights[n] for n in weights}
    ref_change = {n: ref_after[n] - weights[n] for n in weights}
    return compare.train_numbers(losses, ref_losses, compare.norms(grads),
                                 compare.norms(ref_grads), compare.norms(change),
                                 compare.norms(ref_change))


def check(cell, run, prog) -> dict:
    rec = prog.recorder
    ref = reference_steps(cell, prog.weights, prog.feed.kept, prog.train_seed,
                          common.Precision(), prog.cfg.data.augment_flip, run.device)
    grads = {n: m / (1.0 - B1) for n, m in rec.mu.items()}
    return readings(cell, rec.losses, grads, rec.params, prog.weights, ref)
