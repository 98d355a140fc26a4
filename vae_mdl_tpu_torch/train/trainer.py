"""The training loop, its checkpoints and the final test evaluation.

Port of ``vae_mdl_tpu/train/trainer.py``: train one batch an update (or
``steps_per_call`` stacked batches a call); every ``eval_interval`` updates
validate one batch, log, save ``latest`` (with the improved best validation
loss folded in first), save ``best`` when the validation loss improved and a
``step_<N>`` snapshot at ``snapshot_interval``; resume from ``latest`` at start, with the train
stream sought to the checkpointed step, so a resumed run takes the batches
an uninterrupted one takes; SIGTERM finishes the step in flight, saves and
returns. ``report`` logs three image grids and ``test`` runs the n-sample
test evaluation, with the PSIS k-hat and convergence curve on request.

Batches reach the card through ``data.pipeline.device_prefetch``: pinned
host memory, copied on the producer's own stream. Nothing in the loop waits
for the device except at eval intervals, where the throughput window is
timed after ``torch.cuda.synchronize()`` and the metrics are read.

Under a ``mesh`` (``parallel.mesh.make_mesh``, one rank per process) each
rank feeds its slice of every global batch through the pipeline's
``process_index`` / ``process_count``, the replicas start from rank 0's
state, the step is ``parallel.spmd.make_shard_map_train_step`` (on a state
in the tensor-parallel layout, ``parallel.tensor.shard_state_tp``, where the
mesh has ``model > 1``), the validation metrics are averaged over the
ranks, so every rank keeps the same best validation loss, and only rank 0
logs and writes ``config.json``.

On the card the train and eval steps are CUDA graphs, one a key
(``train/capture.py``), the mesh steps' collectives inside them over NCCL;
the retrace guard, the JAX trainer's
``_check_retrace``, reads each step's key cache at every eval interval and
warns once a function when it holds more than one capture.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vae_mdl_tpu_torch.config import ExperimentConfig
from vae_mdl_tpu_torch.data.pipeline import device_prefetch, iterators_from_splits, make_splits
from vae_mdl_tpu_torch.distributions import MixtureDiscretizedLogistic
from vae_mdl_tpu_torch.models.objective import apply
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.parallel.distributed import process_index
from vae_mdl_tpu_torch.parallel.mesh import batch_sharding, mean_over_replicas, shard_state
from vae_mdl_tpu_torch.parallel.spmd import make_shard_map_train_step, pack_metrics
from vae_mdl_tpu_torch.parallel.tensor import shard_state_tp
from vae_mdl_tpu_torch.train.checkpoint import Checkpointer, local_state_dict
from vae_mdl_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    eval_params,
    make_optimizer,
)
from vae_mdl_tpu_torch.train.steps import (
    make_device_data_train_step,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
    preprocess,
)
from vae_mdl_tpu_torch.utils.images import fill_canvas
from vae_mdl_tpu_torch.utils.logging import MetricLogger
from vae_mdl_tpu_torch.utils.tracing import span


class Trainer:
    """``Trainer(cfg).fit()`` trains ``cfg`` on the CUDA card (``device=None``;
    it raises where there is none) or on ``device``. The model's weights are
    initialised from ``cfg.train.seed``. ``data``, where given, is
    ``(train_iter, val_iter, test arrays)`` of uint8 batches; by default the
    trainer builds its own pipeline from ``cfg.data``."""

    def __init__(self, cfg: ExperimentConfig, data=None, logger: Optional[MetricLogger] = None,
                 device=None, mesh=None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"Trainer(mesh=...) takes the DeviceMesh of "
                            f"parallel.mesh.make_mesh; got {type(mesh).__name__}")
        self.cfg = cfg
        self.mesh = mesh
        # build_model places the model on the card and raises where there is none
        self.model = build_model(cfg.model, torch.Generator().manual_seed(cfg.train.seed),
                                 device=device)
        self.device = next(self.model.parameters()).device

        # the global batch divides over the batch shards; each rank feeds
        # its slice (data given here is this rank's)
        self._shard, self._n_shards = batch_sharding(mesh) if mesh is not None else (0, 1)
        if cfg.data.batch_size % self._n_shards:
            raise ValueError(f"batch_size {cfg.data.batch_size} not divisible by the mesh's "
                             f"{self._n_shards} batch shards (data x sample)")
        self._splits = None
        self._iter_kw = None  # set iff the trainer owns its data pipeline
        if data is None:
            self._splits = make_splits(cfg.data.dataset, cfg.data.data_dir,
                                       allow_synthetic_fallback=not cfg.data.strict)
            self._iter_kw = dict(batch_size=cfg.data.batch_size // self._n_shards,
                                 val_batch_size=max(1, cfg.data.val_batch_size
                                                    // self._n_shards),
                                 seed=cfg.data.seed, process_index=self._shard,
                                 process_count=self._n_shards)
            data = iterators_from_splits(self._splits, **self._iter_kw)
        self.train_iter, self.val_iter, self.test_set = data
        # the JAX trainer initialises from one validation batch; taking it
        # here too keeps both validating on the same batches
        next(self.val_iter)

        self.tx = make_optimizer(cfg.train)
        self.state = create_train_state(self.model, cfg.train)
        self.ckpt = Checkpointer(cfg.train.checkpoint_dir, cfg.model.name)
        if cfg.train.resume and self.ckpt.restore_latest(self.state) is not None:
            print(f"[trainer] resumed from step {self.state.step}")
        if mesh is not None:
            shard_state(mesh, self.state)  # the replicas start from rank 0's state
            if "model" in mesh.mesh_dim_names and mesh.size(
                    mesh.mesh_dim_names.index("model")) > 1:
                # the wide layers' channels (and their moments) over "model"
                shard_state_tp(self.state, mesh, model=self.model)

        spc = cfg.train.steps_per_call
        if spc > 1 and (cfg.train.eval_interval % spc or cfg.train.n_updates % spc):
            raise ValueError("steps_per_call must divide eval_interval and n_updates")
        if cfg.train.snapshot_interval and cfg.train.snapshot_interval % cfg.train.eval_interval:
            # snapshots ride the eval cadence; an off-cadence interval would
            # never fire
            raise ValueError("snapshot_interval must be a multiple of eval_interval")
        if cfg.train.snapshot_interval and cfg.train.max_snapshots < 1:
            raise ValueError("max_snapshots must be >= 1 when snapshots are enabled")
        self._device_data = None
        if cfg.train.device_dataset:
            if self._splits is None:
                self._splits = make_splits(cfg.data.dataset, cfg.data.data_dir,
                                           allow_synthetic_fallback=not cfg.data.strict)
            train_x = self._splits.train[0]
            self._device_data = torch.as_tensor(train_x, device=self.device)
            self.train_step = make_device_data_train_step(self.model, cfg, self.tx, n_steps=spc,
                                                          n_data=len(train_x), mesh=mesh)
        elif spc > 1:
            self.train_step = make_multi_train_step(self.model, cfg, self.tx, n_steps=spc,
                                                    mesh=mesh)
        elif mesh is not None:
            self.train_step = make_shard_map_train_step(self.model, cfg, self.tx, mesh)
        else:
            self.train_step = make_train_step(self.model, cfg, self.tx)
        self.steps_per_call = spc
        self.eval_step = make_eval_step(self.model, cfg,
                                        fold=self._shard if mesh is not None else None)
        self.logger = logger or (MetricLogger(cfg.train.log_dir, cfg.model.name)
                                 if process_index() == 0 else _NullLogger())
        self._stream = None  # the device-prefetch stream of one fit
        self._retrace_warned: set = set()

    # ------------------------------------------------------------------ utils

    def _put(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch), device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_retrace(self) -> None:
        """Warn (once a function) if a step has been captured more than once.

        A silent re-capture in the training loop is the CUDA-graph form of
        the JAX trainer's silent retrace: an input signature drifting
        between calls (shape, dtype, device) makes the step capture a new
        graph instead of replaying its one, and nothing crashes. The steps
        take ``(state, batch)`` with fixed shapes, so one capture is
        expected; checked at every eval interval, the mesh steps' as the
        single-device steps'. A step without a key cache (a caller's
        wrapper) is skipped, and the others are still checked. The model's
        evaluation graphs (``evaluation.harness.cache_size``: the most batch
        signatures one evaluator setting has seen) are checked the same way."""
        from vae_mdl_tpu_torch.evaluation.harness import cache_size as eval_cache_size

        sizes = [(name, fn.cache_size()) for name, fn in (("train_step", self.train_step),
                                                          ("eval_step", self.eval_step))
                 if hasattr(fn, "cache_size")]
        sizes.append(("evaluate_llh", eval_cache_size(self.model)))
        for name, n in sizes:
            if n > 1 and name not in self._retrace_warned:
                self._retrace_warned.add(name)
                print(f"[trainer] WARNING: {name} has {n} captured variants — an input "
                      "signature (shape/dtype/device) is drifting between calls and every "
                      "re-capture stalls training for a warm-up and a new CUDA graph")

    def _record_config(self) -> None:
        """Write the resolved config as ``config.json`` beside the
        checkpoints; where one is there already and differs, print the
        fields that changed first."""
        from vae_mdl_tpu_torch.config_io import diff_configs, load_config, save_config

        if process_index() != 0:
            return
        path = os.path.join(self.ckpt.base, "config.json")
        if os.path.exists(path):
            try:
                recorded = load_config(path)
            except (ValueError, TypeError, OSError) as e:
                print(f"[trainer] WARNING: could not read {path} ({e}); rewriting it")
            else:
                drift = diff_configs(recorded, self.cfg)
                if drift:
                    print(f"[trainer] WARNING: live config differs from the recorded {path}:")
                    for line in drift:
                        print(f"  {line}")
        save_config(self.cfg, path)

    # ------------------------------------------------------------------ loop

    def fit(self, n_updates: Optional[int] = None, eval_interval: Optional[int] = None,
            progress: bool = True, profile_dir: Optional[str] = None,
            profile_steps: int = 20) -> TrainState:
        """Train to ``n_updates`` steps. ``profile_dir`` captures a
        ``torch.profiler`` trace of ``profile_steps`` steps early in the run
        into ``<profile_dir>/trace.json``."""
        cfg = self.cfg
        n_updates = n_updates if n_updates is not None else cfg.train.n_updates
        eval_interval = eval_interval if eval_interval is not None else cfg.train.eval_interval
        spc = self.steps_per_call
        if spc > 1 and (eval_interval % spc or n_updates % spc):
            raise ValueError("steps_per_call must divide eval_interval and n_updates")
        if cfg.train.snapshot_interval and cfg.train.snapshot_interval % eval_interval:
            raise ValueError("snapshot_interval must be a multiple of eval_interval")
        self._record_config()
        start_step = self.state.step
        profile_at = start_step + spc if profile_dir else -1
        steps = range(start_step, n_updates, spc)
        pbar = None
        if progress and process_index() == 0:
            try:
                from tqdm import tqdm

                pbar = tqdm(total=n_updates, initial=start_step)
            except ImportError:
                pass

        if self._device_data is None:
            src = self.train_iter
            if start_step and self._iter_kw is not None:
                # data-deterministic resume: the trainer-owned train stream
                # sought to the state's step
                src, _, _ = iterators_from_splits(self._splits, start_step=start_step,
                                                  **self._iter_kw)
                self.train_iter = src
            if spc > 1:
                def stacked(it=src, n=spc):  # spc batches -> one [spc, B, ...]
                    while True:
                        yield np.stack([next(it) for _ in range(n)])

                src = stacked()
            self._stream = device_prefetch(src, size=2, device=self.device)

        # SIGTERM finishes the step in flight, then breaks out to the final save
        stop_requested = {"flag": False}

        def _on_sigterm(signum, frame):
            stop_requested["flag"] = True

        installed = False
        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            installed = True
        except ValueError:
            pass  # not in the main thread; the periodic checkpoints remain

        try:
            self._fit_loop(steps, eval_interval, pbar, profile_dir, profile_steps, profile_at,
                           stop_requested)
        finally:
            if installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
            # stop the producer thread now, not at interpreter exit; the next
            # fit seeks a fresh stream to the state's step
            if self._stream is not None:
                self._stream.close()
                self._stream = None
        return self.state

    def _fit_loop(self, steps, eval_interval, pbar, profile_dir, profile_steps, profile_at,
                  stop_requested):
        cfg = self.cfg
        spc = self.steps_per_call
        profiler = None
        window_t0 = time.perf_counter()
        window_imgs = 0
        window_steps = 0
        for i in steps:
            with span("trainer.iter"):
                if stop_requested["flag"]:
                    print(f"[trainer] SIGTERM: checkpointing at step {self.state.step} "
                          "and exiting")
                    break
                if i == profile_at:
                    profiler = _start_profiler(self.device)
                if self._device_data is not None:
                    self.state, metrics = self.train_step(self.state, self._device_data)
                    window_imgs += spc * cfg.data.batch_size
                else:
                    batch = next(self._stream)
                    self.state, metrics = self.train_step(self.state, batch)
                    window_imgs += (batch.shape[0] * (batch.shape[1] if spc > 1 else 1)
                                    * self._n_shards)
                window_steps += spc
                if pbar is not None:
                    pbar.update(spc)
                if profiler is not None and i >= profile_at + profile_steps:
                    _stop_profiler(profiler, profile_dir, self.device)
                    profiler = None

                if i % eval_interval == 0:
                    # throughput over the window just finished (eval excluded)
                    self._sync()
                    dt = time.perf_counter() - window_t0
                    imgs_per_sec = window_imgs / dt if dt > 0 else 0.0

                    val_metrics = self.eval_step(self.state, self._put(next(self.val_iter)))
                    self._check_retrace()
                    if self.mesh is not None:  # the same mean on every rank
                        val_metrics = _mean_metrics(val_metrics, self.mesh)
                    val_loss = float(val_metrics["loss"])
                    self.logger.scalars(i, metrics, prefix="Train")
                    self.logger.scalars(i, val_metrics, prefix="Evaluation")
                    self.logger.scalars(i, {"imgs_per_sec": imgs_per_sec,
                                            "step_ms": 1000.0 * dt / max(1, window_steps)},
                                        prefix="Perf")
                    if cfg.train.report_images:
                        self.report(i)

                    # fold the improved best validation loss in BEFORE the
                    # 'latest' save: a 'latest' with the stale threshold would,
                    # after a hard-kill resume, let a worse model replace 'best'
                    improved = val_loss < self.state.best_val_loss
                    if improved:
                        self.state.best_val_loss = val_loss
                    self.ckpt.save(self.state, "latest")
                    if improved:
                        self.ckpt.save(self.state, "best")
                    snap = cfg.train.snapshot_interval
                    if snap and i > 0 and i % snap == 0:
                        # named by the true step count: the eval runs after the
                        # step(s) at loop value i
                        self.ckpt.save(self.state, f"step_{i + spc}")
                        self.ckpt.prune_snapshots(cfg.train.max_snapshots)

                    window_t0 = time.perf_counter()
                    window_imgs = 0
                    window_steps = 0

        if pbar is not None:
            pbar.close()
        if profiler is not None:  # the run ended before profile_steps elapsed
            _stop_profiler(profiler, profile_dir, self.device)

        # the final save, so a resume continues from the true last step
        self._sync()
        self.ckpt.save(self.state, "latest")

    # ------------------------------------------------------------------ report

    def report(self, step: int, n_grid: int = 8):
        """Log three image grids on the eval weights: the inputs, their
        reconstructions (the observation model's mean at one posterior
        sample) and prior samples (a Gaussian observation model's mean).
        Returns the three as ``(x, recon, samples)``, ``[n_grid ** 2, H, W,
        C]`` tensors on the trainer's device, for the CLI's asset PNGs."""
        cfg = self.cfg
        n = n_grid * n_grid
        x_raw = self._put(np.asarray(next(self.val_iter))[:n])
        rngs = self.state.next_rngs("rep_sample", "rep_binarize", "rep_prior",
                                    device=self.device)
        top_shape = (cfg.model.top_latent_shape() if hasattr(cfg.model, "top_latent_shape")
                     else (cfg.model.latents()[-1],))
        params = eval_params(cfg.train, self.state)
        with torch.no_grad():
            x = preprocess(cfg, x_raw, rngs["rep_binarize"])
            _, _, pxz = apply(self.model, params, x, 1, generator=rngs["rep_sample"])
            recon = _obs_mean(pxz.dist)[0]  # the first (only) importance sample
            z_top = torch.randn((x.shape[0],) + tuple(top_shape), generator=rngs["rep_prior"],
                                device=self.device)
            gen = apply(self.model, params, z_top, rngs["rep_prior"], method="generate")
            samples = _obs_mean(gen.dist) if cfg.model.likelihood == "gaussian" else gen.x
        for name, images in (("inputs", x), ("reconstructions", recon), ("samples", samples)):
            self.logger.image(step, name, fill_canvas(images.float().cpu().numpy(), n_grid))
        return x, recon, samples

    # ------------------------------------------------------------------ test

    def test(self, n_samples: Optional[int] = None, ckpt: str = "best", **kwargs):
        """The n-sample importance-weighted test evaluation of the ``ckpt``
        checkpoint (the live state where there is none): its EMA copy where
        the config has EMA on, else its params. ``n_samples`` defaults to
        ``cfg.train.n_eval_samples``; ``kwargs`` go to ``evaluate_llh``
        (``khat``, ``k_curve``, ``batch_size``, ...). The checkpoint's
        weights are evaluated through ``params=``: the live state and the
        model's own parameters stay as they are, so ``fit`` continues from
        them. Returns ``(mean_llh, per_image_llh, metrics)``."""
        from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh

        n_samples = n_samples or self.cfg.train.n_eval_samples
        params = eval_params(self.cfg.train, self.state)
        if ckpt and self.ckpt.has(ckpt):
            saved = local_state_dict(self.ckpt.load(ckpt, self.device), self.state)
            use_ema = self.cfg.train.ema_decay > 0 and saved["ema_params"] is not None
            params = saved["ema_params"] if use_ema else saved["params"]
        return evaluate_llh(self.model, self.cfg, self.test_set[0], n_samples=n_samples,
                            params=params, mesh=self.mesh, **kwargs)


class _NullLogger:
    """The metric sink of a rank other than 0: only rank 0 logs."""

    def scalars(self, *args, **kwargs):
        pass

    def image(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _mean_metrics(metrics, mesh):
    """Scalar metrics averaged over the mesh's batch shards, in one
    all-reduce."""
    packed, unpack = pack_metrics(metrics)
    return unpack(mean_over_replicas(packed, mesh))


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    print(f"[trainer] wrote profiler trace to {profile_dir}")


def _obs_mean(dist):
    """The image an observation model stands for in a report: its mean; a
    MoDL's Monte-Carlo mean over 32 samples from a generator seeded 0."""
    if isinstance(dist, MixtureDiscretizedLogistic):
        device = dist.parameters.device
        return dist.mean(torch.Generator(device=device).manual_seed(0), n=32)
    return dist.mean()


def train(cfg: ExperimentConfig, device=None, **fit_kwargs) -> TrainState:
    """``Trainer(cfg, device=device).fit(**fit_kwargs)``."""
    return Trainer(cfg, device=device).fit(**fit_kwargs)
