"""The port's retrace guard: each step function is captured once.

Mirrors ``tests/test_retrace.py`` on the port's ``Trainer``. The JAX trainer
counts the jit caches of its train and eval steps at every eval interval
and warns loudly on a recompile; the port's steps are CUDA graphs on the
card, one a key (input shape, dtype, device, steps a call), and their key
cache is kept on the CPU too, so the guard runs and is tested here.
"""
import dataclasses
import json
import os

import numpy as np
import torch

from vae_mdl_tpu_torch.config import DataConfig, TrainConfig
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _tiny_cfg(tmp, **train_kw):
    cfg = experiment("model01")
    return dataclasses.replace(
        cfg,
        data=DataConfig(dataset="synthetic:mnist", batch_size=16, val_batch_size=32),
        train=TrainConfig(
            n_updates=train_kw.pop("n_updates", 8),
            eval_interval=train_kw.pop("eval_interval", 4),
            report_images=False,
            checkpoint_dir=os.path.join(tmp, "ckpt"),
            log_dir=os.path.join(tmp, "tb"),
            **train_kw,
        ),
    )


def test_fit_captures_each_step_exactly_once(tmp_path, capsys):
    """Across a run of several eval intervals the train and eval steps each
    hold one key: the pipeline's shapes and dtypes are stable."""
    tr = Trainer(_tiny_cfg(str(tmp_path)), device="cpu")
    tr.fit(progress=False)
    assert tr.train_step.cache_size() == 1
    assert tr.eval_step.cache_size() == 1
    assert "WARNING" not in capsys.readouterr().out
    # train-side metrics reach the logger
    prefixes = {r.get("prefix") for r in map(json.loads,
                                             open(os.path.join(tr.logger.dir, "metrics.jsonl")))}
    assert {"Train", "Evaluation", "Perf"} <= prefixes


def test_scanned_multistep_captures_once(tmp_path, capsys):
    """The steps_per_call window (the counterpart of the JAX scan) also
    holds one key."""
    tr = Trainer(_tiny_cfg(str(tmp_path), steps_per_call=2), device="cpu")
    tr.fit(progress=False)
    assert tr.train_step.cache_size() == 1
    assert tr.train_step.n_steps == 2
    assert "WARNING" not in capsys.readouterr().out


def test_guard_checks_each_fn_independently(tmp_path, capsys):
    """A step without a key cache (an eager wrapper) must not silently
    disable the guard for the other step: eval_step drift is still caught
    when train_step is uninspectable."""
    tr = Trainer(_tiny_cfg(str(tmp_path)), device="cpu")
    batch = np.zeros((32, 28, 28, 1), np.uint8)
    tr.eval_step(tr.state, torch.as_tensor(batch))
    tr.eval_step(tr.state, torch.as_tensor(batch, dtype=torch.float32) / 255.0)
    assert tr.eval_step.cache_size() == 2
    real = tr.train_step
    tr.train_step = lambda s, b: real(s, b)  # no cache_size attribute
    tr._check_retrace()
    assert "eval_step has 2 captured variants" in capsys.readouterr().out


def test_retrace_warns_once(tmp_path, capsys):
    """A drifting input signature triggers one loud warning, not one per
    eval interval."""
    tr = Trainer(_tiny_cfg(str(tmp_path)), device="cpu")
    batch = np.zeros((16, 28, 28, 1), np.uint8)
    tr.state, _ = tr.train_step(tr.state, torch.as_tensor(batch))
    # dtype drift: a float32 batch is another key of the same function
    tr.state, _ = tr.train_step(tr.state, torch.as_tensor(batch, dtype=torch.float32) / 255.0)
    assert tr.train_step.cache_size() == 2
    tr._check_retrace()
    first = capsys.readouterr().out
    assert "train_step has 2 captured variants" in first
    tr._check_retrace()
    assert "WARNING" not in capsys.readouterr().out
