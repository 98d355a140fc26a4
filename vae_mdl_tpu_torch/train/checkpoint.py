"""Checkpoints of the full training state: latest, best, snapshots, resume.

Port of ``vae_mdl_tpu/train/checkpoint.py``. ``latest`` is written at every
eval interval, ``best`` whenever the validation loss improves, ``step_<N>``
snapshots at ``snapshot_interval``; ``restore_latest`` resumes a run where
it stopped (falling back to ``best``).

A checkpoint is one directory per tag under ``<directory>/<name>/``, holding
``state.pt`` (``torch.save`` of ``TrainState.state_dict()``: params,
optimizer state, step, seed, best validation loss, EMA copy) and
``meta.json`` (the step and whether an EMA copy is in it), so that listing
snapshots and ``saved_with_ema`` read no tensors. A save writes
``<tag>.tmp`` whole and then moves it into place, so a crash mid-save leaves
the previous checkpoint as it was. Loads use ``weights_only=True``: the
state is nested dicts and lists of tensors and numbers, which that takes,
and ``map_location`` is the target state's device, so a checkpoint written
on the card restores on the CPU and the other way round.

Restores write into the target state in place: its parameters are the
model's own, so the model holds the restored weights afterwards.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import torch

from vae_mdl_tpu_torch.train.state import TrainState


def _structure(tree):
    """Nested dict keys, list lengths and tensor shapes and dtypes."""
    if isinstance(tree, dict):
        return {key: _structure(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(value) for value in tree]
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return type(tree).__name__


def _device(state: TrainState) -> torch.device:
    return next(iter(state.params.values())).device


class Checkpointer:
    def __init__(self, directory: str, name: str):
        self.base = os.path.abspath(os.path.join(directory, name))
        os.makedirs(self.base, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.base, tag)

    def save(self, state: TrainState, tag: str = "latest") -> None:
        """Write ``state`` under ``tag``, whole or not at all: into
        ``<tag>.tmp``, then moved into place (the previous ``<tag>`` goes to
        ``<tag>.old`` for the moment between the two renames, and ``has``
        and the loaders put it back should a crash fall there)."""
        path = self._path(tag)
        tmp, old = path + ".tmp", path + ".old"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state.state_dict(), os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": int(state.step), "has_ema": state.ema_params is not None}, f)
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    def wait(self) -> None:
        """A no-op: saves are synchronous, so nothing is ever in flight. Kept
        so that callers of the JAX package's asynchronous checkpointer run
        unchanged."""

    def _settled(self, tag: str) -> str:
        """The path of ``tag``, after putting back a previous checkpoint that
        a crash between ``save``'s two renames left at ``<tag>.old``."""
        path = self._path(tag)
        if not os.path.isdir(path) and os.path.isdir(path + ".old"):
            os.replace(path + ".old", path)
        return path

    def snapshots(self) -> list:
        """``step_<N>`` snapshot tags on disk, oldest first."""
        found = []
        for d in os.listdir(self.base):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.isdir(self._path(d)):
                found.append((int(m.group(1)), d))
        return [tag for _, tag in sorted(found)]

    def prune_snapshots(self, keep: int) -> None:
        """Delete the oldest snapshots beyond ``keep`` (never ``latest`` or
        ``best``); ``keep <= 0`` keeps everything."""
        if keep <= 0:
            return
        for tag in self.snapshots()[:-keep]:
            shutil.rmtree(self._path(tag), ignore_errors=True)

    def load(self, tag: str, device) -> dict:
        """The saved ``state_dict`` of ``tag``, its tensors on ``device``;
        nothing else is touched (``Trainer.test`` evaluates weights from it
        without restoring them into the live state)."""
        path = os.path.join(self._settled(tag), "state.pt")
        return torch.load(path, map_location=device, weights_only=True)

    def restore(self, target: TrainState, tag: str = "latest") -> TrainState:
        """Restore ``tag`` into ``target``, in place, and return it.

        The optimizer state must have the target's structure (it follows
        the optimizer flags; ``restore_weights`` does without it). An EMA
        mismatch is reconciled: a checkpoint with an EMA copy restored into
        a target without one drops the copy; a checkpoint without one
        restored into a target with one seeds the EMA from the restored
        params.
        """
        saved = self.load(tag, _device(target))
        if _structure(saved["opt_state"]) != _structure(target.opt_state):
            raise ValueError(
                f"checkpoint {self._path(tag)!r}: its optimizer state has another "
                "structure than the target's (a different optimizer, grad_clip_norm "
                "or grad_accum_steps); restore_weights restores the weights alone")
        want_ema = target.ema_params is not None
        target.load_state_dict({**saved, "ema_params": saved["ema_params"] if want_ema
                                else None})
        if want_ema and target.ema_params is None:
            target.ema_params = {name: p.detach().clone() for name, p in target.params.items()}
        return target

    def restore_weights(self, target: TrainState, tag: str = "best") -> TrainState:
        """Restore the params, the step and (where the target has one) the
        EMA copy of ``tag`` into ``target``, in place, leaving its optimizer
        state as it is, so a checkpoint trained under other optimizer flags
        restores for evaluation. A target with EMA and a checkpoint without
        seeds the EMA from the restored params."""
        saved = self.load(tag, _device(target))
        with torch.no_grad():
            for name, p in target.params.items():
                p.copy_(saved["params"][name])
        target.step = int(saved["step"])
        if target.ema_params is not None:
            source = saved["ema_params"] if saved["ema_params"] is not None else saved["params"]
            target.ema_params = {name: source[name].clone() for name in target.params}
        return target

    def saved_with_ema(self, tag: str = "latest") -> bool:
        """Whether the checkpoint at ``tag`` carries an EMA copy (read from
        its ``meta.json``; no tensor is loaded)."""
        with open(os.path.join(self._settled(tag), "meta.json")) as f:
            return bool(json.load(f)["has_ema"])

    def has(self, tag: str) -> bool:
        return os.path.isdir(self._settled(tag))

    def restore_latest(self, target: TrainState) -> Optional[TrainState]:
        """Auto-resume: ``latest`` restored into ``target``, else ``best``
        (the layout a converted checkpoint leaves), else None."""
        if self.has("latest"):
            return self.restore(target, "latest")
        if self.has("best"):
            print("[checkpoint] no 'latest' checkpoint; resuming from 'best'")
            return self.restore(target, "best")
        return None
