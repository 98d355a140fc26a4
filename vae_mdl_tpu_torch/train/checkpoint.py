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

Under a process group (``parallel/``) a checkpoint is one whole state, as
the JAX package's are global arrays: a ZeRO-1 state's flat moments are
gathered at their padded length and a tensor-parallel state's channel
slices whole, by every rank; rank 0 writes, and every rank waits for the
write before going on. A restore takes this rank's part of what was saved.
``meta.json`` records the shapes of the saved optimizer state
(``metadata_tree``), so the rank count a ZeRO-1 state was saved under is
read without a tensor (``parallel.spmd.elastic_restore_zero1``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed as dist

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


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    """Every rank waits here for every other (over the host, whatever the
    device's backend)."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1))


def _shapes(tree):
    """``meta.json``'s record of a state tree: tensors as their shapes."""
    if isinstance(tree, dict):
        return {key: _shapes(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(value) for value in tree]
    if isinstance(tree, torch.Tensor):
        return {"shape": list(tree.shape)}
    return None


def _sizes(record):
    """The inverse of ``_shapes``: shapes as ``torch.Size`` leaves."""
    if isinstance(record, dict) and set(record) == {"shape"}:
        return torch.Size(record["shape"])
    if isinstance(record, dict):
        return {key: _sizes(value) for key, value in record.items()}
    if isinstance(record, list):
        return [_sizes(value) for value in record]
    return record


def whole_state_dict(state: TrainState) -> dict:
    """``state.state_dict()`` with every sharded tensor whole: a
    tensor-parallel state's channel slices and a ZeRO-1 state's flat
    slices gathered (collectives: every rank of the group calls this)."""
    sd = state.state_dict()
    layout = state.tp_layout
    if layout is not None:
        names = list(state.params)
        sd["params"] = {name: layout.whole(name, p) for name, p in sd["params"].items()}
        sd["opt_state"] = layout.map_params(layout.whole, sd["opt_state"], names)
        if sd["ema_params"] is not None:
            sd["ema_params"] = layout.map_params(layout.whole, sd["ema_params"], names)
    if dist.is_initialized():
        from vae_mdl_tpu_torch.parallel.spmd import gather_zero1_opt_state

        sd["opt_state"] = gather_zero1_opt_state(sd["opt_state"])
    return sd


def local_state_dict(saved: dict, target: TrainState) -> dict:
    """This rank's part of a whole saved state, laid out as ``target``."""
    from vae_mdl_tpu_torch.parallel.spmd import local_zero1_opt_state

    saved = dict(saved, opt_state=local_zero1_opt_state(saved["opt_state"], target.opt_state))
    layout = target.tp_layout
    if layout is not None:
        names = list(target.params)
        saved["params"] = {name: layout.local(name, p) for name, p in saved["params"].items()}
        saved["opt_state"] = layout.map_params(layout.local, saved["opt_state"], names)
        if saved["ema_params"] is not None:
            saved["ema_params"] = layout.map_params(layout.local, saved["ema_params"], names)
    return saved


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
        sd = whole_state_dict(state)
        if _rank() == 0:
            path = self._path(tag)
            tmp, old = path + ".tmp", path + ".old"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(sd, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": int(state.step), "has_ema": state.ema_params is not None,
                           "shapes": {"opt_state": _shapes(sd["opt_state"])}}, f)
            shutil.rmtree(old, ignore_errors=True)
            if os.path.isdir(path):
                os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        _barrier()

    def wait(self) -> None:
        """A no-op: saves are synchronous, so nothing is ever in flight. Kept
        so that callers of the JAX package's asynchronous checkpointer run
        unchanged."""

    def _settled(self, tag: str) -> str:
        """The path of ``tag``, after putting back a previous checkpoint that
        a crash between ``save``'s two renames left at ``<tag>.old``."""
        path = self._path(tag)
        if not os.path.isdir(path) and os.path.isdir(path + ".old"):
            try:
                os.replace(path + ".old", path)
            except FileNotFoundError:  # another rank put it back first
                pass
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
        ``best``); ``keep <= 0`` keeps everything. Rank 0 deletes."""
        if keep <= 0 or _rank() != 0:
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
        return self.restore_state_dict(target, self.load(tag, _device(target)), tag)

    def restore_state_dict(self, target: TrainState, saved: dict,
                           tag: str = "latest") -> TrainState:
        """``restore`` from a saved state already loaded (``load``), e.g.
        one whose optimizer state was laid out for another rank count."""
        saved = local_state_dict(saved, target)
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
        saved = local_state_dict(self.load(tag, _device(target)), target)
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

    def metadata_tree(self, tag: str = "latest") -> Optional[dict]:
        """``{"opt_state": tree}`` of the saved optimizer state's shapes
        (``torch.Size`` leaves), read from ``meta.json`` without loading a
        tensor; None where the record is missing or unreadable."""
        try:
            with open(os.path.join(self._settled(tag), "meta.json")) as f:
                return _sizes(json.load(f)["shapes"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

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
