"""Metric sink: a JSONL file always, TensorBoard where ``tensorboardX``
imports. Port of ``vae_mdl_tpu/utils/logging.py``.

The logger is a sink, not a device path: ``scalars`` turns each value into a
float with ``float(np.asarray(value).mean())``, which for a CUDA tensor
copies it to the host and waits for it. The trainer calls it only at eval
intervals, after its own synchronisation, so a train step never waits on a
metric.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from vae_mdl_tpu_torch.utils.images import to_uint8


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    if isinstance(value, (list, tuple)):  # a per-layer list of tensors
        return np.asarray([_host(v).mean() for v in value])
    return np.asarray(value)


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.dir = os.path.join(log_dir, f"{run_name}-{stamp}")
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb: Optional[object] = SummaryWriter(self.dir)
        except Exception:
            self._tb = None

    def scalars(self, step: int, metrics: Dict[str, object], prefix: str = "Evaluation"):
        """One JSONL record ``{"step", "prefix", name: float, ...}``; each
        value is the mean of the tensor, array or number given."""
        record = {"step": int(step), "prefix": prefix}
        for name, value in metrics.items():
            v = float(_host(value).mean())
            record[name] = v
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}/{name}", v, int(step))
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def image(self, step: int, name: str, img: np.ndarray, prefix: str = "Evaluation"):
        """img: ``[H, W, C]`` float in [0, 1] or uint8; TensorBoard only."""
        if self._tb is None:
            return
        self._tb.add_image(f"{prefix}/{name}", to_uint8(img), int(step), dataformats="HWC")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
