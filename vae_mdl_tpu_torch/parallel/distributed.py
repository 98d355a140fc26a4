"""Multi-process initialisation: one process per rank, one rank per device.

Port of ``vae_mdl_tpu/parallel/distributed.py``. ``torchrun`` starts the
processes and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR`` / ``MASTER_PORT``; each process then runs

    from vae_mdl_tpu_torch.parallel.distributed import init_distributed
    init_distributed()               # False in a single process
    mesh = make_mesh(MeshConfig())   # every rank on the data axis

and the trainer feeds each rank its slice of every batch. On the card the
group's backend is ``"cpu:gloo,cuda:nccl"``: tensors on the device travel
over NCCL, host tensors (the evaluation's per-image results, float64 sums)
over gloo. A caller on the CPU (``device="cpu"``) gets gloo alone.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, device=None,
                     backend: Optional[str] = None, timeout: float = 1800.0) -> bool:
    """Join the process group when one is configured; return whether this
    process is in one.

    The arguments default to torchrun's environment (``WORLD_SIZE``,
    ``RANK``; ``init_method`` ``env://`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). With neither arguments nor environment this is a
    single process and nothing happens (False), as in the JAX package.
    ``device`` is ``"cuda"`` (the default) or ``"cpu"``: on the card the
    process takes ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to the rank
    modulo the card count) and the backend is ``"cpu:gloo,cuda:nccl"``;
    on the CPU it is ``"gloo"``. ``backend`` overrides that choice, e.g.
    ``"gloo"`` for several ranks on one card, which NCCL refuses.
    ``timeout`` (seconds) bounds every collective."""
    if dist.is_initialized():
        return True
    env_world = os.environ.get("WORLD_SIZE")
    world_size = world_size if world_size is not None else (
        int(env_world) if env_world else None)
    if init_method is None and world_size is None:
        return False
    env_rank = os.environ.get("RANK")
    rank = rank if rank is not None else (int(env_rank) if env_rank else 0)
    on_card = torch.device(device if device is not None else "cuda").type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: torch.cuda.is_available() is False; pass "
                               "device='cpu' to run the ranks on the CPU")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local else rank % torch.cuda.device_count())
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if on_card else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1
