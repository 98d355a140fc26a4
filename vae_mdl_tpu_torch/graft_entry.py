"""The entry hooks of the JAX package's ``__graft_entry__.py``, on the port.

``entry(device=None)`` -> ``(forward_step, example_args)``: one forward pass
and loss of the flagship model (model05: the conv VAE with the mixture of
discretized logistics, whose log-prob runs in the MoDL forward kernel on
the card), ``forward_step(params, x, generator) -> loss``.

``dryrun_multichip(n, device=None)`` starts ``n`` rank processes of its own
(a FileStore in a temporary directory; the caller sets no environment),
each of which runs the JAX dry run's sequence at ``_flagship_cfg(tiny=True)``'s
shapes over a ``data x sample`` mesh (``sample = 2`` where ``n`` is even and
at least 4): the full step, a sample-sharded evaluator chunk, the
data-parallel and ZeRO-1 steps, a window of 4 steps under the mesh, an EMA
step read through ``eval_params``, a checkpoint round trip of the replicated
state, ``evaluate_llh(mesh=)``, the tensor-parallel step on
``make_tp_mesh(n // 2, 2)`` with ``min_features=16``, a hybrid two-host mesh
and one biladder step. The JAX package's jitted step over the sharded batch
and its shard_map step are one step here, ``make_shard_map_train_step``,
run for each. Rank 0's ``[dryrun_multichip] ok: ...`` line, with the JAX
line's fields, is printed and returned.

On the card every rank takes a card of its own over NCCL (``n`` cards at
least: NCCL refuses two ranks on one device), and every step above is one
CUDA graph with its collectives (``train/capture.py``); with
``device="cpu"`` the ranks run over gloo, eagerly.

    python -m vae_mdl_tpu_torch.graft_entry [--cpu] [n]

runs ``entry`` and then ``dryrun_multichip(n)`` (by default over every card,
or one rank with ``--cpu``), as ``__graft_entry__.py`` does as a script.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DRYRUN_TIMEOUT = 900.0  # seconds the ranks of a dry run may take together
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT")


def _flagship_cfg(tiny: bool = False):
    """model05 on ``synthetic:svhn_cropped``; ``tiny`` narrows every conv of
    the encoder and decoder to 16 channels and keeps the 50-channel
    likelihood head (``__graft_entry__.py``'s config, field for field)."""
    from vae_mdl_tpu_torch.config import DataConfig
    from vae_mdl_tpu_torch.models.zoo import experiment

    cfg = experiment("model05")
    cfg = dataclasses.replace(cfg, data=DataConfig(dataset="synthetic:svhn_cropped"))
    if tiny:
        def narrow(layers, cap=16):
            return tuple(l if l[0] == 50 else (min(l[0], cap),) + tuple(l[1:]) for l in layers)

        enc = dataclasses.replace(cfg.model.encoder,
                                  conv_layers=narrow(cfg.model.encoder.conv_layers))
        dec = dataclasses.replace(cfg.model.decoder, base_size=(4, 4, 16),
                                  conv_layers=narrow(cfg.model.decoder.conv_layers))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, encoder=enc,
                                                                 decoder=dec))
    return cfg


def entry(device=None):
    """``(forward_step, (params, x, generator))``: model05's forward and
    ``compute_loss`` on a ``[16, 32, 32, 3]`` batch, on the card unless
    ``device`` says otherwise (it raises where there is no card)."""
    from vae_mdl_tpu_torch.models.objective import apply, compute_loss
    from vae_mdl_tpu_torch.models.vae import build_model, prior_for

    cfg = _flagship_cfg()
    model = build_model(cfg.model, torch.Generator().manual_seed(0), device=device)
    dev = next(model.parameters()).device
    prior = prior_for(cfg.model, dev)
    k = cfg.model.n_samples
    x = torch.zeros((16, 32, 32, 3), dtype=torch.float32, device=dev)
    params = {name: p.detach() for name, p in model.named_parameters()}

    def forward_step(params, x, generator):
        Qs, Ps, pxz = apply(model, params, x, k, generator=generator)
        loss, _ = compute_loss(prior, Qs, Ps, pxz, x)
        return loss

    return forward_step, (params, x, torch.Generator(device=dev).manual_seed(2))


# -- the dry run --------------------------------------------------------------------


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Run the dry run over ``n_devices`` ranks (module docstring) and
    return rank 0's ``ok`` line, printed too. On the card it raises where
    there is no card or fewer than ``n_devices``; a rank that fails or
    outlives ``DRYRUN_TIMEOUT`` seconds fails it, with its log."""
    on_card = torch.device(device if device is not None else "cuda").type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: torch.cuda.is_available() is False; pass "
                               "device='cpu' to run the ranks on the CPU over gloo")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) takes one card a rank over "
                               f"NCCL, and there are {torch.cuda.device_count()}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    if not on_card:
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as work:
        procs = []
        try:
            for rank in range(n_devices):
                with open(os.path.join(work, f"rank{rank}.log"), "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "vae_mdl_tpu_torch.graft_entry", "--rank",
                         str(rank), "--world", str(n_devices), "--work", work, "--device",
                         "cuda" if on_card else "cpu"],
                        env={**env, "LOCAL_RANK": str(rank)}, stdout=log,
                        stderr=subprocess.STDOUT))
            deadline = time.monotonic() + DRYRUN_TIMEOUT
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = []
        for rank in range(len(procs)):
            with open(os.path.join(work, f"rank{rank}.log")) as log:
                logs.append(log.read())
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {rank} failed (exit "
                               f"{p.returncode}; killed after {DRYRUN_TIMEOUT:.0f} s if "
                               f"negative):\n{log[-6000:]}")
    line = [l for l in logs[0].splitlines() if l.startswith("[dryrun_multichip] ok:")][-1]
    print(line, flush=True)
    return line


def _dryrun(n_devices: int, device: str, work: str) -> str:
    """One rank's dry run (module docstring) -> the ``ok`` line."""
    from vae_mdl_tpu_torch.config import DataConfig, ExperimentConfig, MeshConfig
    from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh, make_batch_evaluator
    from vae_mdl_tpu_torch.models.bidirectional import BiLadderConfig
    from vae_mdl_tpu_torch.models.vae import build_model
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_state
    from vae_mdl_tpu_torch.parallel.spmd import (
        make_shard_map_train_step,
        make_zero1_train_step,
        zero1_opt_state,
    )
    from vae_mdl_tpu_torch.parallel.tensor import make_tp_mesh, shard_batch_tp, shard_state_tp
    from vae_mdl_tpu_torch.train.checkpoint import Checkpointer
    from vae_mdl_tpu_torch.train.state import create_train_state, eval_params, make_optimizer
    from vae_mdl_tpu_torch.train.steps import make_multi_train_step

    dev = torch.device(device if device == "cpu" else f"cuda:{torch.cuda.current_device()}")

    def fresh(model_cfg, train_cfg, seed=0):
        model = build_model(model_cfg, torch.Generator().manual_seed(seed), device=dev)
        return model, create_train_state(model, train_cfg)

    # 2-D mesh where the ranks allow it: data x sample (sample shards the k axis)
    sample = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh_cfg = MeshConfig(data=n_devices // sample, sample=sample)
    mesh = make_mesh(mesh_cfg)

    cfg = _flagship_cfg(tiny=True)
    assert cfg.model.encoder.conv_layers[0][0] == 16  # the narrow config
    model, state = fresh(cfg.model, cfg.train)
    tx = make_optimizer(cfg.train)
    state = shard_state(mesh, state)
    batch = n_devices * 2
    images = torch.full((batch, 32, 32, 3), 127, dtype=torch.uint8, device=dev)
    rows = shard_batch(mesh, images)

    # the full training step: dequantize + forward (k = 5) + IWAE bound + grads
    # + the averaged gradient + adam
    train_step = make_shard_map_train_step(model, cfg, tx, mesh)
    start = state.step
    state, metrics = train_step(state, rows)
    assert state.step == start + 1

    # a sample-sharded importance-weighted eval chunk
    evaluator = make_batch_evaluator(model, cfg, n_samples=2 * sample * 5, k_chunk=sample * 5,
                                     mesh=mesh)
    llh = evaluator(images, torch.Generator(device=dev).manual_seed(0))

    # the explicit-collective step (the mean over the batch shards)
    state, sm_metrics = make_shard_map_train_step(model, cfg, tx, mesh)(state, rows)

    # ZeRO-1: reduce-scattered gradients, 1/n of the moments a rank
    z_state = dataclasses.replace(state, opt_state=zero1_opt_state(tx, state.params, mesh))
    z_state, z_metrics = make_zero1_train_step(model, cfg, tx, mesh)(z_state, rows)

    # (a) steps_per_call: one program runs 4 updates on stacked batches
    spc = 4
    start = state.step
    multi_step = make_multi_train_step(model, cfg, tx, n_steps=spc, mesh=mesh)
    state, m_metrics = multi_step(state, torch.stack([rows] * spc))
    assert state.step == start + spc

    # (b) the EMA step and eval_params' read of the averaged weights
    ema_train = dataclasses.replace(cfg.train, ema_decay=0.999)
    ema_cfg = dataclasses.replace(cfg, train=ema_train)
    ema_model, ema_state = fresh(cfg.model, ema_train)
    ema_state = shard_state(mesh, ema_state)
    ema_step = make_shard_map_train_step(ema_model, ema_cfg, make_optimizer(ema_train), mesh)
    ema_state, e_metrics = ema_step(ema_state, rows)
    ep = eval_params(ema_train, ema_state)
    assert ep is ema_state.ema_params

    # (c) a checkpoint round trip of the replicated state, into another model's
    ck = Checkpointer(os.path.join(work, "ckpt"), "dryrun")
    ck.save(state, "latest")
    ck.wait()
    target_model, target = fresh(cfg.model, cfg.train, seed=1)
    restored = ck.restore_latest(shard_state(mesh, target))
    assert restored is not None and restored.step == state.step
    assert all(torch.equal(restored.params[name], p) for name, p in state.params.items())

    # (d) one evaluate_llh pass (sample-sharded, streaming) under the mesh
    test_imgs = np.zeros((batch, 32, 32, 3), np.uint8) + np.uint8(127)
    mean_llh, _, ev_metrics = evaluate_llh(target_model, cfg, test_imgs,
                                           n_samples=2 * sample * 5, k_chunk=sample * 5,
                                           batch_size=batch, mesh=mesh)

    # (e) tensor parallelism: the hidden channels over "model" (min_features
    # 16, so the narrowed layers shard; the 50-channel head stays whole)
    tp_model = 2 if n_devices % 2 == 0 else 1
    tp_mesh = make_tp_mesh(n_devices // tp_model, tp_model)
    tp_net, tp_state = fresh(cfg.model, cfg.train)
    tp_state = shard_state_tp(tp_state, tp_mesh, min_features=16, model=tp_net)
    tp_state, tp_metrics = make_shard_map_train_step(
        tp_net, cfg, make_optimizer(cfg.train), tp_mesh)(tp_state,
                                                         shard_batch_tp(images, tp_mesh))
    # with an odd rank count the model axis is 1, and nothing is really sharded
    tp_leaf = sorted(tp_state.tp_layout.dims) if tp_model > 1 else []
    if tp_model > 1:
        assert tp_leaf, "TP layout: expected channel-sharded layers"

    # (f) a hybrid mesh of two hosts: host-major blocks on data, so the sample
    # collectives stay inside a host (the guard is on the data axis: n = 6
    # has sample 2 and data 3, which two hosts cannot split)
    hybrid_loss = float("nan")
    if n_devices % 2 == 0 and (n_devices // sample) % 2 == 0:
        per_slice = n_devices // 2
        h_mesh = make_mesh(MeshConfig(data=n_devices // sample, sample=sample),
                           slice_of=lambda r: r // per_slice)
        h_model, h_state = fresh(cfg.model, cfg.train)
        h_state = shard_state(h_mesh, h_state)
        _, h_metrics = make_shard_map_train_step(h_model, cfg, make_optimizer(cfg.train),
                                                 h_mesh)(h_state, shard_batch(h_mesh, images))
        hybrid_loss = float(h_metrics["loss"])

    # (g) the biladder family under the mesh
    bl_mcfg = BiLadderConfig(stages=((8, 4, 1, 2), (8, 4, 1, 2)), n_samples=2,
                             stem_features=8)
    bl_cfg = ExperimentConfig(model=bl_mcfg, data=DataConfig(dataset="synthetic:svhn_cropped",
                                                             batch_size=batch),
                              train=cfg.train)
    bl_model, bl_state = fresh(bl_mcfg, cfg.train)
    bl_state = shard_state(mesh, bl_state)
    bl_state, bl_metrics = make_shard_map_train_step(bl_model, bl_cfg,
                                                     make_optimizer(cfg.train), mesh)(bl_state,
                                                                                      rows)
    assert bl_state.step == 1

    return (
        f"[dryrun_multichip] ok: mesh data={mesh_cfg.data} sample={sample}, "
        f"jit loss={float(metrics['loss']):.3f}, "
        f"shard_map loss={float(sm_metrics['loss']):.3f}, "
        f"zero1 loss={float(z_metrics['loss']):.3f}, "
        f"eval llh[0]={float(llh[0]):.3f}, "
        f"scan(spc={spc}) loss={float(m_metrics['loss']):.3f}, "
        f"ema loss={float(e_metrics['loss']):.3f}, "
        f"ckpt roundtrip step={restored.step}, "
        f"evaluate_llh mean={mean_llh:.3f} bpd={ev_metrics['bpd']:.3f}, "
        f"tp({n_devices // tp_model}x{tp_model}) "
        f"loss={float(tp_metrics['loss']):.3f} "
        f"sharded_leaves={len(tp_leaf)}, "
        f"hybrid-dcn loss={hybrid_loss:.3f}, "
        f"biladder loss={float(bl_metrics['loss']):.3f}"
    )


def _rank_main(rank: int, world: int, work: str, device: str) -> None:
    import torch.distributed as dist

    from vae_mdl_tpu_torch.parallel.distributed import init_distributed

    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"file://{os.path.join(work, 'store')}", world, rank, device=device,
                     timeout=DRYRUN_TIMEOUT)
    try:
        line = _dryrun(world, device, work)
        if rank == 0:
            print(line, flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="entry() and dryrun_multichip(n) on the port")
    parser.add_argument("n", nargs="?", type=int, help="ranks (default: every card; 1 with "
                                                       "--cpu)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, the ranks over gloo")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--work", help=argparse.SUPPRESS)
    parser.add_argument("--device", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:  # one rank, started by dryrun_multichip
        _rank_main(args.rank, args.world, args.work, args.device)
        return
    device = "cpu" if args.cpu else None
    fn, example = entry(device)
    with torch.no_grad():
        print("entry loss:", float(fn(*example)))
    n = args.n if args.n is not None else (1 if args.cpu else torch.cuda.device_count())
    dryrun_multichip(n, device)


if __name__ == "__main__":
    main()
