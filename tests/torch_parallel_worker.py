"""One rank of the port's multi-process tests (tests/test_torch_parallel*.py).

    python tests/torch_parallel_worker.py SCENARIO RANK WORLD WORKDIR

joins a gloo group of WORLD ranks over a FileStore in WORKDIR, runs
SCENARIO on the CPU and writes what it computed to
``WORKDIR/out_<RANK>.pt``. The test that spawns the ranks writes its
inputs (initial parameters, batches, noise) to ``WORKDIR/inputs.pt`` first
and reads every rank's output afterwards. A rank imports torch, numpy and
the port only, never jax.
"""
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from vae_mdl_tpu_torch import config as c
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.parallel.distributed import init_distributed
from vae_mdl_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_state
from vae_mdl_tpu_torch.parallel.spmd import (
    FLAT,
    elastic_restore_zero1,
    gather_zero1_opt_state,
    make_shard_map_train_step,
    make_zero1_train_step,
    reshard_zero1_opt_state,
    zero1_opt_state,
)
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step, reduce_scan_metrics


def narrow_model(cfg_module=c, name="narrow", n_latent=4):
    """The model05 family at 8x8x3: every layer type (convs, a transposed
    conv, dense layers) at widths a test runs in seconds."""
    m = cfg_module
    return m.ModelConfig(
        name=name, image_shape=(8, 8, 3), n_latent=n_latent, likelihood="mdl", n_mix=2,
        encoder=m.EncoderConfig(kind="conv", conv_layers=(m.conv(8, 3, 1), m.conv(16, 3, 2))),
        decoder=m.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(m.deconv(8, 4, 2), m.conv(20, 3, 1, "none"))),
    )


def tiny_mlp(n_hidden=64):
    """tests/multihost_worker.py's tiny MLP (here 64 wide, so that its hidden
    layers are wide enough to shard over model ranks)."""
    return c.ModelConfig(name="tiny", image_shape=(28, 28, 1), n_latent=8, n_samples=2,
                         likelihood="bernoulli",
                         encoder=c.EncoderConfig(kind="mlp", n_hidden=n_hidden),
                         decoder=c.DecoderConfig(kind="mlp", n_hidden=n_hidden))


def tiny_ladder(family):
    """tests/test_parallel.py's tiny ladders."""
    if family == "ladder":
        from vae_mdl_tpu_torch.models.ladder import LadderConfig

        return LadderConfig(stages=((8, 4, 1, 2), (8, 4, 1, 2)), n_samples=2, stem_features=8)
    from vae_mdl_tpu_torch.models.bidirectional import BiLadderConfig

    return BiLadderConfig(stages=((8, 4, 1, 2), (8, 4, 1, 2)), n_samples=2, stem_features=8)


def experiment_of(model_cfg, batch_size=8, **train):
    cfg = experiment("model05", model=model_cfg) if isinstance(model_cfg, c.ModelConfig) \
        else c.ExperimentConfig(model=model_cfg)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset="synthetic:svhn_cropped",
                                      batch_size=batch_size),
        train=dataclasses.replace(cfg.train, **train))


def setup(cfg, params=None, seed=0):
    """(model, tx, state) on the CPU; ``params`` (a state_dict) set first."""
    model = build_model(cfg.model, torch.Generator().manual_seed(seed), device="cpu")
    if params is not None:
        model.load_state_dict(params)
    tx = make_optimizer(cfg.train)
    return model, tx, create_train_state(model, cfg.train)


def snapshot(state):
    """The state as plain tensors (params, EMA, optimizer tree), copied."""
    return copy.deepcopy({"params": {n: p.detach() for n, p in state.params.items()},
                          "opt_state": state.opt_state, "ema": state.ema_params,
                          "step": state.step})


def _float(metrics):
    return {k: (float(v) if not isinstance(v, list) else [float(u) for u in v])
            for k, v in metrics.items()}


# -- scenarios -------------------------------------------------------------------


def dp_suite(rank, world, inputs):
    """The data-parallel and ZeRO-1 steps against the single-rank step and
    each other on the narrow model (tests/test_parallel.py's cases)."""
    out = {}
    batch = torch.from_numpy(inputs["batch"])  # the whole batch
    eps = torch.from_numpy(inputs["eps"])  # [k, B, n], the whole batch's
    mesh = make_mesh(c.MeshConfig())
    rows = shard_batch(mesh, batch)

    # one step each: single rank on every row, DP and ZeRO-1 on this rank's
    for name, train in (("plain", {}), ("ema", {"ema_decay": 0.9}),
                        ("clip", {"grad_clip_norm": 0.01}),
                        ("skip", {"grad_skip_threshold": 1e-9})):
        cfg = experiment_of(narrow_model(), **train)
        model, tx, single = setup(cfg, inputs["params"])
        single, m1 = make_train_step(model, cfg, tx)(single, batch, eps=eps)
        out[f"{name}/single"] = (snapshot(single), _float(m1))

        model, tx, state = setup(cfg, inputs["params"])
        state = shard_state(mesh, state)
        state, m2 = make_shard_map_train_step(model, cfg, tx, mesh)(state, rows, eps=eps)
        out[f"{name}/dp"] = (snapshot(state), _float(m2))

        model, tx, state = setup(cfg, inputs["params"])
        state.opt_state = zero1_opt_state(tx, state.params, mesh)
        state, m3 = make_zero1_train_step(model, cfg, tx, mesh)(state, rows, eps=eps)
        snap = snapshot(state)
        snap["opt_state"] = gather_zero1_opt_state(state.opt_state)
        out[f"{name}/zero1"] = (snap, _float(m3))

    # three steps on the generators' own draws: DP and ZeRO-1 fold the same
    # rank index in, so they see the same noise
    cfg = experiment_of(narrow_model())
    losses = {}
    for kind in ("dp", "zero1"):
        model, tx, state = setup(cfg, inputs["params"])
        if kind == "dp":
            step = make_shard_map_train_step(model, cfg, tx, mesh)
        else:
            state.opt_state = zero1_opt_state(tx, state.params, mesh)
            step = make_zero1_train_step(model, cfg, tx, mesh)
        history = []
        for _ in range(3):
            state, m = step(state, rows)
            history.append(float(m["loss"]))
        losses[kind] = history
        snap = snapshot(state)
        if kind == "zero1":
            snap["local_mu"] = state.opt_state["mu"][FLAT].clone()
            snap["opt_state"] = gather_zero1_opt_state(state.opt_state)
        out[f"three/{kind}"] = snap
    out["three/losses"] = losses
    return out


def ladder_suite(rank, world, inputs):
    """The ladders under the data-parallel step and ZeRO-1 (with and
    without an always-exceeded skip threshold)."""
    out = {}
    mesh = make_mesh(c.MeshConfig())
    for family in ("ladder", "biladder"):
        batch = torch.from_numpy(inputs["batch32"])
        eps = [torch.from_numpy(e) for e in inputs[f"eps_{family}"]]
        cfg = experiment_of(tiny_ladder(family), batch_size=batch.shape[0])
        model, tx, single = setup(cfg, seed=5)
        params0 = {n: p.detach().clone() for n, p in single.params.items()}
        single, m1 = make_train_step(model, cfg, tx)(single, batch, eps=eps)
        model, tx, state = setup(cfg, params0)
        state, m2 = make_shard_map_train_step(model, cfg, tx, mesh)(
            state, shard_batch(mesh, batch), eps=eps)
        out[f"{family}/single"] = (snapshot(single), _float(m1))
        out[f"{family}/dp"] = (snapshot(state), _float(m2))
        if family == "biladder":
            out["biladder/init"] = params0
            for skip in (0.0, 1e-9):
                cfg = experiment_of(tiny_ladder(family), batch_size=batch.shape[0],
                                    grad_skip_threshold=skip)
                model, tx, state = setup(cfg, params0)
                state.opt_state = zero1_opt_state(tx, state.params, mesh)
                state, m = make_zero1_train_step(model, cfg, tx, mesh)(
                    state, shard_batch(mesh, batch))
                snap = snapshot(state)
                snap["local_mu"] = state.opt_state["mu"][FLAT].clone()
                out[f"biladder/zero1_skip{skip:g}"] = (snap, _float(m))
    return out


def tp_suite(rank, world, inputs):
    """The tensor-parallel layout (model = 2, min_features 8, so every layer
    type of the narrow model shards) against the single-rank step: the
    unchanged ``make_train_step`` at data = 1 and the data-parallel step on
    a 2x2 mesh where there are four ranks."""
    from vae_mdl_tpu_torch.parallel.tensor import make_tp_mesh, shard_state_tp
    from vae_mdl_tpu_torch.train.checkpoint import whole_state_dict

    out = {}
    batch = torch.from_numpy(inputs["batch"])
    eps = torch.from_numpy(inputs["eps"])
    n_data = world // 2
    mesh = make_tp_mesh(n_data, 2)
    # the memory path the MoDL kernel would take for the head's parameters
    from vae_mdl_tpu_torch.distributions.mixture import MixtureDiscretizedLogistic
    from vae_mdl_tpu_torch.ops.cuda.mdl_kernel import forward_path

    log_prob, paths = MixtureDiscretizedLogistic.log_prob, []

    def recording(self, x):
        paths.append(forward_path(self.parameters))
        return log_prob(self, x)

    MixtureDiscretizedLogistic.log_prob = recording
    for name, train in (("plain", {}), ("clip", {"grad_clip_norm": 0.01})):
        cfg = experiment_of(narrow_model(), **train)
        model, tx, state = setup(cfg, inputs["params"])
        state = shard_state_tp(state, mesh, min_features=8, model=model)
        out[f"{name}/local_shapes"] = {n: tuple(p.shape) for n, p in state.params.items()}
        out[f"{name}/sharded"] = sorted(state.tp_layout.dims.items())
        if n_data == 1:
            step = make_train_step(model, cfg, tx)
        else:
            step = make_shard_map_train_step(model, cfg, tx, mesh)
        paths.clear()
        state, m = step(state, shard_batch(mesh, batch), eps=eps)
        out[f"{name}/head_paths"] = list(paths)
        sd = whole_state_dict(state)
        out[name] = ({"params": sd["params"], "opt_state": sd["opt_state"]}, _float(m))
    return out


def eval_suite(rank, world, inputs):
    """make_batch_evaluator under meshes of every (data, sample) split of
    the ranks, on injected noise and on a generator, with the k-hat tails
    and the convergence curve."""
    from vae_mdl_tpu_torch.evaluation.harness import make_batch_evaluator

    from vae_mdl_tpu_torch.parallel.mesh import batch_sharding

    cfg = experiment_of(narrow_model())
    model, _, _ = setup(cfg, inputs["params"])
    batch = torch.from_numpy(inputs["eval_batch"])
    eps = torch.from_numpy(inputs["eval_eps"])
    out = {"meshes": {}}
    # the mesh shapes and their errors (tests/test_parallel.py::test_mesh_shapes)
    for mesh_cfg in (c.MeshConfig(), c.MeshConfig(data=world // 2, sample=2),
                     c.MeshConfig(data=1, sample=world // 2, model=2)):
        mesh = make_mesh(mesh_cfg)
        out["meshes"][str(mesh_cfg)] = (dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                                        batch_sharding(mesh))
    for bad in (c.MeshConfig(data=3, sample=2), c.MeshConfig(sample=3)):
        try:
            make_mesh(bad)
        except ValueError as e:
            out["meshes"][str(bad)] = str(e)
    for data in [d for d in (1, 2, 4) if world % d == 0 and d <= world]:
        mesh = make_mesh(c.MeshConfig(data=data, sample=world // data))
        ev = make_batch_evaluator(model, cfg, n_samples=32, k_chunk=4, with_khat=True,
                                  with_curve=True, mesh=mesh)
        out[f"{data}x{world // data}/eps"] = ev(batch, eps=eps)
        out[f"{data}x{world // data}/gen"] = ev(batch, torch.Generator().manual_seed(3))
    return out


def trainer_suite(rank, world, inputs):
    """Trainer(cfg, mesh=...) on two ranks (tests/test_multihost.py), then
    evaluate_llh striped over them and over a tensor-parallel mesh."""
    from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
    from vae_mdl_tpu_torch.train.checkpoint import whole_state_dict
    from vae_mdl_tpu_torch.train.trainer import Trainer

    workdir = inputs["workdir"]
    out = {}
    for name, mesh_cfg in (("dp", c.MeshConfig()), ("tp", c.MeshConfig(data=1, model=world))):
        cfg = experiment_of(tiny_mlp(), batch_size=16, n_updates=4, eval_interval=2,
                            report_images=False, lr_staircase=False,
                            checkpoint_dir=os.path.join(workdir, name, "ckpt"),
                            log_dir=os.path.join(workdir, name, f"tb{rank}"))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, dataset="synthetic:mnist", val_batch_size=32))
        trainer = Trainer(cfg, device="cpu", mesh=make_mesh(mesh_cfg))
        if name == "dp":
            # the CLI's output-bias init: each rank reads batches of its own slice
            from vae_mdl_tpu_torch.cli.run import _maybe_bias_init

            _maybe_bias_init(trainer)
        if name == "tp":
            out["tp/sharded"] = sorted(trainer.state.tp_layout.dims)
        losses = []
        real_step = trainer.train_step

        def recording(state, batch, step=real_step):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m

        trainer.train_step = recording
        state = trainer.fit(progress=False)
        out[f"{name}/losses"] = losses
        out[f"{name}/best"] = state.best_val_loss
        out[f"{name}/step"] = state.step
        out[f"{name}/params"] = whole_state_dict(state)["params"]  # the TP slices gathered
        images = np.asarray(trainer.test_set[0][:88])
        mean, per_image, metrics = evaluate_llh(trainer.model, cfg, images, n_samples=8,
                                                k_chunk=4, batch_size=16, khat=False,
                                                k_curve=True, mesh=trainer.mesh)
        out[f"{name}/eval"] = (mean, per_image, metrics)
        if name == "dp":
            # thirteen images in batches of ten: a padded tail, striped
            small = evaluate_llh(trainer.model, cfg, images[:13], n_samples=32, k_chunk=8,
                                 batch_size=10, khat=True, mesh=trainer.mesh)
            out["dp/small_eval"] = small
    # the device-resident dataset, two steps a call, under the mesh
    cfg = experiment_of(tiny_mlp(), batch_size=16, n_updates=4, eval_interval=2,
                        steps_per_call=2, device_dataset=True, report_images=False,
                        checkpoint_dir=os.path.join(workdir, "device", "ckpt"),
                        log_dir=os.path.join(workdir, "device", f"tb{rank}"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic:mnist",
                                                            val_batch_size=500))
    trainer = Trainer(cfg, device="cpu", mesh=make_mesh(c.MeshConfig()))
    state = trainer.fit(progress=False)
    out["device/step"] = state.step
    out["device/params"] = {n: p.detach().clone() for n, p in state.params.items()}
    return out


def _elastic_cfg():
    # n_latent 5: 9014 parameters, padded to 9014 for two ranks and 9016
    # for four, so the saved length really names the rank count
    return experiment_of(narrow_model(n_latent=5))


def elastic_save(rank, world, inputs):
    """Two steps of ZeRO-1 and of the data-parallel step, each checkpointed;
    the ZeRO-1 state also kept whole as it is in memory (``mem.pt``)."""
    from vae_mdl_tpu_torch.train.checkpoint import Checkpointer

    cfg = _elastic_cfg()
    mesh = make_mesh(c.MeshConfig())
    rows = shard_batch(mesh, torch.from_numpy(inputs["batch"]))
    model, tx, state = setup(cfg, seed=1)
    state.opt_state = zero1_opt_state(tx, state.params, mesh)
    step = make_zero1_train_step(model, cfg, tx, mesh)
    for _ in range(2):
        state, _ = step(state, rows)
    Checkpointer(inputs["ckpt_dir"], "zero1").save(state, "latest")
    mem = snapshot(state)
    mem["opt_state"] = gather_zero1_opt_state(state.opt_state)
    if rank == 0:
        torch.save(mem, os.path.join(inputs["ckpt_dir"], "mem.pt"))
    model, tx, plain = setup(cfg, seed=1)
    step = make_shard_map_train_step(model, cfg, tx, mesh)
    for _ in range(2):
        plain, _ = step(plain, rows)
    Checkpointer(inputs["ckpt_dir"], "plain").save(plain, "latest")
    return {"local_mu": state.opt_state["mu"][FLAT].clone(), "mem": mem,
            "plain": snapshot(plain)}


def elastic_restore(rank, world, inputs):
    """The checkpoints of ``elastic_save`` restored under this rank count:
    ZeRO-1 through ``elastic_restore_zero1`` and through an in-memory
    reshard of the live state, each taken one step further; the plain
    data-parallel state through ``Checkpointer.restore_latest``."""
    from vae_mdl_tpu_torch.train.checkpoint import Checkpointer

    cfg = _elastic_cfg()
    mesh = make_mesh(c.MeshConfig())
    rows = shard_batch(mesh, torch.from_numpy(inputs["batch"]))
    ck = Checkpointer(inputs["ckpt_dir"], "zero1")
    out = {"meta": ck.metadata_tree("latest")}

    model, tx, s_ck = setup(cfg, seed=2)
    s_ck.opt_state = zero1_opt_state(tx, s_ck.params, mesh)
    elastic_restore_zero1(ck, s_ck, mesh, "latest")
    out["restored"] = snapshot(s_ck)
    out["restored"]["opt_state"] = gather_zero1_opt_state(s_ck.opt_state)
    out["restored"]["local_mu"] = s_ck.opt_state["mu"][FLAT].clone()
    s_ck, m_ck = make_zero1_train_step(model, cfg, tx, mesh)(s_ck, rows)

    mem = torch.load(os.path.join(inputs["ckpt_dir"], "mem.pt"), weights_only=False)
    model, tx, s_mem = setup(cfg, mem["params"], seed=2)
    s_mem.step = mem["step"]
    s_mem.opt_state = reshard_zero1_opt_state(mem["opt_state"], s_mem.params, mesh)
    s_mem, m_mem = make_zero1_train_step(model, cfg, tx, mesh)(s_mem, rows)
    out["ck_step"] = (snapshot(s_ck), float(m_ck["loss"]))
    out["mem_step"] = (snapshot(s_mem), float(m_mem["loss"]))

    model, tx, plain = setup(cfg, seed=2)
    Checkpointer(inputs["ckpt_dir"], "plain").restore_latest(plain)
    out["plain"] = snapshot(plain)
    plain, m = make_shard_map_train_step(model, cfg, tx, mesh)(plain, rows)
    out["plain_loss"] = float(m["loss"])
    return out


def serving_model(name, params=None):
    """(cfg, model, params) on the CPU: ``"model01"`` (the zoo's) or
    ``"narrow"`` (``narrow_model``) from seed 0, or with ``params`` (a
    state_dict) in place of the seeded weights."""
    from vae_mdl_tpu_torch.models.zoo import MODELS

    cfg = MODELS["model01"] if name == "model01" else narrow_model()
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    if params is not None:
        model.load_state_dict(params)
    return cfg, model, {n: p.detach() for n, p in model.named_parameters()}


def export_mesh(rank, world, inputs):
    """Sharded serving (models/export.py), one phase a set of processes.

    ``phase == "export"``: each entry of ``inputs["exports"]`` (``mesh``,
    ``model``, ``params`` key or None, ``what``, global batch ``n``,
    ``path``, where ``{rank}`` in it is this rank's number) exported with
    ``mesh=make_mesh(MeshConfig(*mesh))``: -> {path: (the bytes' length,
    or the bytes where the entry has ``keep``; the file's existence after
    the call)}.
    ``phase == "load"``: each entry of ``inputs["loads"]`` (``key``,
    ``path``, ``seed``, the global ``images`` or None) loaded with
    ``load_exported(path, "cpu")`` and run: -> {key: output}; each entry of
    ``inputs["raw"]`` (the same) served without the loader
    (``torch_alone``); each entry of ``inputs["refusals"]`` (the same,
    expected to raise) -> {key: the error's type and message}."""
    from vae_mdl_tpu_torch.models.export import (
        export_encoder,
        export_reconstructor,
        export_sampler,
        load_exported,
    )

    out = {}
    if inputs["phase"] == "export":
        meshes = {}
        for e in inputs["exports"]:
            if e["mesh"] not in meshes:
                meshes[e["mesh"]] = make_mesh(c.MeshConfig(*e["mesh"]))
            cfg, model, params = serving_model(e["model"], inputs["params"].get(e["params"]))
            path = e["path"].format(rank=rank)
            mesh = meshes[e["mesh"]]
            if e["what"] == "sampler":
                blob = export_sampler(model, cfg, params, n=e["n"], path=path, mesh=mesh)
            else:
                fn = export_encoder if e["what"] == "encoder" else export_reconstructor
                blob = fn(model, cfg, params, (e["n"],) + tuple(cfg.image_shape), path=path,
                          mesh=mesh)
            out[path] = (blob if e.get("keep") else len(blob), os.path.exists(path))
        return out
    for key, path, seed, images in inputs["loads"]:
        data = () if images is None else (torch.from_numpy(images),)
        got = load_exported(path, "cpu")(seed, *data)
        out[key] = tuple(got) if isinstance(got, tuple) else got
    for key, path, seed, images in inputs.get("raw", ()):
        got = torch_alone(path, seed, images)
        out[key] = tuple(got) if isinstance(got, tuple) else got
    for key, path, seed, images in inputs.get("refusals", ()):
        try:
            data = () if images is None else (torch.from_numpy(images),)
            load_exported(path, "cpu")(seed, *data)
            out[key] = None
        except (RuntimeError, ValueError) as err:
            out[key] = (type(err).__name__, str(err))
    return out


def torch_alone(path, seed, images):
    """A sharded file served as a process with torch alone would serve it:
    ``torch.export.load``, this rank's rows of the noise (drawn at the
    global shape from ``seed``, as ``load_exported`` draws it) and of the
    images, as ``mesh.json`` says, into the program's ``module()``."""
    import json

    from vae_mdl_tpu_torch.models.inference import draw_noise

    extra = {"noise.json": "", "mesh.json": ""}
    program = torch.export.load(path, extra_files=extra)
    spec = [(e["name"], tuple(e["shape"]), e["kind"])
            for e in json.loads(extra["noise.json"])["noise"]]
    layout = json.loads(extra["mesh.json"])
    shards = np.asarray(layout["ranks"]).reshape(layout["shards"], -1)
    index = int(np.nonzero((shards == dist.get_rank()).any(axis=1))[0][0])
    per = layout["batch"] // layout["shards"]
    noise = draw_noise(spec, torch.Generator().manual_seed(seed), torch.device("cpu"))
    inputs = [t.narrow(axis, index * per, per)
              for t, axis in zip(noise, layout["noise_batch_axes"])]
    if images is not None:
        inputs.append(torch.from_numpy(images).narrow(0, index * per, per))
    return program.module()(*inputs)


def mesh_window_suite(rank, world, inputs):
    """The mesh windows (``make_multi_train_step(mesh=)``,
    ``make_device_data_train_step(mesh=)``) of 10 steps against 10 calls of
    the one-step mesh step, the device-data rows written out as the eager
    loop drew them (the unfolded "device_batch" stream, this rank's slice of
    the indices); under beta warm-up too, with the betas each window takes."""
    from vae_mdl_tpu_torch.parallel.mesh import batch_sharding
    from vae_mdl_tpu_torch.train.steps import (
        make_device_data_train_step,
        make_multi_train_step,
    )

    mesh = make_mesh(c.MeshConfig())
    index, count = batch_sharding(mesh)
    batches = torch.from_numpy(inputs["batches"])  # [10, B, ...], the whole batches
    rows = torch.stack([shard_batch(mesh, b) for b in batches])
    data = torch.from_numpy(inputs["data"])
    out = {"index": index, "folds": {}}
    for name, train in (("plain", {}), ("warmup", {"beta_warmup_steps": 4, "ema_decay": 0.9})):
        cfg = experiment_of(narrow_model(), **train)
        model, tx, state = setup(cfg, inputs["params"])
        multi = make_multi_train_step(model, cfg, tx, 10, mesh=mesh)
        state, m = multi(state, rows)
        out[f"{name}/window"] = (snapshot(state), _float(m), multi.cache_size())
        out["folds"]["window"] = dict(multi.fold)
        out[f"{name}/betas"] = [float(b) for b in multi.betas(0, "cpu")]
        model, tx, state = setup(cfg, inputs["params"])
        step = make_shard_map_train_step(model, cfg, tx, mesh)
        history = []
        for batch in rows:
            state, m = step(state, batch)
            history.append(m)
        out[f"{name}/steps"] = (snapshot(state), _float(reduce_scan_metrics(history)))

        model, tx, state = setup(cfg, inputs["params"])
        device = make_device_data_train_step(model, cfg, tx, 10, len(data), mesh=mesh)
        state, m = device(state, data)
        out[f"{name}/device"] = (snapshot(state), _float(m))
        out["folds"]["device"] = dict(device.fold)
        # the eager loop as the port ran it before the window was captured
        model, tx, state = setup(cfg, inputs["params"])
        step = make_shard_map_train_step(model, cfg, tx, mesh)
        per = cfg.data.batch_size // count
        history, drawn = [], []
        for _ in range(10):
            gen = state.next_rngs("device_batch")["device_batch"]
            idx = torch.randint(0, len(data), (cfg.data.batch_size,), generator=gen)
            drawn.append(idx)
            state, m = step(state, data[idx[index * per:(index + 1) * per]])
            history.append(m)
        out[f"{name}/device_steps"] = (snapshot(state), _float(reduce_scan_metrics(history)))
        out[f"{name}/indices"] = torch.stack(drawn)
    return out


def retrace_suite(rank, world, inputs):
    """``Trainer(mesh=...)``'s retrace guard over the ranks
    (tests/test_retrace.py's cases): one key a step function across a run,
    and one warning, once, on a drifting input signature."""
    import contextlib
    import io

    from vae_mdl_tpu_torch.train.trainer import Trainer

    workdir = inputs["workdir"]
    out, trainers = {}, {}
    for spc in (1, 2):
        cfg = experiment_of(tiny_mlp(), batch_size=16, n_updates=4, eval_interval=2,
                            steps_per_call=spc, report_images=False,
                            checkpoint_dir=os.path.join(workdir, f"spc{spc}", "ckpt"),
                            log_dir=os.path.join(workdir, f"spc{spc}", f"tb{rank}"))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, dataset="synthetic:mnist", val_batch_size=32))
        trainer = trainers[spc] = Trainer(cfg, device="cpu", mesh=make_mesh(c.MeshConfig()))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            trainer.fit(progress=False)
        out[f"spc{spc}"] = {"sizes": (trainer.train_step.cache_size(),
                                      trainer.eval_step.cache_size()),
                            "n_steps": trainer.train_step.n_steps,
                            "printed": printed.getvalue()}
    # dtype drift: a float32 batch is another key of the same function
    trainer = trainers[1]
    batch = torch.zeros((8, 28, 28, 1), dtype=torch.uint8)
    trainer.state, _ = trainer.train_step(trainer.state, batch)
    trainer.state, _ = trainer.train_step(trainer.state, batch.float() / 255.0)
    checks = []
    for _ in range(2):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            trainer._check_retrace()
        checks.append(printed.getvalue())
    out["drift"] = {"size": trainer.train_step.cache_size(), "checks": checks}
    return out


def sharding_suite(rank, world, inputs):
    """``sample_sharding`` on the meshes of ``eval_suite``, with the rank
    array each mesh lays out."""
    from vae_mdl_tpu_torch.parallel.mesh import sample_sharding

    out = {}
    for mesh_cfg in (c.MeshConfig(), c.MeshConfig(data=world // 2, sample=2),
                     c.MeshConfig(data=1, sample=world // 2, model=2)):
        mesh = make_mesh(mesh_cfg)
        out[(mesh_cfg.data, mesh_cfg.sample, mesh_cfg.model)] = (
            sample_sharding(mesh), mesh.mesh.tolist(), list(mesh.mesh_dim_names))
    return out


SCENARIOS = {"dp_suite": dp_suite, "ladder_suite": ladder_suite, "tp_suite": tp_suite,
             "eval_suite": eval_suite, "trainer_suite": trainer_suite,
             "elastic_save": elastic_save, "elastic_restore": elastic_restore,
             "export_mesh": export_mesh, "mesh_window_suite": mesh_window_suite,
             "retrace_suite": retrace_suite, "sharding_suite": sharding_suite}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launcher's variables a rank must not inherit: it is given its rank
_DROP = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
         "XLA_FLAGS", "JAX_PLATFORMS")


def spawn(scenario, world, workdir, inputs=None, timeout=120):
    """Run ``scenario`` in ``world`` rank processes and return their
    outputs in rank order; a rank that fails or outlives ``timeout``
    seconds fails the caller, with its log."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    if inputs is not None:
        torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if k not in _DROP}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r),
                               str(world), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{logs[r]}"
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    scenario, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    init_distributed(f"file://{os.path.join(workdir, 'store')}", world, rank, device="cpu",
                     timeout=120)
    path = os.path.join(workdir, "inputs.pt")
    inputs = torch.load(path, weights_only=False) if os.path.exists(path) else {}
    out = SCENARIOS[scenario](rank, world, inputs)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
