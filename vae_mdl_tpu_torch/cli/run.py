"""The command line, as users start the port.

Port of ``vae_mdl_tpu/cli/run.py`` with its subcommands and flag names:

    python -m vae_mdl_tpu_torch.cli.run train model05 [--n-updates N] [--dataset D]
    python -m vae_mdl_tpu_torch.cli.run eval  model05 [--n-samples 5000] [--ckpt best]
    python -m vae_mdl_tpu_torch.cli.run sample model05 [--n 64]
    python -m vae_mdl_tpu_torch.cli.run export model05 [--what sampler]
    python -m vae_mdl_tpu_torch.cli.run convert model05 --from-reference PREFIX
    python -m vae_mdl_tpu_torch.cli.run parity model05 [--allow-synthetic]
    python -m vae_mdl_tpu_torch.cli.run list
    python -m vae_mdl_tpu_torch.cli.run describe model05 [--json]

(``vae-mdl-tpu-torch`` once installed; ``python -m vae_mdl_tpu_torch
model05`` is ``train``.) ``train`` runs the reference protocol: training
with checkpoints every eval interval, then the ``best`` checkpoint reloaded,
the input/reconstruction/sample PNG grids written to ``./assets/`` and the
5000-IS test evaluation. Every run records its resolved experiment as
``<checkpoint_dir>/<model>/config.json``, and ``--config FILE`` rebuilds an
experiment from such a file (flag overrides still apply).

Every command runs on the CUDA card (``--device cuda``, the default) and
stops where there is none; ``--device cpu`` is the only way onto the CPU.
``--pallas`` / ``--no-pallas`` force the hand-written CUDA likelihood
kernels or their plain versions (default: the kernels on the card).
Several ranks start under ``torchrun`` (``torchrun --nproc-per-node N -m
vae_mdl_tpu_torch train model05 --mesh N``): ``train``, ``eval`` and
``parity`` join the process group (``parallel.distributed.init_distributed``)
and ``--mesh D|DxS|DxSxM`` lays the ranks out (``parallel.mesh.make_mesh``;
without it, ``cfg.mesh`` where there are several ranks). Only rank 0 prints
results and writes files.
``export`` writes a ``torch.export`` program (``.pt2``) for the device it
runs on; with an explicit ``--mesh`` it joins the process group too and
writes the batch-sharded serving layout over the ranks. ``describe`` builds
the model on the CPU and launches nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os

import numpy as np
import torch


def _json_finite(obj):
    """Non-finite floats (NaN, +-inf) mapped to None, recursively, so that
    ``json.dump`` writes strict RFC 8259 JSON (``null``), not a bare
    ``NaN``."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_finite(v) for v in obj]
    return obj


def _replace_model_field(model_cfg, field: str, value, flag: str):
    """``dataclasses.replace`` that names the flag and the config family
    where the field does not exist (the ladder configs have no objective or
    free bits)."""
    if field not in {f.name for f in dataclasses.fields(model_cfg)}:
        raise SystemExit(
            f"{flag} is not supported by the {type(model_cfg).__name__} family "
            f"({getattr(model_cfg, 'name', '?')}): it has no {field!r} knob")
    return dataclasses.replace(model_cfg, **{field: value})


def _apply_overrides(cfg, args):
    """The experiment with the command line's flags applied: the same flags
    build the same experiment as the JAX package's CLI."""
    model, data, train = cfg.model, cfg.data, cfg.train
    if args.n_updates is not None:
        train = dataclasses.replace(train, n_updates=args.n_updates)
    if args.eval_interval is not None:
        train = dataclasses.replace(train, eval_interval=args.eval_interval)
    if args.dataset is not None:
        data = dataclasses.replace(data, dataset=args.dataset)
    if args.data_dir is not None:
        data = dataclasses.replace(data, data_dir=args.data_dir)
    if args.batch_size is not None:
        data = dataclasses.replace(data, batch_size=args.batch_size)
    if args.checkpoint_dir is not None:
        train = dataclasses.replace(train, checkpoint_dir=args.checkpoint_dir)
    if args.log_dir is not None:
        train = dataclasses.replace(train, log_dir=args.log_dir)
    if args.bf16:
        model = dataclasses.replace(model, compute_dtype="bfloat16")
    if args.pallas is not None:
        model = dataclasses.replace(model, use_pallas=args.pallas)
    if args.likelihood_io_dtype:
        model = _replace_model_field(model, "likelihood_io_dtype", args.likelihood_io_dtype,
                                     "--likelihood-io-dtype")
    if args.no_resume:
        train = dataclasses.replace(train, resume=False)
    if args.steps_per_call:
        train = dataclasses.replace(train, steps_per_call=args.steps_per_call)
    if args.device_dataset:
        train = dataclasses.replace(train, device_dataset=True)
    if args.strict_data:
        data = dataclasses.replace(data, strict=True)
    if args.ema is not None:
        train = dataclasses.replace(train, ema_decay=args.ema)
    if args.bound_logstd:
        model = dataclasses.replace(model, bound_logstd=True)
    if args.grad_clip is not None:
        train = dataclasses.replace(train, grad_clip_norm=args.grad_clip)
    if args.grad_skip is not None:
        train = dataclasses.replace(train, grad_skip_threshold=args.grad_skip)
    if args.beta_warmup is not None:
        train = dataclasses.replace(train, beta_warmup_steps=args.beta_warmup)
    if args.objective:
        model = _replace_model_field(model, "objective", args.objective, "--objective")
    if args.free_bits is not None:
        model = _replace_model_field(model, "free_bits", args.free_bits, "--free-bits")
    if args.snapshot_interval is not None:
        train = dataclasses.replace(train, snapshot_interval=args.snapshot_interval)
    if args.max_snapshots is not None:
        train = dataclasses.replace(train, max_snapshots=args.max_snapshots)
    return dataclasses.replace(cfg, model=model, data=data, train=train)


def _base_config(args):
    """``--config FILE`` where given (its model must be the one named),
    else the zoo entry named by the positional."""
    from vae_mdl_tpu_torch.models.zoo import experiment

    if getattr(args, "config", None):
        from vae_mdl_tpu_torch.config_io import load_config

        try:
            cfg = load_config(args.config)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--config {args.config}: {e}")
        if args.model and args.model != cfg.model.name:
            raise SystemExit(f"--config {args.config} describes model {cfg.model.name!r} "
                             f"but the command names {args.model!r}")
        return cfg
    if not args.model:
        raise SystemExit("a model name or --config FILE is required")
    return experiment(args.model)


def _parse_mesh_spec(mesh_spec: str) -> tuple:
    """``"D"``, ``"DxS"`` or ``"DxSxM"`` -> ``(data, sample, model)``.
    Empty components default to 1 ("4x" == 4x1); anything else is a
    SystemExit with the expected grammar. Shared by every command that
    accepts --mesh so the describe preview validates exactly what
    train/eval would accept."""
    parts = mesh_spec.split("x")
    if not 1 <= len(parts) <= 3:
        raise SystemExit(
            f"--mesh {mesh_spec!r}: expected D, DxS or DxSxM (e.g. 4, 4x2, "
            "2x2x2)")
    try:
        vals = [int(p) if p else 1 for p in parts]
    except ValueError:
        raise SystemExit(
            f"--mesh {mesh_spec!r}: components must be integers (or 'none')")
    if any(v < 1 for v in vals):
        raise SystemExit(
            f"--mesh {mesh_spec!r}: components must be >= 1")
    vals += [1] * (3 - len(vals))
    return tuple(vals)


def _make_mesh_or_none(mesh_spec, mesh_cfg, device: str):
    """The mesh of ``--mesh`` (``none``: no mesh), or of the experiment's
    ``MeshConfig`` where there are several ranks and no ``--mesh``. A
    single process given ``--mesh 1`` becomes a world of one."""
    from vae_mdl_tpu_torch.config import MeshConfig
    from vae_mdl_tpu_torch.parallel.distributed import init_distributed, process_count
    from vae_mdl_tpu_torch.parallel.mesh import make_mesh

    if mesh_spec == "none":
        return None
    if mesh_spec is None:
        if process_count() == 1:
            return None
        cfg = mesh_cfg or MeshConfig()
    else:
        data, sample, model = _parse_mesh_spec(mesh_spec)
        cfg = MeshConfig(data=data, sample=sample, model=model)
        n = data * sample * model
        if process_count() == 1 and n > 1:
            raise SystemExit(
                f"--mesh {mesh_spec!r}: {n} ranks wanted and this process is alone; start "
                f"them with torchrun --nproc-per-node {n} (parallel/distributed.py)")
        if process_count() == 1:
            import tempfile

            store = os.path.join(tempfile.mkdtemp(), "store")
            init_distributed(f"file://{store}", world_size=1, rank=0, device=device)
    try:
        return make_mesh(cfg)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")


def _is_rank0() -> bool:
    from vae_mdl_tpu_torch.parallel.distributed import process_index

    return process_index() == 0


def _device(args) -> torch.device:
    """The device of ``--device``: the card unless ``cpu`` is asked for;
    never the CPU in place of a missing card."""
    if args.device == "cpu":
        if args.pallas:
            raise SystemExit("--pallas forces the CUDA likelihood kernels, which do not run "
                             "with --device cpu; leave it out or pass --no-pallas")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda (the default): torch.cuda.is_available() is False; "
                         "pass --device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _joined_mesh(args, cfg):
    """Join the process group, where torchrun started this process, and
    lay the ranks out: the mesh, or None for one device."""
    from vae_mdl_tpu_torch.parallel.distributed import init_distributed

    init_distributed(device=args.device)
    return _make_mesh_or_none(args.mesh, cfg.mesh, args.device)


def _trainer(args, cfg, distributed: bool = False):
    """The command's Trainer; ``distributed``: join the process group
    first and lay the ranks out (``_joined_mesh``)."""
    from vae_mdl_tpu_torch.train.trainer import Trainer

    mesh = None
    if distributed:
        mesh = _joined_mesh(args, cfg)
    elif args.mesh not in (None, "none"):
        raise SystemExit(f"--mesh {args.mesh!r}: {args.cmd} runs on one device; train, "
                         "eval, parity and export take a mesh (parallel/)")
    return Trainer(cfg, device=_device(args), mesh=mesh)


def _no_resume(cfg):
    """eval/sample/export: no full-state auto-resume; they restore the
    weights alone (``_restore_weights``), whatever optimizer flags trained
    them."""
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, resume=False))


def cmd_train(args) -> None:
    cfg = _apply_overrides(_base_config(args), args)
    trainer = _trainer(args, cfg, distributed=True)
    if args.from_reference:
        if trainer.state.step != 0:
            raise SystemExit("--from-reference warm-starts a FRESH run, but a resumable "
                             "checkpoint exists; pass --no-resume or a new --checkpoint-dir")
        _import_reference(trainer, cfg, args.from_reference, "train")
    elif cfg.model.name == "model01":
        _maybe_bias_init(trainer)

    state = trainer.fit(profile_dir=args.profile)
    if _is_rank0():
        print(f"[train] finished at step {state.step}, best val loss "
              f"{state.best_val_loss:.4f}")
    # the best checkpoint goes into the assets and the final eval, as the
    # reference loads "best" before plotting
    if trainer.ckpt.has("best"):
        trainer.state = trainer.ckpt.restore(trainer.state, "best")
    _dump_assets(trainer, cfg)
    if not args.skip_final_eval:
        _evaluate(trainer, cfg, args.n_samples or cfg.train.n_eval_samples,
                  args.khat, args.k_curve)


def _import_reference(trainer, cfg, prefix: str, what: str) -> None:
    """Load a reference (nbip/vae-mdl Keras ``save_weights``) checkpoint into
    the live state, in place; an EMA copy starts at the imported weights."""
    from vae_mdl_tpu_torch.utils.import_reference import load_reference_weights

    state = trainer.state
    new = load_reference_weights(prefix, cfg.model.name, state.params)
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(new[name])
    if state.ema_params is not None:
        state.ema_params = {name: p.detach().clone() for name, p in state.params.items()}
    print(f"[{what}] imported reference weights from {prefix!r} ({cfg.model.name})")


def _maybe_bias_init(trainer) -> None:
    """model01's decoder output bias from the mean of 8 training batches,
    on a fresh run only (the reference's bias init). Under a mesh each rank
    reads 8 batches of its slice and the means are averaged over the
    ranks, so that every replica starts from the same bias."""
    from vae_mdl_tpu_torch.train.state import init_output_bias

    if trainer.state.step != 0:
        return
    batches = [next(trainer.train_iter) for _ in range(8)]
    mean_img = torch.as_tensor(np.concatenate(batches).astype(np.float32).mean(0) / 255.0)
    if trainer.mesh is not None:
        from vae_mdl_tpu_torch.parallel.mesh import mean_over_replicas

        mean_img = mean_over_replicas(mean_img, trainer.mesh)
    init_output_bias(trainer.state, mean_img)
    if _is_rank0():
        print("[train] decoder output bias initialised to train-mean logits")


def _print_khat(metrics, n_samples: int, n_images: int) -> None:
    """The PSIS k-hat readout (eval and train's final eval)."""
    frac = metrics["khat_frac_gt_07"]
    kmax = metrics["khat_max"]
    n_under = metrics["khat_n_underflow"]
    n_ties = metrics["khat_n_ties"]
    if kmax < 0.5:
        verdict = "RELIABLE (k < 0.5: CLT-rate convergence)"
    elif kmax <= 0.7:
        verdict = "MARGINAL (0.5 <= k <= 0.7: usable but slower-than-CLT convergence)"
    else:
        verdict = (f"{frac:.1%} of images have k-hat > 0.7 — their bound is unreliable at "
                   f"k={n_samples}; raise --n-samples")
    mean = metrics["khat_mean"]
    mean_str = f"{mean:.3f}" if math.isfinite(mean) else "n/a (no fittable tails)"
    print(f"[eval] PSIS k-hat (Vehtari et al. 2024): mean {mean_str}, max {kmax:.3f} "
          f"-> {verdict}")
    if n_under or n_ties:
        print(f"[eval]   degenerate tails: {n_under} underflow-heavy (treated as unreliable), "
              f"{n_ties} all-tied (perfect-proposal) of {n_images} images")


def _print_k_curve(metrics) -> None:
    ks = metrics["k_curve_ks"]
    vals = metrics["k_curve_llh"]
    # log-spaced rows and the final one; the whole curve is in metrics
    shown = sorted({len(ks) - 1} | {int(round(len(ks) ** (p / 6))) - 1 for p in range(7)})
    print("[eval] IS convergence (test-mean bound vs k, one stream):")
    for j in shown:
        tail = "  (final)" if j == len(ks) - 1 else f"  ({vals[-1] - vals[j]:+.3f} to final)"
        print(f"         k={int(ks[j]):>6d}  {vals[j]:.3f}{tail}")


def _evaluate(trainer, cfg, n_samples: int, khat: bool = False, k_curve: bool = False):
    """The n-sample test evaluation of the trainer's eval weights (EMA where
    on). Prints the LLH rounded, then exactly (``repr``), and returns
    ``(mean_llh, metrics)``."""
    from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
    from vae_mdl_tpu_torch.train.state import eval_params

    test = trainer.test_set[0]
    mean_llh, _, metrics = evaluate_llh(trainer.model, cfg, test, n_samples=n_samples,
                                        params=eval_params(cfg.train, trainer.state),
                                        khat=khat, k_curve=k_curve, mesh=trainer.mesh)
    if not _is_rank0():
        return mean_llh, metrics
    print(f"[eval] {n_samples}-IS test LLH: {mean_llh:.2f} nats, bpd: {metrics['bpd']:.4f} "
          f"(llh {mean_llh!r})")
    if khat:
        _print_khat(metrics, n_samples, len(test))
    if k_curve:
        _print_k_curve(metrics)
    return mean_llh, metrics


def _dump_assets(trainer, cfg, out_dir: str = "./assets") -> None:
    """The three PNG grids of ``Trainer.report`` on the eval weights."""
    from vae_mdl_tpu_torch.utils.images import fill_canvas, save_png

    grids = trainer.report(trainer.state.step)  # every rank: a layer may be sharded
    if not _is_rank0():
        return
    os.makedirs(out_dir, exist_ok=True)
    name = cfg.model.name
    for tag, images in zip(("inputs", "recon", "samples"), grids):
        save_png(fill_canvas(images.float().cpu().numpy()), f"{out_dir}/{name}_{tag}.png")
    print(f"[assets] wrote {out_dir}/{name}_{{inputs,recon,samples}}.png")


def cmd_eval(args) -> None:
    cfg = _no_resume(_apply_overrides(_base_config(args), args))
    trainer = _trainer(args, cfg, distributed=True)
    _restore_weights(trainer, cfg, args, "eval")
    _evaluate(trainer, cfg, args.n_samples or cfg.train.n_eval_samples, args.khat,
              args.k_curve)
    if args.active_units:
        from vae_mdl_tpu_torch.evaluation.diagnostics import active_units
        from vae_mdl_tpu_torch.train.state import eval_params

        test = trainer.test_set[0]
        au = active_units(trainer.model, cfg, eval_params(cfg.train, trainer.state), test,
                          batch_size=min(500, len(test)))
        layers = ", ".join(f"z{i + 1}: {a}/{d}"
                           for i, (a, d) in enumerate(zip(au["au"], au["n_dims"])))
        if _is_rank0():  # every rank computes: a layer may be sharded over model
            print(f"[eval] active units (Cov_x(E_q[z|x]) > 0.01, Burda et al. 2016): "
                  f"{layers}")


def _restore_weights(trainer, cfg, args, what: str) -> None:
    """eval/sample/export: a ``--from-reference`` import, else the weights of
    the ``--ckpt`` checkpoint (then ``latest``, then ``best``); the optimizer
    state is never read. Says which weights are in play."""
    if args.from_reference:
        _import_reference(trainer, cfg, args.from_reference, what)
        return
    for tag in (args.ckpt, "latest", "best"):
        if trainer.ckpt.has(tag):
            trainer.ckpt.restore_weights(trainer.state, tag)
            note = "" if tag == args.ckpt else f" (no '{args.ckpt}' checkpoint; fell back)"
            print(f"[{what}] loaded '{tag}' at step {trainer.state.step}{note}")
            if cfg.train.ema_decay == 0 and trainer.ckpt.saved_with_ema(tag):
                print(f"[{what}] NOTE: checkpoint '{tag}' carries EMA weights but --ema was "
                      f"not given; using RAW params. Pass --ema <decay> (e.g. the training "
                      f"value) to {what} the EMA copy.")
            return
    print(f"[{what}] WARNING: no '{args.ckpt}' checkpoint; using INIT weights")


def cmd_sample(args) -> None:
    """Prior samples -> one PNG grid."""
    from vae_mdl_tpu_torch.models.inference import make_sampler
    from vae_mdl_tpu_torch.train.state import eval_params
    from vae_mdl_tpu_torch.utils.images import fill_canvas, save_png

    cfg = _no_resume(_apply_overrides(_base_config(args), args))
    trainer = _trainer(args, cfg)
    _restore_weights(trainer, cfg, args, "sample")
    sampler = make_sampler(trainer.model, cfg.model)
    generator = torch.Generator(device=trainer.device).manual_seed(0)
    imgs = sampler(eval_params(cfg.train, trainer.state), generator, args.n).cpu().numpy()
    out = args.out or f"./assets/{cfg.model.name}_prior_samples.png"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_png(fill_canvas(imgs, int(math.sqrt(args.n))), out)
    print(f"[sample] wrote {args.n} prior samples to {out}")


def cmd_export(args) -> None:
    """A ``torch.export`` program with the weights in it, servable with
    torch alone (``models/export.py``), for the device of ``--device``.

    An explicit ``--mesh D|DxS|DxSxM`` (under torchrun, one rank a card, or
    gloo ranks with ``--device cpu``; a single process given ``--mesh 1`` is
    a world of one) exports the batch-sharded serving layout over the ranks:
    each rank runs its rows of the batch and every rank returns the whole
    batch; rank 0 writes the file, which serves in a process group of the
    same size. The weights are whole on every rank (the Trainer takes no
    mesh). Without ``--mesh``, or with ``--mesh none``, the program is
    single-device however many ranks run, as in the JAX package."""
    from vae_mdl_tpu_torch.models import export as mexport
    from vae_mdl_tpu_torch.train.state import eval_params
    from vae_mdl_tpu_torch.train.trainer import Trainer

    cfg = _no_resume(_apply_overrides(_base_config(args), args))
    mesh = _joined_mesh(args, cfg) if args.mesh not in (None, "none") else None
    trainer = Trainer(cfg, device=_device(args))
    _restore_weights(trainer, cfg, args, "export")
    params = eval_params(cfg.train, trainer.state)
    out = args.out or f"./assets/{cfg.model.name}_{args.what}.pt2"
    if _is_rank0():
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if args.what == "sampler":
        blob = mexport.export_sampler(trainer.model, cfg.model, params, n=args.n, path=out,
                                      mesh=mesh)
    else:
        fn = (mexport.export_reconstructor if args.what == "reconstructor"
              else mexport.export_encoder)
        blob = fn(trainer.model, cfg.model, params, (args.n,) + tuple(cfg.model.image_shape),
                  path=out, mesh=mesh)
    layout = "single-device" if mesh is None else f"sharded {tuple(mesh.mesh.shape)}"
    if _is_rank0():
        print(f"[export] wrote {args.what} ({len(blob)} bytes, device={trainer.device.type}, "
              f"layout={layout}) to {out}")


def cmd_convert(args) -> None:
    """Reference Keras checkpoint -> the port's checkpoint, once; eval,
    sample and train then read it without TensorFlow."""
    if not args.from_reference:
        raise SystemExit("convert requires --from-reference CKPT_PREFIX")
    # a conversion is a fresh step-0 state: never resumed into, and never
    # over an existing checkpoint at the tag
    cfg = _no_resume(_apply_overrides(_base_config(args), args))
    trainer = _trainer(args, cfg)
    if trainer.ckpt.has(args.tag):
        raise SystemExit(
            f"convert refuses to overwrite the existing '{args.tag}' checkpoint under "
            f"{cfg.train.checkpoint_dir}/{cfg.model.name}; pass a fresh --checkpoint-dir "
            "(or the other --tag)")
    _import_reference(trainer, cfg, args.from_reference, "convert")
    trainer.ckpt.save(trainer.state, args.tag)
    trainer.ckpt.wait()
    print(f"[convert] saved '{args.tag}' checkpoint (step 0) under "
          f"{cfg.train.checkpoint_dir}/{cfg.model.name} — eval/sample read it directly; "
          "train warm-starts from it (auto-resume falls back to 'best' when no 'latest' "
          "exists)")


# reference-parity targets: metric, value, absolute tolerance, source (the
# JAX package's table, BASELINE.md)
_PARITY_TARGETS = {
    "model01": ("llh", -85.02, 0.43, "nbip/vae-mdl README.md:11-13"),
    "model05": ("bpd", 4.5, 0.05, "nbip/vae-mdl README.md:75-77"),
    "model06": ("bpd", 5.4, 0.05, "nbip/vae-mdl README.md:88-90"),
    "digits": ("llh", -71.3, 1.5, "README.md (digits protocol row)"),
}

# the files each dataset reads (data/sources.py), shown when they are missing
_DATA_LAYOUTS = {
    "mnist": "<data-dir>/train-images-idx3-ubyte[.gz] (+ t10k-*)",
    "svhn_cropped": "<data-dir>/{train,test[,extra]}_32x32.mat",
    "cifar10": "<data-dir>/cifar-10-batches-py/data_batch_*",
    "celeba": "<data-dir>/celeba-tfr/{train,validation}/* (Glow shards)",
}


def cmd_parity(args) -> None:
    """One-command reference parity: check the data files, run the
    reference-length protocol (resumable), the 5000-IS eval with the k-hat
    and the convergence curve, compare with the target and write a report
    JSON. Exits 1 on a failed comparison on real data."""
    import json
    import time

    cfg = _apply_overrides(_base_config(args), args)
    name = cfg.model.name
    synthetic = cfg.data.dataset.startswith("synthetic")
    if synthetic and not args.allow_synthetic:
        raise SystemExit(
            f"parity: dataset {cfg.data.dataset!r} is synthetic — a parity run needs real "
            "data (--data-dir); pass --allow-synthetic only to rehearse the command path")
    if not synthetic and not args.allow_synthetic:
        # fail up front, never fall back to synthetic data
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, strict=True))
        from vae_mdl_tpu_torch.data.sources import load_dataset

        try:
            load_dataset(cfg.data.dataset, cfg.data.data_dir, allow_synthetic_fallback=False)
        except FileNotFoundError as e:
            raise SystemExit(f"parity: {e}\nexpected layout: "
                             f"{_DATA_LAYOUTS.get(cfg.data.dataset, '')}\n"
                             "(docs/parity.md lists every dataset's files)")

    target = _PARITY_TARGETS.get(name)
    trainer = _trainer(args, cfg, distributed=True)
    if not args.eval_only:
        if name == "model01":
            _maybe_bias_init(trainer)
        state = trainer.fit()
        print(f"[parity] trained to step {state.step}, best val loss "
              f"{state.best_val_loss:.4f}")
    if trainer.ckpt.has("best"):
        trainer.state = trainer.ckpt.restore(trainer.state, "best")
    elif args.eval_only and trainer.state.step == 0:
        raise SystemExit(f"parity --eval-only: no checkpoint found under "
                         f"{cfg.train.checkpoint_dir}/{name}")
    _dump_assets(trainer, cfg)

    n_samples = args.n_samples or cfg.train.n_eval_samples
    mean_llh, metrics = _evaluate(trainer, cfg, n_samples, khat=True, k_curve=True)
    curve = metrics["k_curve_llh"]
    report = {
        "model": name,
        "dataset": cfg.data.dataset,
        "synthetic_rehearsal": bool(synthetic or args.allow_synthetic),
        "step": trainer.state.step,
        "n_updates_protocol": cfg.train.n_updates,
        "n_samples": n_samples,
        "llh": mean_llh,
        "bpd": metrics["bpd"],
        "khat_mean": metrics["khat_mean"],
        "khat_max": metrics["khat_max"],
        "khat_frac_gt_07": metrics["khat_frac_gt_07"],
        "khat_n_underflow": metrics["khat_n_underflow"],
        "khat_n_ties": metrics["khat_n_ties"],
        # the bound's climb over the second half of the weight stream: ~0
        # when the quoted number has converged at this sample count
        "k_curve_second_half_climb": float(curve[-1] - curve[len(curve) // 2]),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    if target is None:
        report.update(status="NO_TARGET", target=None)
        verdict = f"no reference target for {name!r} (report only)"
    else:
        metric, value, tol, source = target
        got = report[metric]
        ok = abs(got - value) <= tol
        report.update(status="PASS" if ok else "FAIL",
                      target={"metric": metric, "value": value, "tolerance": tol,
                              "source": source},
                      deviation=got - value)
        verdict = (f"{metric}={got:.4f} vs target {value} ±{tol} ({source}) -> "
                   f"{report['status']}")
    if report["synthetic_rehearsal"]:
        verdict += "  [SYNTHETIC REHEARSAL — not a parity claim]"
    if not _is_rank0():
        return

    path = args.report or os.path.join(cfg.train.checkpoint_dir, name, "parity.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        # strict JSON: khat_mean is NaN where no tail is fittable
        json.dump(_json_finite(report), f, indent=2)
    print(f"[parity] {verdict}")
    print(f"[parity] report: {path}")
    if report["status"] == "FAIL" and not report["synthetic_rehearsal"]:
        raise SystemExit(1)


def cmd_list(args) -> None:
    from vae_mdl_tpu_torch.models.zoo import _DATASETS, MODELS

    for name, m in MODELS.items():
        latent = m.latents() if hasattr(m, "latents") else f"spatial {m.top_latent_shape()}"
        print(f"{name}: {m.likelihood} obs, {m.n_stochastic} stochastic layer(s), "
              f"latent {latent}, dataset {_DATASETS[name]}")


# the part whose published peaks price the ceiling where no card is present
CEILING_PART = "H100 SXM"


def cmd_describe(args) -> None:
    """Static model card: config, parameter and memory footprint, analytic
    FLOPs and the ceiling they give at the card's published peak. The model
    is built on the CPU; nothing runs on a device and no checkpoint is read."""
    from vae_mdl_tpu_torch.models.vae import build_model
    from vae_mdl_tpu_torch.nn.decoders import head_channels
    from vae_mdl_tpu_torch.utils.flops import device_peaks, forward_flops, train_step_flops

    cfg = _base_config(args)
    m = cfg.model
    if args.batch_size is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                batch_size=args.batch_size))
    if args.bf16:
        m = dataclasses.replace(m, compute_dtype="bfloat16")
        cfg = dataclasses.replace(cfg, model=m)
    batch = cfg.data.batch_size

    model = build_model(m, torch.Generator().manual_seed(0), device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    params_mib = n_params * 4 / 2**20  # params are stored float32

    # optimizer-side copies: Adam's two moments, one accumulator with
    # gradient accumulation, one EMA copy
    slots = 2.0
    if cfg.train.grad_accum_steps > 1:
        slots += 1.0
    if cfg.train.ema_decay > 0:
        slots += 1.0
    state_mib = params_mib * (1.0 + slots)

    fwd = forward_flops(m, batch=1)
    step = train_step_flops(m, batch)
    part = torch.cuda.get_device_name(0) if torch.cuda.is_available() else CEILING_PART
    peak = device_peaks(part)[m.compute_dtype]
    ceiling = peak / (step / batch)

    latent = m.latents() if hasattr(m, "latents") else f"spatial {m.top_latent_shape()}"
    lk_head = head_channels(m.likelihood, m.image_shape[-1], m.n_mix)
    mesh_plan = None
    if args.mesh and args.mesh != "none":
        d, s, mm = _parse_mesh_spec(args.mesh)
        ks = cfg.train.n_eval_samples
        mesh_plan = {
            "data": d, "sample": s, "model": mm, "n_ranks": d * s * mm,
            # the data-parallel and ZeRO-1 steps shard the batch over data x
            # sample; the model ranks share rows (parallel/spmd.py)
            "batch_per_rank": batch // (d * s),
            "batch_divides": batch % (d * s) == 0,
            "eval_samples_per_sample_rank": ks // s,
            "eval_samples_divide": ks % s == 0,
            # several hosts: make_mesh lays them out as major blocks on data
            "host_axis": "data",
        }
    if cfg.train.lr_staircase:
        sched = (f"staircase(base {cfg.train.lr_staircase_base}, "
                 f"{cfg.train.lr_staircase_levels} levels)")
    else:
        sched = "constant"
    if cfg.train.lr_warmup_steps:
        sched += f" + warmup {cfg.train.lr_warmup_steps}"
    if m.use_pallas is None:
        pallas = ("auto (the CUDA likelihood kernel on the card)"
                  if m.likelihood in ("mdl", "dl")
                  else "auto (n/a: no CUDA kernel for this head)")
    else:
        pallas = "forced on" if m.use_pallas else "off"

    if args.json:
        import json

        from vae_mdl_tpu_torch.config_io import config_to_dict

        print(json.dumps({
            "name": m.name,
            "n_params": n_params,
            "params_mib": round(params_mib, 3),
            "train_state_mib": round(state_mib, 3),
            "optimizer_slots": slots,
            "forward_flops_per_img": fwd,
            "train_step_flops": step,
            "flops_peak": peak,
            "peak_part": part,
            "peak_dtype": m.compute_dtype,
            "ceiling_imgs_per_sec": ceiling,
            "config": config_to_dict(cfg),
            **({"mesh_plan": mesh_plan} if mesh_plan is not None else {}),
        }))
        return

    def _flops(v: float) -> str:
        return f"{v / 1e9:.2f} GFLOP" if v >= 1e8 else f"{v / 1e6:.2f} MFLOP"

    print(f"{m.name} — {m.likelihood} obs, {m.n_stochastic} stochastic layer(s)")
    print(f"  dataset          {cfg.data.dataset} {m.image_shape}, batch {batch}")
    print(f"  latents          {latent}")
    print(f"  importance k     {m.n_samples} (train), {cfg.train.n_eval_samples} (final eval)")
    print(f"  likelihood head  {m.likelihood}: {lk_head} channels"
          + (f" (n_mix={m.n_mix})" if m.likelihood in ("mdl", "pmdl") else ""))
    print(f"  compute dtype    {m.compute_dtype} (likelihood math always f32)")
    print(f"  cuda kernels     {pallas}")
    print(f"  objective        {getattr(m, 'objective', 'iwae')}, beta {getattr(m, 'beta', 1.0)}")
    print(f"  optimizer        {cfg.train.optimizer}, lr {cfg.train.learning_rate:g}, {sched}")
    print(f"  protocol         {cfg.train.n_updates:,} updates, "
          f"eval every {cfg.train.eval_interval:,}")
    print()
    print(f"  parameters       {n_params:,}  ({params_mib:.1f} MiB f32)")
    print(f"  train state      ~{state_mib:.1f} MiB (params + {slots:g} optimizer-side copies)")
    print(f"  forward FLOPs    {_flops(fwd)}/img (k={m.n_samples})")
    print(f"  train step       {_flops(step / batch)}/img — {step / 1e12:.3f} TFLOP/step at "
          f"batch {batch}")
    print(f"  ceiling          {ceiling:,.0f} imgs/s at 100% of {part}'s {m.compute_dtype} peak "
          f"({peak / 1e12:g} TFLOP/s, NVIDIA's published dense figure)")
    if mesh_plan is not None:
        d, s, mm = mesh_plan["data"], mesh_plan["sample"], mesh_plan["model"]
        print()
        print(f"  mesh plan        (data={d}, sample={s}, model={mm}) = "
              f"{mesh_plan['n_ranks']} ranks (one process and one card each)")
        div = "" if mesh_plan["batch_divides"] else "  [! does not divide]"
        print(f"    train batch    {batch} -> {mesh_plan['batch_per_rank']} per rank "
              f"(data x sample){div}")
        kdiv = "" if mesh_plan["eval_samples_divide"] else "  [! does not divide]"
        print(f"    eval IS axis   {cfg.train.n_eval_samples} importance samples -> "
              f"{mesh_plan['eval_samples_per_sample_rank']} per sample rank{kdiv}")
        if mm > 1:
            print(f"    tensor par.    wide conv/dense layers channel-sharded over model={mm} "
                  "(parallel/tensor.py)")
        if mm == 1:
            print(f"    optimizer      ZeRO-1 available: moments reduce-scattered over all "
                  f"{d * s} ranks (parallel/spmd.py)")
        print("    several hosts  'data' is the host-major axis; sample/model collectives "
              "stay inside a host (parallel/mesh.py)")
        print(f"    start          torchrun --nproc-per-node {d * s * mm} -m vae_mdl_tpu_torch "
              f"train {m.name} --mesh {args.mesh}")


def build_parser() -> argparse.ArgumentParser:
    # read at parse time, so that models added with zoo.register_model run
    from vae_mdl_tpu_torch.models.zoo import MODELS

    p = argparse.ArgumentParser(prog="vae_mdl_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("model", nargs="?", choices=list(MODELS),
                        help="zoo entry (optional when --config is given)")
        sp.add_argument("--config", metavar="FILE",
                        help="build the experiment from a config JSON (e.g. a run's recorded "
                             "config.json) instead of the zoo; flag overrides still apply")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where to run (default: the CUDA card; it stops where there is "
                             "none)")
        sp.add_argument("--dataset")
        sp.add_argument("--data-dir")
        sp.add_argument("--batch-size", type=int)
        sp.add_argument("--n-updates", type=int)
        sp.add_argument("--eval-interval", type=int)
        sp.add_argument("--checkpoint-dir")
        sp.add_argument("--log-dir")
        sp.add_argument("--n-samples", type=int, default=None,
                        help="importance samples for the final eval "
                             "(default: cfg.train.n_eval_samples = 5000)")
        sp.add_argument("--mesh", help="DxS or DxSxM rank mesh (data x sample x model); "
                                       "'none' for one device (train, eval, parity; "
                                       "export: the sharded serving layout)")
        sp.add_argument("--bf16", action="store_true", help="bfloat16 conv/matmul body")
        sp.add_argument("--likelihood-io-dtype", choices=["bfloat16", "float32"], default=None,
                        help="quantize the decoder-head -> likelihood boundary tensor (mdl); "
                             "likelihood math stays float32")
        sp.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                        help="force the hand-written CUDA likelihood kernels on or off "
                             "(default: on the card for mdl and dl)")
        sp.add_argument("--no-resume", action="store_true")
        sp.add_argument("--snapshot-interval", type=int, metavar="STEPS",
                        help="also keep immutable step_<N> snapshot checkpoints every STEPS "
                             "(multiple of --eval-interval)")
        sp.add_argument("--max-snapshots", type=int, metavar="N",
                        help="rotate snapshots, keeping the newest N (default 3)")
        sp.add_argument("--grad-clip", type=float, metavar="NORM",
                        help="clip gradients to this global norm")
        sp.add_argument("--grad-skip", type=float, metavar="THRESHOLD",
                        help="skip updates whose global grad norm is non-finite or exceeds "
                             "this")
        sp.add_argument("--objective", choices=["iwae", "elbo", "iwae_dreg"], default=None,
                        help="training objective: the config's default (usually iwae), elbo, "
                             "or iwae_dreg (VAE family only)")
        sp.add_argument("--free-bits", type=float, metavar="NATS", default=None,
                        help="floor each stochastic layer's expected KL at this many nats "
                             "(requires --objective elbo)")
        sp.add_argument("--beta-warmup", type=int, metavar="STEPS",
                        help="KL annealing: ramp beta linearly 0 -> model beta over STEPS")
        sp.add_argument("--ema", type=float, metavar="DECAY",
                        help="per-step EMA decay of the params (e.g. 0.999); val/test/report "
                             "then use the EMA weights")
        sp.add_argument("--profile", metavar="DIR",
                        help="write a torch.profiler trace of ~20 steps to DIR/trace.json")
        sp.add_argument("--steps-per-call", type=int,
                        help="N updates per call of the train step")
        sp.add_argument("--device-dataset", action="store_true",
                        help="keep the whole train split in device memory (small sets)")
        sp.add_argument("--bound-logstd", action="store_true",
                        help="tanh-bound the DL head's logstd")
        sp.add_argument("--from-reference", metavar="CKPT_PREFIX",
                        help="import weights from a reference (nbip/vae-mdl) Keras "
                             "save_weights checkpoint prefix; eval/sample use them directly, "
                             "train warm-starts from them")
        sp.add_argument("--strict-data", action="store_true",
                        help="fail if dataset files are missing instead of falling back to "
                             "synthetic data")

    def ckpt(sp):
        sp.add_argument("--ckpt", default="best",
                        help="checkpoint tag: best, latest, or a step_<N> snapshot")

    sp = sub.add_parser("train", help="train + final 5000-IS eval + assets")
    common(sp)
    sp.add_argument("--skip-final-eval", action="store_true")
    sp.add_argument("--khat", action="store_true",
                    help="final eval also reports the PSIS k-hat reliability diagnostic")
    sp.add_argument("--k-curve", action="store_true",
                    help="final eval also reports the IS-convergence curve")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="5000-IS test evaluation")
    common(sp)
    ckpt(sp)
    sp.add_argument("--active-units", action="store_true",
                    help="also report per-layer active latent units (posterior-mean variance "
                         "> 0.01, Burda et al. 2016)")
    sp.add_argument("--khat", action="store_true",
                    help="also report the PSIS Pareto-shape reliability diagnostic "
                         "(k-hat > 0.7 = unreliable; Vehtari et al. 2024)")
    sp.add_argument("--k-curve", action="store_true",
                    help="also report the IS-convergence curve over the k-chunks")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("sample", help="generate images from the prior")
    common(sp)
    sp.add_argument("--n", type=int, default=64)
    sp.add_argument("--out", default=None, help="output PNG path")
    ckpt(sp)
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("export", help="export for serving (torch.export .pt2, weights in it)")
    common(sp)
    sp.add_argument("--what", default="sampler",
                    choices=["sampler", "reconstructor", "encoder"])
    sp.add_argument("--n", type=int, default=64,
                    help="sample count (sampler) / batch size (reconstructor, encoder)")
    sp.add_argument("--out", default=None, help="output path (.pt2)")
    ckpt(sp)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("convert", help="reference Keras checkpoint -> the port's checkpoint "
                                        "(one-shot; --from-reference required)")
    common(sp)
    sp.add_argument("--tag", default="best", choices=["best", "latest"],
                    help="tag for the converted checkpoint")
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser(
        "parity",
        help="one-command reference parity: verify data files, run the reference-length "
             "protocol (resumable), 5000-IS eval with k-hat/k-curve, compare with the "
             "target, write a report JSON")
    common(sp)
    sp.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate existing checkpoints")
    sp.add_argument("--allow-synthetic", action="store_true",
                    help="rehearse the parity path on synthetic data (marked in the report; "
                         "never a parity claim)")
    sp.add_argument("--report", metavar="FILE",
                    help="report path (default <checkpoint-dir>/<model>/parity.json)")
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("list", help="list model configs")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("describe", help="model card: config, params, memory, analytic "
                                         "FLOPs, ceiling (nothing runs on a device)")
    sp.add_argument("model", nargs="?", choices=list(MODELS),
                    help="zoo entry (optional when --config is given)")
    sp.add_argument("--config", metavar="FILE",
                    help="describe a config JSON (e.g. a run's recorded config.json)")
    sp.add_argument("--batch-size", type=int)
    sp.add_argument("--bf16", action="store_true")
    sp.add_argument("--mesh", help="DxS or DxSxM plan to preview")
    sp.add_argument("--json", action="store_true",
                    help="emit the card as one JSON object (with the full config)")
    sp.set_defaults(fn=cmd_describe)
    p.subcommands = tuple(sub.choices)  # python -m vae_mdl_tpu_torch's dispatch
    return p


def main(argv=None) -> None:
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    joined = dist.is_initialized()
    try:
        args.fn(args)
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
