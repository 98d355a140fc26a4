"""The port's CLI (cli/run.py) against the JAX package's: the same flags build
the same experiment, ``list`` prints the same text, ``describe --json`` gives
the same parameter count and FLOPs; and the protocol end to end on tiny
synthetic runs with ``--device cpu``, mirroring tests/test_cli.py.

Tolerances: the experiments' dicts, the list text and the describe counts
are equal; the CLI's model01 run equals the library's ``Trainer`` with
``init_output_bias`` bit for bit (same operations on the CPU); the bias init
equals JAX's ``init_output_bias`` on the same mean image within 1e-6 (the
logit of a float32 mean, two libraries' log and log1p).
"""
import dataclasses
import json
import os
import subprocess
import sys

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu.cli import run as jax_run
from vae_mdl_tpu.config_io import config_to_dict as jax_config_to_dict
from vae_mdl_tpu.train.state import init_output_bias as jax_init_output_bias
from vae_mdl_tpu_torch.cli.run import (
    _apply_overrides,
    _base_config,
    _json_finite,
    build_parser,
    main,
)
from vae_mdl_tpu_torch.config_io import config_to_dict
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment
from vae_mdl_tpu_torch.train.checkpoint import Checkpointer
from vae_mdl_tpu_torch.train.state import init_output_bias
from vae_mdl_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = ["model01", "model02", "model03", "model04", "model05", "model06", "ladder_svhn",
       "biladder_svhn", "biladder_celeba", "digits"]
# the keys of the JAX CLI's parity report (vae_mdl_tpu/cli/run.py cmd_parity)
JAX_PARITY_KEYS = {
    "model", "dataset", "synthetic_rehearsal", "step", "n_updates_protocol", "n_samples",
    "llh", "bpd", "khat_mean", "khat_max", "khat_frac_gt_07", "khat_n_underflow",
    "khat_n_ties", "k_curve_second_half_climb", "timestamp", "status", "target", "deviation"}


def _tiny(tmp_path, *extra):
    return ["--device", "cpu", "--dataset", "synthetic:mnist", "--batch-size", "8",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "tb"),
            *extra]


def test_parser_covers_protocol():
    args = build_parser().parse_args(["train", "model05", "--n-updates", "3", "--bf16",
                                      "--pallas", "--mesh", "none", "--n-samples", "10"])
    assert args.model == "model05" and args.bf16 and args.pallas and args.mesh == "none"
    assert args.device == "cuda" and args.n_samples == 10
    for cmd in ("train", "eval", "sample", "export", "convert", "parity", "list", "describe"):
        assert build_parser().parse_args([cmd] + (["model01"] if cmd != "list" else []))


ARGVS = [
    ["train", "model05", "--bf16", "--ema", "0.999"],
    ["train", "model01", "--grad-clip", "200", "--grad-skip", "400"],
    ["train", "model02", "--objective", "elbo", "--free-bits", "0.25"],
    ["train", "model06", "--objective", "iwae_dreg", "--beta-warmup", "100"],
    ["train", "model05", "--snapshot-interval", "2000", "--max-snapshots", "2",
     "--steps-per-call", "10", "--likelihood-io-dtype", "bfloat16", "--no-pallas"],
    ["eval", "model03", "--batch-size", "64", "--n-updates", "7", "--eval-interval", "3",
     "--dataset", "synthetic:svhn_cropped", "--data-dir", "/data", "--checkpoint-dir", "c",
     "--log-dir", "l", "--no-resume", "--strict-data", "--device-dataset", "--bound-logstd",
     "--pallas"],
    ["export", "biladder_celeba", "--bf16", "--ema", "0.99"],
    ["sample", "ladder_svhn", "--n-updates", "5"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "-".join(a[:2]) + str(len(a)))
def test_flags_build_the_jax_experiment(argv):
    args = build_parser().parse_args(argv)
    jargs = jax_run.build_parser().parse_args(argv)
    got = config_to_dict(_apply_overrides(_base_config(args), args))
    want = jax_config_to_dict(jax_run._apply_overrides(jax_run._base_config(jargs), jargs))
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_parser_accepts_registered_models():
    from vae_mdl_tpu_torch.models.zoo import _DATASETS, _N_UPDATES, register_model

    custom = dataclasses.replace(experiment("model01").model, name="custom_parse_check")
    register_model(custom, dataset="synthetic:mnist")
    try:
        args = build_parser().parse_args(["train", "custom_parse_check", "--n-updates", "1"])
        assert args.model == "custom_parse_check"
    finally:
        for reg in (MODELS, _DATASETS, _N_UPDATES):
            reg.pop("custom_parse_check", None)


def test_objective_flags_rejected_for_ladder_families():
    with pytest.raises(SystemExit, match="LadderConfig"):
        main(["sample", "ladder_svhn", "--objective", "elbo"])
    with pytest.raises(SystemExit, match="LadderConfig"):
        main(["sample", "ladder_svhn", "--free-bits", "0.25"])


def test_cli_list_prints_the_jax_text(capsys):
    main(["list"])
    got = capsys.readouterr().out.splitlines()
    jax_run.main(["list"])
    want = capsys.readouterr().out.splitlines()
    for name in ZOO:  # registries may hold more entries other tests added
        line = [entry for entry in got if entry.startswith(f"{name}:")]
        assert line and line == [entry for entry in want if entry.startswith(f"{name}:")]


@pytest.mark.parametrize("name", ZOO)
def test_cli_describe_matches_jax(capsys, name):
    """``describe --json``: JAX's parameter count and FLOPs, and a ceiling
    from the card's published peak (no TPU number)."""
    from vae_mdl_tpu_torch.utils.flops import device_peaks

    main(["describe", name, "--json"])
    card = json.loads(capsys.readouterr().out)
    jax_run.main(["describe", name, "--json"])
    want = json.loads(capsys.readouterr().out)
    for key in ("n_params", "forward_flops_per_img", "train_step_flops", "params_mib",
                "train_state_mib", "config"):
        assert card[key] == want[key], key
    part = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "H100 SXM"
    assert card["peak_part"] == part
    assert card["flops_peak"] == device_peaks(part)[MODELS[name].compute_dtype]
    batch = experiment(name).data.batch_size
    assert card["ceiling_imgs_per_sec"] == card["flops_peak"] / (card["train_step_flops"] / batch)
    peaks = json.dumps({k: v for k, v in card.items() if k != "config"}).lower()
    assert "v5e" not in peaks and "tpu" not in peaks


def test_cli_describe_text_and_mesh(capsys):
    main(["describe", "model05"])
    out = capsys.readouterr().out
    assert "parameters       1,035,962" in out and "TFLOP/step" in out and "ceiling" in out
    assert "v5e" not in out
    with pytest.raises(SystemExit, match="parallel"):
        main(["describe", "model01", "--mesh", "4x2"])


def test_cli_train_end_to_end(tmp_path, monkeypatch):
    """train -> checkpoints -> assets (under the working directory) -> a
    profiler trace, all through the CLI on the CPU."""
    monkeypatch.chdir(tmp_path)
    main(["train", "model01"] + _tiny(tmp_path, "--n-updates", "4", "--eval-interval", "2",
                                      "--n-samples", "4", "--mesh", "none",
                                      "--skip-final-eval", "--profile", str(tmp_path / "prof")))
    assert os.path.isdir(tmp_path / "ckpt" / "model01" / "latest")
    for tag in ("inputs", "recon", "samples"):
        assert os.path.exists(tmp_path / "assets" / f"model01_{tag}.png")
    assert os.path.exists(tmp_path / "prof" / "trace.json")


def test_cli_train_model01_equals_the_library(tmp_path, monkeypatch, capsys):
    """``train model01`` = ``Trainer`` + ``init_output_bias`` on the mean of 8
    training batches + ``fit``, bit for bit; and that bias init equals
    JAX's on the same mean image."""
    monkeypatch.chdir(tmp_path)
    flags = ["--n-updates", "4", "--eval-interval", "2", "--skip-final-eval"]
    main(["train", "model01"] + _tiny(tmp_path / "cli", *flags))
    assert "output bias initialised" in capsys.readouterr().out

    args = build_parser().parse_args(["train", "model01"] + _tiny(tmp_path / "lib", *flags))
    cfg = _apply_overrides(_base_config(args), args)
    trainer = Trainer(cfg, device="cpu")
    batches = [next(trainer.train_iter) for _ in range(8)]
    mean_img = np.concatenate(batches).astype(np.float32).mean(0) / 255.0
    init_output_bias(trainer.state, torch.as_tensor(mean_img))
    bias = trainer.state.params["decoder.out.bias"].detach().clone()

    @flax.struct.dataclass
    class JaxState:
        params: dict
        ema_params: dict = None

    jax_state = jax_init_output_bias(
        JaxState({"params": {"decoder": {"out": {"bias": jnp.zeros(784)}}}}),
        jnp.asarray(mean_img))
    np.testing.assert_allclose(bias.numpy(), np.asarray(
        jax_state.params["params"]["decoder"]["out"]["bias"]), rtol=1e-6, atol=1e-6)

    state = trainer.fit(progress=False)
    saved = Checkpointer(str(tmp_path / "cli" / "ckpt"), "model01").load("latest", "cpu")
    assert saved["step"] == state.step == 4
    for name, p in state.params.items():
        assert torch.equal(saved["params"][name], p.detach()), name
    lib = state.state_dict()["opt_state"]
    flat_saved, flat_lib = [], []
    for tree, out in ((saved["opt_state"], flat_saved), (lib, flat_lib)):
        stack = [tree]
        while stack:
            node = stack.pop()
            if isinstance(node, torch.Tensor):
                out.append(node)
            elif isinstance(node, dict):
                stack.extend(node[k] for k in sorted(node))
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
    assert len(flat_saved) == len(flat_lib) > 0
    assert all(torch.equal(a, b) for a, b in zip(flat_saved, flat_lib))


def test_cli_eval_without_checkpoint_warns(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    main(["eval", "model01", "--n-samples", "4", "--mesh", "none"] + _tiny(tmp_path))
    out = capsys.readouterr().out
    assert "WARNING" in out and "test LLH" in out


def _strict(text):
    def refuse(token):
        raise ValueError(f"non-RFC 8259 token {token}")

    return json.loads(text, parse_constant=refuse)


def test_cli_parity_rehearsal_synthetic(tmp_path, monkeypatch, capsys):
    """The parity command rehearsed on synthetic data: a report in strict
    JSON with the JAX report's keys, marked a rehearsal, never a claim."""
    monkeypatch.chdir(tmp_path)
    main(["parity", "model01", "--allow-synthetic", "--n-updates", "4", "--eval-interval", "2",
          "--n-samples", "25"] + _tiny(tmp_path))
    assert "SYNTHETIC REHEARSAL" in capsys.readouterr().out
    with open(tmp_path / "ckpt" / "model01" / "parity.json") as f:
        rep = _strict(f.read())
    assert set(rep) == JAX_PARITY_KEYS
    assert rep["synthetic_rehearsal"] is True and rep["status"] in ("PASS", "FAIL")
    assert rep["target"]["value"] == -85.02 and rep["n_samples"] == 25


def test_parity_report_json_is_strict_rfc():
    report = {"llh": -85.0, "khat_mean": float("nan"),
              "nested": {"climb": float("inf"), "vals": [1.0, float("-inf")]}}
    back = _strict(json.dumps(_json_finite(report)))
    assert back["khat_mean"] is None and back["nested"]["climb"] is None
    assert back["nested"]["vals"] == [1.0, None] and back["llh"] == -85.0


def test_cli_parity_refuses_synthetic_and_missing_data(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="allow-synthetic"):
        main(["parity", "model01", "--dataset", "synthetic:mnist", "--device", "cpu",
              "--checkpoint-dir", str(tmp_path / "ckpt")])
    with pytest.raises(SystemExit, match="expected layout"):
        main(["parity", "model01", "--data-dir", str(tmp_path / "nodata"), "--device", "cpu",
              "--checkpoint-dir", str(tmp_path / "ckpt")])


def test_device_defaults_to_the_card_and_raises_here(tmp_path, monkeypatch):
    """No command carries on on the CPU in place of a missing card; ``--pallas``
    with ``--device cpu`` raises; ``--mesh`` takes only ``none``."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    monkeypatch.chdir(tmp_path)
    for cmd in ("train", "eval", "sample", "export", "parity"):
        with pytest.raises(SystemExit, match="--device cpu"):
            main([cmd, "model01", "--dataset", "synthetic:mnist", "--allow-synthetic"]
                 if cmd == "parity" else [cmd, "model01"])
    with pytest.raises(SystemExit, match="no-pallas"):
        main(["eval", "model05", "--device", "cpu", "--pallas"])
    with pytest.raises(SystemExit, match="parallel"):
        main(["train", "model01", "--device", "cpu", "--mesh", "4x2"])
    # the python -m twin of train_model.py is the same train command
    run = subprocess.run([sys.executable, "-m", "vae_mdl_tpu_torch", "model01"], cwd=REPO,
                         capture_output=True, text=True)
    assert run.returncode != 0 and "--device cpu" in run.stderr


def test_console_script_names_the_cli():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert 'vae-mdl-tpu-torch = "vae_mdl_tpu_torch.cli.run:main"' in text
    assert 'vae-mdl-tpu = "vae_mdl_tpu.cli.run:main"' in text
