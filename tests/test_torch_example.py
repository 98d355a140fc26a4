"""The port's examples are product surface: they must keep running.

Drives ``vae_mdl_tpu_torch/examples/custom_model.py`` end to end on the CPU
(register_model -> Trainer -> the evaluator -> the sampler) on synthetic
CIFAR shapes, the suite's end-to-end run of the ``pmdl`` observation model,
and ``examples/serve_model.py``: train, export, and a server process that
imports torch alone, agreeing with ``load_exported``.
"""
import numpy as np
import torch

torch.set_num_threads(1)


def test_custom_model_example_end_to_end(tmp_path):
    from vae_mdl_tpu_torch.examples import custom_model
    from vae_mdl_tpu_torch.models.zoo import MODELS, experiment

    assert "tiny_cifar_pmdl" in MODELS
    cfg = experiment("tiny_cifar_pmdl")
    assert cfg.model.likelihood == "pmdl" and cfg.data.dataset == "cifar10"
    state, mean_llh = custom_model.main(workdir=str(tmp_path), n_updates=20, device="cpu")
    assert state.step == 20 and np.isfinite(mean_llh)


def test_serve_example_end_to_end(capsys):
    from vae_mdl_tpu_torch.examples import serve_model

    serve_model.main(device="cpu")
    out = capsys.readouterr().out
    assert "[main] in-process load_exported agrees with the server" in out
