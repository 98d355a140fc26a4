"""model01 .. model06, the ladder families' ``ladder_svhn``,
``biladder_svhn`` and ``biladder_celeba``, and ``digits`` as named configs.

Mirrors ``vae_mdl_tpu/models/zoo.py`` entry for entry (held equal by
``tests/test_torch_config.py``), with ``register_model`` for a user's own
config.
"""
from __future__ import annotations

import dataclasses

from vae_mdl_tpu_torch.config import (
    DataConfig,
    DecoderConfig,
    EncoderConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
    conv,
    deconv,
)
from vae_mdl_tpu_torch.models.bidirectional import BILADDER_CELEBA, BILADDER_SVHN
from vae_mdl_tpu_torch.models.ladder import LADDER_SVHN

# conv trunk shared by models 02/03/05 — relu activations
_ENC_CONV_RELU = (
    conv(32, 3, 1, "relu"),
    conv(64, 3, 2, "relu"),
    conv(128, 3, 2, "relu"),
    conv(256, 3, 2, "relu"),
)
# gelu variant used by model06
_ENC_CONV_GELU = (
    conv(32, 3, 1, "gelu"),
    conv(64, 3, 2, "gelu"),
    conv(128, 3, 2, "gelu"),
    conv(256, 3, 2, "gelu"),
)
# mirrored deconv trunk; the final layer is the likelihood head
_DEC_DECONV_RELU = (
    deconv(128, 4, 2, "relu"),
    deconv(64, 4, 2, "relu"),
    deconv(32, 4, 2, "relu"),
)
_DEC_DECONV_GELU = (
    deconv(128, 4, 2, "gelu"),
    deconv(64, 4, 2, "gelu"),
    deconv(32, 4, 2, "gelu"),
)


MODEL01 = ModelConfig(
    name="model01",
    image_shape=(28, 28, 1),
    n_latent=100,
    likelihood="bernoulli",
    encoder=EncoderConfig(kind="mlp", n_hidden=200, activation="tanh",
                          std_transform="exp"),
    decoder=DecoderConfig(kind="mlp", n_hidden=200, activation="tanh"),
)

MODEL02 = ModelConfig(
    name="model02",
    image_shape=(32, 32, 3),
    n_latent=20,
    likelihood="gaussian",
    encoder=EncoderConfig(kind="conv", conv_layers=_ENC_CONV_RELU),
    decoder=DecoderConfig(
        kind="conv",
        base_size=(4, 4, 128),
        conv_layers=_DEC_DECONV_RELU + (conv(6, 3, 1, "none"),),
    ),
)

MODEL03 = ModelConfig(
    name="model03",
    image_shape=(32, 32, 3),
    n_latent=20,
    likelihood="dl",
    encoder=EncoderConfig(kind="conv", conv_layers=_ENC_CONV_RELU),
    decoder=DecoderConfig(
        kind="conv",
        base_size=(4, 4, 128),
        conv_layers=_DEC_DECONV_RELU + (conv(6, 3, 1, "none"),),
    ),
)

MODEL04 = ModelConfig(
    name="model04",
    image_shape=(32, 32, 3),
    n_latent=50,
    likelihood="dl",
    encoder=EncoderConfig(
        kind="conv",
        conv_layers=(
            conv(128, 4, 2, "relu"),
            conv(256, 4, 2, "relu"),
            conv(256, 3, 1, "relu"),
        ),
        n_glu=5,
        glu_features=64,
    ),
    decoder=DecoderConfig(
        kind="conv",
        base_size=(8, 8, 63),  # 63-channel base at /4 resolution
        pre_layers=(conv(256, 3, 1, "relu"),),
        n_glu=5,
        glu_features=64,
        conv_layers=(deconv(128, 4, 2, "relu"), deconv(6, 4, 2, "none")),
    ),
)

MODEL05 = ModelConfig(
    name="model05",
    image_shape=(32, 32, 3),
    n_latent=20,
    likelihood="mdl",
    n_mix=5,
    encoder=EncoderConfig(kind="conv", conv_layers=_ENC_CONV_RELU),
    decoder=DecoderConfig(
        kind="conv",
        base_size=(4, 4, 128),
        conv_layers=_DEC_DECONV_RELU + (conv(50, 3, 1, "none"),),  # n_mix*10
    ),
)

MODEL06 = ModelConfig(
    name="model06",
    image_shape=(32, 32, 3),
    n_latent=20,
    likelihood="dl",
    n_stochastic=2,
    mlp_hidden=100,
    mlp_activation="gelu",
    encoder=EncoderConfig(kind="conv", conv_layers=_ENC_CONV_GELU),
    decoder=DecoderConfig(
        kind="conv",
        base_size=(4, 4, 128),
        fc_activation="gelu",
        conv_layers=_DEC_DECONV_GELU + (conv(6, 3, 1, "none"),),
    ),
)

# small model01-style Bernoulli IWAE for 16x16 digits
DIGITS = ModelConfig(
    name="digits",
    image_shape=(16, 16, 1),
    n_latent=16,
    likelihood="bernoulli",
    encoder=EncoderConfig(kind="mlp", n_hidden=128, activation="tanh",
                          std_transform="exp"),
    decoder=DecoderConfig(kind="mlp", n_hidden=128, activation="tanh"),
)

MODELS = {m.name: m for m in
          (MODEL01, MODEL02, MODEL03, MODEL04, MODEL05, MODEL06, LADDER_SVHN,
           BILADDER_SVHN, BILADDER_CELEBA, DIGITS)}

_DATASETS = {
    "model01": "mnist",
    "model02": "svhn_cropped",
    "model03": "svhn_cropped",
    "model04": "svhn_cropped",
    "model05": "svhn_cropped",
    "model06": "svhn_cropped",
    "ladder_svhn": "svhn_cropped",
    "biladder_svhn": "svhn_cropped",
    "biladder_celeba": "celeba",
    "digits": "digits",
}

# reference run lengths: model01 trains 1.4M updates, the SVHN models 100k
_N_UPDATES = {
    "model01": 1_400_000,
    "model02": 100_000,
    "model03": 100_000,
    "model04": 100_000,
    "model05": 100_000,
    "model06": 100_000,
    "ladder_svhn": 100_000,
    "biladder_svhn": 100_000,
    "biladder_celeba": 200_000,
    "digits": 20_000,
}


def register_model(model, dataset: str = "svhn_cropped", n_updates: int = 100_000) -> None:
    """Register a config under ``model.name`` so that :func:`experiment`
    builds its experiment as it does a zoo entry's. ``model`` is any config
    ``models.vae.build_model`` takes: a ``ModelConfig``, a ``LadderConfig``
    or a ``BiLadderConfig``."""
    MODELS[model.name] = model
    _DATASETS[model.name] = dataset
    _N_UPDATES[model.name] = n_updates


def experiment(name: str, **overrides) -> ExperimentConfig:
    """Full experiment config for a named model, reference defaults."""
    model = MODELS[name]
    # model01 validates on the whole 10k MNIST test set as one batch
    val_bs = 10_000 if name == "model01" else 500
    cfg = ExperimentConfig(
        model=model,
        data=DataConfig(
            dataset=_DATASETS[name],
            val_batch_size=val_bs,
            augment_flip=_DATASETS[name] == "celeba",
        ),
        train=TrainConfig(n_updates=_N_UPDATES[name]),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
