"""The port's configs and zoo equal the JAX package's, field for field."""
import dataclasses

import pytest
import torch

import vae_mdl_tpu.config as jconfig
from vae_mdl_tpu.models import zoo as jzoo
from vae_mdl_tpu_torch import config
from vae_mdl_tpu_torch.models import zoo

torch.set_num_threads(1)

_JAX_MODEL_NAMES = sorted(jzoo.MODELS)


def _fields(cls):
    """(name, default) per field; nested config defaults compared as dicts."""
    return [(f.name, dataclasses.asdict(f.default) if dataclasses.is_dataclass(f.default)
             else f.default) for f in dataclasses.fields(cls)]


def test_every_model_config_of_the_jax_zoo_is_ported():
    assert sorted(zoo.MODELS) == _JAX_MODEL_NAMES


@pytest.mark.parametrize("name", _JAX_MODEL_NAMES)
def test_zoo_entry_equals_jax(name):
    assert dataclasses.asdict(zoo.MODELS[name]) == dataclasses.asdict(jzoo.MODELS[name])


@pytest.mark.parametrize("cls", ["ModelConfig", "EncoderConfig", "DecoderConfig",
                                 "DataConfig", "TrainConfig", "MeshConfig"])
def test_config_class_fields_and_defaults_equal_jax(cls):
    assert _fields(getattr(config, cls)) == _fields(getattr(jconfig, cls))


def test_experiment_equals_jax_without_the_mesh():
    """The experiment field for field, the mesh (which counts ranks in the
    port, devices in JAX) apart; MeshConfig's own fields are held equal
    above."""
    mine = dataclasses.asdict(zoo.experiment("model05"))
    theirs = dataclasses.asdict(jzoo.experiment("model05"))
    assert mine.pop("mesh") == theirs.pop("mesh")
    assert mine == theirs


def test_conv_helpers_equal_jax():
    assert config.conv(32, 3, 2) == jconfig.conv(32, 3, 2)
    assert config.deconv(64, 4, 2, "none") == jconfig.deconv(64, 4, 2, "none")


@pytest.mark.parametrize("kwargs", [dict(likelihood="mdl", likelihood_io_dtype="bf16"),
                                    dict(likelihood="dl", likelihood_io_dtype="bfloat16")])
def test_likelihood_io_dtype_is_validated(kwargs):
    with pytest.raises(ValueError):
        config.ModelConfig(**kwargs)
