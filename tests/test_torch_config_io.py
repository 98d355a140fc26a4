"""The port's config serialization against the JAX package's: every zoo
entry round-trips, a config.json written by either package loads in the
other equal field for field, any mesh section round-trips under the JAX
field names, unknown fields are named errors, and diff_configs gives
dotted paths.

Tolerance: none; configs are compared for equality.
"""
import dataclasses
import json

import pytest

from vae_mdl_tpu import config_io as jconfig_io
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.models.zoo import experiment as jax_experiment
from vae_mdl_tpu_torch.config_io import (
    config_from_dict,
    config_to_dict,
    diff_configs,
    load_config,
    save_config,
)
from vae_mdl_tpu_torch.models.zoo import MODELS, experiment


def _jax_dict(cfg):
    """A JAX config as the port would write it: the same JSON."""
    return json.loads(json.dumps(jconfig_io.config_to_dict(cfg)))


def _varied(make, name):
    cfg = make(name)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.999, grad_clip_norm=200.0, optimizer="adam_keras"),
        data=dataclasses.replace(cfg.data, dataset="synthetic:svhn_cropped", strict=True))


def test_zoo_entries_are_the_same_in_both_packages():
    assert sorted(MODELS) == sorted(JAX_MODELS)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_zoo_entry_round_trips(name):
    cfg = _varied(experiment, name)
    assert config_from_dict(config_to_dict(cfg)) == cfg


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_jax_written_config_loads_in_the_port_and_back(name, tmp_path):
    """Both directions through files, compared as JSON dicts field for
    field: what JAX wrote loads in the port and writes back the same, and
    what the port wrote loads in JAX equal to JAX's own config."""
    jcfg = _varied(jax_experiment, name)
    jpath, path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jconfig_io.save_config(jcfg, jpath)
    cfg = load_config(jpath)
    assert cfg == _varied(experiment, name)
    assert json.loads(json.dumps(config_to_dict(cfg))) == _jax_dict(jcfg)
    save_config(cfg, path)
    assert jconfig_io.load_config(path) == jcfg
    with open(path) as f, open(jpath) as g:
        assert json.load(f) == json.load(g)


def test_the_mesh_section():
    """Any mesh section reads back into MeshConfig, and a JAX-written one
    loads in the port and back, equal."""
    from vae_mdl_tpu import config as jconfig
    from vae_mdl_tpu_torch.config import MeshConfig

    d = config_to_dict(experiment("model05"))
    assert d["mesh"] == {"data": -1, "sample": 1, "model": 1}
    assert config_from_dict({k: v for k, v in d.items() if k != "mesh"}) == experiment("model05")
    assert config_from_dict(dict(d, mesh={"data": -1})) == experiment("model05")
    for mesh in ({"data": 2, "sample": 1, "model": 1}, {"data": -1, "sample": 4, "model": 1},
                 {"data": 2, "sample": 2, "model": 2}):
        cfg = config_from_dict(dict(d, mesh=mesh))
        assert cfg.mesh == MeshConfig(**mesh)
        assert config_to_dict(cfg)["mesh"] == mesh
        jcfg = dataclasses.replace(jax_experiment("model05"), mesh=jconfig.MeshConfig(**mesh))
        assert config_from_dict(_jax_dict(jcfg)) == cfg
        assert jconfig_io.config_from_dict(config_to_dict(cfg)) == jcfg
    with pytest.raises(ValueError, match=r"'mesh'.*unknown field.*pipeline"):
        config_from_dict(dict(d, mesh={"data": -1, "pipeline": 2}))


def test_unknown_fields_are_named_errors():
    d = config_to_dict(experiment("model01"))
    d["train"]["learning_rtae"] = 1e-3
    with pytest.raises(ValueError, match=r"'train'.*learning_rtae"):
        config_from_dict(d)
    d2 = config_to_dict(experiment("model01"))
    d2["model"]["encoder"]["n_hiden"] = 5
    with pytest.raises(ValueError, match=r"model.encoder.*n_hiden"):
        config_from_dict(d2)
    d3 = config_to_dict(experiment("model01"))
    with pytest.raises(ValueError, match="model_class"):
        config_from_dict(dict(d3, model_class="transformer"))
    with pytest.raises(ValueError, match="format"):
        config_from_dict(dict(d3, format="vae-mdl-tpu/config/v999"))
    with pytest.raises(ValueError, match="no 'model' section"):
        config_from_dict({"train": {}})


def test_diff_configs_gives_dotted_paths_as_jax():
    a = experiment("model01")
    b = dataclasses.replace(
        a, train=dataclasses.replace(a.train, learning_rate=5e-4),
        model=dataclasses.replace(a.model, encoder=dataclasses.replace(a.model.encoder,
                                                                       n_hidden=123)))
    drift = diff_configs(a, b)
    assert "train.learning_rate: 0.001 -> 0.0005" in drift
    assert "model.encoder.n_hidden: 200 -> 123" in drift
    assert diff_configs(a, a) == []
    ja = jax_experiment("model01")
    jb = dataclasses.replace(
        ja, train=dataclasses.replace(ja.train, learning_rate=5e-4),
        model=dataclasses.replace(ja.model, encoder=dataclasses.replace(ja.model.encoder,
                                                                        n_hidden=123)))
    assert drift == jconfig_io.diff_configs(ja, jb)
    # across families: the model class and its fields
    assert "model_class: 'model' -> 'ladder'" in diff_configs(a, experiment("ladder_svhn"))
