"""Reference-checkpoint interop: import and export Keras weights.

Port of ``vae_mdl_tpu/utils/import_reference.py`` over the port's flat
params (``{name: tensor}``, the model's ``named_parameters()``). The
reference (nbip/vae-mdl) saves with ``tf.keras`` ``save_weights``, a TF
object-graph checkpoint whose keys are attribute paths such as
``encoder/encode_x_to_z/l1/kernel/.ATTRIBUTES/VARIABLE_VALUE``:

    from vae_mdl_tpu_torch.utils.import_reference import (
        load_reference_weights, save_reference_weights)
    params = load_reference_weights("saved_models/model01/best", "model01",
                                    dict(model.named_parameters()))
    save_reference_weights("saved_models/model01/exported", "model01", params)

The families and their reference object graphs are the JAX package's:
model01 (MLP), model02/03/05 (conv: ``encoder.convs`` + ``encoder.fc``,
``decoder.fc`` + ``decoder.deconvs`` ending in a Conv2D head), model04 (the
conv skeleton with 5-GLU stacks, a Conv2DTranspose head) and model06 (the
conv family plus the ``mlp_encoder`` / ``mlp_decoder`` blocks of the second
stochastic layer). The port names its layers as Flax does, so each Keras
layer maps straight to a parameter-name prefix (``encoder.conv_0``); the
port has no pytree key paths and keeps no copy of ``utils/trees.py``.

Layouts: Keras Dense ``[in, out]`` and Conv2D ``[kh, kw, in, out]`` kernels
are Flax's; a Conv2DTranspose kernel is ``[kh, kw, out, in]``, which
``transpose(0, 1, 3, 2)`` and a spatial flip turn into Flax's (TF applies the
mirror that Flax omits). From Flax's layout ``utils/convert.py``'s
``kernel_from_flax`` gives the torch weight (``Linear [out, in]``,
``Conv2d [out, in, kh, kw]``, ``ConvTranspose2d [in, out, kh, kw]``), and
``kernel_to_flax`` goes back.

TensorFlow is imported inside the two functions that read or write a Keras
file, never at module import.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from vae_mdl_tpu_torch.utils.convert import kernel_from_flax, kernel_to_flax

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"

# the port's layer (parameter-name prefix) -> (Keras attribute path, kind)
LayerMap = Dict[str, Tuple[str, str]]


def _require_params(params, fn: str) -> None:
    """Both directions take the flat ``{name: tensor}`` params of the model
    (``dict(model.named_parameters())``, ``TrainState.params``)."""
    if not isinstance(params, Mapping) or not all(
            isinstance(v, torch.Tensor) for v in params.values()):
        raise ValueError(f"{fn} expects the model's flat params {{name: tensor}}, e.g. "
                         "dict(model.named_parameters()) or TrainState.params")


def _model01_map() -> LayerMap:
    enc = "encoder/encode_x_to_z"
    dec = "decoder/decode_z_to_x"
    return {
        "encoder.MLPBlock_0.Dense_0": (f"{enc}/l1", "dense"),
        "encoder.MLPBlock_0.Dense_1": (f"{enc}/l2", "dense"),
        "encoder.MLPBlock_0.Dense_2": (f"{enc}/lmu", "dense"),
        "encoder.MLPBlock_0.Dense_3": (f"{enc}/lstd", "dense"),
        "decoder.Dense_0": (f"{dec}/layer_with_weights-0", "dense"),
        "decoder.Dense_1": (f"{dec}/layer_with_weights-1", "dense"),
        "decoder.out": (f"{dec}/layer_with_weights-2", "dense"),
    }


def _n_layers(params, prefix: str) -> int:
    return sum(1 for name in params if name.startswith(prefix) and name.endswith(".weight"))


def _conv_family_map(params) -> LayerMap:
    """model02/03/05: encoder convs + fc, decoder fc + deconvs (+ the conv
    head). The layer counts are read off the params."""
    n_enc = _n_layers(params, "encoder.conv_")
    n_dec = _n_layers(params, "decoder.conv_")
    m = {"encoder.Dense_0": ("encoder/fc", "dense"), "decoder.Dense_0": ("decoder/fc", "dense")}
    for i in range(n_enc):
        m[f"encoder.conv_{i}"] = (f"encoder/convs/layer_with_weights-{i}", "conv")
    for i in range(n_dec):
        # the last Sequential entry is a plain Conv2D likelihood head
        m[f"decoder.conv_{i}"] = (f"decoder/deconvs/layer_with_weights-{i}",
                                  "deconv" if i < n_dec - 1 else "conv")
    return m


def _model06_map(params) -> LayerMap:
    """The conv family plus the two MLP blocks of the second stochastic
    layer (``mlp_encoder`` / ``mlp_decoder`` BasicBlocks)."""
    m = _conv_family_map(params)
    for ours, ref in (("mlp_encoder_1", "mlp_encoder"), ("mlp_decoder_1", "mlp_decoder")):
        for dense, keras in (("Dense_0", "l1"), ("Dense_1", "l2"), ("Dense_2", "lmu"),
                             ("Dense_3", "lstd")):
            m[f"{ours}.{dense}"] = (f"{ref}/{keras}", "dense")
    return m


def _model04_map() -> LayerMap:
    """model04: encoder ``convs`` = 3 Conv2D + 5 GLU; decoder ``deconvs`` =
    Conv2D + 5 GLU + 2 Conv2DTranspose (the last is the 6-channel DL head).
    Each reference GLU holds ``conv`` = Sequential(Conv2D, Conv2D), the
    port's GLU ``Conv_0`` / ``Conv_1``."""
    m = {
        "encoder.Dense_0": ("encoder/fc", "dense"),
        "decoder.Dense_0": ("decoder/fc", "dense"),
        "decoder.pre_0": ("decoder/deconvs/layer_with_weights-0", "conv"),
        "decoder.conv_0": ("decoder/deconvs/layer_with_weights-6", "deconv"),
        "decoder.conv_1": ("decoder/deconvs/layer_with_weights-7", "deconv"),
    }
    for i in range(3):
        m[f"encoder.conv_{i}"] = (f"encoder/convs/layer_with_weights-{i}", "conv")
    for g in range(5):
        for tower, base in (("encoder", f"encoder/convs/layer_with_weights-{3 + g}/conv"),
                            ("decoder", f"decoder/deconvs/layer_with_weights-{1 + g}/conv")):
            m[f"{tower}.glu_{g}.Conv_0"] = (f"{base}/layer_with_weights-0", "conv")
            m[f"{tower}.glu_{g}.Conv_1"] = (f"{base}/layer_with_weights-1", "conv")
    return m


def _mapping_for(model_name: str, params) -> LayerMap:
    if model_name == "model01":
        return _model01_map()
    if model_name in ("model02", "model03", "model05"):
        return _conv_family_map(params)
    if model_name == "model04":
        return _model04_map()
    if model_name == "model06":
        return _model06_map(params)
    raise NotImplementedError(
        f"no reference weight mapping for {model_name!r}: supported families are "
        "model01-model06 (the ladders and digits have no reference checkpoints to import)")


def _keras_to_flax(kind: str, arr: np.ndarray) -> np.ndarray:
    """Keras kernel -> Flax layout: Conv2DTranspose ``[kh, kw, out, in]``
    transposed to ``[kh, kw, in, out]`` and mirrored in space; the transform
    is its own inverse, so it also goes from Flax to Keras."""
    if kind == "deconv":
        return np.ascontiguousarray(np.transpose(arr, (0, 1, 3, 2))[::-1, ::-1])
    return arr


def load_reference_weights(ckpt_prefix: str, model_name: str, params) -> Dict[str, torch.Tensor]:
    """Read a reference ``save_weights`` checkpoint into new params.

    ``params`` is the template (``dict(model.named_parameters())``); the
    result has its names, each a float32 tensor on the template's device.
    Unknown families, missing checkpoint keys, shape mismatches and mapping
    gaps raise: every template parameter must receive an imported value."""
    _require_params(params, "load_reference_weights")
    mapping = _mapping_for(model_name, params)
    try:
        from tensorflow.python.training import py_checkpoint_reader
    except ImportError as e:  # pragma: no cover
        raise ImportError("importing reference checkpoints needs tensorflow "
                          "(pip install tensorflow-cpu)") from e
    reader = py_checkpoint_reader.NewCheckpointReader(ckpt_prefix)
    available = set(reader.get_variable_to_shape_map())

    out = {}
    for layer, (ref_base, kind) in mapping.items():
        for ours, keras in (("weight", "kernel"), ("bias", "bias")):
            key = f"{ref_base}/{keras}{_SUFFIX}"
            name = f"{layer}.{ours}"
            if name not in params:
                raise KeyError(f"params have no {name!r}: wrong model config for "
                               f"{model_name!r}?")
            if key not in available:
                raise KeyError(f"checkpoint {ckpt_prefix!r} lacks {key!r}; is this a "
                               f"{model_name} save_weights checkpoint? available keys "
                               f"include: {sorted(available)[:4]} ...")
            arr = np.asarray(reader.get_tensor(key), np.float32)
            if ours == "weight":
                arr = kernel_from_flax(_keras_to_flax(kind, arr), kind == "deconv")
            want = tuple(params[name].shape)
            if arr.shape != want:
                raise ValueError(f"shape mismatch importing {key!r} -> {name}: checkpoint "
                                 f"{arr.shape} (as a torch weight) vs params {want}")
            out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(params[name].device)

    unmapped = sorted(name for name in params if name not in out)
    if unmapped:
        raise KeyError(f"the {model_name!r} weight mapping covers {len(out)} of {len(params)} "
                       f"params; unmapped: {unmapped} - extend _mapping_for so every "
                       "parameter is imported")
    return {name: out[name] for name in params}


def save_reference_weights(ckpt_prefix: str, model_name: str, params) -> None:
    """Write params as a reference-layout Keras TF-format checkpoint (the
    object-graph keys ``save_weights`` produces), the reverse of
    ``load_reference_weights``: same families, the inverse transforms."""
    _require_params(params, "save_reference_weights")
    mapping = _mapping_for(model_name, params)
    try:
        import tensorflow as tf
    except ImportError as e:  # pragma: no cover
        raise ImportError("writing reference checkpoints needs tensorflow "
                          "(pip install tensorflow-cpu)") from e

    class _Node(tf.Module):
        pass

    roots: Dict[str, _Node] = {}
    for layer, (ref_base, kind) in mapping.items():
        first, *rest = ref_base.split("/")
        node = roots.setdefault(first, _Node())
        for part in rest:
            if getattr(node, part, None) is None:
                setattr(node, part, _Node())
            node = getattr(node, part)
        for ours, keras in (("weight", "kernel"), ("bias", "bias")):
            name = f"{layer}.{ours}"
            if name not in params:
                raise KeyError(f"params have no {name!r}: wrong model config for "
                               f"{model_name!r}?")
            arr = params[name].detach().cpu().numpy().astype(np.float32)
            if ours == "weight":
                arr = _keras_to_flax(kind, kernel_to_flax(arr, kind == "deconv"))
            setattr(node, keras, tf.Variable(np.ascontiguousarray(arr)))
    tf.train.Checkpoint(**roots).write(ckpt_prefix)
