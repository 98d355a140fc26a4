"""The weight bridge: each layer alone matches Flax under bridged weights,
and the round trip Flax -> torch -> Flax is exact.

Tolerance: rtol 1e-5, atol 1e-5 for float32 convolutions and dense layers
whose sums XLA and PyTorch take in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from vae_mdl_tpu.models.vae import build_model as jax_build_model
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.nn.decoders import ConvDecoder as JaxConvDecoder
from vae_mdl_tpu.nn.encoders import ConvEncoder as JaxConvEncoder
from vae_mdl_tpu.nn.encoders import ConvSpec as JaxConvSpec
from vae_mdl_tpu_torch.config import DecoderConfig, ModelConfig
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import MODELS
from vae_mdl_tpu_torch.nn.decoders import ConvDecoder
from vae_mdl_tpu_torch.nn.encoders import ConvEncoder, ConvLayer, ConvSpec
from vae_mdl_tpu_torch.utils.convert import (
    kernel_from_flax,
    params_from_flax,
    params_to_flax,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _init(module, *args):
    return jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(0), *args))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("features,kernel,stride,transpose,size", [
    (8, 3, 1, False, 9),    # stride-1 SAME conv
    (8, 3, 2, False, 32),   # stride-2 SAME, asymmetric (0, 1) padding
    (8, 3, 2, False, 7),    # stride-2 SAME, symmetric (1, 1) padding
    (8, 4, 2, False, 8),    # model04's 4x4 stride-2 conv
    (8, 4, 2, True, 4),     # 4x4 stride-2 ConvTranspose, model05's decoder
    (8, 4, 2, True, 5),
])
def test_single_conv_layer_matches_flax(features, kernel, stride, transpose, size):
    rng = np.random.default_rng(size + 10 * kernel)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    cls = fnn.ConvTranspose if transpose else fnn.Conv
    layer = cls(features, (kernel, kernel), strides=(stride, stride), padding="SAME")
    variables = _init(layer, jnp.asarray(x))
    # non-zero bias, so the bias layout is checked too
    variables["params"]["bias"] = rng.standard_normal(features).astype(np.float32)
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))

    ours = ConvLayer(ConvSpec(features, kernel, stride, transpose, "none"), 5)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(
            kernel_from_flax(variables["params"]["kernel"], transpose)))
        ours.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        got = ours(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_encoder_flatten_dense_boundary_matches_flax():
    """No convs: the encoder is the NHWC flatten + Dense_0 + softplus."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 4, 16)).astype(np.float32)
    theirs = JaxConvEncoder(conv_specs=(), n_latent=6)
    variables = _init(theirs, jnp.asarray(x))
    q_want = theirs.apply(variables, jnp.asarray(x))

    ours = ConvEncoder((), (4, 4, 16), n_latent=6)
    sd = params_from_flax({"encoder": variables["params"]}, MODELS["model05"])
    ours.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        q = ours(torch.from_numpy(x))
    np.testing.assert_allclose(q.loc.numpy(), np.asarray(q_want.loc), **TOL)
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(q_want.scale), **TOL)


def test_decoder_dense_reshape_boundary_matches_flax():
    """Dense_0 + NHWC reshape to the base grid + a 3x3 head conv."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 3, 6)).astype(np.float32)
    head = (20, 3, 1, False, "none")
    theirs = JaxConvDecoder(conv_specs=(JaxConvSpec(*head),), base_size=(4, 4, 8),
                            out_shape=(4, 4, 3), likelihood="mdl", n_mix=2,
                            use_pallas=False)
    variables = _init(theirs, jnp.asarray(z))
    want = np.asarray(theirs.apply(variables, jnp.asarray(z)).parameters)

    cfg = ModelConfig(likelihood="mdl", n_mix=2,
                      decoder=DecoderConfig(base_size=(4, 4, 8), conv_layers=(head,)))
    ours = ConvDecoder((ConvSpec(*head),), n_latent=6, base_size=(4, 4, 8),
                       out_shape=(4, 4, 3), n_mix=2)
    sd = params_from_flax({"decoder": variables["params"]}, cfg)
    ours.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ours(torch.from_numpy(z)).parameters.numpy()
    assert got.shape == want.shape == (2, 3, 4, 4, 20)
    np.testing.assert_allclose(got, want, **TOL)


def test_model05_round_trip_is_exact():
    jm = jax_build_model(JAX_MODELS["model05"])
    init = jax.jit(lambda rngs, x: jm.init(rngs, x, 1))
    variables = jax.tree_util.tree_map(np.asarray, init(
        {"params": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)},
        jnp.zeros((1, 32, 32, 3))))
    state = params_from_flax(variables, MODELS["model05"])
    assert sum(v.numel() for v in state.values()) == 1_035_962
    build_model(MODELS["model05"]).load_state_dict(state, strict=True)
    back = params_to_flax(state, MODELS["model05"])
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
