"""The blocks the discretized-logistic families add, each against its Flax
module on bridged weights: ``MLPBlock`` (model06's upper stochastic layers),
``GLU`` and the GLU encoder and decoder of model04, whose head is a
transposed conv run in float32.

Tolerance: rtol 1e-5, atol 1e-5 for float32 convolutions and dense layers
whose sums XLA and PyTorch take in different orders; 2e-5 after the decoder's
seven stacked convolutions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_mdl_tpu.nn.blocks import GLU as JaxGLU
from vae_mdl_tpu.nn.blocks import MLPBlock as JaxMLPBlock
from vae_mdl_tpu.nn.decoders import ConvDecoder as JaxConvDecoder
from vae_mdl_tpu.nn.encoders import ConvEncoder as JaxConvEncoder
from vae_mdl_tpu.nn.encoders import ConvSpec as JaxConvSpec
from vae_mdl_tpu_torch.config import DecoderConfig, EncoderConfig, ModelConfig
from vae_mdl_tpu_torch.distributions import DiscretizedLogistic
from vae_mdl_tpu_torch.nn.blocks import GLU, MLPBlock
from vae_mdl_tpu_torch.nn.decoders import ConvDecoder
from vae_mdl_tpu_torch.nn.encoders import ConvEncoder, ConvSpec
from vae_mdl_tpu_torch.utils.convert import params_from_flax, params_to_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _init(module, *args):
    """Flax variables with every bias made non-zero, so the bias layouts are
    checked too."""
    variables = jax.tree_util.tree_map(np.array, module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(0)

    def fill(node):
        for key, child in node.items():
            if key == "bias":
                node[key] = rng.standard_normal(child.shape).astype(np.float32) * 0.1
            elif isinstance(child, dict):
                fill(child)

    fill(variables["params"])
    return variables


def _load(module, variables, cfg=ModelConfig(), part="block"):
    state = params_from_flax({part: variables["params"]}, cfg)
    module.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    return module


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("std_transform,activation", [("exp", "tanh"), ("softplus", "gelu")])
def test_mlp_block_matches_flax(std_transform, activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 7)).astype(np.float32)
    theirs = JaxMLPBlock(12, 5, activation=activation, std_transform=std_transform)
    variables = _init(theirs, jnp.asarray(x))
    want = theirs.apply(variables, jnp.asarray(x))
    ours = _load(MLPBlock(7, 12, 5, activation, std_transform), variables)
    assert sorted(n for n, _ in ours.named_children()) == sorted(variables["params"])
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.event_axes == want.event_axes == (-1,)
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc), **TOL)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), **TOL)
    assert float(got.scale.min()) >= 1e-6  # std_eps


def test_mlp_block_refuses_an_unknown_std_transform():
    with pytest.raises(ValueError, match="std_transform"):
        MLPBlock(4, 4, 2, std_transform="sigmoid")


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_glu_matches_flax(activation):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 5, 9)).astype(np.float32)
    theirs = JaxGLU(features=8, activation=activation)
    variables = _init(theirs, jnp.asarray(x))
    want = np.asarray(theirs.apply(variables, jnp.asarray(x)))
    ours = _load(GLU(9, 8, activation), variables)
    with torch.no_grad():
        got = ours(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 6, 5, 8)
    assert (got >= 0).all() and (got > 0).any()  # relu(a * sigmoid(b))
    np.testing.assert_allclose(got, want, **TOL)


def test_glu_encoder_matches_flax():
    """model04's encoder shape at a narrow width: two 4x4 stride-2 convs
    (asymmetric SAME padding), a 3x3 conv, two GLUs, the NHWC flatten."""
    rng = np.random.default_rng(3)
    x = rng.random((3, 16, 16, 3)).astype(np.float32)
    layers = ((8, 4, 2, False, "relu"), (12, 4, 2, False, "relu"), (12, 3, 1, False, "relu"))
    theirs = JaxConvEncoder(conv_specs=tuple(JaxConvSpec(*l) for l in layers), n_latent=6,
                            n_glu=2, glu_features=10)
    variables = _init(theirs, jnp.asarray(x))
    want = theirs.apply(variables, jnp.asarray(x))
    cfg = ModelConfig(encoder=EncoderConfig(kind="conv", conv_layers=layers, n_glu=2,
                                            glu_features=10))
    ours = _load(ConvEncoder(tuple(ConvSpec(*l) for l in layers), (16, 16, 3), 6,
                             n_glu=2, glu_features=10), variables, cfg, "encoder")
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc), **TOL)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), **TOL)


@pytest.mark.parametrize("bound_logstd", [False, True])
def test_glu_decoder_with_a_transposed_head_matches_flax(bound_logstd):
    """model04's decoder shape at a narrow width: an odd-channel base, a
    ``pre`` conv, two GLUs, a transposed conv and the head folded into a
    second transposed conv, which hands the "dl" likelihood its two halves."""
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 3, 5)).astype(np.float32)
    pre = ((12, 3, 1, False, "relu"),)
    layers = ((8, 4, 2, True, "relu"), (6, 4, 2, True, "none"))
    theirs = JaxConvDecoder(conv_specs=tuple(JaxConvSpec(*l) for l in layers),
                            base_size=(4, 4, 7), out_shape=(16, 16, 3),
                            pre_specs=tuple(JaxConvSpec(*l) for l in pre), n_glu=2,
                            glu_features=10, likelihood="dl", bound_logstd=bound_logstd,
                            use_pallas=False)
    variables = _init(theirs, jnp.asarray(z))
    want = theirs.apply(variables, jnp.asarray(z))
    cfg = ModelConfig(likelihood="dl", decoder=DecoderConfig(
        kind="conv", base_size=(4, 4, 7), pre_layers=pre, n_glu=2, glu_features=10,
        conv_layers=layers))
    ours = _load(ConvDecoder(tuple(ConvSpec(*l) for l in layers), 5, base_size=(4, 4, 7),
                             out_shape=(16, 16, 3), likelihood="dl", bound_logstd=bound_logstd,
                             pre_specs=tuple(ConvSpec(*l) for l in pre), n_glu=2,
                             glu_features=10), variables, cfg, "decoder")
    with torch.no_grad():
        got = ours(torch.from_numpy(z))
    assert isinstance(got, DiscretizedLogistic) and got.loc.shape == (2, 3, 16, 16, 3)
    assert (got.low, got.high, got.levels) == (want.low, want.high, want.levels) == (0.0, 1.0, 256.0)
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.logscale.numpy(), np.asarray(want.logscale),
                               rtol=2e-5, atol=2e-5)
    # the bridge back names every leaf as Flax does
    back = params_to_flax({f"decoder.{k}": v for k, v in ours.state_dict().items()}, cfg)
    assert (jax.tree_util.tree_structure(back["params"]["decoder"])
            == jax.tree_util.tree_structure(variables["params"]))


def test_bf16_body_keeps_the_head_and_the_latent_heads_in_float32():
    """compute_dtype bfloat16: the GLU stacks and the MLP body run in bf16,
    the likelihood head and the (mu, scale) heads in float32, within bf16
    rounding (rtol 5e-2 of the largest value) of the float32 module."""
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    layers = (ConvSpec(8, 4, 2, True, "relu"), ConvSpec(6, 4, 2, True, "none"))
    kwargs = dict(base_size=(4, 4, 7), out_shape=(16, 16, 3), likelihood="dl", n_glu=1,
                  glu_features=10, pre_specs=(ConvSpec(12, 3, 1, False, "relu"),))
    f32 = ConvDecoder(layers, 5, generator=gen(), **kwargs)
    bf16 = ConvDecoder(layers, 5, dtype=torch.bfloat16, generator=gen(), **kwargs)
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 5)).astype(np.float32))
    with torch.no_grad():
        a, b = f32(z), bf16(z)
        assert b.loc.dtype == torch.float32
        assert float((a.loc - b.loc).abs().max()) <= 5e-2 * float(a.loc.abs().max())
        assert not torch.equal(a.loc, b.loc)
        q32 = MLPBlock(5, 12, 4, "gelu", "softplus", generator=gen())(z)
        q16 = MLPBlock(5, 12, 4, "gelu", "softplus", dtype=torch.bfloat16, generator=gen())(z)
        assert q16.loc.dtype == q16.scale.dtype == torch.float32
        assert float((q32.loc - q16.loc).abs().max()) <= 5e-2 * float(q32.loc.abs().max())
