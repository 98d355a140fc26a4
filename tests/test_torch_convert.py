"""The weight bridge: each layer alone matches Flax under bridged weights,
and the round trip Flax -> torch -> Flax is exact, the training state's too,
under every optimizer flag.

Tolerance: rtol 1e-5, atol 1e-5 for float32 convolutions and dense layers
whose sums XLA and PyTorch take in different orders; the state bridge's
round trip is exact.
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
    build_model(MODELS["model05"], device="cpu").load_state_dict(state, strict=True)
    back = params_to_flax(state, MODELS["model05"])
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _narrow_mdl(c):
    return c.ModelConfig(
        name="narrow", image_shape=(8, 8, 3), n_latent=4, likelihood="mdl", n_mix=2,
        encoder=c.EncoderConfig(kind="conv", conv_layers=(c.conv(8, 3, 1), c.conv(16, 3, 2))),
        decoder=c.DecoderConfig(kind="conv", base_size=(4, 4, 16),
                                conv_layers=(c.deconv(8, 4, 2), c.conv(20, 3, 1, "none"))),
    )


def _leaves_by_name(tree, prefix=()):
    """{path: array} of a nest of namedtuples, flax structs, dicts and tuples."""
    out = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            out.update(_leaves_by_name(value, prefix + (key,)))
    elif hasattr(tree, "_fields"):
        for key in tree._fields:
            out.update(_leaves_by_name(getattr(tree, key), prefix + (key,)))
    elif hasattr(tree, "__dataclass_fields__"):
        for key in tree.__dataclass_fields__:
            out.update(_leaves_by_name(getattr(tree, key), prefix + (key,)))
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            out.update(_leaves_by_name(value, prefix + (i,)))
    else:
        out[prefix] = np.asarray(tree)
    return out


@pytest.mark.parametrize("train_over", [
    dict(optimizer="adam_keras"),
    dict(grad_accum_steps=2),
    dict(optimizer="adam_keras", grad_accum_steps=3),
    dict(grad_clip_norm=0.5),
    dict(optimizer="adam_keras", grad_clip_norm=0.5, ema_decay=0.5),
    dict(optimizer="adamax", grad_clip_norm=0.5, grad_accum_steps=2),
    dict(grad_clip_norm=0.5, grad_accum_steps=2, lr_staircase=False),
])
def test_train_state_bridge_carries_every_optimizer(train_over):
    """A JAX state 3 steps into training under each optimizer flag -> the
    port -> back, exactly; the port's state holds JAX's values where the
    optimizer keeps them (Keras Adam's m/v/count, MultiSteps' counters and
    accumulated gradients, the clip chain's inner state), and one more step
    on both sides from the bridged states agrees."""
    import dataclasses

    from vae_mdl_tpu import config as jconfig
    from vae_mdl_tpu.models.zoo import experiment as jax_experiment
    from vae_mdl_tpu.train import state as jstate
    from vae_mdl_tpu.train.steps import make_train_step as jax_make_train_step
    from vae_mdl_tpu_torch import config
    from vae_mdl_tpu_torch.models.zoo import experiment
    from vae_mdl_tpu_torch.train.state import make_optimizer
    from vae_mdl_tpu_torch.utils.convert import train_state_from_flax, train_state_to_flax

    jcfg = jax_experiment("model05", model=_narrow_mdl(jconfig))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **train_over))
    cfg = experiment("model05", model=_narrow_mdl(config))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_over))
    jm = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jm, jcfg.train, jnp.zeros((2, 8, 8, 3)), jcfg.model.n_samples)
    step = jax_make_train_step(jm, jcfg, jstate.make_optimizer(jcfg.train), donate=False)
    batch = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8))
    for _ in range(3):
        jst, _ = step(jst, batch)

    model = build_model(cfg.model, device="cpu")
    state = train_state_from_flax(jst, model, cfg, seed=7)
    assert state.step == 3

    def port_node(opt):
        return opt[-1] if isinstance(opt, list) else opt

    node = port_node(state.opt_state)
    if cfg.train.grad_accum_steps > 1:
        jnode = _leaves_by_name(jst.opt_state)
        mini = [v for k, v in jnode.items() if k[-1] == "mini_step"][0]
        assert int(node["mini_step"]) == int(mini) == 3 % cfg.train.grad_accum_steps
        assert int(node["gradient_step"]) == 3 // cfg.train.grad_accum_steps
        acc = [v for k, v in jnode.items()
               if "acc_grads" in k and k[-2:] == ("conv_0", "bias") and k[-3] == "encoder"][0]
        np.testing.assert_array_equal(node["acc_grads"]["encoder.conv_0.bias"].numpy(), acc)
        node = node["inner_opt_state"]
    if cfg.train.optimizer == "adam_keras":
        assert set(node) == {"count", "m", "v"}
        want_v = [v for k, v in _leaves_by_name(jst.opt_state).items()
                  if "v" in k and k[-3:] == ("decoder", "Dense_0", "kernel")][0]
        np.testing.assert_array_equal(node["v"]["decoder.Dense_0.weight"].numpy(), want_v.T)
    assert int(node["count"]) == 3 // cfg.train.grad_accum_steps

    back = train_state_to_flax(state, cfg, like=jst)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jst)
    for u, v in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jst)):
        assert np.asarray(u).dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))

    # the bridged optimizer state is the one the port's update continues:
    # the same gradients into both optimizers give the same updates
    tx, jtx = make_optimizer(cfg.train), jstate.make_optimizer(jcfg.train)
    grads = {name: torch.full_like(p, 0.01) for name, p in state.params.items()}
    updates, _ = tx.update(grads, state.opt_state, state.params)
    jupdates, _ = jtx.update(jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01),
                                                    jst.params),
                             jst.opt_state, jst.params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jupdates), cfg.model)
    # rtol 1e-5 of float32 arithmetic in another order; atol 1e-8 (1.7e-5 of
    # the typical update, 5.8e-4) for the few weights whose second moment
    # is near eps**2, where sqrt(nu) + eps rounds differently (measured
    # 1.3e-9)
    for name, u in updates.items():
        np.testing.assert_allclose(u.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-8)
