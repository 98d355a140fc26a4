"""``PolyphaseConvTranspose`` and ``apply_conv_stack(polyphase=)`` against
the JAX package (mirroring ``tests/test_blocks.py``'s two polyphase tests):
the module on the Flax ``ConvTranspose``'s parameters bridged to the port's
layout (``utils/convert.py``: HWIO to IOHW, flipped), on plain and
leading-sample-axis inputs, values and gradients; the stack with and
without the polyphase form in both packages, on model05's decoder geometry.

Tolerances, as the JAX tests': rtol 1e-5, atol 1e-5 on values (the same
float32 products summed in another order: a 3x3 conv over placed taps
against a transposed conv), rtol 1e-4, atol 1e-4 on the gradients (sums
over every output pixel).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vae_mdl_tpu.nn import encoders as jenc
from vae_mdl_tpu_torch.nn import encoders
from vae_mdl_tpu_torch.nn.encoders import (
    ConvLayer,
    ConvSpec,
    PolyphaseConvTranspose,
    apply_conv_stack,
    polyphase_conv_transpose,
)
from vae_mdl_tpu_torch.utils.convert import kernel_from_flax

torch.set_num_threads(1)

SHAPES = [(4, 4, 16, 12), (8, 8, 13, 7), (5, 7, 3, 6)]


def _nchw(x):
    """``[..., H, W, C]`` numpy -> ``[N, C, H, W]`` torch, leading axes merged."""
    t = torch.from_numpy(np.array(x))
    return t.reshape((-1,) + t.shape[-3:]).permute(0, 3, 1, 2)


def _nhwc(t, lead):
    return t.permute(0, 2, 3, 1).reshape(tuple(lead) + tuple(t.shape[2:]) + (t.shape[1],))


def _module(params, cin, f):
    m = PolyphaseConvTranspose(cin, f)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel_from_flax(np.asarray(params["params"]["kernel"]),
                                                         transposed=True)))
        m.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
    return m


def test_the_automatic_choice_is_off_in_both():
    assert encoders.use_polyphase_deconv() is False is jenc.use_polyphase_deconv()


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("h,w,cin,f", SHAPES)
def test_the_module_equals_jax(h, w, cin, f, lead):
    key = jax.random.PRNGKey(7)
    x = jax.random.normal(jax.random.fold_in(key, h), tuple(lead) + (h, w, cin))
    ref = fnn.ConvTranspose(f, (4, 4), strides=(2, 2), padding="SAME")
    params = ref.init(jax.random.fold_in(key, w), x)
    params = {"params": {"kernel": params["params"]["kernel"],
                         "bias": jax.random.normal(jax.random.fold_in(key, 3), (f,))}}
    poly = jenc.PolyphaseConvTranspose(f, 4, 2)
    want = poly.apply(params, x)
    np.testing.assert_allclose(np.asarray(ref.apply(params, x)), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    m = _module(params, cin, f)
    got = m(_nchw(x))
    assert got.shape == (int(np.prod(lead)), f, 2 * h, 2 * w)
    np.testing.assert_allclose(_nhwc(got, lead).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)

    # gradients with respect to the parameters
    g_want = jax.grad(lambda p: jnp.sum(poly.apply(p, x) ** 2))(params)["params"]
    (got ** 2).sum().backward()
    np.testing.assert_allclose(
        m.weight.grad.numpy(), kernel_from_flax(np.asarray(g_want["kernel"]), transposed=True),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(g_want["bias"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w,cin,f", SHAPES)
def test_the_module_equals_the_transposed_conv_layer_on_its_weights(h, w, cin, f):
    """The same parameters as the transposed ``ConvLayer``: the polyphase
    form equals ``F.conv_transpose2d`` on them, values and gradients."""
    gen = torch.Generator().manual_seed(h * w)
    layer = ConvLayer(ConvSpec(f, 4, 2, True, "none"), cin, gen)
    with torch.no_grad():
        layer.bias.normal_(generator=gen)
    x = torch.randn(3, cin, h, w, generator=gen, requires_grad=True)
    want = F.conv_transpose2d(x, layer.weight, layer.bias, stride=2, padding=1)
    got = polyphase_conv_transpose(x, layer.weight, layer.bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    gw = torch.autograd.grad((want ** 2).sum(), (x, layer.weight, layer.bias))
    gp = torch.autograd.grad((got ** 2).sum(), (x, layer.weight, layer.bias))
    for a, b in zip(gp, gw):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_the_module_refuses_another_kernel_or_stride():
    with pytest.raises(ValueError, match="kernel 4, stride 2"):
        PolyphaseConvTranspose(3, 4, kernel=3, stride=2)


SPECS = ((32, 4, 2, True, "relu"), (6, 4, 2, True, "none"))


class _JaxStack(fnn.Module):
    polyphase: bool

    @fnn.compact
    def __call__(self, x):
        specs = tuple(jenc.ConvSpec(*s) for s in SPECS)
        return jenc.apply_conv_stack(specs, x, jnp.float32, polyphase=self.polyphase)


@pytest.mark.parametrize("lead", [(4,), (2, 4)])
def test_the_stack_with_and_without_polyphase_in_both_packages(lead):
    """``apply_conv_stack(polyphase=True)`` equals ``polyphase=False`` on the
    model05 decoder geometry with shared parameters, in each package and
    across them, values and gradients, with a leading sample axis."""
    x = jax.random.normal(jax.random.PRNGKey(0), tuple(lead) + (8, 8, 16))
    params = _JaxStack(polyphase=False).init(jax.random.PRNGKey(1), x)
    want = _JaxStack(polyphase=False).apply(params, x)
    np.testing.assert_allclose(np.asarray(_JaxStack(polyphase=True).apply(params, x)),
                               np.asarray(want), rtol=1e-5, atol=1e-5)

    layers, cin = [], 16
    for i, spec in enumerate(SPECS):
        layer = ConvLayer(ConvSpec(*spec), cin)
        flax = params["params"][f"conv_{i}"]
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(kernel_from_flax(np.asarray(flax["kernel"]),
                                                                 transposed=True)))
            layer.bias.copy_(torch.from_numpy(np.array(flax["bias"])))
        layers.append(layer)
        cin = spec[0]
    outs, grads = {}, {}
    for polyphase in (False, True):
        y = apply_conv_stack(layers, _nchw(x), torch.float32, polyphase=polyphase)
        outs[polyphase] = _nhwc(y, lead)
        grads[polyphase] = torch.autograd.grad((y ** 2).sum(),
                                               [p for l in layers for p in l.parameters()])
    np.testing.assert_allclose(outs[False].detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[True], outs[False], rtol=1e-5, atol=1e-5)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
