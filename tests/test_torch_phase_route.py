"""The phase route of a forward-only kernel-4 stride-2 transposed conv
(``nn/encoders.py`` ``phase_conv_transpose``: one 2x2 conv over the four
output phases, then the epilogue of ``ops/cuda/phase_shuffle.py``), through
the epilogue's plain version: against ``F.conv_transpose2d`` on
``ConvLayer``'s weights and against the JAX package's ``ConvTranspose``
layer, at model05's three decoder shapes and model04's head, with each
activation the epilogue takes; the phase weight's taps against the
polyphase form's; the rule (``takes_phase_route``) as a pure function; the
CPU layer left on ``F.conv_transpose2d``; the epilogue's checks.

Tolerances: rtol 1e-5, atol 1e-5 on values, as the polyphase tests': the
same float32 products summed in another order (a 2x2 conv over placed taps
against a transposed conv).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vae_mdl_tpu.nn import encoders as jenc
from vae_mdl_tpu_torch.models.zoo import MODELS
from vae_mdl_tpu_torch.nn import encoders
from vae_mdl_tpu_torch.nn.blocks import _activation
from vae_mdl_tpu_torch.nn.encoders import (
    ConvLayer,
    ConvSpec,
    phase_conv_transpose,
    phase_weight,
    polyphase_weight,
    takes_phase_route,
)
from vae_mdl_tpu_torch.ops.cuda import phase_shuffle
from vae_mdl_tpu_torch.utils.convert import kernel_from_flax

torch.set_num_threads(1)

# (in, out, input side): model05's decoder, model04's head
SHAPES = [(128, 128, 4), (128, 64, 8), (64, 32, 16), (128, 6, 16)]
ACTIVATIONS = ["relu", "gelu", "none"]


def zoo_shapes():
    """Every distinct kernel-4 stride-2 transposed layer of the zoo's conv
    decoders as ``(first model, in_features, features, input side,
    activation)``, in the zoo's order; square inputs."""
    seen = {}
    for name, cfg in MODELS.items():
        d = getattr(cfg, "decoder", None)
        if getattr(d, "kind", None) != "conv":
            continue
        side, feats = d.base_size[0], d.base_size[-1]
        for spec in d.pre_layers:
            feats = spec[0]
        if d.n_glu:
            feats = d.glu_features
        for f, k, s, transpose, act in d.conv_layers:
            if transpose and (k, s) == (4, 2):
                seen.setdefault((feats, f, side, act), name)
            side = side * s if transpose else -(-side // s)
            feats = f
    return [(model,) + key for key, model in seen.items()]


def _layer(cin, f, act, seed):
    gen = torch.Generator().manual_seed(seed)
    layer = ConvLayer(ConvSpec(f, 4, 2, True, act), cin, gen)
    with torch.no_grad():
        layer.bias.normal_(generator=gen)
    return layer, gen


@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("cin,f,side", SHAPES)
def test_the_plain_route_equals_conv_transpose2d_on_the_layers_weights(cin, f, side, act):
    """Values, and the output's memory format: NCHW for a float32 input in
    either format (the route makes it contiguous)."""
    layer, gen = _layer(cin, f, act, side)
    x = torch.randn(2, cin, side, side, generator=gen)
    want = _activation(act)(F.conv_transpose2d(x, layer.weight, layer.bias, stride=2,
                                               padding=1))
    got = phase_conv_transpose(x, layer.weight, layer.bias, act)
    assert got.shape == (2, f, 2 * side, 2 * side) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the same from a channels-last input, the layout the decoder's dense layer gives
    got = phase_conv_transpose(x.contiguous(memory_format=torch.channels_last), layer.weight,
                               layer.bias, act)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


class _JaxLayer(fnn.Module):
    spec: tuple

    @fnn.compact
    def __call__(self, x):
        return jenc.apply_conv_spec(jenc.ConvSpec(*self.spec), x, jnp.float32, "conv_0")


@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("cin,f,side", SHAPES)
def test_the_plain_route_equals_jax_conv_transpose(cin, f, side, act):
    """The JAX package's transposed layer (``nn.ConvTranspose``, SAME, and
    its activation) on its own parameters, bridged to the port's layout."""
    key = jax.random.PRNGKey(side)
    x = jax.random.normal(key, (2, side, side, cin))
    ref = _JaxLayer((f, 4, 2, True, act))
    params = ref.init(jax.random.fold_in(key, 1), x)
    flax = params["params"]["conv_0"]
    bias = jax.random.normal(jax.random.fold_in(key, 2), (f,))
    params = {"params": {"conv_0": {"kernel": flax["kernel"], "bias": bias}}}
    want = np.asarray(ref.apply(params, x))
    weight = torch.from_numpy(kernel_from_flax(np.asarray(flax["kernel"]), transposed=True))
    got = phase_conv_transpose(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2), weight,
                               torch.from_numpy(np.array(bias)), act)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,f", [(128, 128), (3, 5)])
def test_the_phase_weight_holds_the_polyphase_forms_taps(cin, f):
    """Phase (r, c)'s 2x2 window is the polyphase form's 3x3 window from row
    r and column c: ``phase_weight[(2r + c) f + o, :, t, u]`` is
    ``polyphase_weight[4 o + 2r + c, :, r + t, c + u]``; the weight is
    contiguous."""
    weight = torch.randn(cin, f, 4, 4, generator=torch.Generator().manual_seed(cin))
    w2, w3 = phase_weight(weight), polyphase_weight(weight)
    assert w2.shape == (4 * f, cin, 2, 2)
    assert w2.is_contiguous()
    for r in (0, 1):
        for c in (0, 1):
            for t in (0, 1):
                for u in (0, 1):
                    mine = w2[(2 * r + c) * f:(2 * r + c + 1) * f, :, t, u]
                    theirs = w3[2 * r + c::4, :, r + t, c + u]
                    assert torch.equal(mine, theirs)


_K42 = ConvSpec(32, 4, 2, True, "relu")


@pytest.mark.parametrize("records", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_the_rule_over_device_dtype_and_grad_mode(device_type, dtype, records):
    """The route on the card at float32 for a call autograd does not record,
    nowhere else (``device_type`` stands in for a card); bf16 keeps
    ``F.conv_transpose2d``."""
    want = device_type == "cuda" and dtype == torch.float32 and not records
    assert takes_phase_route(_K42, device_type, dtype, records) is want


def test_a_traced_call_keeps_conv_transpose2d(monkeypatch):
    """Under ``torch.export`` or ``torch.compile`` (``torch.compiler``
    reports it) the rule says no, so a traced program holds
    ``F.conv_transpose2d``."""
    assert takes_phase_route(_K42, "cuda", torch.float32, False)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert not takes_phase_route(_K42, "cuda", torch.float32, False)


@pytest.mark.parametrize("spec,want", [
    (_K42, True),
    (ConvSpec(32, 4, 2, True, "gelu"), True),
    (ConvSpec(8, 4, 2, True, "none"), True),
    (ConvSpec(6, 4, 2, True, "none"), False),
    (ConvSpec(7, 4, 2, True, "relu"), False),
    (ConvSpec(32, 4, 2, True, "tanh"), False),
    (ConvSpec(32, 4, 2, True, "gelu_tanh"), False),
    (ConvSpec(32, 3, 2, True, "relu"), False),
    (ConvSpec(32, 4, 1, True, "relu"), False),
    (ConvSpec(32, 4, 2, False, "relu"), False),
])
def test_the_rule_over_the_layers_spec(spec, want):
    assert takes_phase_route(spec, "cuda", torch.float32, False) is want


def test_the_zoos_transposed_layers_are_the_tested_shapes():
    """Every kernel-4 stride-2 transposed layer of the zoo is one of
    ``SHAPES`` or model06's gelu copy of model05's, so the card tests'
    shapes cover what the zoo sends the route."""
    shapes = {(cin, f, side, act) for _, cin, f, side, act in zoo_shapes()}
    model05 = {(cin, f, side) for cin, f, side in SHAPES[:3]}
    assert shapes == ({s + ("relu",) for s in model05} | {s + ("gelu",) for s in model05}
                      | {(64, 128, 8, "relu"), (128, 6, 16, "none")})


@pytest.mark.parametrize("grad", [False, True])
def test_a_cpu_layer_keeps_conv_transpose2d(grad):
    """On the CPU the layer is ``F.conv_transpose2d`` whatever the grad
    mode, bit for bit, and the epilogue's kernel is not counted."""
    layer, gen = _layer(16, 8, "relu", 0)
    x = torch.randn(3, 16, 4, 4, generator=gen)
    before = phase_shuffle.launches
    with torch.set_grad_enabled(grad):
        got = layer(x)
    want = F.relu(F.conv_transpose2d(x, layer.weight, layer.bias, stride=2, padding=1))
    assert torch.equal(got, want) and phase_shuffle.launches == before


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_the_plain_epilogue_follows_its_formula(act):
    """``out[n, o, 2i + r, 2j + c] = act(grid[n, (2r + c) C + o, i + r, j + c]
    + bias[o])``, element by element, contiguous from a grid in either
    memory format."""
    gen = torch.Generator().manual_seed(1)
    n, c, h, w = 2, 3, 4, 5
    grid = torch.randn(n, 4 * c, h + 1, w + 1, generator=gen)
    bias = torch.randn(c, generator=gen)
    got = phase_shuffle.phase_shuffle(grid, bias, act)
    a = _activation(act)
    for r in (0, 1):
        for s in (0, 1):
            want = a(grid[:, (2 * r + s) * c:(2 * r + s + 1) * c, r:r + h, s:s + w]
                     + bias[:, None, None])
            assert torch.equal(got[:, :, r::2, s::2], want)
    assert got.is_contiguous()
    last = phase_shuffle.phase_shuffle(grid.contiguous(memory_format=torch.channels_last),
                                       bias, act)
    assert last.is_contiguous() and torch.equal(last, got)


@pytest.mark.parametrize("bad", ["activation", "channels", "side", "bias"])
def test_the_epilogue_refuses_what_it_does_not_take(bad):
    grid, bias, act = torch.zeros(1, 8, 3, 3), torch.zeros(2), "relu"
    if bad == "activation":
        act = "tanh"
    elif bad == "channels":
        grid = torch.zeros(1, 6, 3, 3)
    elif bad == "side":
        grid = torch.zeros(1, 8, 1, 3)
    else:
        bias = torch.zeros(3)
    with pytest.raises(ValueError):
        phase_shuffle.phase_shuffle(grid, bias, act)


def test_the_kernel_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensors"):
        phase_shuffle.phase_shuffle_cuda(torch.zeros(1, 8, 3, 3), torch.zeros(2), "relu")
