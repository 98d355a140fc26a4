"""The residual block's epilogue route (``nn/blocks.py``
``takes_epilogue_route``, ``ResidualBlock._forward_epilogues``; the kernels'
wrapper ``ops/cuda/block_epilogue.py``) on the CPU, through the plain
versions: each epilogue, forward and backward, against the unfused chain of
``F.conv2d``, bias, activation, gate and residual sum in float32; the rule
as a pure function; ``ResidualBlock`` on the CPU left on its plain path,
bit for bit, and its routed body against it; the kernels' wrapper refusing
CPU tensors; the launch counters.

Tolerances. The plain epilogue runs the chain's float32 operations in the
chain's order and rounds once, so its values and ``c``'s gradient are held
to the float32 chain exactly; the bias, shortcut-bias and gate gradients are
the same float32 terms summed in another order (rtol 1e-5, atol 1e-6). The
routed block adds its biases after the conv (the plain block inside it) and
rounds once where the plain block rounds after each operation: rtol 1e-5,
atol 1e-5 at float32; at bfloat16 two ulps of the larger value (2^-7) and
atol 2e-2 on values, as the tolerance for bf16 parameters in
``test_torch_ladder.py``.
"""
import pytest
import torch
import torch.nn.functional as F

from vae_mdl_tpu_torch.nn import blocks
from vae_mdl_tpu_torch.nn.blocks import ResidualBlock, takes_epilogue_route
from vae_mdl_tpu_torch.ops.cuda import block_epilogue

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
ACTIVATIONS = ["gelu_tanh", "gelu"]
# the last conv's epilogue: (residual, shortcut bias, gate) present or not;
# "inner" is an inner conv's, with none of them
MODES = ["inner", "residual", "gate", "shortcut", "shortcut_gate"]


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _operands(dtype, mode, seed=0, n=3, cin=8, c=16, h=5, w=6):
    gen = torch.Generator().manual_seed(seed)
    x = _channels_last(torch.randn(n, cin, h, w, generator=gen)).to(dtype).requires_grad_()
    weight = (torch.randn(c, cin, 3, 3, generator=gen) * 0.3).requires_grad_()
    bias = torch.randn(c, generator=gen).requires_grad_()
    s = _channels_last(torch.randn(n, c, h, w, generator=gen)).to(dtype).requires_grad_()
    s_bias = torch.randn(c, generator=gen).requires_grad_()
    gate = torch.tensor(0.7).requires_grad_()
    return x, weight, bias, s, s_bias, gate


def _parts(mode, s, s_bias, gate):
    """The last conv's (residual, shortcut bias, gate) of ``mode``."""
    return {"inner": (None, None, None), "residual": (s, None, None), "gate": (s, None, gate),
            "shortcut": (s, s_bias, None), "shortcut_gate": (s, s_bias, gate)}[mode]


def _chain(c, bias, act, residual, s_bias, gate):
    """The unfused chain in float32 on the conv's output ``c``."""
    y = c.float() + bias[:, None, None]
    a = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    if residual is None:
        return a
    base = residual.float()
    if s_bias is not None:
        base = base + s_bias[:, None, None]
    if gate is not None:
        a = gate * a
    return base + a


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_plain_epilogue_equals_the_unfused_chain(dtype, act, mode):
    """``block_epilogue`` on a conv's output (its plain versions on the CPU)
    against ``F.conv2d`` + bias + activation (+ gate + residual) in float32:
    the value rounded once to the conv's dtype, in its layout; the gradients
    of the conv's input and weight, the bias, the residual, the shortcut
    bias and the gate."""
    x, weight, bias, s, s_bias, gate = _operands(dtype, mode)
    residual, sb, g = _parts(mode, s, s_bias, gate)
    leaves = [t for t in (x, weight, bias, residual, sb, g) if t is not None]
    c = F.conv2d(x, weight.to(dtype), padding=1)
    got = block_epilogue.block_epilogue(c, bias, act, residual, sb, g)
    want = _chain(c, bias, act, residual, sb, g)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want.to(dtype))
    cotangent = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    got_grads = torch.autograd.grad(got, leaves, cotangent, retain_graph=True)
    want_grads = torch.autograd.grad(want, leaves, cotangent.float())
    for name, a, b in zip(("x", "weight", "bias", "residual", "s_bias", "gate"), got_grads,
                          want_grads):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_plain_backward_follows_its_formula(dtype, act):
    """``epilogue_backward_plain``: ``grad_c = (grad g) act'(c + b)`` rounded
    once, the bias sums over the unrounded float32 terms, the shortcut
    bias's over ``grad`` and the gate's over ``grad act(c + b)``."""
    gen = torch.Generator().manual_seed(2)
    c = _channels_last(torch.randn(2, 8, 3, 4, generator=gen)).to(dtype)
    grad = _channels_last(torch.randn(2, 8, 3, 4, generator=gen)).to(dtype)
    bias, gate = torch.randn(8, generator=gen), torch.tensor(-1.3)
    y = (c.float() + bias[:, None, None]).requires_grad_()
    a = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    (d_y,) = torch.autograd.grad(a, y, grad.float() * gate)
    grad_c, grad_b, grad_sb, grad_g = block_epilogue.epilogue_backward_plain(
        grad, c, bias, act, gate, residual=True)
    assert torch.equal(grad_c, d_y.to(dtype)) and grad_c.dtype == dtype
    torch.testing.assert_close(grad_b, d_y.sum((0, 2, 3)), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grad_sb, grad.float().sum((0, 2, 3)), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grad_g, (grad.float() * a.detach()).sum(), rtol=1e-5, atol=1e-6)
    assert grad_g.shape == () and grad_b.dtype == grad_sb.dtype == torch.float32
    inner = block_epilogue.epilogue_backward_plain(grad, c, bias, act)
    assert inner[2] is None and inner[3] is None


_BASE = dict(device_type="cuda", dtype=torch.bfloat16, residual_dtype=torch.bfloat16,
             dense=True, activation="gelu_tanh", widths=[64, 64, 64, 64], hooked=False)


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"dtype": torch.float32, "residual_dtype": torch.float32}, True),
    ({"activation": "gelu"}, True),
    ({"widths": [48, 48, 48, 8]}, True),
    ({"device_type": "cpu"}, False),
    ({"dtype": torch.float16, "residual_dtype": torch.float16}, False),
    ({"residual_dtype": torch.float32}, False),
    ({"dense": False}, False),
    ({"activation": "relu"}, False),
    ({"activation": "tanh"}, False),
    ({"widths": [64, 64, 64, 12]}, False),
    ({"dtype": torch.float32, "residual_dtype": torch.float32, "widths": [12, 12, 12, 12]},
     True),
    ({"hooked": True}, False),
])
def test_the_rule_over_what_a_call_shows(change, want):
    """``takes_epilogue_route`` as a pure function: one condition changed
    from a routed bf16 call at a time (device, compute dtype, a residual of
    another dtype, memory format, activation, widths, a hooked conv)."""
    assert takes_epilogue_route(**{**_BASE, **change}) is want


def test_a_traced_call_keeps_the_plain_path(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert takes_epilogue_route(**_BASE) is False


def _block(dtype, shortcut, gate, activation="gelu_tanh", seed=0):
    block = ResidualBlock(8 if shortcut else 16, 16, 16, rezero=gate, dtype=dtype,
                          activation=activation, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(len(name)))
        if gate:
            block.gate.fill_(0.6)
    return block


def _block_input(block, dtype, seed=1):
    cin = block.Conv_0.weight.shape[1]
    gen = torch.Generator().manual_seed(seed)
    return _channels_last(torch.randn(4, cin, 6, 5, generator=gen)).to(dtype).requires_grad_()


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_cpu_block_keeps_its_plain_path_bit_for_bit(dtype, shortcut, gate):
    """On the CPU the rule says no and ``forward_nchw`` is the plain body,
    bit for bit: each conv with its bias at the compute dtype, the
    activation, the gate product and the residual sum, each rounded."""
    block = _block(dtype, shortcut, gate)
    x = _block_input(block, dtype)
    assert not block._routed(x)
    h = x
    for conv in (block.Conv_0, block.Conv_1, block.Conv_2, block.Conv_3):
        h = F.gelu(F.conv2d(h, conv.weight.to(dtype), conv.bias.to(dtype),
                            padding=conv.weight.shape[-1] // 2), approximate="tanh")
    if gate:
        h = h * block.gate.to(dtype)
    s = x if not shortcut else F.conv2d(x, block.shortcut.weight.to(dtype),
                                        block.shortcut.bias.to(dtype))
    assert torch.equal(block.forward_nchw(x), s + h)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_routed_body_equals_the_plain_block(dtype, shortcut, gate, activation):
    """``_forward_epilogues`` (the route's body, on the plain epilogues)
    against ``forward_nchw``'s plain body on the same block: the value and
    the gradients of the input and of every parameter."""
    block = _block(dtype, shortcut, gate, activation)
    x = _block_input(block, dtype)
    got = block._forward_epilogues(x)
    want = block.forward_nchw(x)
    assert got.dtype == want.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2e-2)
    torch.testing.assert_close(got, want, **tol)
    cotangent = torch.randn(got.shape, generator=torch.Generator().manual_seed(3)).to(dtype)
    leaves = [x] + list(block.parameters())
    for a, b in zip(torch.autograd.grad(got, leaves, cotangent, retain_graph=True),
                    torch.autograd.grad(want, leaves, cotangent)):
        scale = float(b.abs().max()) + 1e-6
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)
        else:
            assert float((a.float() - b.float()).abs().max()) <= 0.05 * scale


def test_a_hooked_conv_keeps_the_block_plain():
    """A forward hook on one of the block's convs (as tensor parallelism
    puts one there) is seen by the block's rule."""
    block = _block(torch.float32, True, True)
    assert not block.shortcut.hooked()
    block.shortcut.register_forward_hook(lambda module, args, out: out)
    assert block.shortcut.hooked() and not block.Conv_0.hooked()
    block.Conv_2.register_forward_pre_hook(lambda module, args: None)
    assert block.Conv_2.hooked()


def test_the_kernels_take_cuda_tensors_only():
    c = _channels_last(torch.zeros(2, 8, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        block_epilogue.epilogue_cuda(c, torch.zeros(8), "gelu_tanh")
    with pytest.raises(ValueError, match="activation"):
        block_epilogue.epilogue_cuda(c, torch.zeros(8), "relu")


@pytest.mark.parametrize("channels,dtype,want", [
    (64, torch.bfloat16, True), (48, torch.bfloat16, True), (8, torch.bfloat16, True),
    (12, torch.bfloat16, False), (12, torch.float32, True), (6, torch.float32, False),
    (2048, torch.bfloat16, True), (2056, torch.bfloat16, False), (64, torch.float16, False)])
def test_the_widths_the_kernels_take(channels, dtype, want):
    """Whole 16-byte vectors (8 bf16 or 4 float32 channels), at most 256 of
    them a pixel."""
    assert block_epilogue.takes_width(channels, dtype) is want


def test_the_layout_the_kernels_take():
    x = torch.zeros(2, 8, 3, 3)
    assert block_epilogue.fits(_channels_last(x))
    assert not block_epilogue.fits(x)
    assert not block_epilogue.fits(_channels_last(x)[:, :4])
    assert not block_epilogue.fits(torch.zeros(8, 3, 3))


def test_the_launch_counters_are_read_and_reset():
    from vae_mdl_tpu_torch.probes import kernel_structure
    from vae_mdl_tpu_torch.train import capture

    block_epilogue.launches, block_epilogue.backward_launches = 3, 5
    counts = kernel_structure.launch_counts()
    assert counts["block_epilogue"] == 3 and counts["block_epilogue_backward"] == 5
    assert capture.launch_counts()[(block_epilogue.__name__, "backward_launches")] == 5
    kernel_structure.reset_counts()
    assert block_epilogue.launches == block_epilogue.backward_launches == 0


def test_the_route_dtypes_are_the_kernels():
    assert set(blocks.EPILOGUE_DTYPES) <= set(block_epilogue.DTYPES)


@pytest.mark.parametrize("m,channels,dtype,want", [
    (1, 64, torch.bfloat16, 1), (32, 64, torch.bfloat16, 1), (33, 64, torch.bfloat16, 2),
    (5120, 64, torch.bfloat16, 160), (640 * 64 * 64, 64, torch.bfloat16, 4 * 132),
    (21, 48, torch.float32, 1), (22, 48, torch.float32, 2),
    (640 * 32 * 32, 48, torch.float32, 4 * 132)])
def test_the_grid_covers_the_pixels_within_the_card(monkeypatch, m, channels, dtype, want):
    """A block a ``256 / (channels / vector)`` pixels, at most
    ``BLOCKS_PER_SM`` blocks an SM (132 SMs here)."""
    class Properties:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Properties)
    assert block_epilogue.grid(m, channels, dtype, torch.device("cuda")) == want


def test_the_grid_constants_are_the_sources():
    """The wrapper's threads a block and blocks an SM are the kernels'
    ``kThreads`` and ``kBlocksPerSm``, which ``__launch_bounds__`` keeps
    resident."""
    source = block_epilogue.SOURCE.read_text()
    assert f"constexpr int kThreads = {block_epilogue._THREADS};" in source
    assert f"constexpr int kBlocksPerSm = {block_epilogue.BLOCKS_PER_SM};" in source
    assert source.count("__launch_bounds__(kThreads, kBlocksPerSm)") == 2
