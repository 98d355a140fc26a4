"""The yardstick's arithmetic: the likelihood kernels' least times at the
shapes PERF.md's kernel table bounds them at, and the frozen FLOP count
against the program's ``utils/flops.py``."""
from __future__ import annotations

import dataclasses
import json

import pytest

from benchmark.lib import counts

H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]


def _ms(work):
    return counts.least_ms(*work, H100)


@pytest.mark.parametrize("work, bound_ms", [
    # MoDL forward on model05's head, k = 5 and the eval chunk k = 100, B = 128
    (counts.modl_forward(5, 128, 32, 32, 5), 0.0404),
    (counts.modl_forward(100, 128, 32, 32, 5), 0.7986),
    # MoDL backward at k = 5 with a dense cotangent, as the table's contract shape
    (counts.modl_backward(5, 128, 32, 32, 5, cotangent=5 * 128 * 32 * 32), 0.0795),
    # the DL pair on biladder_celeba's heads: train k = 5, B = 128; eval k = 100,
    # B = 32; the backward handed one cotangent a sample and image
    (counts.dl_forward(5, 128, 64, 64, 3), 0.0300),
    (counts.dl_forward(100, 32, 64, 64, 3), 0.1413),
    (counts.dl_backward(5, 128, 64, 64, 3, cotangent=5 * 128), 0.0394),
])
def test_likelihood_bounds_match_the_kernel_table(work, bound_ms):
    assert round(_ms(work), 4) == bound_ms


def test_likelihood_bounds_are_bound_by_bytes():
    for work in (counts.modl_forward(100, 128, 32, 32, 5),
                 counts.modl_backward(5, 128, 32, 32, 5, 640),
                 counts.dl_backward(5, 128, 64, 64, 3, 640)):
        n_bytes, n_flops = work
        assert n_bytes / H100["bytes_per_s"] > n_flops / H100["float32"]


def _model(name):
    from vae_mdl_tpu_torch.models import zoo

    return json.loads(json.dumps(dataclasses.asdict(zoo.MODELS[name])))


def _output_position_extra(m: dict, k: int) -> float:
    """What ``utils/flops.py`` charges a transposed conv beyond its
    multiply-adds: output positions x taps, (stride^2 - 1) x input positions
    x taps, at each of the k samples of the decoder (the encoders hold none)."""
    if "stages" in m or m["decoder"]["kind"] != "conv":
        return 0.0
    d = m["decoder"]
    extra, (h, w, ch) = 0.0, d["base_size"]
    layers = list(d["pre_layers"]) + [None] + list(d["conv_layers"])  # None: the GLU stack
    for layer in layers:
        if layer is None:
            ch = d["glu_features"] if d["n_glu"] else ch
            continue
        f, kk, s, t, _a = layer
        if t:
            extra += 2.0 * h * w * (s * s - 1) * f * kk * kk * ch
        h, w = (h * s, w * s) if t else (-(-h // s), -(-w // s))
        ch = f
    return k * extra


@pytest.mark.parametrize("name, train, eval5000", [
    ("model05", 3.0514e9, 9.8676e11),
    ("biladder_celeba", 3.5263e10, 9.9063e12),
])
def test_flops_reproduce_the_programs_per_image_counts(name, train, eval5000):
    m = _model(name)
    assert 3.0 * (counts.forward_flops(m, 5) + _output_position_extra(m, 5)) == pytest.approx(
        train, rel=5e-5)
    assert counts.forward_flops(m, 5000) + _output_position_extra(m, 5000) == pytest.approx(
        eval5000, rel=5e-5)


@pytest.mark.parametrize("name", ["model01", "model02", "model03", "model04", "model05",
                                  "model06", "ladder_svhn", "biladder_svhn",
                                  "biladder_celeba", "digits"])
def test_flops_equal_utils_flops_but_the_transposed_term(name):
    from vae_mdl_tpu_torch.models import zoo
    from vae_mdl_tpu_torch.utils import flops

    m = _model(name)
    for k in (1, 5, 100):
        assert counts.forward_flops(m, k) + _output_position_extra(m, k) == flops.forward_flops(
            zoo.MODELS[name], 1, k)


def test_transposed_conv_charged_its_multiply_adds():
    # model05's three stride-2 4x4 deconvs at input positions x taps
    deconvs = 2.0 * 16 * (4 * 4 * 128 * 128 + 8 * 8 * 64 * 128 + 16 * 16 * 32 * 64)
    assert _output_position_extra(_model("model05"), 1) == 3 * deconvs
    assert counts.train_flops(_model("model05")) == pytest.approx(1.16397e9, rel=1e-5)


def test_peaks_are_published_h100_sxm():
    assert H100 == {"float32": 67e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12}
    assert counts.peaks("a card with no published peaks") is None
