"""BiLadderVAE (the family of biladder_svhn and biladder_celeba) against
the JAX package, as ``tests/test_torch_ladder.py`` holds the conv ladder:
the same weights drawn in JAX and bridged, the same seeded images and JAX's
own noise. The JAX model draws z_L first and then z_{L-1} .. z_1; the port
takes the same draws in its injected order, bottom up. Two stages with the
split merge heads (``conv_h(h) + conv_d(d)``, the default) reach
``two_layer_iwae_loss``, three with the fused merge conv over ``[h, d]``
(``split_merge=False``) ``hierarchical_iwae_loss``; both at k = 3, where h
broadcasts over the samples.

Tolerances: those of ``tests/test_torch_ladder.py`` (its module docstring)
for float32. The bf16 body of a narrow four-stage 32 x 32 biladder, the
shape of biladder_celeba: its convolutions, pools and resizes run in bf16 on
both sides, but round in other places: PyTorch rounds every op's result to
bf16, XLA's CPU backend computes a fused chain of elementwise ops in float32
and rounds at its end. The posterior, prior and observation parameters
agree to atol 0.05 + rtol 0.05 (measured 2.2e-2 at most; either side's bf16
is 1.6e-2 - 1.7e-2 from its float32 run), and the loss, a float32 sum over
the float32 heads, to rtol 5e-4 (measured 1.4e-4: the port's bf16 loss is
1.5e-4 from its float32 one, JAX's 1e-7 from its own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ladder import (
    L_LAYER_METRICS,
    TWO_LAYER_METRICS,
    LadderPair,
    assert_forward_matches,
    assert_gradients_match,
    assert_metrics_match,
    both,
    evaluator_matches_jax,
    params_round_trip,
    train_state_round_trip,
)

from vae_mdl_tpu.models import bidirectional as jbidirectional
from vae_mdl_tpu.models.objective import compute_loss as jax_compute_loss
from vae_mdl_tpu.models.vae import prior_for as jax_prior_for
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu_torch.models import bidirectional
from vae_mdl_tpu_torch.models.objective import compute_loss
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS

torch.set_num_threads(1)

BF16_TOL = dict(rtol=0.05, atol=0.05)
BF16_LOSS_RTOL = 5e-4


def _narrow(module, family):
    """The narrow biladders; ``module`` is either package's
    ``models.bidirectional``."""
    if family == "B2":
        return module.BiLadderConfig(name="narrow_biladder2", image_shape=(8, 8, 3),
                                     stem_features=8, stages=((8, 6, 1, 2), (8, 4, 1, 2)))
    if family == "B3x":
        return module.BiLadderConfig(name="narrow_biladder3", image_shape=(8, 8, 3),
                                     stem_features=8, split_merge=False,
                                     stages=((8, 6, 2, 2), (8, 4, 1, 2), (8, 4, 1, 2)))
    # biladder_celeba's shape: four stages, a bf16 body
    return module.BiLadderConfig(name="narrow_celeba", image_shape=(32, 32, 3), stem_features=8,
                                 stages=((8, 6, 2, 2), (8, 6, 2, 2), (8, 4, 1, 2), (8, 4, 1, 2)),
                                 compute_dtype="bfloat16")


_PAIRS, _RESULTS = {}, {}


def _pair(family):
    if family not in _PAIRS:
        _PAIRS[family] = LadderPair(_narrow(jbidirectional, family),
                                    _narrow(bidirectional, family), seed=4)
    return _PAIRS[family]


def _both(family):
    if family not in _RESULTS:
        _RESULTS[family] = both(_pair(family), 3)
    return _RESULTS[family]


@pytest.mark.parametrize("family", ["B2", "B3x"])
def test_forward_matches_jax(family):
    assert_forward_matches(_both(family), _pair(family).cfg.n_stochastic)


@pytest.mark.parametrize("family", ["B2", "B3x"])
def test_loss_and_every_gradient_leaf_match_jax(family):
    assert_gradients_match(_both(family), 3)


@pytest.mark.parametrize("family,names", [("B2", TWO_LAYER_METRICS), ("B3x", L_LAYER_METRICS)])
def test_bound_metrics_match_jax(family, names):
    assert_metrics_match(_both(family), names)


def test_leaves_carry_the_flax_names():
    split, fused = _both("B2")["got"], _both("B3x")["got"]
    for leaf in ("stem.weight", "enc_0.ResidualBlock_0.Conv_0.weight", "enc_1.ResidualBlock_0.gate",
                 "q_top.Conv_0.weight", "up_0.ResidualBlock_0.shortcut.weight",
                 "p_0.Conv_0.bias", "q_0.conv_h.weight", "q_0.conv_d.weight", "q_0.conv_d.bias",
                 "obs_up.ResidualBlock_0.Conv_3.weight", "obs_head.bias"):
        assert leaf in split, leaf
    assert "q_0.conv_h.bias" not in split  # conv_h has no bias, as in Flax
    for leaf in ("q_0.Conv_0.weight", "q_1.Conv_0.bias", "up_1.ResidualBlock_0.Conv_2.weight",
                 "enc_0.ResidualBlock_1.gate"):
        assert leaf in fused, leaf
    assert fused["q_0.Conv_0.weight"].shape == (2 * 6, 2 * 8, 3, 3)  # over [h, d]


def test_split_merge_is_the_same_linear_map():
    """With ``conv_h`` and ``conv_d`` the input-channel halves of the fused
    merge conv (and its bias on ``conv_d``), the split model computes the
    fused model's posterior to float roundoff (as JAX's
    tests/test_bidirectional.py holds its two variants)."""
    fused_cfg = _narrow(bidirectional, "B3x")
    split_cfg = dataclasses.replace(fused_cfg, split_merge=True)
    fused = build_model(fused_cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {name: p for name, p in fused.state_dict().items() if ".Conv_0." not in name
             or not name.startswith("q_") or name.startswith("q_top")}
    for i in range(len(fused_cfg.stages) - 1):
        weight = fused.state_dict()[f"q_{i}.Conv_0.weight"]
        h_width = fused_cfg.stages[i][0]
        state[f"q_{i}.conv_h.weight"] = weight[:, :h_width]
        state[f"q_{i}.conv_d.weight"] = weight[:, h_width:]
        state[f"q_{i}.conv_d.bias"] = fused.state_dict()[f"q_{i}.Conv_0.bias"]
    split = build_model(split_cfg, device="cpu")
    split.load_state_dict(state, strict=True)
    x = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    eps = [torch.randn((3, 2) + s, generator=torch.Generator().manual_seed(2))
           for s in fused_cfg.latent_shapes()]
    with torch.no_grad():
        (fq, fp, fx), (sq, sp, sx) = fused(x, 3, eps=eps), split(x, 3, eps=eps)
    for a, b in zip(fq, sq):
        torch.testing.assert_close(a.dist.loc, b.dist.loc, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a.dist.scale, b.dist.scale, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fx.dist.loc, sx.dist.loc, rtol=1e-5, atol=1e-5)


def test_bfloat16_body_matches_jax_bfloat16():
    """The celeba-shaped narrow biladder with its bf16 body against JAX's
    bf16 (module docstring); the heads are float32 on both sides."""
    pair = _pair("celeba")
    x = pair.images(np.random.default_rng(6), 2).astype(np.float32) / 255.0
    prior = jax_prior_for(pair.jax_cfg)

    def run(variables, x, key):
        Qs, Ps, pxz = pair.jm.apply(variables, x, 3, rngs={"sample": key})
        return ([(q.dist.loc, q.dist.scale) for q in Qs], [(p.dist.loc, p.dist.scale) for p in Ps],
                (pxz.dist.loc, pxz.dist.logscale), jax_compute_loss(prior, Qs, Ps, pxz, x)[0],
                pair.jax_noise(variables, key, 3, 2))

    jQs, jPs, jx, jloss, eps = jax.jit(run)(pair.variables, jnp.asarray(x), jax.random.PRNGKey(8))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        Qs, Ps, pxz = pair.model(xt, 3, eps=[torch.from_numpy(np.array(e)) for e in eps])
        loss, _ = compute_loss(prior_for(pair.cfg), Qs, Ps, pxz, xt)
    assert [q.dist.loc.dtype for q in Qs] == [torch.float32] * 4  # float32 heads
    pairs = [(q.dist.loc, j[0]) for q, j in zip(Qs, jQs)] + [
        (q.dist.scale, j[1]) for q, j in zip(Qs, jQs)] + [
        (p.dist.loc, j[0]) for p, j in zip(Ps, jPs)] + [
        (p.dist.scale, j[1]) for p, j in zip(Ps, jPs)] + [
        (pxz.dist.loc, jx[0]), (pxz.dist.logscale, jx[1])]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)
    assert float(loss) == pytest.approx(float(jloss), rel=BF16_LOSS_RTOL)


def test_evaluator_matches_the_jax_evaluator_on_its_noise():
    evaluator_matches_jax(_pair("B2"), "biladder_svhn")


def test_generate_shapes():
    pair = _pair("B3x")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        pxz = pair.model.generate(torch.randn((2, 3) + pair.cfg.top_latent_shape(),
                                              generator=gen), gen)
    # generate attaches the x sample, drawn from the generator, as JAX's does
    assert pxz.dist.loc.shape == pxz.x.shape == (2, 3, 8, 8, 3)
    assert pair.model.prior().event_axes == (-1, -2, -3)


@pytest.mark.parametrize("name,n_params", [("biladder_svhn", 529_375),
                                           ("biladder_celeba", 1_327_683)])
def test_weight_bridge_round_trip_is_exact_at_full_width(name, n_params):
    state = params_round_trip(JAX_MODELS[name], MODELS[name])
    assert sum(v.numel() for v in state.values()) == n_params
    assert "q_0.conv_h.bias" not in state


def test_weight_bridge_round_trip_over_the_fused_merge_tree():
    cfg = dataclasses.replace(MODELS["biladder_svhn"], split_merge=False)
    state = params_round_trip(dataclasses.replace(JAX_MODELS["biladder_svhn"],
                                                  split_merge=False), cfg)
    assert state["q_1.Conv_0.weight"].shape == (2 * 16, 2 * 48, 3, 3)


def test_train_state_bridge_round_trips_over_the_biladder_tree():
    state = train_state_round_trip(_pair("B2"), "biladder_svhn")
    assert "q_0.conv_h.weight" in state.params and "q_0.conv_h.bias" not in state.params
