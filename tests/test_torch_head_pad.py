"""``DecoderConfig.head_pad`` against the JAX package: the decoder's head
layer emits ``max(n_head, head_pad)`` channels and slices them back to
``n_head`` before the likelihood. model05 with ``head_pad=64`` (the folded
MoDL head ``conv_3``, 64 outputs for 50) and model05 with a discretized-
logistic ``head`` conv padded from 6 to 8: both packages built, the Flax
weights bridged (``utils/convert.py`` carries the padded kernel), the same
injected noise.

Tolerances, each with its reason (as ``test_torch_mlp.py`` for model05):
- the observation's parameters: rtol 1e-5, atol 1e-5 (the same float32
  convolutions summed in another order);
- the loss: rtol 1e-5 (sums of ~3000 per-pixel float32 terms);
- the log-weights: rtol 1e-5 of |log w|, atol 1e-3 (the evaluator tests');
- parameter gradients, leaf by leaf in norm: the rule
  ``test_torch_families.py`` states (1e-4 at k = 1, ten float32 spacings of
  the loss at k = 3); the padded channels get no gradient on either side;
- the FLOPs count and the tensor-parallel specs: exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FamilyPair, _grad_rtol, _rel

from vae_mdl_tpu.distributions import DistributionTuple as JaxDT
from vae_mdl_tpu.models.objective import log_weights as jax_log_weights
from vae_mdl_tpu.models.vae import prior_for as jax_prior_for
from vae_mdl_tpu.models.zoo import MODELS as JAX_MODELS
from vae_mdl_tpu.parallel.tensor import _structural_head_pairs as jax_head_pairs
from vae_mdl_tpu.parallel.tensor import tp_param_spec as jax_tp_param_spec
from vae_mdl_tpu.parallel.tensor import tp_replicated_by_path as jax_replicated_by_path
from vae_mdl_tpu.utils.flops import analytic_model_flops as jax_flops
from vae_mdl_tpu_torch.models.objective import log_weights
from vae_mdl_tpu_torch.models.vae import build_model, prior_for
from vae_mdl_tpu_torch.models.zoo import MODELS
from vae_mdl_tpu_torch.parallel.tensor import _tp_specs, tp_param_spec
from vae_mdl_tpu_torch.utils.convert import params_from_flax
from vae_mdl_tpu_torch.utils.flops import analytic_model_flops

torch.set_num_threads(1)

LOSS_RTOL = 1e-5

# (case, likelihood, head_pad, the head's parameter, its padded width, n_head)
CASES = {
    "model05": ("mdl", 64, "decoder.conv_3.weight", 64, 50),
    "model05_dl": ("dl", 8, "decoder.head.weight", 8, 6),
}


def _padded(models, case):
    likelihood, pad = CASES[case][:2]
    cfg = models["model05"]
    return dataclasses.replace(cfg, likelihood=likelihood,
                               decoder=dataclasses.replace(cfg.decoder, head_pad=pad))


_PAIRS = {}


def _pair(case):
    if case not in _PAIRS:
        _PAIRS[case] = FamilyPair(_padded(JAX_MODELS, case), _padded(MODELS, case), seed=3)
    return _PAIRS[case]


_RESULTS = {}


def _both(case, k):
    if (case, k) not in _RESULTS:
        pair = _pair(case)
        x, eps = pair.inputs(np.random.default_rng(5 + k), batch=2, k=k)
        loss, grads = pair.jax_loss_and_grad(pair.variables, x, eps)
        want = {leaf: t.numpy() for leaf, t in params_from_flax(grads, pair.cfg).items()}
        _RESULTS[case, k] = pair.port_loss_and_grads(x, eps) + (float(loss), want)
    return _RESULTS[case, k]


def _jax_forward(pair, x, eps):
    """JAX's ``(Qs, Ps, pxz)`` of one stochastic layer on injected noise."""
    jm, variables = pair.jm, pair.variables
    q = jm.apply(variables, x, method=lambda m, x: m.encoder(x))
    z = q.loc + q.scale * eps
    pxz = jm.apply(variables, z, method=lambda m, z: m.decoder(z))
    return (JaxDT(q, z, axes=(-1,)),), (), JaxDT(pxz, None, axes=pxz.event_axes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_padded_head_builds_with_the_padded_kernel(case):
    """``build_model`` takes ``head_pad``: the head layer has the padded
    width, bridged from the Flax kernel of that width."""
    pair = _pair(case)
    _, _, leaf, width, n_head = CASES[case]
    weight = dict(pair.model.named_parameters())[leaf]
    assert weight.shape[0] == width
    flax = pair.variables["params"]["decoder"][leaf.split(".")[1]]["kernel"]
    assert flax.shape[-1] == width
    assert pair.model.decoder.n_head == n_head


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_observation_is_sliced_back_to_n_head(case):
    pair = _pair(case)
    n_head = CASES[case][4]
    x, eps = pair.inputs(np.random.default_rng(1), batch=2, k=3)
    (jq,), _, jpxz = _jax_forward(pair, jnp.asarray(x), jnp.asarray(eps[0]))
    Qs, _, pxz = pair.model(torch.from_numpy(x), 3, eps=torch.from_numpy(eps[0]))
    got = pxz.dist
    if CASES[case][0] == "mdl":
        assert got.parameters.shape == (3, 2, 32, 32, n_head)
        got, want = got.parameters, jpxz.dist.parameters
    else:
        assert got.loc.shape == (3, 2, 32, 32, n_head // 2)
        got = torch.cat([got.loc, got.logscale], -1)
        want = jnp.concatenate([jpxz.dist.loc, jpxz.dist.logscale], -1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_log_weights_match_jax(case):
    pair = _pair(case)
    x, eps = pair.inputs(np.random.default_rng(2), batch=2, k=3)
    want = jax_log_weights(jax_prior_for(pair.jax_cfg),
                           *_jax_forward(pair, jnp.asarray(x), jnp.asarray(eps[0])),
                           jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = log_weights(prior_for(pair.cfg), *pair.model(xt, 3, eps=torch.from_numpy(eps[0])),
                          xt)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_loss_matches_jax(case, k):
    got_loss, got, _, want_loss, want = _both(case, k)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_gradient_leaf_matches_jax(case, k):
    _, got, _, want_loss, want = _both(case, k)
    tol = _grad_rtol(k, want_loss)
    worst = {leaf: _rel(got[leaf], want[leaf]) for leaf in want}
    assert all(got[leaf].shape == want[leaf].shape for leaf in want)
    assert max(worst.values()) <= tol, worst
    # the padded channels receive no gradient
    leaf, n_head = CASES[case][2], CASES[case][4]
    assert not got[leaf][n_head:].any() and not want[leaf][n_head:].any()
    assert got[leaf][:n_head].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_flops_do_not_count_the_padded_channels(case):
    assert (analytic_model_flops(_padded(MODELS, case), 4)
            == analytic_model_flops(dataclasses.replace(_padded(MODELS, case),
                                                        decoder=MODELS["model05"].decoder), 4)
            == pytest.approx(jax_flops(_padded(JAX_MODELS, case), 4), rel=0))


def test_the_tensor_parallel_rule_keeps_the_padded_head_whole():
    """The padded MoDL head passes the width test (64 outputs over 2 ranks)
    yet stays whole by path, in both packages."""
    model = build_model(_padded(MODELS, "model05"), torch.Generator().manual_seed(0),
                        device="cpu")
    params = dict(model.named_parameters())
    assert tp_param_spec(model.decoder.conv_3, "weight", 2) == ("model", None, None, None)
    specs = _tp_specs(params, model, 2, 64)
    assert specs["decoder.conv_3.weight"] == () and specs["decoder.conv_3.bias"] == ()
    # the layer before it is sharded: the rule is by path, not by width
    assert specs["decoder.conv_1.weight"] != ()

    variables = _pair("model05").variables
    kernel = variables["params"]["decoder"]["conv_3"]["kernel"]
    assert tuple(jax_tp_param_spec(kernel, 2)) != ()
    assert jax_replicated_by_path(("params", "decoder", "conv_3", "kernel"),
                                  jax_head_pairs(variables))
