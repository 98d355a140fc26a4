"""Ground-truth evidence for the port's evaluator: its importance-sampled
log p(x) against the exact integral.

The port's counterpart of tests/test_ground_truth.py, with the same six
cases, the same k and the same tolerances. On a model with 1-D latents,
log p(x) is computed exactly by Gauss-Hermite quadrature through the port's
own decoder, so the port's whole estimation pipeline (encoder proposal,
log-weight assembly in ``models/objective.py``, the streaming k-chunked
logsumexp of ``evaluation/harness.py``) must converge to it, for all five
likelihood heads (bernoulli, gaussian, dl, mdl, pmdl) and for the
two-layer bound through nested location-scale quadrature. The truth is the
integral, not the JAX package: this file imports neither JAX nor the JAX
tests.

Each model is the JAX test's: a ``model01`` variant with 4x4 images, depth
1 or 2, trained by the port's ``make_train_step`` for 400 steps on the same
structured images, so that the encoder is a usable proposal. The quadrature
sums in float64 over the decoder's float32 log-probabilities, by the JAX
test's rules (``_quad_depth1``, nodes at z = s; ``_quad_depth2``, nested
location-scale), but for the dl case, whose posterior the port trains
narrower than those nodes resolve: there the integrand places the nodes
(``_quad_adaptive``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from vae_mdl_tpu_torch.config import DataConfig
from vae_mdl_tpu_torch.evaluation.harness import evaluate_llh
from vae_mdl_tpu_torch.models.vae import build_model
from vae_mdl_tpu_torch.models.zoo import experiment
from vae_mdl_tpu_torch.train.state import create_train_state, make_optimizer
from vae_mdl_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)

_PROTOS = np.array(
    [[[1, 1, 0, 0]] * 2 + [[0, 0, 1, 1]] * 2, [[0, 1, 0, 1]] * 4],
    np.float32,
)[..., None]  # two 4x4x1 prototypes


def _make_batch(rng, n, channels=1, grayscale=False):
    """Structured images: a prototype with 5% pixel flips; ``grayscale``
    adds jitter towards mid-levels so discretized heads see interior bins
    as well as the 0/255 edge bins."""
    x = np.repeat(_PROTOS, channels, axis=-1)[rng.integers(0, 2, n)]
    flip = rng.random(x.shape) < 0.05
    x = (x + flip) % 2
    if grayscale:
        g = rng.integers(0, 64, x.shape)
        return (x * 255 - x * g + (1 - x) * g).clip(0, 255).astype(np.uint8)
    return (x * 255).astype(np.uint8)


def _tiny_trained(n_stochastic: int, likelihood: str, channels: int,
                  grayscale: bool, steps: int = 400):
    """A 1-D-latent VAE (depth 1 or 2) on the CPU, trained enough that the
    encoder is a usable proposal; returns (model, cfg, rng)."""
    cfg = experiment("model01")
    model_cfg = dataclasses.replace(
        cfg.model,
        image_shape=(4, 4, channels),
        n_latent=1,
        likelihood=likelihood,
        n_mix=2,
        n_stochastic=n_stochastic,
        latent_sizes=(1,) * n_stochastic,
        mlp_hidden=16,
        encoder=dataclasses.replace(cfg.model.encoder, n_hidden=16),
        decoder=dataclasses.replace(cfg.model.decoder, n_hidden=16),
    )
    cfg = dataclasses.replace(
        cfg,
        model=model_cfg,
        data=DataConfig(dataset="synthetic:mnist", batch_size=64, dynamic_binarization=False),
    )
    model = build_model(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    state = create_train_state(model, cfg.train)
    step = make_train_step(model, cfg, make_optimizer(cfg.train))
    rng = np.random.default_rng(0)
    for _ in range(steps):
        state, _ = step(state, torch.from_numpy(_make_batch(rng, 64, channels, grayscale)))
    return model, cfg, rng


def _gh(n_nodes):
    """Gauss-Hermite nodes for E_{z~N(0,1)}[f(z)] = sum_i e^{logc_i} f(s_i):
    s = sqrt(2)*t, logc = log(w) - log(sqrt(pi))."""
    t, w = np.polynomial.hermite.hermgauss(n_nodes)
    return (torch.from_numpy(np.sqrt(2.0) * t).float(),
            torch.from_numpy(np.log(w) - 0.5 * np.log(np.pi)))


def _per_image_logp(model, z1, x):
    """log p(x_b | z1_i) -> float64 [B, N], through the port's decoder.
    One image at a time with x broadcast to the node axis: the MoDL
    conditions its locations on the observed x, so x and the head's
    parameters share their batch shape."""
    with torch.no_grad():
        obs = model.decoder(z1)
        rows = []
        for b in range(x.shape[0]):
            xb = x[b].expand((z1.shape[0],) + tuple(x.shape[1:]))
            lp = obs.log_prob(xb)
            rows.append(lp.sum(dim=tuple(range(1, lp.dim()))).double())
    return torch.stack(rows)


def _log_joint(model, z, x):
    """log p(x_b | z_i) + log N(z_i; 0, 1) -> float64 [B, N]."""
    prior = -0.5 * z.double() ** 2 - 0.5 * np.log(2.0 * np.pi)
    return _per_image_logp(model, z[:, None], x) + prior[None]


def _quad_depth1(model, x, n_nodes):
    """log p(x) = log E_{z~N(0,1)} p(x|z), exactly."""
    s, logc = _gh(n_nodes)
    return torch.logsumexp(_per_image_logp(model, s[:, None], x) + logc[None], dim=1)


def _posterior_moments(model, x):
    """The mean and standard deviation of p(z | x_b) for each image, from
    the normalised integrand on a grid of 4001 points on [-8, 8]."""
    grid = torch.linspace(-8.0, 8.0, 4001)
    w = torch.softmax(_log_joint(model, grid, x), dim=1)
    m = (w * grid.double()).sum(1)
    return m, (w * (grid.double()[None] - m[:, None]) ** 2).sum(1).sqrt()


def _quad_adaptive(model, x, n_nodes):
    """log p(x) = log integral p(x|z) N(z; 0, 1) dz, exactly, by adaptive
    Gauss-Hermite: per image the nodes sit at z = m + sd * s, with m and sd
    the mean and standard deviation of the integrand (``_posterior_moments``);
    then the integral is E_{s~N(0,1)}[p(x, z) sd / N(s)]. The integrand
    places the nodes, not the encoder.

    For the dl case: the port's dl model trains to a posterior sd of
    0.063-0.219 on the six test images, and the plain rule's 201 and 301
    nodes disagree by up to 0.45 nats there, past the 0.01 check; this
    rule's 201 and 301 nodes by 8.4e-4. On the other four heads the plain
    rule's gap is 0.0011-0.0053 nats (posterior sd 0.125-0.648). These are
    ``python tests/test_torch_ground_truth.py``'s readings."""
    m, sd = _posterior_moments(model, x)
    s, logc = _gh(n_nodes)
    s = s.double()
    out = []
    for b in range(x.shape[0]):
        z = m[b] + sd[b] * s
        lf = _log_joint(model, z.float(), x[b:b + 1])[0]
        log_normal = -0.5 * s ** 2 - 0.5 * np.log(2.0 * np.pi)
        out.append(torch.logsumexp(logc + lf + sd[b].log() - log_normal, dim=0))
    return torch.stack(out)


def _quad_depth2(model, x, n_nodes):
    """log p(x) = log E_{z2~N(0,1)} E_{z1~p(z1|z2)} p(x|z1), exactly: the
    inner integral through the location-scale transform of the learned
    Normal p(z1|z2) (``VAE.decode_down``'s ``mlp_decoders``)."""
    s, logc = _gh(n_nodes)
    with torch.no_grad():
        p12 = model.mlp_decoders[0](s[:, None])
    loc, scale = p12.loc[:, 0], p12.scale[:, 0]  # [N]
    z1 = (loc[:, None] + scale[:, None] * s[None, :]).reshape(-1, 1)
    lp = _per_image_logp(model, z1, x).reshape(x.shape[0], n_nodes, n_nodes)
    inner = torch.logsumexp(lp + logc[None, None, :], dim=2)
    return torch.logsumexp(inner + logc[None, :], dim=1)


# (depth, likelihood, channels, grayscale data, n_samples, tolerance): the
# JAX test's cases, k and tolerances
_CASES = [
    (1, "bernoulli", 1, False, 5000, 0.05),
    (2, "bernoulli", 1, False, 5000, 0.05),
    (1, "dl", 1, True, 5000, 0.05),
    (1, "mdl", 3, True, 20000, 0.08),
    (1, "pmdl", 3, True, 20000, 0.08),
    (1, "gaussian", 1, True, 20000, 0.08),
]


@pytest.mark.parametrize("depth,likelihood,channels,gray,k,tol", _CASES)
def test_is_harness_matches_exact_evidence(depth, likelihood, channels, gray, k, tol):
    quad = {1: _quad_depth1, 2: _quad_depth2}[depth]
    if likelihood == "dl":
        quad = _quad_adaptive
    model, cfg, rng = _tiny_trained(depth, likelihood, channels, gray)
    test_u8 = _make_batch(rng, 6, channels, gray)
    x = torch.from_numpy(test_u8.astype(np.float32) / 255.0)

    truth = quad(model, x, 201).numpy()
    # the quadrature itself must be converged (node-count stability; the
    # sharp discretized likelihoods need denser nodes than bernoulli)
    np.testing.assert_allclose(truth, quad(model, x, 301).numpy(), atol=0.01)

    _, per_image, metrics = evaluate_llh(model, cfg, test_u8, n_samples=k, k_chunk=1000,
                                         batch_size=6, seed=0)
    np.testing.assert_allclose(per_image, truth, atol=tol)
    # and the summary metric agrees with the per-image vector
    assert metrics["llh"] == pytest.approx(float(per_image.mean()), rel=1e-6)


def _node_rule_report():
    """For each depth-1 case: the gap between 201 and 301 nodes of the
    plain and of the adaptive rule, and the posterior sd's range over the
    six test images (the reading behind ``_quad_adaptive``'s use for dl)."""
    for depth, likelihood, channels, gray, _, _ in _CASES:
        if depth != 1:
            continue
        model, _, rng = _tiny_trained(depth, likelihood, channels, gray)
        x = torch.from_numpy(_make_batch(rng, 6, channels, gray).astype(np.float32) / 255.0)
        gaps = [float((rule(model, x, 201) - rule(model, x, 301)).abs().max())
                for rule in (_quad_depth1, _quad_adaptive)]
        sd = _posterior_moments(model, x)[1]
        print(f"{likelihood}: 201 vs 301 nodes, plain {gaps[0]:.2e}, adaptive {gaps[1]:.2e}; "
              f"posterior sd {float(sd.min()):.3f}-{float(sd.max()):.3f}")


if __name__ == "__main__":
    # python tests/test_torch_ground_truth.py (from the repository's root)
    _node_rule_report()
