"""5000-importance-sample test evaluation, the headline metric.

Port of ``effective_chunks``, ``make_batch_evaluator`` and ``evaluate_llh``
from ``vae_mdl_tpu/evaluation/harness.py``:

- images go in batches; the padded tail batch keeps every batch the same
  shape and its padding is dropped;
- the k = 5000 samples are streamed in k-chunks folded into a streaming
  logmeanexp (``ops.math``); ``[5000, B, H, W, C]`` never exists;
- the chunk loop is a Python loop under ``torch.inference_mode()``; for
  the VAE family q(z_1 | x) is computed once per batch and reused by every
  chunk (the JAX version recomputes it per chunk; the numbers are the same),
  and the upper stochastic layers are sampled per chunk from it; the ladder
  families run their whole forward pass per chunk, as the JAX version does;
- each batch draws from its own generator, seeded from ``(seed, batch
  index)``, so a batch's result does not depend on the batches before it;
- a Bernoulli model whose data is binarised dynamically
  (``dynamic_binarization``) is evaluated on one fixed binarisation of each
  batch, drawn once from the batch's generator before any sample noise, as
  the reference folds key 0 for it and key 1 for the samples: the encoder,
  every k-chunk and the likelihood see the same binary images.

Over several ranks (``parallel/``) there are two layouts, as in the JAX
package:

- ``make_batch_evaluator(mesh=)`` shards one batch: its rows over ``data``
  and its k-chunks over ``sample`` (chunk j on the ``sample`` rank j mod
  S). Each rank streams its chunks; the streaming log-mean-exp states
  (running max and scaled sum, after every chunk index) and the k-hat tails
  are combined over the ``sample`` group, the rows gathered over ``data``;
- ``evaluate_llh`` in a process group of several ranks stripes whole
  batches (batch i on rank i mod world; the batch shard where the mesh has
  ``model > 1``, whose ranks work together on each batch). Each batch's
  generator is seeded from (seed, batch index), so the result is bit-equal
  to one process's: the per-image LLH, the k-hat and each batch's float64
  curve sums are combined with one all-reduce each over disjoint slots, on
  host tensors, and the batches' curve sums are then added in batch order.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vae_mdl_tpu_torch.config import ExperimentConfig
from vae_mdl_tpu_torch.data.preprocess import binarize
from vae_mdl_tpu_torch.evaluation.psis import (
    khat_from_top_log_weights,
    tail_size,
    top_lw_init,
    top_lw_update,
)
from vae_mdl_tpu_torch.models.objective import apply, log_weights
from vae_mdl_tpu_torch.models.vae import VAE, latent_shapes, prior_for
from vae_mdl_tpu_torch.parallel.distributed import process_count, process_index
from vae_mdl_tpu_torch.ops.math import (
    streaming_logmeanexp_finalize,
    streaming_logmeanexp_init,
    streaming_logmeanexp_update,
)


def effective_chunks(n_samples: int, k_chunk: int) -> Tuple[int, int]:
    """Clamp ``k_chunk`` to a divisor of ``n_samples`` so the chunks cover
    exactly ``n_samples``; returns ``(k_chunk, n_chunks)``."""
    k_chunk = min(k_chunk, n_samples)
    while n_samples % k_chunk:
        k_chunk -= 1
    return k_chunk, n_samples // k_chunk


def _combine_lme(m: torch.Tensor, s: torch.Tensor, group) -> Tuple[torch.Tensor,
                                                                    torch.Tensor]:
    """Streaming log-mean-exp states ``(max, scaled sum)`` combined over a
    group: the max of the maxima, each sum rescaled to it, then summed."""
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    s = s * torch.exp(torch.where(torch.isfinite(m), m - m_all, torch.full_like(m, -math.inf)))
    dist.all_reduce(s, group=group)
    return m_all, s


def _gather_rows(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` (rank order)."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def make_batch_evaluator(model, cfg: ExperimentConfig, n_samples: int = 5000,
                         k_chunk: int = 100, with_khat: bool = False,
                         with_curve: bool = False, mesh=None):
    """Returns ``batch_llh(batch, generator=None, eps=None, u=None,
    params=None)`` -> ``llh [B]``, or the tuple ``(llh[, top_lw][, curve])``
    when an extra is asked for, in the JAX package's order: ``top_lw``
    ``[M + 1, B]``, the ``M + 1`` largest log-weights of each image (M =
    ``psis.tail_size(n_samples)``), and ``curve`` ``[n_chunks, B]``, row j
    the bound over the first ``(j + 1) * k_chunk`` samples of the same
    stream. Every tensor stays on the batch's device.

    ``batch``: uint8 images (scaled by 1/255) or floats in [0, 1],
    ``[B, H, W, C]``, on the model's device. The standard-normal draws come
    from ``generator``, or from ``eps`` ``[n_chunks, k_chunk, B] + shape``
    (z_1's noise, or a sequence with one such tensor per stochastic layer,
    bottom up; ``shape`` is ``models.vae.latent_shapes``': ``(n_latent,)``,
    or ``(h, w, c)`` for a ladder).
    Where the model is a Bernoulli on dynamically binarised data, the batch
    is binarised once, before any sample noise: ``x = (u < x)`` with ``u``
    uniform on [0, 1) ``[B, H, W, C]``, drawn from ``generator`` or injected
    as ``u`` (a binary batch is its own binarisation whatever ``u``).
    ``params`` (``{name: tensor}`` of all the model's parameters) are
    evaluated in place of the model's own.

    Under a ``mesh`` the batch is the whole batch on every rank: each rank
    evaluates its rows (``data``) on its k-chunks (``sample``), and every
    rank returns the whole batch's results. Where the mesh shards the batch
    (``data`` or ``sample`` above 1), the noise of every chunk is drawn at
    the whole batch's shape (from ``generator``: z_1's first, then each
    layer's, bottom up, at ``[k_chunk, B] + shape``) whether the chunk is
    this rank's or not, so the result does not depend on how the batch is
    sharded; the VAE family's model draws the same stream itself, so it
    also equals the result with no mesh.
    """
    k_chunk, n_chunks = effective_chunks(n_samples, k_chunk)
    binarize_input = cfg.model.likelihood == "bernoulli" and cfg.data.dynamic_binarization
    # the VAE family computes q(z_1 | x) once a batch; the ladders have no
    # such split
    once_a_batch = isinstance(model, VAE)
    if with_khat and tail_size(n_samples) < 5:
        raise ValueError(
            f"khat needs a tail of >= 5 weights to fit the GPD; n_samples={n_samples} "
            f"gives tail_size={tail_size(n_samples)}. Use n_samples >= 25 or drop "
            "the diagnostic.")
    n_top = tail_size(n_samples) + 1  # M exceedances + the threshold
    (n_data, row), (n_sample, col) = _places(mesh)
    # a sharded batch draws every chunk's noise at the whole batch's shape,
    # so its stream does not depend on the mesh
    draw_whole = n_data * n_sample > 1
    shapes = latent_shapes(cfg.model)

    def batch_llh(batch: torch.Tensor, generator: Optional[torch.Generator] = None,
                  eps=None, u: Optional[torch.Tensor] = None, params=None):
        def call(method, *args):
            if params is None:
                return getattr(model, method)(*args)
            return apply(model, params, *args, method=method)

        if batch.shape[0] % n_data:
            raise ValueError(f"batch of {batch.shape[0]} rows does not divide over "
                             f"data={n_data}")
        per = batch.shape[0] // n_data
        rows = slice(row * per, (row + 1) * per)
        with torch.inference_mode():
            x = batch.float()
            if not batch.is_floating_point():
                x = x / 255.0
            if binarize_input:
                # one fixed draw per evaluation, the same in every k-chunk
                x = binarize(generator, x) if u is None else (u < x).float()
            x = x[rows]
            prior = prior_for(cfg.model, x.device)
            q = call("encoder", x) if once_a_batch else None
            state = streaming_logmeanexp_init((per,), device=x.device)
            top = top_lw_init((per,), n_top, device=x.device) if with_khat else None
            maxes, sums = [], []
            if isinstance(eps, torch.Tensor):
                eps = (eps,)
            for j in range(n_chunks):
                if eps is not None:
                    noise = [layer[j][:, rows] for layer in eps]
                elif draw_whole:
                    noise = [torch.randn((k_chunk, batch.shape[0]) + shape,
                                         generator=generator, device=x.device)[:, rows]
                             for shape in shapes]
                else:
                    noise = None
                if j % n_sample == col:
                    draws = generator if noise is None else None
                    if once_a_batch:
                        Qs = call("sample_posterior", q, k_chunk, draws, noise)
                        Ps, pxz = call("decode_down", Qs)
                    else:
                        Qs, Ps, pxz = call("forward", x, k_chunk, draws, noise)
                    log_w = log_weights(prior, Qs, Ps, pxz, x)  # [k_chunk, per]
                    state = streaming_logmeanexp_update(state, log_w, dim=0)
                    if with_khat:
                        top = top_lw_update(top, log_w)
                maxes.append(state[0])
                sums.append(state[1])
            if n_sample > 1:
                group = mesh.get_group("sample")
                m, s = _combine_lme(torch.stack(maxes), torch.stack(sums), group)
                maxes, sums = list(m), list(s)
                if with_khat:
                    top = top_lw_update(top_lw_init((per,), n_top, device=x.device),
                                        _gather_rows(top, group, n_sample, 0))
            # the bound after the first j + 1 chunks, j = 0 .. n_chunks - 1
            bound = [streaming_logmeanexp_finalize((maxes[j], sums[j], (j + 1) * k_chunk))
                     for j in (range(n_chunks) if with_curve else [n_chunks - 1])]
            out = [bound[-1]] + ([top] if with_khat else []) + (
                [torch.stack(bound)] if with_curve else [])
            if n_data > 1:
                group = mesh.get_group("data")
                out = [_gather_rows(t, group, n_data, t.ndim - 1) for t in out]
            return tuple(out) if len(out) > 1 else out[0]

    return batch_llh


def _places(mesh) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((size, this rank's coordinate) on ``data``, the same on ``sample``):
    (1, 0) for a dimension the mesh lacks, or where there is no mesh."""
    if mesh is None:
        return (1, 0), (1, 0)
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    return tuple((mesh.size(names.index(name)), coord[names.index(name)])
                 if name in names else (1, 0) for name in ("data", "sample"))


def _batch_seed(seed: int, index: int) -> int:
    """The generator seed of batch ``index`` of an evaluation seeded ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def _sum_host(values: np.ndarray, group) -> np.ndarray:
    """A host array summed over ``group`` (float32 and float64 alike)."""
    t = torch.from_numpy(np.ascontiguousarray(values))
    dist.all_reduce(t, group=group)
    return t.numpy()


def evaluate_llh(
    model,
    cfg: ExperimentConfig,
    test_images: np.ndarray,
    n_samples: int = 5000,
    k_chunk: int = 100,
    batch_size: int = 128,
    seed: int = 0,
    params=None,
    khat: bool = False,
    k_curve: bool = False,
    mesh=None,
) -> Tuple[float, np.ndarray, dict]:
    """Test-set n-sample importance-weighted log-likelihood.

    ``test_images``: host array ``[N, H, W, C]``, uint8 or floats in [0, 1].
    Runs on the model's device, on ``params`` where given (``{name:
    tensor}``, e.g. ``train.state.eval_params``), else the model's own
    weights. Returns ``(mean_llh, per_image_llh, metrics)`` with ``bpd =
    -llh / (log 2 * H * W * C)``.

    ``khat=True`` adds the per-image PSIS k-hat (``khat_per_image``) and its
    summary: ``khat_mean`` over the finite values (NaN where there are
    none), ``khat_max``, ``khat_frac_gt_07`` (images whose bound is
    unreliable at this sample count), ``khat_n_underflow`` (+inf: a tail so
    heavy its weights underflow) and ``khat_n_ties`` (-inf: a tail of equal
    weights). ``k_curve=True`` adds ``k_curve_ks`` and ``k_curve_llh``, the
    test-set mean bound after every k-chunk of the same weight stream; its
    last entry is the returned mean.

    In a process group of several ranks the batches are striped (batch i
    on rank i mod world, or on batch shard i mod shards where ``mesh`` has
    ``model > 1``) and combined: every rank returns the whole result,
    bit-equal to one process's. ``metrics["local_batches"]`` counts this
    rank's batches. In one process a ``mesh`` (a world of one) takes
    ``make_batch_evaluator(mesh=)``.
    """
    device = next(model.parameters()).device
    stripe, n_stripes, groups = 0, 1, ()
    if process_count() > 1:
        from vae_mdl_tpu_torch.parallel.mesh import batch_sharding, replicated

        if mesh is not None and "model" in mesh.mesh_dim_names:
            stripe, n_stripes = batch_sharding(mesh)
            groups = replicated(mesh)
        else:
            stripe, n_stripes, groups = process_index(), process_count(), (None,)
        mesh = None  # striping replaces the sharding of one batch
    evaluator = make_batch_evaluator(model, cfg, n_samples, k_chunk,
                                     with_khat=khat, with_curve=k_curve, mesh=mesh)

    def run_batch(batch: np.ndarray, index: int):
        """-> (llh [B], khat [B] | None, curve [n_chunks, B] float64 | None)."""
        generator = torch.Generator(device=device)
        generator.manual_seed(_batch_seed(seed, index))
        out = evaluator(torch.as_tensor(batch, device=device), generator, params=params)
        out = list(out) if isinstance(out, tuple) else [out]
        llh = out.pop(0).cpu().numpy()
        kh = khat_from_top_log_weights(out.pop(0).cpu().numpy()) if khat else None
        curve = out.pop(0).cpu().numpy().astype(np.float64) if k_curve else None
        return llh, kh, curve

    n = len(test_images)
    n_batches, leftover = divmod(n, batch_size)
    n_chunks = effective_chunks(n_samples, k_chunk)[1]
    per_image = np.zeros(n, np.float32)
    per_image_khat = np.zeros(n, np.float32) if khat else None
    # each batch's per-chunk sum of per-image partial bounds, in float64
    curve_rows = np.zeros((n_batches + bool(leftover), n_chunks), np.float64) if k_curve \
        else None

    local_batches = 0

    def take(i: int, sl: slice, out, keep: int) -> None:
        nonlocal local_batches
        llh, kh, curve = out
        per_image[sl] = llh[:keep]
        if khat:
            per_image_khat[sl] = kh[:keep]
        if k_curve:
            curve_rows[i] = curve[:, :keep].sum(axis=1)
        local_batches += 1

    for i in range(n_batches):
        if i % n_stripes != stripe:
            continue
        sl = slice(i * batch_size, (i + 1) * batch_size)
        take(i, sl, run_batch(test_images[sl], i), batch_size)
    if leftover and n_batches % n_stripes == stripe:
        # pad the tail batch to the batch shape, then drop the padding
        tail = test_images[n_batches * batch_size:]
        pad = np.concatenate([tail] * -(-batch_size // leftover))[:batch_size]
        take(n_batches, slice(n_batches * batch_size, n), run_batch(pad, n_batches), leftover)
    for group in groups:
        # disjoint slots: the sum over the ranks is every rank's whole result
        per_image = _sum_host(per_image, group)
        if khat:
            per_image_khat = _sum_host(per_image_khat, group)
        if k_curve:
            curve_rows = _sum_host(curve_rows, group)
    if k_curve:
        # the batches' sums added in batch order, whatever the striping
        curve_sum = np.zeros(n_chunks, np.float64)
        for sums in curve_rows:
            curve_sum += sums

    # float64 accumulation: a mean quoted to two decimals over 10k images
    mean_llh = float(per_image.mean(dtype=np.float64))
    h, w, c = cfg.model.image_shape
    bpd = -mean_llh / (math.log(2.0) * h * w * c)
    metrics = {
        "llh": mean_llh,
        "bpd": bpd,
        "n_samples": n_samples,
        "batches": n_batches + bool(leftover),
        "local_batches": local_batches,
    }
    if khat:
        finite = per_image_khat[np.isfinite(per_image_khat)]
        metrics["khat_mean"] = float(finite.mean()) if finite.size else float("nan")
        metrics["khat_max"] = float(per_image_khat.max())
        metrics["khat_frac_gt_07"] = float((per_image_khat > 0.7).mean())
        metrics["khat_n_underflow"] = int((per_image_khat == np.inf).sum())
        metrics["khat_n_ties"] = int((per_image_khat == -np.inf).sum())
        metrics["khat_per_image"] = per_image_khat
    if k_curve:
        k_eff = effective_chunks(n_samples, k_chunk)[0]
        metrics["k_curve_ks"] = np.arange(1, n_chunks + 1) * k_eff
        metrics["k_curve_llh"] = curve_sum / n
    return mean_llh, per_image, metrics
