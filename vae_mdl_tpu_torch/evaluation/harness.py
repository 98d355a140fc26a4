"""5000-importance-sample test evaluation, the headline metric.

Port of ``effective_chunks``, ``make_batch_evaluator`` and ``evaluate_llh``
from ``vae_mdl_tpu/evaluation/harness.py``:

- images go in batches; the padded tail batch keeps every batch the same
  shape and its padding is dropped;
- the k = 5000 samples are streamed in k-chunks folded into a streaming
  logmeanexp (``ops.math``); ``[5000, B, H, W, C]`` never exists;
- for the VAE family q(z_1 | x) is computed once per batch and reused by
  every chunk (the JAX version recomputes it per chunk; the numbers are the
  same), and the upper stochastic layers are sampled per chunk from it; the
  ladder families run their whole forward pass per chunk, as the JAX
  version does;
- on the card a batch's whole evaluation, every chunk included, is one CUDA
  graph a key, the counterpart of ``jax.jit`` of the batch with its
  ``lax.scan`` over the chunks, kept by model and key across evaluators;
  CPU tensors, injected noise and a mesh over gloo run the same body as a
  Python loop under ``torch.inference_mode()`` (``BatchEvaluator``);
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
import weakref
from typing import Dict, List, Optional, Tuple

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
from vae_mdl_tpu_torch.parallel.mesh import sample_sharding
from vae_mdl_tpu_torch.train.capture import (
    _add_counts,
    _copy_changed,
    _matches,
    _synced,
    capture,
    groups_capture,
    warm_up,
)
from vae_mdl_tpu_torch.train.state import tree_leaves
from vae_mdl_tpu_torch.ops.math import (
    streaming_logmeanexp_finalize,
    streaming_logmeanexp_init,
    streaming_logmeanexp_update,
)
from vae_mdl_tpu_torch.utils.tracing import timed


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
                         with_curve: bool = False, mesh=None) -> "BatchEvaluator":
    """Returns ``batch_llh(batch, generator=None, eps=None, u=None,
    params=None)`` -> ``llh [B]``, or the tuple ``(llh[, top_lw][, curve])``
    when an extra is asked for, in the JAX package's order: ``top_lw``
    ``[M + 1, B]``, the ``M + 1`` largest log-weights of each image (M =
    ``psis.tail_size(n_samples)``), and ``curve`` ``[n_chunks, B]``, row j
    the bound over the first ``(j + 1) * k_chunk`` samples of the same
    stream. Every tensor stays on the batch's device.

    ``batch``: uint8 images (scaled by 1/255) or floats in [0, 1],
    ``[B, H, W, C]``, on the model's device. The standard-normal draws come
    from ``generator`` (None: the device's default generator), or from
    ``eps`` ``[n_chunks, k_chunk, B] + shape``
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

    On the card a call is one CUDA graph a key (``BatchEvaluator``).
    """
    return BatchEvaluator(model, cfg, n_samples, k_chunk, with_khat, with_curve, mesh)


class _ModelGraphs:
    """One model's evaluation graphs: ``{key: _EvalGraph}`` on the card, ``{key:
    None}`` for the signatures that ran eagerly, and the memory pool the
    graphs share."""

    def __init__(self):
        self.keys: Dict[tuple, Optional["_EvalGraph"]] = {}
        self.pool = None


# held weakly by the model: a model dropped frees its graphs and their pool
_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, _ModelGraphs]" = weakref.WeakKeyDictionary()


def _graphs_of(model) -> _ModelGraphs:
    graphs = _GRAPHS.get(model)
    if graphs is None:
        graphs = _GRAPHS[model] = _ModelGraphs()
    return graphs


def cache_size(model) -> int:
    """The most batch signatures (shape, dtype, device, ``params`` given or
    not) that one evaluator setting of ``model`` has seen: 1 where every
    evaluation of one setting took one graph. The trainer's retrace guard
    reads it."""
    seen: Dict[tuple, int] = {}
    for settings, *_ in _graphs_of(model).keys:
        seen[settings] = seen.get(settings, 0) + 1
    return max(seen.values(), default=0)


def clear_cache(model) -> None:
    """Drop ``model``'s evaluation graphs, and with them the memory their
    pool holds: the counterpart of jit's ``clear_cache()``, for a caller
    that evaluates one model at many batch shapes and needs the memory of
    the shapes it is done with."""
    _GRAPHS.pop(model, None)


class BatchEvaluator:
    """``make_batch_evaluator``'s ``batch_llh``: the counterpart of the JAX
    package's ``jax.jit(batch_llh)`` with its ``lax.scan`` over the k-chunks.

    Which path a call takes is decided by rule (``train.capture.captures``),
    never by a failure:

    - eagerly (``eager``, the chunk loop in Python under
      ``torch.inference_mode``) for CPU tensors (the tests), for a call that
      injects ``eps=`` or ``u=`` (the hooks that hold the port to JAX), and
      under a mesh whose groups do not carry the card's tensors over NCCL
      (gloo);
    - otherwise as one ``torch.cuda.CUDAGraph`` a key: the scaling, the
      binarisation draw, q(z_1 | x) (the VAE family), all ``n_chunks``
      k-chunks (noise, decoder, likelihood kernel, log-weights, the
      streaming update, ``top_lw_update``), every partial bound of the
      curve and, under a mesh, the ``sample`` combine and the ``data``
      gather. The key is the evaluator's setting (``n_samples``, the
      effective ``k_chunk``, the extras, the binarisation, the model's
      config, the mesh) and the batch's shape, dtype and device, and whether
      ``params`` is given. At a key's first call the body runs on a side
      stream over one chunk a ``sample`` shard (every kernel loaded, every
      handle and communicator made), then is captured whole into the
      model's memory pool. A failed capture raises; nothing falls back.

    The graphs outlive the evaluator: they are kept by model (weakly) and
    key, so a second ``evaluate_llh`` on the same model and batch shape
    captures nothing, and the padded tail batch takes the full batch's
    graph. ``cache_size()`` counts this setting's keys: the captures on the
    card, the signatures seen on the CPU.

    Where a replay could differ from the eager loop, and what it does:

    - the caller's generator: a graph replays only the generators
      registered at its capture, so it owns one; before each replay it
      takes the caller's (or, for ``generator=None``, the device's default
      generator's) seed and offset, and after it leaves the caller's at the
      offset the eager loop would leave it at. The binarisation draw comes
      first, from the same generator, so a replay draws what the eager
      batch draws, never the numbers it was captured with;
    - ``params=``: the graph reads its own copies, into which a call copies
      the given tensors where they are not the ones it last copied (other
      tensors, or written in place since: the EMA copy after a train step);
      without ``params`` it reads the model's own parameters in place (a
      train step writes them there), and where a parameter was given new
      storage since (a module moved, or loaded with ``assign=True``) it
      copies it into the storage the graph reads, which it keeps alive;
    - memory: the graph's private pool holds a batch's peak as long as the
      model lives (model05's MoDL head at a chunk, ``[100 * 128, 32, 32, 50]``
      float32, is 2.6 GB before the decoder's activations), beside the train
      step's graphs in ``Trainer.fit``; no cut of ``k_chunk`` or of the batch
      makes it fit, as that would change the result's path;
    - host syncs: none in the captured body; the k-hat fit and the float64
      curve sums stay on the host after the replay (``evaluate_llh``).
    """

    def __init__(self, model, cfg: ExperimentConfig, n_samples: int = 5000, k_chunk: int = 100,
                 with_khat: bool = False, with_curve: bool = False, mesh=None):
        k_chunk, n_chunks = effective_chunks(n_samples, k_chunk)
        if with_khat and tail_size(n_samples) < 5:
            raise ValueError(
                f"khat needs a tail of >= 5 weights to fit the GPD; n_samples={n_samples} "
                f"gives tail_size={tail_size(n_samples)}. Use n_samples >= 25 or drop "
                "the diagnostic.")
        self.model, self.cfg, self.mesh = model, cfg, mesh
        self.k_chunk, self.n_chunks = k_chunk, n_chunks
        self.with_khat, self.with_curve = with_khat, with_curve
        self.binarize_input = (cfg.model.likelihood == "bernoulli"
                               and cfg.data.dynamic_binarization)
        # the VAE family computes q(z_1 | x) once a batch; the ladders have no
        # such split
        self.once_a_batch = isinstance(model, VAE)
        self.n_top = tail_size(n_samples) + 1  # M exceedances + the threshold
        (self.n_data, self.row), (self.n_sample, self.col) = sample_sharding(mesh)
        # a sharded batch draws every chunk's noise at the whole batch's shape,
        # so its stream does not depend on the mesh
        self.draw_whole = self.n_data * self.n_sample > 1
        self.shapes = latent_shapes(cfg.model)
        self.groups = () if mesh is None else tuple(mesh.get_group(name)
                                                    for name in mesh.mesh_dim_names)
        self.settings = (n_samples, k_chunk, with_khat, with_curve, self.binarize_input,
                         repr(cfg.model), None if mesh is None else id(mesh))

    def key(self, batch: torch.Tensor, params) -> tuple:
        return (self.settings, tuple(batch.shape), batch.dtype, batch.device, params is None)

    def cache_size(self) -> int:
        """The keys of this setting: the captures on the card, the
        signatures seen on the CPU (``BatchEvaluator``)."""
        return sum(key[0] == self.settings for key in _graphs_of(self.model).keys)

    def captures(self, batch: torch.Tensor) -> bool:
        """The rule (``train.capture.captures``) for a batch on this device
        under this evaluator's mesh."""
        return groups_capture(batch.device.type, self.groups)

    def __call__(self, batch: torch.Tensor, generator: Optional[torch.Generator] = None,
                 eps=None, u: Optional[torch.Tensor] = None, params=None):
        if eps is not None or u is not None:
            return self.eager(batch, generator, eps, u, params)
        graphs = _graphs_of(self.model)
        key = self.key(batch, params)
        if not self.captures(batch):
            graphs.keys.setdefault(key, None)
            return self.eager(batch, generator, params=params)
        graph = graphs.keys.get(key)
        if graph is None:
            if graphs.pool is None:
                graphs.pool = torch.cuda.graph_pool_handle()
            graph = graphs.keys[key] = _EvalGraph(self, graphs.pool, batch, params)
        return _result(graph.run(self.model, batch, generator, params))

    def eager(self, batch: torch.Tensor, generator: Optional[torch.Generator] = None,
              eps=None, u: Optional[torch.Tensor] = None, params=None):
        """The batch evaluated by the chunk loop, run eagerly."""
        return _result(self.body(batch, generator, eps, u, params))

    def body(self, batch: torch.Tensor, generator: Optional[torch.Generator], eps,
             u: Optional[torch.Tensor], params,
             n_chunks: Optional[int] = None) -> List[torch.Tensor]:
        """The evaluation of one batch, both paths' body: ``[llh[, top_lw][,
        curve]]``. ``n_chunks`` cuts the chunk loop short (the capture's
        warm-up)."""
        model, mesh, k_chunk = self.model, self.mesh, self.k_chunk
        n_chunks = n_chunks or self.n_chunks
        n_data, row, n_sample, col = self.n_data, self.row, self.n_sample, self.col

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
            if self.binarize_input:
                # one fixed draw per evaluation, the same in every k-chunk
                x = binarize(generator, x) if u is None else (u < x).float()
            x = x[rows]
            prior = prior_for(self.cfg.model, x.device)
            q = call("encoder", x) if self.once_a_batch else None
            state = streaming_logmeanexp_init((per,), device=x.device)
            top = top_lw_init((per,), self.n_top, device=x.device) if self.with_khat else None
            maxes, sums = [], []
            if isinstance(eps, torch.Tensor):
                eps = (eps,)
            for j in range(n_chunks):
                if eps is not None:
                    noise = [layer[j][:, rows] for layer in eps]
                elif self.draw_whole:
                    noise = [torch.randn((k_chunk, batch.shape[0]) + shape,
                                         generator=generator, device=x.device)[:, rows]
                             for shape in self.shapes]
                else:
                    noise = None
                if j % n_sample == col:
                    draws = generator if noise is None else None
                    if self.once_a_batch:
                        Qs = call("sample_posterior", q, k_chunk, draws, noise)
                        Ps, pxz = call("decode_down", Qs)
                    else:
                        Qs, Ps, pxz = call("forward", x, k_chunk, draws, noise)
                    log_w = log_weights(prior, Qs, Ps, pxz, x)  # [k_chunk, per]
                    state = streaming_logmeanexp_update(state, log_w, dim=0)
                    if self.with_khat:
                        top = top_lw_update(top, log_w)
                maxes.append(state[0])
                sums.append(state[1])
            if n_sample > 1:
                group = mesh.get_group("sample")
                m, s = _combine_lme(torch.stack(maxes), torch.stack(sums), group)
                maxes, sums = list(m), list(s)
                if self.with_khat:
                    top = top_lw_update(top_lw_init((per,), self.n_top, device=x.device),
                                        _gather_rows(top, group, n_sample, 0))
            # the bound after the first j + 1 chunks, j = 0 .. n_chunks - 1
            bound = [streaming_logmeanexp_finalize((maxes[j], sums[j], (j + 1) * k_chunk))
                     for j in (range(n_chunks) if self.with_curve else [n_chunks - 1])]
            out = [bound[-1]] + ([top] if self.with_khat else []) + (
                [torch.stack(bound)] if self.with_curve else [])
            if n_data > 1:
                group = mesh.get_group("data")
                out = [_gather_rows(t, group, n_data, t.ndim - 1) for t in out]
            return out


def _result(out: List[torch.Tensor]):
    return tuple(out) if len(out) > 1 else out[0]


def hand_over(source: torch.Generator, into: torch.Generator) -> None:
    """``into`` set to ``source``'s seed and offset (its whole state), in
    place: before a replay from the caller's generator into the graph's,
    after it back."""
    into.set_state(source.get_state())


def _default_generator(device: torch.device) -> torch.Generator:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch.cuda.default_generators[index]


class _EvalGraph:
    """One key's capture: the graph, its static batch, its generator, its
    own copies of ``params`` (where the key has them) and its outputs. It
    holds no reference to the evaluator or the model, so that the model's
    cache entry is dropped with the model."""

    def __init__(self, evaluator: BatchEvaluator, pool, batch: torch.Tensor, params):
        self.generator = torch.Generator(device=batch.device)
        self.x = batch.clone()
        # the tensors the graph reads the weights from: the model's own
        # storage (params=None; held, so that it outlives a parameter given
        # new storage), else its own copies of the given ones
        self.bound = [p.detach() for p in evaluator.model.parameters()]
        self.params = None if params is None else {
            name: t.detach().clone() for name, t in params.items()}
        self.synced = None if params is None else _synced(params)

        def body(n_chunks=None):
            return evaluator.body(self.x, self.generator, None, None, self.params, n_chunks)

        with timed("capture"):
            # every chunk launches the same kernels at the same shapes, so the
            # warm-up runs one chunk a sample shard (every rank computes one)
            warm_up(lambda: body(min(evaluator.n_chunks, evaluator.n_sample)), batch.device)
            # the warm-up's blocks back to the card before the capture takes
            # its own, which it cannot take from the allocator's cache
            torch.cuda.empty_cache()
            self.graph, self.out, self.launched = capture(body, pool, (self.generator,))

    def run(self, model, batch: torch.Tensor, generator: Optional[torch.Generator],
            params) -> List[torch.Tensor]:
        caller = generator if generator is not None else _default_generator(batch.device)
        with torch.no_grad():
            if params is None:
                mine = [p.detach() for p in model.parameters()]
                if not _matches(mine, self.bound):
                    raise ValueError("the model's parameters do not match the tensors this "
                                     "evaluation was captured with")
                moved = [(b, m) for b, m in zip(self.bound, mine) if b.data_ptr() != m.data_ptr()]
                if moved:
                    torch._foreach_copy_([b for b, _ in moved], [m for _, m in moved])
            else:
                if set(params) != set(self.params):
                    raise ValueError("params= names other parameters than this evaluation "
                                     "was captured with")
                given = {name: params[name] for name in self.params}
                if not _matches(tree_leaves(given), tree_leaves(self.params)):
                    raise ValueError("params= does not match the tensors this evaluation was "
                                     "captured with")
                if not self.synced.holds(tree_leaves(given)):
                    _copy_changed(tree_leaves(self.params), tree_leaves(given))
                    self.synced = _synced(given)
            if batch is not self.x:
                self.x.copy_(batch)
            hand_over(caller, self.generator)
            self.graph.replay()
            hand_over(self.generator, caller)
            _add_counts(self.launched)
        with torch.inference_mode():
            return [t.clone() for t in self.out]


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
