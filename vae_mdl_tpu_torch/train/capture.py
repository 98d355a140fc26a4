"""Train and eval steps captured as CUDA graphs: the counterpart of the JAX
package's ``jax.jit`` of a step and ``lax.scan`` of n steps in one program
(``vae_mdl_tpu/train/steps.py`` ``make_train_step``,
``make_multi_train_step``, ``make_device_data_train_step``), and of
``jax.jit(shard_map(...))`` for the mesh steps
(``vae_mdl_tpu/parallel/spmd.py``).

A ``CapturedStep`` holds a step's window, ``window(state, x, rngs, betas,
**noise) -> metrics``: one or ``n_steps`` updates of ``state`` (or, for the
eval step, none), each with its own ``{stream: generator}`` and beta. It is
the one body both paths run, and which path runs is decided by rule
(``captures``), never by a failure:

- eagerly, with fresh generators seeded for each step of the window
  (``train.state.stream_generators``) and each step's beta: for CPU
  tensors (the tests), for a call that injects noise (``eps=``, ``u=``: the
  hooks that hold the port to JAX), and for a step whose collectives run
  over a group without NCCL for the card's tensors (gloo: it cannot be
  captured);
- for a CUDA tensor whose step has no collectives, or whose every process
  group carries the card's tensors over NCCL (the mesh steps of
  ``parallel/spmd.py``, a state in the tensor-parallel layout), as one
  ``torch.cuda.CUDAGraph`` a key, collectives included, the key being
  the input's shape, dtype and device and ``n_steps``. At a key's first call
  the window runs once on a side stream to warm up (every kernel built and
  loaded, cuDNN's and cuBLAS's handles made, each kernel's residency asked,
  each group's NCCL communicator made by its first collective, which a
  capture cannot do), the parameters it wrote are put back, and the window
  is captured once into the step function's own memory pool. Every call
  then copies its input into the graph's static input buffer, seeds the
  graph's generators for the state's step and writes each step's beta, and
  replays: one launch for the whole window from the host, beside two small
  fills a generator (the graph reads each generator's seed and offset from
  device memory) and a fill a beta. A failed capture raises; nothing falls
  back to the eager body.

The rule depends on nothing rank-local: the device type and the groups'
backend are the same on every rank, and so is the key, since a mesh step
takes equal rows on every rank (``parallel.mesh.shard_batch`` refuses
uneven ones). So every rank captures the same collectives at the same call,
which NCCL needs.

NCCL under capture (torch 2.11's ``ProcessGroupNCCL``, NCCL 2.28.9 on the
card). The group allows a capture from NCCL 2.9.6 on and raises below it. A
collective runs on the group's internal NCCL stream, which waits on an event
recorded on the current stream and is waited on when the collective
returns: under capture that fork and join put the NCCL stream's kernels
into the graph. The capture is thread-local, so the group's watchdog
thread, which queries its work's events meanwhile, does not void it. No
environment variable is set (every ``TORCH_NCCL_*`` at its default). The
tensor-parallel layout's backward collectives run on the autograd engine's
thread, on the capturing stream, and are captured with the rest.

What a graph reads and writes. The parameters are the model's own tensors
(``apply_update`` writes them in place), read and written at the addresses
they had at capture. The optimizer state and the EMA copy are new tensors
each update, which under a graph land in its pool: the graph keeps its own
copies of them, ends by copying the window's last state into those, and
each call copies them into the state's own tensors after the replay, so
that ``state_dict()``, the checkpointer and resume read the state as the
eager step leaves it, and the state's tensors stay its own (no state ever
aliases a graph's). A call copies the state's tensors into the graph's
copies first only where they are not the ones it last wrote (other
tensors, or written in place since: a resume, an eager step). A state of
another model has its parameters copied in and out around the replay, the
bound ones kept aside. Metrics come back packed in one tensor, copied out
of the pool at each call, as 0-dimensional views.

Each graph carries one generator a stream and step of its window, for the
streams the window draws from (registered with the graph,
``CUDAGraph.register_generator_state``), re-seeded on the host from (seed,
step, stream name) before each replay: a replay draws what the eager window
draws at that step, never the numbers it was captured with.

``cache_size()``, the counterpart of jit's ``_cache_size()``, counts the
keys: the captures on the card, the signatures seen on the CPU, where the
key cache is kept too. The trainer's retrace guard reads it.

The hand-written kernels' launch counters count what runs on the device:
the warm-up's launches count; the capture's recorded launches do not (the
counters are put back after it); each replay adds the launches its graph
holds, as the wrappers counted them at capture.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vae_mdl_tpu_torch.train.state import (
    Fold,
    TrainState,
    seed_streams,
    stream_generators,
    tree_leaves,
    tree_map,
)
from vae_mdl_tpu_torch.utils.tracing import span, timed

Metrics = Dict[str, object]
_KERNEL_MODULES = ("mdl_kernel", "dl_kernel", "mdl_null", "io_probe", "sfu_probe", "phase_shuffle",
                   "block_epilogue")


def pack_metrics(metrics: Dict[str, object]) -> Tuple[torch.Tensor, Callable]:
    """Scalar metrics (0-d tensors or lists of them) -> one 1-d tensor and
    the function that puts a tensor of that shape back into the dict."""
    layout, values = [], []
    for name, v in metrics.items():
        parts = v if isinstance(v, (list, tuple)) else [v]
        layout.append((name, len(parts) if isinstance(v, (list, tuple)) else None))
        values.extend(torch.as_tensor(p).float().reshape(1) for p in parts)

    def unpack(flat: torch.Tensor) -> Dict[str, object]:
        out, i = {}, 0
        for name, n in layout:
            if n is None:
                out[name] = flat[i]
                i += 1
            else:
                out[name] = [flat[i + j] for j in range(n)]
                i += n
        return out

    return torch.cat(values), unpack


# -- the kernels' launch counters ----------------------------------------------


def _counter_modules():
    import importlib

    return [importlib.import_module(f"vae_mdl_tpu_torch.ops.cuda.{name}")
            for name in _KERNEL_MODULES]


def launch_counts() -> dict:
    """Every hand-written kernel wrapper's launch counters, copied:
    ``{(module, counter): int or {key: int}}``."""
    out = {}
    for module in _counter_modules():
        for name, value in vars(module).items():
            if name.endswith("launches") or "launches_by_" in name:
                out[(module.__name__, name)] = dict(value) if isinstance(value, dict) else value
    return out


def _restore_counts(counts: dict) -> None:
    """Put the counters back to ``counts`` (a dict counter in place)."""
    for module in _counter_modules():
        for (owner, name), value in counts.items():
            if owner != module.__name__:
                continue
            if isinstance(value, dict):
                getattr(module, name).clear()
                getattr(module, name).update(value)
            else:
                setattr(module, name, value)


def _counts_since(before: dict) -> dict:
    delta = {}
    for key, now in launch_counts().items():
        was = before.get(key, {} if isinstance(now, dict) else 0)
        if isinstance(now, dict):
            moved = {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}
            if moved:
                delta[key] = moved
        elif now != was:
            delta[key] = now - was
    return delta


def _add_counts(delta: dict) -> None:
    by_name = {module.__name__: module for module in _counter_modules()}
    for (owner, name), moved in delta.items():
        module = by_name[owner]
        value = getattr(module, name)
        if isinstance(moved, dict):
            for k, v in moved.items():
                value[k] = value.get(k, 0) + v
        else:
            setattr(module, name, value + moved)


# -- the rule -------------------------------------------------------------------


def cuda_backend(backend: str) -> str:
    """The backend that carries CUDA tensors in a process group's backend
    string: ``"nccl"`` of ``"cpu:gloo,cuda:nccl"``, the string itself where
    it names one backend for every device."""
    for part in backend.split(","):
        device, sep, name = part.partition(":")
        if sep and device.strip() == "cuda":
            return name.strip()
    return backend if ":" not in backend else ""


def captures(device_type: str, backend: Optional[str]) -> bool:
    """Whether a step on tensors of ``device_type`` whose collectives run
    over a group of ``backend`` (None: a step without collectives) is one
    CUDA graph: on the card, with no group or a group that carries the
    card's tensors over NCCL; gloo and the CPU run the eager body."""
    if device_type != "cuda":
        return False
    return backend is None or cuda_backend(str(backend)) == "nccl"


def groups_capture(device_type: str, groups: Sequence) -> bool:
    """The rule (``captures``) for a body whose collectives run over
    ``groups`` (none: a body without collectives)."""
    if not groups:
        return captures(device_type, None)
    return all(captures(device_type, dist.get_backend(group)) for group in groups)


# -- warm-up and capture ---------------------------------------------------------


def warm_up(fn: Callable, device) -> None:
    """``fn()`` once on a side stream, before a capture: every kernel built
    and loaded, cuDNN's and cuBLAS's handles made, each kernel's residency
    asked, each group's NCCL communicator made by its first collective,
    which a capture cannot do."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)


def capture(fn: Callable, pool, generators: Sequence[torch.Generator] = ()):
    """``fn()`` captured into a new ``torch.cuda.CUDAGraph`` in ``pool``,
    with ``generators`` registered (a replay draws from their seed and
    offset at that time) -> ``(graph, fn's result, the launches the graph
    holds)``. The capture is thread-local: another thread's calls (the
    trainer's prefetch) must not void it, and the autograd thread's
    launches on the capturing stream are captured all the same. The
    launch counters are put back after it; a replay adds the launches it
    holds (``_add_counts``)."""
    counts = launch_counts()
    try:
        graph = torch.cuda.CUDAGraph()
        for generator in generators:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = fn()
        return graph, out, _counts_since(counts)
    finally:
        _restore_counts(counts)


# -- the captured step -----------------------------------------------------------


class CapturedStep:
    """``step(state, x, **noise)``: ``window`` eagerly or as a CUDA graph
    (module docstring). ``streams``: the stream names each step of the
    window takes; ``drawn``: those it draws from (the graph's registered
    generators); ``beta_of(step)``: the bound's beta at a step, or None
    (the eval step); ``tensor_betas``: pass each beta as a 0-d float32
    tensor (a warm-up ramp, written before each replay) rather than the
    float (a constant of the graph); ``updates``: the window updates the
    state (a train step: it returns ``(state, metrics)`` and advances
    ``state.step`` by ``n_steps``), else it only reads the parameters and
    the EMA copy (the eval step: it returns the metrics); ``fold``: folded
    into every stream's seeds, or ``{stream: fold or None}`` (a mesh step
    folds its rank's batch shard into some streams only); ``groups``: the
    process groups the window's collectives run over (a state in the
    tensor-parallel layout adds its ``model`` group)."""

    def __init__(self, window: Callable, n_steps: int, streams: Sequence[str],
                 drawn: Sequence[str], beta_of: Optional[Callable[[int], float]] = None,
                 tensor_betas: bool = False, fold: Fold = None,
                 updates: bool = True, groups: Sequence = ()):
        self.window = window
        self.n_steps = n_steps
        self.streams = tuple(streams)
        self.drawn = tuple(drawn)
        self.beta_of = beta_of
        self.tensor_betas = tensor_betas
        self.fold = fold
        self.updates = updates
        self.groups = tuple(groups)
        # the trees the graph keeps copies of (the parameters it reads in place)
        self.trees = ("opt_state", "ema_params") if updates else ("ema_params",)
        self._keys: Dict[tuple, Optional["_Graph"]] = {}
        self._pool = None
        self._span = "step.train" if updates else "step.eval"

    def cache_size(self) -> int:
        """The key cache's size, the counterpart of jit's ``_cache_size()``:
        the captures on the card, the signatures seen on the CPU."""
        return len(self._keys)

    def key(self, x: torch.Tensor) -> tuple:
        return (tuple(x.shape), x.dtype, x.device, self.n_steps)

    def betas(self, step: int, device) -> List:
        """Each step's beta of a window starting at ``step``, as the eager
        window takes them."""
        if self.beta_of is None:
            return [None] * self.n_steps
        values = [self.beta_of(step + i) for i in range(self.n_steps)]
        if self.tensor_betas:
            return [torch.full((), v, dtype=torch.float32, device=device) for v in values]
        return values

    def eager(self, state: TrainState, x: torch.Tensor, **noise):
        """The window run eagerly on fresh generators for the state's step."""
        rngs = [stream_generators(state.seed, state.step + i, self.streams, x.device, self.fold)
                for i in range(self.n_steps)]
        metrics = self.window(state, x, rngs, self.betas(state.step, x.device), **noise)
        return (state, metrics) if self.updates else metrics

    def captures(self, state: TrainState, x: torch.Tensor) -> bool:
        """The rule (``captures``) for this call: every group the window's
        collectives run over, on ``x``'s device."""
        groups = self.groups + ((state.tp_layout.group,) if state.tp_layout is not None else ())
        return groups_capture(x.device.type, groups)

    def __call__(self, state: TrainState, x: torch.Tensor, **noise):
        with span(self._span):
            noise = {name: value for name, value in noise.items() if value is not None}
            if noise:
                return self.eager(state, x, **noise)
            key = self.key(x)
            if not self.captures(state, x):
                self._keys.setdefault(key, None)
                return self.eager(state, x)
            graph = self._keys.get(key)
            if graph is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = _Graph(self, state, x)
                self._keys[key] = graph
            metrics = graph.run(state, x)
            return (state, metrics) if self.updates else metrics


def _matches(mine: List[torch.Tensor], bound: List[torch.Tensor]) -> bool:
    return len(mine) == len(bound) and all(
        a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
        for a, b in zip(mine, bound))


class _Graph:
    """One key's capture: the graph, its static input, generators and
    betas, its own copies of the state's trees but the parameters, and the
    packed metrics."""

    def __init__(self, owner: CapturedStep, state: TrainState, x: torch.Tensor):
        # no reference cycle: a step function dropped frees its graphs' memory
        # at once, not at the next collection
        self.owner = weakref.proxy(owner)
        device = x.device
        n = owner.n_steps
        self.rngs = [{name: torch.Generator(device=device) for name in owner.streams}
                     for _ in range(n)]
        self.betas = ([torch.empty((), dtype=torch.float32, device=device) for _ in range(n)]
                      if owner.beta_of is not None and owner.tensor_betas else None)
        self.x = x.clone()
        self.params = tree_leaves(state.params)
        # the graph's own copies of the other trees, and the state's tensors
        # they were last made equal to (with their version counters)
        self.trees = {attr: _clone(getattr(state, attr)) for attr in owner.trees}
        self.synced = {attr: _synced(getattr(state, attr)) for attr in self.trees}

        def body():
            metrics = owner.window(view, self.x, self.rngs, self._beta_args(state.step))
            for attr, tree in self.trees.items():
                _copy_changed(tree_leaves(tree), tree_leaves(getattr(view, attr)))
            return pack_metrics(metrics)

        with timed("capture"):
            self._prepare(state)
            self._warm_up(state)
            view = self._view(state)
            drawn = [rngs[name] for rngs in self.rngs for name in owner.drawn]
            self.graph, (self.packed, self.unpack), self.launched = capture(body, owner._pool,
                                                                             drawn)

    def _view(self, state: TrainState) -> TrainState:
        """The state as the window sees it: its parameters, the graph's own
        copies of its other trees."""
        return dataclasses.replace(state, **self.trees)

    def _beta_args(self, step: int) -> List:
        if self.betas is not None:
            return self.betas
        return self.owner.betas(step, self.x.device)

    def _prepare(self, state: TrainState) -> None:
        """Seed the generators and write the betas for a window starting at
        the state's step."""
        owner = self.owner
        for i, rngs in enumerate(self.rngs):
            seed_streams({name: rngs[name] for name in owner.drawn}, state.seed,
                         state.step + i, owner.fold)
        if self.betas is not None:
            for i, beta in enumerate(self.betas):
                beta.fill_(owner.beta_of(state.step + i))

    def _warm_up(self, state: TrainState) -> None:
        """The window once on a side stream, on a view of the state whose
        parameters are put back after it."""
        saved = [p.detach().clone() for p in self.params]
        warm_up(lambda: self.owner.window(self._view(state), self.x, self.rngs,
                                          self._beta_args(state.step)), self.x.device)
        with torch.no_grad():
            torch._foreach_copy_(self.params, saved)

    def run(self, state: TrainState, x: torch.Tensor) -> Metrics:
        owner = self.owner
        with torch.no_grad():
            params = tree_leaves(state.params)
            if not _matches(params, self.params):
                raise ValueError("the state's params do not match the tensors this step was "
                                 f"captured with ({len(params)} against {len(self.params)})")
            # another model's parameters: theirs in, the bound ones kept aside
            foreign = [(b, m) for b, m in zip(self.params, params) if b is not m]
            kept = [b.clone() for b, _ in foreign]
            if foreign:
                torch._foreach_copy_([b for b, _ in foreign], [m for _, m in foreign])
            for attr, tree in self.trees.items():
                mine = tree_leaves(getattr(state, attr))
                if not _matches(mine, tree_leaves(tree)):
                    raise ValueError(f"the state's {attr} does not match the tensors this step "
                                     "was captured with")
                if not self.synced[attr].holds(mine):
                    _copy_changed(tree_leaves(tree), mine)
                    self.synced[attr] = _synced(getattr(state, attr))
            if x is not self.x:
                self.x.copy_(x)
            self._prepare(state)
            self.graph.replay()
            _add_counts(self.launched)
            if foreign:
                if owner.updates:
                    torch._foreach_copy_([m for _, m in foreign], [b for b, _ in foreign])
                torch._foreach_copy_([b for b, _ in foreign], kept)
            if owner.updates:
                for attr, tree in self.trees.items():
                    # the window's last state into the state's own tensors
                    mine = tree_leaves(getattr(state, attr))
                    if mine:
                        torch._foreach_copy_(mine, tree_leaves(tree))
                    self.synced[attr] = _synced(getattr(state, attr))
                state.step += owner.n_steps
            return self.unpack(self.packed.clone())


class _synced:
    """The tensors a graph's own copy was last made equal to, held with
    their version counters: the same tensors, not written in place since,
    still hold what the copy holds."""

    def __init__(self, tree):
        self.leaves = tree_leaves(tree)
        self.versions = [t._version for t in self.leaves]

    def holds(self, leaves: List[torch.Tensor]) -> bool:
        return (len(leaves) == len(self.leaves)
                and all(a is b for a, b in zip(leaves, self.leaves))
                and [t._version for t in leaves] == self.versions)


def _clone(tree):
    return None if tree is None else tree_map(lambda t: t.detach().clone(), tree)


def _copy_changed(into: List[torch.Tensor], values: List[torch.Tensor]) -> None:
    """``into[i] <- values[i]`` where they are not one tensor."""
    pairs = [(a, b) for a, b in zip(into, values) if a is not b]
    if pairs:
        torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])
