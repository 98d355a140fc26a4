"""Host-side data pipeline: numpy uint8 batches, staged onto the device.

Port of ``vae_mdl_tpu/data/pipeline.py``. ``setup_data(dataset, data_dir,
batch_size=128, val_batch_size=500)`` -> (train_iter, val_iter, test set),
with the JAX package's split policy:

    svhn_cropped : train(+extra) | test[0:50%] | test[50%:100%]
    cifar10      : train         | test[0:50%] | test[50%:100%]
    mnist        : train         | test        | test
    celeba       : train         | validation  | validation
    digits       : train         | val         | test

Batches are uint8 (the device dequantises); the train stream is an infinite
shuffled epoch permutation from an explicit numpy Generator, which
``start_step`` seeks for a data-deterministic resume. The batch sequences
are the JAX package's, batch for batch, for the same seed.

``device_prefetch`` stages upcoming batches onto the card from a producer
thread: each batch is copied from pinned host memory on the thread's own
CUDA stream, and the consumer's stream waits on the copy's event before the
tensor is handed on.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from vae_mdl_tpu_torch.data.sources import Arrays, load_dataset
from vae_mdl_tpu_torch.utils.tracing import span


@dataclasses.dataclass
class DataSplits:
    train: Arrays
    val: Arrays
    test: Arrays

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return self.train[0].shape[1:]


def make_splits(
    dataset: str,
    data_dir: Optional[str] = None,
    allow_synthetic_fallback: bool = True,
) -> DataSplits:
    raw = load_dataset(dataset, data_dir, allow_synthetic_fallback)
    base = dataset.split(":", 1)[-1] if dataset.startswith("synthetic:") else dataset

    if base == "svhn_cropped" and "extra" in raw:
        xtr = np.concatenate([raw["train"][0], raw["extra"][0]])
        ytr = np.concatenate([raw["train"][1], raw["extra"][1]])
        train: Arrays = (xtr, ytr)
    else:
        train = raw["train"]

    if base in ("svhn_cropped", "cifar10"):
        x, y = raw["test"]
        half = len(x) // 2
        val, test = (x[:half], y[:half]), (x[half:], y[half:])
    elif base == "celeba":
        # real shards have a "validation" split; the synthetic fallback
        # provides only "test"
        val = test = raw.get("validation", raw.get("test"))
    elif "val" in raw:  # digits: disjoint val and test slices
        val, test = raw["val"], raw["test"]
    else:  # mnist, synthetic: val == test
        val = test = raw["test"]
    return DataSplits(train=train, val=val, test=test)


def shard_arrays(arrays: Arrays, process_index: int, process_count: int) -> Arrays:
    if process_count == 1:
        return arrays
    x, y = arrays
    return x[process_index::process_count], y[process_index::process_count]


def epoch_batches(
    arrays: Arrays, batch_size: int, seed: int, shuffle: bool = True,
    start_step: int = 0,
) -> Iterator[np.ndarray]:
    """Infinite stream of image batches; a fresh permutation per epoch, the
    remainder dropped (every batch has the same shape).

    ``start_step`` seeks the stream: the first batch yielded is the one an
    identically seeded stream yields after ``start_step`` ``next()`` calls,
    found by replaying only the per-epoch permutation draws.
    """
    x, _ = arrays
    n = len(x)
    if batch_size > n:
        raise ValueError(
            f"batch_size {batch_size} exceeds the split size {n}: the "
            "remainder-dropping epoch stream would never yield"
        )
    rng = np.random.default_rng(seed)
    batches_per_epoch = (n - batch_size) // batch_size + 1
    epochs_done, offset = divmod(start_step, batches_per_epoch)
    if shuffle:
        for _ in range(epochs_done):  # advance the rng exactly as iteration
            rng.permutation(n)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(offset * batch_size, n - batch_size + 1, batch_size):
            yield x[order[start:start + batch_size]]
        offset = 0


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises where there is none; pass
    ``"cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port's entry points run on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


_END = object()


def _offer(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """``q.put(item)`` unless ``stop`` is set first; -> whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            pass
    return False


def _produce(it: Iterator, q: "queue.Queue", stop: threading.Event,
             device: torch.device, put: Optional[Callable]) -> None:
    """The producer thread: every batch of ``it`` staged and queued, then
    the end marker; an exception is queued for the consumer to raise."""
    try:
        if put is not None:
            for batch in it:
                if not _offer(q, (put(batch), None), stop):
                    return
        elif device.type == "cuda":
            with torch.cuda.device(device):
                stream = torch.cuda.Stream(device)
                for batch in it:
                    # a fresh pinned buffer a batch: the caching host
                    # allocator records the copy's event on it and reuses
                    # its memory only once that event has completed
                    host = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
                    with torch.cuda.stream(stream):
                        staged = host.to(device, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if not _offer(q, (staged, ready), stop):
                        return
        else:
            for batch in it:
                if not _offer(q, (torch.as_tensor(np.asarray(batch), device=device), None),
                              stop):
                    return
        _offer(q, _END, stop)
    except BaseException as e:  # noqa: BLE001 - raised again in the consumer
        _offer(q, e, stop)


class DevicePrefetch:
    """Iterator over ``it``'s batches as tensors on ``device``, staged up to
    ``size`` ahead by a producer thread.

    On a CUDA device the producer copies each batch from pinned host memory
    with ``non_blocking=True`` on its own stream and records an event; the
    consumer makes its current stream wait on that event and records the
    tensor's use on that stream (``record_stream``), so the copy is ordered
    before any kernel that reads the batch and the memory is not recycled
    while that stream may still read it. ``put``, where given, stages a
    batch instead (as in the JAX package) and its result is handed on as it
    is. A producer error is raised in the consumer. ``close()`` (also on
    garbage collection) stops the producer and joins it; batches it has
    already taken from ``it`` are dropped.
    """

    def __init__(self, it: Iterator, size: int = 2, put: Optional[Callable] = None,
                 device=None):
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._done = False
        # the thread holds the queue and the flag, not this object, so that
        # dropping the iterator collects it and stops the producer
        self._thread = threading.Thread(
            target=_produce, args=(it, self._q, self._stop, self.device, put), daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        with span("data.wait"):
            item = self._q.get()
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        tensor, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            tensor.record_stream(current)
        return tensor

    def close(self) -> None:
        """Stop the producer and wait for it to end."""
        self._done = True
        self._stop.set()
        while self._thread.is_alive():
            try:  # unblock a producer waiting on a full queue
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __del__(self):
        if hasattr(self, "_thread"):
            self.close()


def device_prefetch(it: Iterator[np.ndarray], size: int = 2, put: Optional[Callable] = None,
                    device=None) -> DevicePrefetch:
    """Stage upcoming batches of ``it`` onto ``device`` (default: the CUDA
    card; ``"cpu"`` for the CPU) from a background thread, overlapping host
    IO with device compute. See ``DevicePrefetch``."""
    return DevicePrefetch(it, size=size, put=put, device=device)


def setup_data(
    dataset: str = "svhn_cropped",
    data_dir: Optional[str] = None,
    batch_size: int = 128,
    val_batch_size: int = 500,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    allow_synthetic_fallback: bool = True,
    batch_multiple: int = 1,
):
    """(train_iter, val_iter, test arrays); the iterators yield uint8 numpy
    batches. ``batch_multiple`` keeps the clamped validation batch a
    multiple of it."""
    splits = make_splits(dataset, data_dir, allow_synthetic_fallback)
    return iterators_from_splits(
        splits, batch_size, val_batch_size, seed,
        process_index, process_count, batch_multiple,
    )


def iterators_from_splits(
    splits: DataSplits,
    batch_size: int = 128,
    val_batch_size: int = 500,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    batch_multiple: int = 1,
    start_step: int = 0,
):
    """(train_iter, val_iter, test arrays) from already loaded splits;
    ``start_step`` seeks the train stream (``epoch_batches``)."""
    train = shard_arrays(splits.train, process_index, process_count)
    val = shard_arrays(splits.val, process_index, process_count)

    # a split smaller than val_batch_size is one whole batch
    vbs = min(val_batch_size, len(val[0]))
    vbs = max(batch_multiple, vbs // batch_multiple * batch_multiple)

    train_iter = epoch_batches(train, batch_size, seed, shuffle=True,
                               start_step=start_step)
    val_iter = epoch_batches(val, vbs, seed + 1, shuffle=False)
    return train_iter, val_iter, splits.test
