"""Host → device prefetch (port of tensorflow_yolo2_tpu/data/prefetch.py).

- :class:`PrefetchLoader`: a pool of threads calls ``get_batch()`` into a
  bounded queue, so that image decoding overlaps the device step (cv2 and
  numpy release the GIL). A worker's error reaches the consumer after the
  batches already queued.
- :class:`ProcessPrefetchLoader`: the same over worker processes, each
  with its own dataset built by a picklable factory, for per-batch work
  that holds the GIL. Workers start by ``spawn``: a forked child of a
  parent that holds a CUDA context is unsafe. They do numpy and cv2 work
  only and never touch the card.
- :class:`EpochShardedStream`: the factory that gives each worker its
  share of a seeded per-epoch permutation, so that every example is read
  once an epoch across the workers with no coordination between them.
- :func:`device_prefetch`: keeps ``size`` batches on their way to the
  device, copied from pinned host memory with ``non_blocking=True`` on a
  CUDA device, so that a step does not wait for its batch's copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


class PrefetchLoader:
    """Concurrent batch producer over a ``get()``-style dataset.

    Workers call ``get_batch()`` concurrently, so it must be thread-safe
    (``data.voc.PascalVOC`` locks its cursor). No batch is dropped or
    duplicated; with several workers the delivery order may interleave,
    ``num_workers=1`` keeps it sequential.
    """

    def __init__(self, get_batch: Callable[[], Any], num_workers: int = 4,
                 prefetch_size: int = 8):
        self._get_batch = get_batch
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch_size)
        self._stop = threading.Event()    # no further get_batch() calls
        self._closed = threading.Event()  # abandon in-flight puts
        self._error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"prefetch-{i}")
            for i in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._get_batch()
            except BaseException as e:  # surfaced after the queue drains
                self._error = e
                self._stop.set()
                return
            # a batch already made is delivered even after another worker
            # failed; only close() abandons it
            while not self._closed.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> "PrefetchLoader":
        return self

    def __next__(self) -> Any:
        while True:
            try:
                return self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set() and \
                        not any(t.is_alive() for t in self._threads):
                    # a last batch may land between the get and the check
                    try:
                        return self._queue.get_nowait()
                    except queue.Empty:
                        pass
                    if self._error is not None and \
                            not isinstance(self._error, StopIteration):
                        raise self._error
                    raise StopIteration

    def close(self) -> None:
        self._stop.set()
        self._closed.set()
        # drain so that workers blocked on put() exit, then join them
        self._drain()
        for t in self._threads:
            t.join(timeout=5.0)
        self._drain()

    def _drain(self) -> None:
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class _WorkerDone:
    """End-of-stream sentinel (one a worker)."""


class _WorkerError:
    def __init__(self, formatted: str):
        self.formatted = formatted


def _pp_worker(factory, worker_id: int, num_workers: int, q, stop) -> None:
    """A worker process: build its ``get_batch`` and stream batches into
    the queue until the stream ends or the loader stops; an error goes to
    the parent as its formatted traceback. Top-level, so that it pickles
    under spawn."""
    try:
        get_batch = factory(worker_id, num_workers)
        while not stop.is_set():
            try:
                batch = get_batch()
            except StopIteration:
                q.put(_WorkerDone())
                return
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
    except Exception:  # reported to the parent, which raises it
        import traceback

        try:
            q.put(_WorkerError(traceback.format_exc()), timeout=5.0)
        except queue.Full:
            pass


class ProcessPrefetchLoader:
    """Batch producer over worker processes.

    ``factory(worker_id, num_workers)``, a picklable module-level
    callable, builds and returns the worker's ``get_batch`` inside the
    child: each worker has a dataset of its own (no shared cursor, no
    lock). A stream that must read every example once an epoch shards
    itself in the factory (:class:`EpochShardedStream`). Each batch is
    pickled across the process boundary. A worker's error is raised in
    the parent, with the worker's traceback, by ``__next__``, as is the
    exit of a worker that reported neither; the stream ends when every
    worker has ended its own.
    """

    def __init__(self, factory: Callable[[int, int], Callable[[], Any]],
                 num_workers: int = 4, prefetch_size: int = 8):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue(maxsize=prefetch_size)
        self._stop = ctx.Event()
        self._live = num_workers
        self._closed = False
        self._procs = [
            ctx.Process(target=_pp_worker,
                        args=(factory, i, num_workers, self._queue,
                              self._stop),
                        daemon=True, name=f"prefetch-proc-{i}")
            for i in range(num_workers)
        ]
        for proc in self._procs:
            proc.start()

    def __iter__(self) -> "ProcessPrefetchLoader":
        return self

    def __next__(self) -> Any:
        while True:
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._live <= 0:
                    raise StopIteration
                if not any(p.is_alive() for p in self._procs):
                    # gone without an end-of-stream or an error report
                    codes = [p.exitcode for p in self._procs]
                    self.close()
                    raise RuntimeError(f"prefetch worker processes exited "
                                       f"before their stream ended (exit "
                                       f"codes {codes})")
                continue
            if isinstance(item, _WorkerDone):
                self._live -= 1
                if self._live <= 0:
                    raise StopIteration
                continue
            if isinstance(item, _WorkerError):
                self.close()
                raise RuntimeError(
                    "prefetch worker process failed:\n" + item.formatted)
            return item

    def close(self) -> None:
        """Stop the workers: drain the queue (a worker blocked on a put
        then exits), join them, terminate any that did not exit."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for p in self._procs:
            p.join(timeout=5.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        self._queue.close()
        self._queue.cancel_join_thread()

    def __enter__(self) -> "ProcessPrefetchLoader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _classification_example(imdb: Any, entry: Any) -> tuple[Any, Any]:
    """The default example of :class:`EpochShardedStream`: a
    classification dataset's (path, class index) entry read by its
    ``image_read``."""
    path, cls = entry
    return imdb.image_read(path), cls


class EpochShardedStream:
    """Every example once an epoch across the workers of a
    :class:`ProcessPrefetchLoader`, with no coordination between them.

    Each worker derives epoch e's permutation of all the dataset's
    entries from ``(seed, e)`` and reads its slice
    ``perm[worker_id::num_workers]``; the slices partition the entries,
    and each epoch is a fresh global shuffle. An instance is the
    ``factory(worker_id, num_workers)`` the loader takes (it also runs in
    one process). ``imdb_factory``, a picklable module-level callable,
    builds a worker's dataset and must give every worker the same
    ``gt_labels`` (the datasets' seeded shuffles do).
    ``example_fn(imdb, entry)`` maps an entry to (image, label). An
    epoch's remainder is a last, smaller batch, or is dropped with
    ``drop_remainder`` (fixed device shapes). ``epochs`` ends the stream
    after that many; None streams on. ``shard=(index, count)`` folds a
    data-parallel rank into the worker ids: worker w of shard i reads
    slice ``i·num_workers + w`` of ``count·num_workers``, so that the
    ranks' workers partition each epoch together.
    """

    def __init__(self, imdb_factory: Callable[[], Any], batch_size: int,
                 epochs: Optional[int] = None, seed: int = 0,
                 example_fn: Optional[Callable[[Any, Any], tuple]] = None,
                 drop_remainder: bool = False,
                 shard: tuple[int, int] = (0, 1)):
        self._imdb_factory = imdb_factory
        self._batch_size = batch_size
        self._epochs = epochs
        self._seed = seed
        self._example_fn = example_fn
        self._drop_remainder = drop_remainder
        self._shard = shard

    def epoch_slice(self, epoch: int, worker_id: int, num_workers: int,
                    n: int) -> list[int]:
        """The entry indices of worker ``worker_id`` in epoch ``epoch``:
        its modulo slice of the epoch's seeded permutation of range(n)."""
        import random

        perm = list(range(n))
        random.Random(self._seed * 1_000_003 + epoch).shuffle(perm)
        return perm[worker_id::num_workers]

    def __call__(self, worker_id: int, num_workers: int
                 ) -> Callable[[], Any]:
        imdb = self._imdb_factory()
        example_fn = self._example_fn or _classification_example
        n = len(imdb.gt_labels)
        index, count = self._shard
        worker_id, num_workers = (index * num_workers + worker_id,
                                  count * num_workers)

        def batches():
            epoch = 0
            while self._epochs is None or epoch < self._epochs:
                idxs = self.epoch_slice(epoch, worker_id, num_workers, n)
                for lo in range(0, len(idxs), self._batch_size):
                    part = idxs[lo:lo + self._batch_size]
                    if self._drop_remainder and \
                            len(part) < self._batch_size:
                        break
                    pairs = [example_fn(imdb, imdb.gt_labels[i])
                             for i in part]
                    yield (np.stack([p[0] for p in pairs]),
                           np.asarray([p[1] for p in pairs]))
                epoch += 1

        it = batches()
        return lambda: next(it)


def to_device(batch: Any, device: torch.device) -> Any:
    """A batch (an array or a tuple/list of arrays or tensors) on
    ``device``: through pinned memory, without blocking, on CUDA."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(x, device) for x in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch)) \
        if isinstance(batch, np.ndarray) else torch.as_tensor(batch)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator: Iterator[Any], size: int = 2,
                    device: str | torch.device = "cuda") -> Iterator[Any]:
    """Yield the iterator's batches on ``device``, with ``size`` of them
    copied ahead."""
    device = torch.device(device)
    buf: list[Any] = []
    for batch in iterator:
        buf.append(to_device(batch, device))
        if len(buf) > size:
            yield buf.pop(0)
    yield from buf
