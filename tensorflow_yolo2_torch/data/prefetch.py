"""Host → device prefetch (port of tensorflow_yolo2_tpu/data/prefetch.py).

- :class:`PrefetchLoader`: a pool of threads calls ``get_batch()`` into a
  bounded queue, so that image decoding overlaps the device step (cv2 and
  numpy release the GIL). A worker's error reaches the consumer after the
  batches already queued.
- :func:`device_prefetch`: keeps ``size`` batches on their way to the
  device, copied from pinned host memory with ``non_blocking=True`` on a
  CUDA device, so that a step does not wait for its batch's copy.

The process-pool loader and the epoch-sharded stream are not ported yet.
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
