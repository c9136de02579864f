"""The shared in-memory dataset (a copy of
tensorflow_yolo2_tpu/data/memory.py, which the port does not import):
a cursor over a seeded permutation of in-memory (images, labels) arrays,
taken under a lock so that prefetch threads can share one dataset, with
a reshuffle and a new epoch when it wraps; uint8 images are scaled to
[-1, 1] at batch time, float ones pass through.
"""

from __future__ import annotations

import threading

import numpy as np


class InMemoryImdb:
    """Base dataset over in-memory (images, labels) arrays.

    Subclasses set ``batch_size``, ``_images`` (uint8, scaled to [-1, 1]
    at batch time, or float32 passed through) and ``_labels``, then call
    :meth:`_init_order`. ``preprocess_fn``, where set, maps each stored
    uint8 HWC image to its float32 image instead of the scaling.
    """

    batch_size: int
    preprocess_fn = None

    def _init_order(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)
        self._order = self._rng.permutation(len(self._labels))
        self.cursor = 0
        self.epoch = 1
        self._lock = threading.Lock()

    @property
    def channels(self) -> int:
        """The stored images' channels (MNIST's 1), which the factory
        preprocessings keep."""
        return self._images.shape[-1]

    @property
    def total_batch(self) -> int:
        return max(1, len(self._labels) // self.batch_size)

    def _pick(self) -> list:
        """Advance the cursor by one batch under the lock."""
        with self._lock:
            idx = []
            for _ in range(self.batch_size):
                idx.append(self._order[self.cursor])
                self.cursor += 1
                if self.cursor >= len(self._order):
                    self._order = self._rng.permutation(len(self._labels))
                    self.cursor = 0
                    self.epoch += 1
        return idx

    def get(self) -> tuple[np.ndarray, np.ndarray]:
        idx = self._pick()
        images = self._images[idx]
        if self.preprocess_fn is not None:
            images = np.stack([self.preprocess_fn(im) for im in images])
        elif images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0 * 2.0 - 1.0
        return images, self._labels[idx]
