"""The CIFAR-10 classification dataset (port of
tensorflow_yolo2_tpu/data/cifar10.py).

Reads the python-pickle batches (``data_batch_1`` … ``_5`` /
``test_batch``, class names from ``batches.meta``) or the binary ones
(``data_batch_N.bin`` / ``test_batch.bin``: a label byte and 3072 CHW
bytes a record) under ``data_path`` (default ``<root>/data/cifar10``)
into 32×32×3 RGB uint8 images, on the in-memory dataset
(``data.memory``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np

from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.data.memory import InMemoryImdb

_DEFAULT_CLASSES = ("airplane", "automobile", "bird", "cat", "deer",
                    "dog", "frog", "horse", "ship", "truck")


def _chw_to_hwc(flat: np.ndarray) -> np.ndarray:
    """(N, 3072) CHW-flat uint8 → (N, 32, 32, 3) RGB."""
    return flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def read_python_batches(data_path: str, split: str):
    """CIFAR-10 python-pickle batches → (images NHWC uint8, labels, names)."""
    files = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    images, labels = [], []
    for fn in files:
        with open(os.path.join(data_path, fn), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        images.append(_chw_to_hwc(np.asarray(batch[b"data"], np.uint8)))
        labels.append(np.asarray(batch[b"labels"], np.int32))
    names = _DEFAULT_CLASSES
    meta = os.path.join(data_path, "batches.meta")
    if os.path.exists(meta):
        with open(meta, "rb") as f:
            meta_d = pickle.load(f, encoding="bytes")
        names = tuple(n.decode() for n in meta_d[b"label_names"])
    return np.concatenate(images), np.concatenate(labels), names


def read_binary_batches(data_path: str, split: str):
    """CIFAR-10 binary batches (.bin records) → same triple."""
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)]
             if split == "train" else ["test_batch.bin"])
    images, labels = [], []
    for fn in files:
        raw = np.fromfile(os.path.join(data_path, fn), np.uint8)
        rec = raw.reshape(-1, 3073)
        labels.append(rec[:, 0].astype(np.int32))
        images.append(_chw_to_hwc(rec[:, 1:].copy()))
    return np.concatenate(images), np.concatenate(labels), _DEFAULT_CLASSES


class Cifar10(InMemoryImdb):
    """CIFAR-10 imdb: 32×32×3 RGB images scaled to [-1, 1]."""

    def __init__(self, split: str = "train", batch_size: int = 32,
                 data_path: str | None = None, paths: Paths | None = None,
                 seed: int = 0, **_: Any):
        if split in ("val", "validation"):
            split = "test"
        if split not in ("train", "test"):
            raise ValueError(f"split name {split} was not recognized")
        self.name = "cifar10"
        self.paths = paths or Paths()
        self.data_path = data_path or os.path.join(self.paths.root, "data",
                                                   "cifar10")
        self.batch_size = batch_size
        self.image_size = 32

        if os.path.exists(os.path.join(self.data_path, "data_batch_1")) or \
                os.path.exists(os.path.join(self.data_path, "test_batch")):
            images, labels, names = read_python_batches(self.data_path, split)
        else:
            images, labels, names = read_binary_batches(self.data_path, split)
        self.classes = names
        self.num_class = len(names)
        self._images = images
        self._labels = labels
        self._init_order(seed)
