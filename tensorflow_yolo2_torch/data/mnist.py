"""The MNIST classification dataset (port of
tensorflow_yolo2_tpu/data/mnist.py).

Reads the IDX files (``train-images-idx3-ubyte`` /
``train-labels-idx1-ubyte`` and the ``t10k`` pair, each raw or gzipped)
under ``data_path`` (default ``<root>/data/mnist``) into 28×28×1 uint8
images with 10 classes, on the in-memory dataset (``data.memory``):
scaled to [-1, 1] at batch time, or through ``preprocess_fn``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Any

import numpy as np

from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.data.memory import InMemoryImdb

_CLASS_NAMES = ("zero", "one", "two", "three", "four",
                "five", "six", "seven", "eight", "nine")

_SPLIT_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    """IDX3 file → uint8 (N, rows, cols) array."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX3 magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """IDX1 file → uint8 (N,) array."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX1 magic {magic} in {path}")
        data = np.frombuffer(f.read(n), np.uint8)
    return data


class MNIST(InMemoryImdb):
    """MNIST imdb: 28×28×1 digits, values scaled to [-1, 1]."""

    def __init__(self, split: str = "train", batch_size: int = 32,
                 data_path: str | None = None, paths: Paths | None = None,
                 seed: int = 0, **_: Any):
        if split in ("val", "validation"):
            split = "test"
        if split not in _SPLIT_FILES:
            raise ValueError(f"split name {split} was not recognized")
        self.name = "mnist"
        self.paths = paths or Paths()
        self.data_path = data_path or os.path.join(self.paths.root, "data",
                                                   "mnist")
        self.batch_size = batch_size
        self.image_size = 28
        self.classes = _CLASS_NAMES
        self.num_class = 10

        img_file, lbl_file = _SPLIT_FILES[split]
        images = read_idx_images(os.path.join(self.data_path, img_file))
        labels = read_idx_labels(os.path.join(self.data_path, lbl_file))
        if len(images) != len(labels):
            raise ValueError(
                f"image/label count mismatch: {len(images)} vs {len(labels)}")
        self._images = images[..., None]  # N,28,28,1
        self._labels = labels.astype(np.int32)
        self._init_order(seed)
