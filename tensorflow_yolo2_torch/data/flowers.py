"""The TF_flowers classification dataset (port of
tensorflow_yolo2_tpu/data/flowers.py).

Images under one directory a class (``Paths().flowers`` or
``data_path``), classes by the sorted directory names; the entries
shuffled with ``seed`` and the first ``val_split`` of them held out as
the validation list. ``get_train()`` serves augmented batches
(``data.augment.read_and_augment``) and reshuffles the train list when
its cursor wraps, ``get_val()`` plain resized ones (``image_read``) from
the validation list (the train list when it is empty), ``get()`` is
``get_train()``. The cursors move under a lock and the decode runs
outside it, so prefetch threads decode in parallel.

The slim preprocessing functions (``preprocess_name``) are not ported
yet: they come with the slim data tier.
"""

from __future__ import annotations

import os
import random
import threading

import numpy as np

from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.data.augment import (
    AugmentConfig,
    image_read,
    read_and_augment,
)

DATA_TIER = ("the slim data tier (preprocessing, mnist, cifar10, prepared, "
             "fetch) is not ported yet (ROADMAP.md, queue A, A6)")


class TFFlowers:
    """Flowers with the datasets' interface (``get``, ``classes``,
    ``num_class``, ``epoch``, ``total_batch``) and ``get_train`` /
    ``get_val``."""

    def __init__(self, batch_size: int = 16, image_size: int = 224,
                 val_split: float = 0.2, data_aug: bool = True,
                 paths: Paths | None = None, data_path: str | None = None,
                 seed: int = 0, preprocess_name: str | None = None):
        if preprocess_name:
            raise ValueError(f"preprocess_name={preprocess_name!r}: "
                             f"{DATA_TIER}")
        self.name = "tf_flowers"
        self.paths = paths or Paths()
        self.data_path = data_path or self.paths.flowers
        self.batch_size = batch_size
        self.image_size = image_size
        self.data_aug = data_aug
        self.aug_cfg = AugmentConfig(image_size=image_size)
        self.rng = random.Random(seed)
        self.epoch = 1
        self.train_cursor = 0
        self.val_cursor = 0
        self._lock = threading.Lock()

        if not os.path.isdir(self.data_path):
            raise FileNotFoundError(
                f"TF_flowers path does not exist: {self.data_path}")
        self.classes = tuple(sorted(
            d for d in os.listdir(self.data_path)
            if os.path.isdir(os.path.join(self.data_path, d))))
        self.num_class = len(self.classes)
        self.class_to_ind = {c: i for i, c in enumerate(self.classes)}

        entries = []
        for cls in self.classes:
            cdir = os.path.join(self.data_path, cls)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith((".jpg", ".jpeg", ".png")):
                    entries.append((os.path.join(cdir, fn),
                                    self.class_to_ind[cls]))
        random.Random(seed).shuffle(entries)
        n_val = int(len(entries) * val_split)
        self.val_list = entries[:n_val]
        self.train_list = entries[n_val:]

    @property
    def total_batch(self) -> int:
        return max(1, len(self.train_list) // self.batch_size)

    def _fetch(self, entries: list, cursor_attr: str, augment: bool):
        with self._lock:
            cursor = getattr(self, cursor_attr)
            picked = []
            for _ in range(self.batch_size):
                picked.append(entries[cursor])
                cursor += 1
                if cursor >= len(entries):
                    # only the train stream reshuffles: with val_split=0
                    # get_val serves train_list mid-epoch
                    if cursor_attr == "train_cursor":
                        self.rng.shuffle(entries)
                        self.epoch += 1
                    cursor = 0
            setattr(self, cursor_attr, cursor)
        images = np.zeros(
            (self.batch_size, self.image_size, self.image_size, 3), np.float32)
        labels = np.zeros(self.batch_size, np.int32)
        for count, (path, cls) in enumerate(picked):
            if augment and self.data_aug:
                images[count] = read_and_augment(path, self.aug_cfg, self.rng)
            else:
                images[count] = image_read(path, self.image_size)
            labels[count] = cls
        return images, labels

    def get_train(self):
        return self._fetch(self.train_list, "train_cursor", augment=True)

    def get_val(self):
        return self._fetch(self.val_list or self.train_list, "val_cursor",
                           augment=False)

    def get(self):
        return self.get_train()
