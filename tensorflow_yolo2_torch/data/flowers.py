"""The TF_flowers classification dataset (port of
tensorflow_yolo2_tpu/data/flowers.py).

Images under one directory a class (``Paths().flowers`` or
``data_path``), classes by the sorted directory names; the entries
shuffled with ``seed`` and the first ``val_split`` of them held out as
the validation list. ``get_train()`` serves augmented batches
(``data.augment.read_and_augment``) and reshuffles the train list when
its cursor wraps, ``get_val()`` plain resized ones (``image_read``) from
the validation list (the train list when it is empty), ``get()`` is
``get_train()``. With ``preprocess_name`` the factory preprocessing
(``data.preprocessing``) replaces both: its train form for
``get_train()``, its eval form for ``get_val()``, each on the cv2-read
BGR image and each with its own ``random.Random(seed)``. The cursors move
under a lock and the decode runs outside it, so prefetch threads decode
in parallel.
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

class TFFlowers:
    """Flowers with the datasets' interface (``get``, ``classes``,
    ``num_class``, ``epoch``, ``total_batch``) and ``get_train`` /
    ``get_val``."""

    def __init__(self, batch_size: int = 16, image_size: int = 224,
                 val_split: float = 0.2, data_aug: bool = True,
                 paths: Paths | None = None, data_path: str | None = None,
                 seed: int = 0, preprocess_name: str | None = None):
        self.name = "tf_flowers"
        self.paths = paths or Paths()
        self.data_path = data_path or self.paths.flowers
        self.batch_size = batch_size
        self.image_size = image_size
        self.data_aug = data_aug
        self.aug_cfg = AugmentConfig(image_size=image_size)
        self.rng = random.Random(seed)
        self._pp_train = self._pp_eval = None
        if preprocess_name:
            from tensorflow_yolo2_torch.data.preprocessing import (
                get_preprocessing,
            )

            self._pp_train = get_preprocessing(
                preprocess_name, is_training=True, image_size=image_size,
                seed=seed)
            self._pp_eval = get_preprocessing(
                preprocess_name, is_training=False, image_size=image_size,
                seed=seed)
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
            if self._pp_train is not None:
                import cv2

                fn = self._pp_train if augment else self._pp_eval
                images[count] = fn(cv2.imread(path))
            elif augment and self.data_aug:
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
