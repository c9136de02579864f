"""The ILSVRC CLS-LOC classification dataset (port of
tensorflow_yolo2_tpu/data/ilsvrc.py).

The 1000-class train and val listings (``ImageSets/CLS-LOC/train_cls.txt``
with the per-synset image dirs; the val labels from the per-image XML
annotations), cached as a pickle under ``Paths().cache``; class indices
by the sorted synset dirs of the train split. Batches come from ``get()``:
a cursor over the seeded shuffle of the entries, taken under a lock (the
decode runs outside it, so prefetch threads decode in parallel), with a
reshuffle and a new epoch when it wraps.

Images: a warp resize to image_size² (``data.augment.image_read``: cv2's
decode, the native resize), or with ``resize_policy="pad"`` an
aspect-preserving resize centred on zeros; with ``data_aug`` the
augmentation chain (``data.augment.augment_image``). ``uint8=True`` gives
uint8 batches for the on-device normalize. ``preprocess_name`` replaces
all of these with a factory preprocessing (``data.preprocessing``) of the
cv2-read BGR image: its train form on the train split with ``data_aug``,
else its eval form; it gives float32 images, so it refuses ``uint8``.
"""

from __future__ import annotations

import os
import pickle
import random
import threading
import xml.etree.ElementTree as ET

import numpy as np

from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.data.augment import (
    AugmentConfig,
    augment_image,
    augment_image_u8,
    image_read,
    image_read_u8,
    normalize,
)


def _pad_center_resize(image: np.ndarray, size: int) -> np.ndarray:
    """Aspect-preserving resize (cv2) centred in a size² image of
    zeros."""
    import cv2

    h, w = image.shape[:2]
    scale = size / float(max(h, w))
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = cv2.resize(image, (nw, nh))
    out = np.zeros((size, size, 3), dtype=image.dtype)
    top, left = (size - nh) // 2, (size - nw) // 2
    out[top:top + nh, left:left + nw] = resized
    return out


class IlsvrcCls:
    """ILSVRC CLS-LOC with the datasets' interface: ``get()``,
    ``classes``, ``num_class``, ``epoch``, ``total_batch``, and
    ``gt_labels``, the (path, class index) entries."""

    def __init__(self, image_set: str, batch_size: int = 48,
                 image_size: int = 224, data_aug: bool = False,
                 rgb: bool = False, resize_policy: str = "warp",
                 random_noise: bool = False, rebuild: bool = False,
                 paths: Paths | None = None, data_path: str | None = None,
                 seed: int = 0, preprocess_name: str | None = None,
                 uint8: bool = False):
        if image_set not in ("train", "val"):
            raise ValueError(f"image_set must be 'train' or 'val', got "
                             f"{image_set!r}")
        if resize_policy not in ("warp", "pad"):
            raise ValueError(f"resize_policy must be 'warp' or 'pad', got "
                             f"{resize_policy!r}")
        if uint8 and random_noise:
            raise ValueError("random_noise is host-side float arithmetic; "
                             "use float transfer")
        if uint8 and preprocess_name:
            raise ValueError("slim preprocessing fns emit normalized float; "
                             "use float transfer")
        self.name = "ilsvrc_2017_cls"
        self.paths = paths or Paths()
        self.data_path = data_path or self.paths.ilsvrc
        self.image_set = image_set
        self.batch_size = batch_size
        self.image_size = image_size
        self.data_aug = data_aug
        self.rgb = rgb
        self.resize_policy = resize_policy
        self.rebuild = rebuild
        self.aug_cfg = AugmentConfig(image_size=image_size,
                                     random_noise=random_noise)
        self.uint8 = uint8
        self.rng = random.Random(seed)
        self._preprocess = None
        if preprocess_name:
            from tensorflow_yolo2_torch.data.preprocessing import (
                get_preprocessing,
            )

            self._preprocess = get_preprocessing(
                preprocess_name, is_training=image_set == "train" and data_aug,
                image_size=image_size, seed=seed)
        self.cursor = 0
        self.epoch = 1
        self._lock = threading.Lock()

        if not os.path.isdir(self.data_path):
            raise FileNotFoundError(
                f"ILSVRC path does not exist: {self.data_path}")
        self.load_classes()
        self.gt_labels = self.prepare()

    # -- listings -------------------------------------------------------------

    def load_classes(self) -> None:
        train_dir = os.path.join(self.data_path, "Data", "CLS-LOC", "train")
        self.classes = tuple(sorted(os.listdir(train_dir)))
        self.num_class = len(self.classes)
        self.class_to_ind = {c: i for i, c in enumerate(self.classes)}

    def prepare(self) -> list[tuple[str, int]]:
        """The (path, class index) entries, from the cache when there is
        one (and not ``rebuild``), shuffled by the dataset's rng."""
        cache_file = os.path.join(
            self.paths.cache, f"ilsvrc_{self.image_set}_gt_labels.pkl")
        if os.path.isfile(cache_file) and not self.rebuild:
            with open(cache_file, "rb") as f:
                gt = pickle.load(f)
            self.rng.shuffle(gt)
            return gt

        os.makedirs(self.paths.cache, exist_ok=True)
        gt: list[tuple[str, int]] = []
        if self.image_set == "train":
            # ImageSets/CLS-LOC/train_cls.txt lines: "<synset>/<imgid> <idx>"
            listing = os.path.join(self.data_path, "ImageSets", "CLS-LOC",
                                   "train_cls.txt")
            root = os.path.join(self.data_path, "Data", "CLS-LOC", "train")
            with open(listing) as f:
                for line in f:
                    rel = line.split()[0]
                    synset = rel.split("/")[0]
                    gt.append((os.path.join(root, rel + ".JPEG"),
                               self.class_to_ind[synset]))
        else:
            # the val labels come from the per-image XML annotations
            ann_dir = os.path.join(self.data_path, "Annotations", "CLS-LOC",
                                   "val")
            root = os.path.join(self.data_path, "Data", "CLS-LOC", "val")
            for fn in sorted(os.listdir(ann_dir)):
                if not fn.endswith(".xml"):
                    continue
                tree = ET.parse(os.path.join(ann_dir, fn))
                obj = tree.find("object")
                name = obj.find("name") if obj is not None else None
                if name is None or name.text not in self.class_to_ind:
                    print(f"ilsvrc val: skipping {fn} (no usable "
                          "<object><name> synset)")
                    continue
                gt.append((os.path.join(root, fn[:-4] + ".JPEG"),
                           self.class_to_ind[name.text]))
        with open(cache_file, "wb") as f:
            pickle.dump(gt, f)
        self.rng.shuffle(gt)
        return gt

    # -- batching -------------------------------------------------------------

    @property
    def total_batch(self) -> int:
        return max(1, len(self.gt_labels) // self.batch_size)

    def image_read(self, path: str) -> np.ndarray:
        """One image as the batches hold it (uint8 with ``uint8``, else
        float32 in [-1, 1], or the factory preprocessing's float32)."""
        if self._preprocess is not None:
            import cv2

            image = cv2.imread(path)
            if image is None:
                raise FileNotFoundError(path)
            return self._preprocess(image)
        if not self.data_aug and self.resize_policy != "pad":
            read = image_read_u8 if self.uint8 else image_read
            return read(path, self.image_size, rgb=self.rgb)
        import cv2

        image = cv2.imread(path)
        if image is None:
            raise FileNotFoundError(path)
        if self.rgb:
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        if self.data_aug:
            augment = augment_image_u8 if self.uint8 else augment_image
            return augment(image, self.aug_cfg, self.rng, rgb=self.rgb)
        padded = _pad_center_resize(image, self.image_size)
        return padded if self.uint8 else normalize(padded)

    def _next_entries(self, n: int) -> list[tuple[str, int]]:
        with self._lock:
            out = []
            for _ in range(n):
                out.append(self.gt_labels[self.cursor])
                self.cursor += 1
                if self.cursor >= len(self.gt_labels):
                    self.rng.shuffle(self.gt_labels)
                    self.cursor = 0
                    self.epoch += 1
            return out

    def get(self) -> tuple[np.ndarray, np.ndarray]:
        """The next batch: images (N, size, size, 3) and int32 labels.
        Thread-safe: the entries are taken under the lock, the images
        decoded outside it."""
        entries = self._next_entries(self.batch_size)
        images = np.zeros(
            (self.batch_size, self.image_size, self.image_size, 3),
            np.uint8 if self.uint8 else np.float32)
        labels = np.zeros(self.batch_size, np.int32)
        for count, (path, cls) in enumerate(entries):
            images[count] = self.image_read(path)
            labels[count] = cls
        return images, labels
