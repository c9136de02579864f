"""Pascal VOC2007 detection dataset (port of
tensorflow_yolo2_tpu/data/voc.py, the v1 label grid).

VOC XML annotations → per-image (S, S, 5+C) label grids:

- boxes in 0-based pixel coordinates of the *resized* (image_size²) image,
  clamped to it, via per-axis ratios;
- one object per cell, the first object wins;
- label layout ``[responsible, cx, cy, w, h, one-hot class]``;
- a pickle cache ``cache/pascal_<set>_gt_labels.pkl`` (the JAX package's
  file and format);
- optional horizontally flipped copies;
- ``get()`` returns sequential (images, labels) batches and reshuffles at
  the end of each epoch with the generator it was given (the JAX package
  uses numpy's global one). Images are BGR, warp-resized, float32 in
  [-1, 1] or uint8.

The per-slot grid of the anchor heads is not ported yet.
"""

from __future__ import annotations

import copy
import os
import pickle
import threading
import xml.etree.ElementTree as ET

import numpy as np

from tensorflow_yolo2_torch.config import VOC_CLASSES, Paths, YoloConfig
from tensorflow_yolo2_torch.data.augment import image_read, image_read_u8


def build_label_grid(corners_xyxy: np.ndarray, cls_inds: np.ndarray,
                     S: int, num_class: int,
                     image_size: float) -> np.ndarray:
    """Resized-space x1y1x2y2 boxes (float32) → (S, S, 5+num_class) grid:
    cxcywh in resized pixels in the cell holding the centre, one object
    per cell, the first object wins."""
    label = np.zeros((S, S, 5 + num_class), np.float32)
    for (x1, y1, x2, y2), cls_ind in zip(corners_xyxy, cls_inds):
        boxes = [(x2 + x1) / 2.0, (y2 + y1) / 2.0, x2 - x1, y2 - y1]
        x_ind = int(boxes[0] * S / image_size)
        y_ind = int(boxes[1] * S / image_size)
        if label[y_ind, x_ind, 0] == 1:
            continue
        label[y_ind, x_ind, 0] = 1
        label[y_ind, x_ind, 1:5] = boxes
        label[y_ind, x_ind, 5 + cls_ind] = 1
    return label


class PascalVOC:
    """VOC2007 image set with YOLO grid labels.

    ``rng`` shuffles the entries once at start and again at each epoch's
    end; anything with numpy's ``shuffle`` (a ``np.random.Generator`` by
    default, seeded 0).
    """

    def __init__(self, image_set: str, batch_size: int = 48,
                 yolo: YoloConfig = YoloConfig(), rebuild: bool = False,
                 flipped: bool = False, paths: Paths | None = None,
                 data_path: str | None = None, uint8: bool = False,
                 rng=None):
        if yolo.per_slot_classes:
            raise ValueError("the per-slot label grid of the anchor heads "
                             "is not ported yet (ROADMAP.md, queue A, "
                             "slice 3b)")
        self.name = "voc_2007"
        self.paths = paths or Paths()
        self.data_path = data_path or os.path.join(self.paths.pascal,
                                                   "VOC2007")
        self.cache_path = self.paths.cache
        self.batch_size = batch_size
        self.yolo = yolo
        self.image_size = yolo.image_size
        self.cell_size = yolo.S
        self.classes = VOC_CLASSES
        self.num_class = len(self.classes)
        self.class_to_ind = {c: i for i, c in enumerate(self.classes)}
        self.image_set = image_set
        self.rebuild = rebuild
        self.flipped = flipped
        self.uint8 = uint8
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.cursor = 0
        self.epoch = 1
        self.gt_labels: list[dict] = []
        # the cursor and the shuffle are locked; decoding is not, so that
        # prefetch threads read images in parallel
        self._lock = threading.Lock()
        if not os.path.exists(self.data_path):
            raise FileNotFoundError(
                f"VOCdevkit path does not exist: {self.data_path}")
        self.prepare()

    @property
    def total_batch(self) -> int:
        return max(1, len(self.gt_labels) // self.batch_size)

    def _next_entries(self, n: int) -> list[dict]:
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
        """The next (images, labels) batch."""
        entries = self._next_entries(self.batch_size)
        images = np.zeros(
            (self.batch_size, self.image_size, self.image_size, 3),
            np.uint8 if self.uint8 else np.float32)
        labels = np.zeros((self.batch_size, self.cell_size, self.cell_size,
                           5 + self.num_class), np.float32)
        read = image_read_u8 if self.uint8 else image_read
        for count, entry in enumerate(entries):
            images[count] = read(entry["imname"], self.image_size,
                                 flipped=entry["flipped"])
            labels[count] = entry["label"]
        return images, labels

    def prepare(self) -> list[dict]:
        gt_labels = self.load_labels()
        if self.flipped:
            # mirror the grid along x and reflect the stored cx
            gt_flip = copy.deepcopy(gt_labels)
            for entry in gt_flip:
                entry["flipped"] = True
                entry["label"] = entry["label"][:, ::-1]
                resp = entry["label"][..., 0] == 1
                entry["label"][..., 1] = np.where(
                    resp, self.image_size - 1 - entry["label"][..., 1],
                    entry["label"][..., 1])
            gt_labels = gt_labels + gt_flip
        self.rng.shuffle(gt_labels)
        self.gt_labels = gt_labels
        return gt_labels

    def load_labels(self) -> list[dict]:
        # grids depend on (image_size, S): the default keeps the plain name
        scale_tag = ("" if (self.image_size, self.cell_size) == (224, 7)
                     else f"_{self.image_size}x{self.cell_size}")
        cache_file = os.path.join(
            self.cache_path,
            f"pascal_{self.image_set}_gt_labels{scale_tag}.pkl")
        if os.path.isfile(cache_file) and not self.rebuild:
            with open(cache_file, "rb") as f:
                return pickle.load(f)

        os.makedirs(self.cache_path, exist_ok=True)
        txtname = os.path.join(self.data_path, "ImageSets", "Main",
                               self.image_set + ".txt")
        with open(txtname) as f:
            image_index = [x.strip() for x in f.readlines()]

        gt_labels = []
        for index in image_index:
            label, num = self.load_annotation(index)
            if num == 0:
                continue
            imname = os.path.join(self.data_path, "JPEGImages",
                                  index + ".jpg")
            gt_labels.append(
                {"imname": imname, "label": label, "flipped": False})
        with open(cache_file, "wb") as f:
            pickle.dump(gt_labels, f)
        return gt_labels

    def load_annotation(self, index: str) -> tuple[np.ndarray, int]:
        """One VOC XML → (S, S, 5+C) grid and its object count."""
        import cv2

        imname = os.path.join(self.data_path, "JPEGImages", index + ".jpg")
        im = cv2.imread(imname)
        if im is None:
            raise FileNotFoundError(
                f"VOC image missing or undecodable: {imname}")
        h_ratio = float(self.image_size) / im.shape[0]
        w_ratio = float(self.image_size) / im.shape[1]

        filename = os.path.join(self.data_path, "Annotations",
                                index + ".xml")
        objs = ET.parse(filename).findall("object")
        corners, cls_inds = [], []
        top = self.image_size - 1
        for obj in objs:
            bbox = obj.find("bndbox")
            # 0-based pixel coords in the resized image, clamped to it
            x1 = max(min((float(bbox.find("xmin").text) - 1) * w_ratio,
                         top), 0)
            y1 = max(min((float(bbox.find("ymin").text) - 1) * h_ratio,
                         top), 0)
            x2 = max(min((float(bbox.find("xmax").text) - 1) * w_ratio,
                         top), 0)
            y2 = max(min((float(bbox.find("ymax").text) - 1) * h_ratio,
                         top), 0)
            corners.append((x1, y1, x2, y2))
            cls_inds.append(
                self.class_to_ind[obj.find("name").text.lower().strip()])
        label = build_label_grid(
            np.asarray(corners, np.float32).reshape(-1, 4),
            np.asarray(cls_inds, np.int32), self.cell_size, self.num_class,
            float(self.image_size))
        return label, len(objs)
