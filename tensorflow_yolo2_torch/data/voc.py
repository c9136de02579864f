"""Pascal VOC2007 detection dataset (port of
tensorflow_yolo2_tpu/data/voc.py).

VOC XML annotations → per-image label grids: (S, S, 5+C) for the v1 head,
(S, S, B, 5+C) per-slot grids for an anchor config
(``build_label_grid_v2``):

- boxes in 0-based pixel coordinates of the *resized* (image_size²) image,
  clamped to it, via per-axis ratios;
- v1: one object per cell, the first object wins; per-slot: each object
  in its cell's best free anchor slot;
- label layout ``[responsible, cx, cy, w, h, one-hot class]``;
- a pickle cache ``cache/pascal_<set>_gt_labels<tags>.pkl`` (the JAX
  package's files and format; the tags name the size, the slots and
  non-classic anchors, so that grids built otherwise never share one);
- optional horizontally flipped copies;
- ``get()`` returns sequential (images, labels) batches and reshuffles at
  the end of each epoch with the generator it was given (the JAX package
  uses numpy's global one). Images are BGR, warp-resized, float32 in
  [-1, 1] or uint8.
"""

from __future__ import annotations

import copy
import hashlib
import os
import pickle
import threading
import xml.etree.ElementTree as ET

import numpy as np

from tensorflow_yolo2_torch.config import (
    VOC_CLASSES,
    Paths,
    YoloConfig,
    yolo_v2_config,
)
from tensorflow_yolo2_torch.data.augment import (
    image_read,
    image_read_u8,
    jpeg_size,
)
from tensorflow_yolo2_torch.utils import native


def build_label_grid(corners_xyxy: np.ndarray, cls_inds: np.ndarray,
                     S: int, num_class: int,
                     image_size: float) -> np.ndarray:
    """Resized-space x1y1x2y2 boxes (float32) → (S, S, 5+num_class) grid:
    cxcywh in resized pixels in the cell holding the centre, one object
    per cell, the first object wins. In the native layer where it built
    (``utils.native.label_grid``), else in :func:`label_grid_numpy`: the
    same grid."""
    fast = native.label_grid(corners_xyxy, cls_inds, S, num_class,
                             image_size)
    if fast is not None:
        return fast
    return label_grid_numpy(corners_xyxy, cls_inds, S, num_class, image_size)


def label_grid_numpy(corners_xyxy: np.ndarray, cls_inds: np.ndarray,
                     S: int, num_class: int,
                     image_size: float) -> np.ndarray:
    """:func:`build_label_grid` in numpy."""
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


def build_label_grid_v2(corners_xyxy: np.ndarray, cls_inds: np.ndarray,
                        S: int, B: int, anchors, num_class: int,
                        image_size: float) -> np.ndarray:
    """Resized-space x1y1x2y2 boxes (float32) → (S, S, B, 5+num_class)
    per-slot grid: each object goes to the free slot of its centre cell
    whose anchor (``anchors``, (B, 2) w/h in cell units) best matches its
    shape, ties to the lowest index, and is dropped when all B slots are
    taken. Shape IoU does not change with the grid's scale, so the
    assignment is the same at every multiscale size."""
    anchors = np.asarray(anchors, np.float32).reshape(B, 2)
    label = np.zeros((S, S, B, 5 + num_class), np.float32)
    for (x1, y1, x2, y2), cls_ind in zip(corners_xyxy, cls_inds):
        boxes = [(x2 + x1) / 2.0, (y2 + y1) / 2.0, x2 - x1, y2 - y1]
        x_ind = int(boxes[0] * S / image_size)
        y_ind = int(boxes[1] * S / image_size)
        wh = np.array([boxes[2], boxes[3]], np.float32) * S / image_size
        inter = (np.minimum(anchors[:, 0], wh[0]) *
                 np.minimum(anchors[:, 1], wh[1]))
        union = anchors[:, 0] * anchors[:, 1] + wh[0] * wh[1] - inter
        shape_iou = inter / np.maximum(union, 1e-10)
        for b in np.argsort(-shape_iou, kind="stable"):
            if label[y_ind, x_ind, b, 0] == 0:
                label[y_ind, x_ind, b, 0] = 1
                label[y_ind, x_ind, b, 1:5] = boxes
                label[y_ind, x_ind, b, 5 + cls_ind] = 1
                break
    return label


class PascalVOC:
    """VOC2007 image set with YOLO grid labels: per-slot grids when
    ``yolo`` has anchors and the per-slot layout, else v1 grids.

    ``rng`` shuffles the entries once at start and again at each epoch's
    end; anything with numpy's ``shuffle`` (a ``np.random.Generator`` by
    default, seeded 0).
    """

    def __init__(self, image_set: str, batch_size: int = 48,
                 yolo: YoloConfig = YoloConfig(), rebuild: bool = False,
                 flipped: bool = False, paths: Paths | None = None,
                 data_path: str | None = None, uint8: bool = False,
                 rng=None):
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
        self.per_slot = bool(yolo.per_slot_classes and yolo.anchors)
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
        grid = (self.cell_size, self.cell_size) + \
            ((self.yolo.B,) if self.per_slot else ()) + (5 + self.num_class,)
        labels = np.zeros((self.batch_size,) + grid, np.float32)
        read = image_read_u8 if self.uint8 else image_read
        for count, entry in enumerate(entries):
            images[count] = read(entry["imname"], self.image_size,
                                 flipped=entry["flipped"])
            labels[count] = entry["label"]
        return images, labels

    def prepare(self) -> list[dict]:
        gt_labels = self.load_labels()
        if self.flipped:
            # mirror the grid along x and reflect the stored cx (either
            # layout; the slot assignment is shape-only, so it holds)
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
        if self.per_slot:
            # the slots depend on the priors: non-classic ones get a tag
            scale_tag += f"_slots{self.yolo.B}"
            if tuple(self.yolo.anchors) != \
                    yolo_v2_config(self.image_size).anchors:
                digest = hashlib.sha1(np.asarray(
                    self.yolo.anchors, np.float64).tobytes()).hexdigest()
                scale_tag += f"_a{digest[:8]}"
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
        """One VOC XML → its label grid and its object count."""
        imname = os.path.join(self.data_path, "JPEGImages", index + ".jpg")
        height, width = image_shape(imname)
        h_ratio = float(self.image_size) / height
        w_ratio = float(self.image_size) / width

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
        corners = np.asarray(corners, np.float32).reshape(-1, 4)
        cls_inds = np.asarray(cls_inds, np.int32)
        if self.per_slot:
            label = build_label_grid_v2(
                corners, cls_inds, self.cell_size, self.yolo.B,
                self.yolo.anchors, self.num_class, float(self.image_size))
        else:
            label = build_label_grid(corners, cls_inds, self.cell_size,
                                     self.num_class, float(self.image_size))
        return label, len(objs)


def image_shape(imname: str) -> tuple[int, int]:
    """(height, width) of a VOC image as ``cv2.imread`` gives it where cv2
    is installed, else from the JPEG's frame header (VOC's images carry no
    EXIF orientation, which cv2 would apply)."""
    try:
        import cv2
    except ImportError:
        return jpeg_size(imname)
    im = cv2.imread(imname)
    if im is None:
        raise FileNotFoundError(f"VOC image missing or undecodable: {imname}")
    return im.shape[:2]
