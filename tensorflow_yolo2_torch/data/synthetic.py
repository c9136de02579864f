"""Synthetic on-disk fixtures of the quality program
(``entries.quality_curve``): a hard VOC2007 tree with a held-out split
and an ILSVRC CLS-LOC tree of the same object vocabulary to pretrain the
classifier on. The same seeds and draws as the repository's test fixtures
(``tests/synthetic.py``), so both packages are scored on byte-identical
trees."""

from __future__ import annotations

import os

import cv2
import numpy as np

# class → base BGR color family so the class label is learnable from
# pixels (the fixture must be harder than trivial but not impossible)
_HARD_CLASSES = ("dog", "person", "car", "cat")
_HARD_COLORS = ((40, 40, 200), (40, 200, 40), (200, 40, 40), (40, 200, 200))
# deliberately imbalanced class frequencies
_HARD_WEIGHTS = (0.55, 0.25, 0.12, 0.08)


def make_image(path: str, w: int = 320, h: int = 240, seed: int = 0,
               boxes: list | None = None) -> None:
    """A noise image of ``w``×``h`` with a randomly colored filled
    rectangle for each of ``boxes`` (x1, y1, x2, y2), written to ``path``."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (h, w, 3), np.uint8)
    for (x1, y1, x2, y2) in boxes or []:
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), color, -1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, img)


def _xml(index: str, w: int, h: int, objects: list[tuple[str, tuple]]) -> str:
    parts = [f"<annotation><filename>{index}.jpg</filename>",
             f"<size><width>{w}</width><height>{h}</height>"
             "<depth>3</depth></size>"]
    for name, (x1, y1, x2, y2) in objects:
        parts.append(
            f"<object><name>{name}</name><bndbox>"
            f"<xmin>{x1}</xmin><ymin>{y1}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
    parts.append("</annotation>")
    return "".join(parts)


def make_voc_hard(root: str, n_train: int = 64, n_val: int = 32,
                  w: int = 320, h: int = 240, seed: int = 11,
                  easy: bool = False) -> str:
    """Harder VOC fixture with a held-out val split: 2-5 objects per
    image, deliberate overlapping pairs, imbalanced classes, size range
    16-120 px, class-colored boxes on noise. Writes image sets
    ``trainval`` (train) and ``test`` (val); returns the VOC2007 dir.

    ``easy=True`` keeps the held-out split but drops the difficulty
    (1-2 non-overlapping objects, 48-120 px, balanced classes): the
    sanity point showing that the train→val pipeline itself works."""
    voc = os.path.join(root, "VOC2007")
    os.makedirs(os.path.join(voc, "ImageSets", "Main"), exist_ok=True)
    os.makedirs(os.path.join(voc, "Annotations"), exist_ok=True)
    rng = np.random.RandomState(seed)
    sets = {"trainval": [], "test": []}
    for i in range(n_train + n_val):
        split = "trainval" if i < n_train else "test"
        index = f"{i:06d}"
        sets[split].append(index)
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        objs = []
        n_obj = rng.randint(1, 3) if easy else rng.randint(2, 6)
        prev = None
        for _ in range(n_obj):
            lo, hi = (48, 120) if easy else (16, 120)
            bw = rng.randint(lo, hi)
            bh = rng.randint(lo, hi)
            if not easy and prev is not None and rng.rand() < 0.4:
                # overlapping pair: offset from the previous box
                x1 = int(np.clip(prev[0] + rng.randint(-20, 20),
                                 1, w - bw - 1))
                y1 = int(np.clip(prev[1] + rng.randint(-20, 20),
                                 1, h - bh - 1))
            else:
                x1 = rng.randint(1, max(2, w - bw - 1))
                y1 = rng.randint(1, max(2, h - bh - 1))
            x2, y2 = min(x1 + bw, w - 1), min(y1 + bh, h - 1)
            ci = (rng.randint(len(_HARD_CLASSES)) if easy else
                  rng.choice(len(_HARD_CLASSES), p=_HARD_WEIGHTS))
            base = np.asarray(_HARD_COLORS[ci], np.int32)
            color = tuple(int(c) for c in np.clip(
                base + rng.randint(-40, 40, 3), 0, 255))
            cv2.rectangle(img, (x1, y1), (x2, y2), color, -1)
            objs.append((_HARD_CLASSES[ci], (x1, y1, x2, y2)))
            prev = (x1, y1)
        img_path = os.path.join(voc, "JPEGImages", index + ".jpg")
        os.makedirs(os.path.dirname(img_path), exist_ok=True)
        cv2.imwrite(img_path, img)
        with open(os.path.join(voc, "Annotations", index + ".xml"),
                  "w") as f:
            f.write(_xml(index, w, h, objs))
    for name, indices in sets.items():
        with open(os.path.join(voc, "ImageSets", "Main",
                               name + ".txt"), "w") as f:
            f.write("\n".join(indices) + "\n")
    return voc


def make_cls_pretrain(root: str, per_class: int = 200, n_val: int = 100,
                      w: int = 256, h: int = 192, seed: int = 23) -> str:
    """Classification-pretraining fixture in ILSVRC CLS-LOC layout: one
    synset per hard-VOC class, each image a single class-colored
    rectangle (the color families and jitter of ``make_voc_hard``) on
    noise at varied scale and position: the synthetic world's "ImageNet",
    so that a Darknet19 classifier pretrained here warm-starts the
    detector on the hard fixture as ImageNet does on VOC. Returns the
    ILSVRC root."""
    rng = np.random.RandomState(seed)
    synsets = [f"n_{cls}" for cls in _HARD_CLASSES]
    train_lines = []

    def render(ci: int) -> np.ndarray:
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        bw, bh = rng.randint(16, 160), rng.randint(16, 160)
        x1 = rng.randint(1, max(2, w - bw - 1))
        y1 = rng.randint(1, max(2, h - bh - 1))
        base = np.asarray(_HARD_COLORS[ci], np.int32)
        color = tuple(int(c) for c in np.clip(
            base + rng.randint(-40, 40, 3), 0, 255))
        cv2.rectangle(img, (x1, y1), (min(x1 + bw, w - 1),
                                      min(y1 + bh, h - 1)), color, -1)
        return img

    for ci, syn in enumerate(synsets):
        d = os.path.join(root, "Data", "CLS-LOC", "train", syn)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            cv2.imwrite(os.path.join(d, f"{syn}_{i}.JPEG"), render(ci))
            train_lines.append(f"{syn}/{syn}_{i} {len(train_lines) + 1}")
    os.makedirs(os.path.join(root, "ImageSets", "CLS-LOC"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "CLS-LOC",
                           "train_cls.txt"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    val_img = os.path.join(root, "Data", "CLS-LOC", "val")
    val_ann = os.path.join(root, "Annotations", "CLS-LOC", "val")
    os.makedirs(val_img, exist_ok=True)
    os.makedirs(val_ann, exist_ok=True)
    for i in range(n_val):
        ci = i % len(synsets)
        name = f"ILSVRC2012_val_{i:08d}"
        cv2.imwrite(os.path.join(val_img, name + ".JPEG"), render(ci))
        with open(os.path.join(val_ann, name + ".xml"), "w") as f:
            f.write(f"<annotation><object><name>{synsets[ci]}</name>"
                    "</object></annotation>")
    return root
