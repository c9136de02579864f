"""YOLO9000 dimension clusters and the priors persisted beside a snapshot
(port of tensorflow_yolo2_tpu/data/anchors.py).

``pascal_train_darknet --v2 --anchors kmeans`` fits the priors to the
training set's box shapes by k-means under the distance 1 − IoU (shapes
centred), as the YOLOv2 paper does (``iou_kmeans`` on
``collect_voc_wh_cells``); the classic priors (``config.CLASSIC_VOC_ANCHORS``)
are the paper's VOC clusters. Training writes the priors its anchor head
was fitted with to ``anchors.json`` in its snapshot dir (``{"S": grid,
"anchors": [[w, h], ...]}``, cell units at that grid), and serving and
evaluation decode with them (``v2_config_for_snapshot``).

The fit is deterministic: k boxes at evenly spaced quantiles of the
area-sorted distinct shapes start it, ties go to the lowest centroid,
and each centroid moves to its members' mean.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from tensorflow_yolo2_torch.config import YoloConfig, yolo_v2_config

ANCHORS_FILE = "anchors.json"


def _shape_iou(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Pairwise shape-only IoU of boxes (N, 2) and centroids (K, 2)."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0]) *
             np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, None, 0] * wh[:, None, 1] +
             centroids[None, :, 0] * centroids[None, :, 1] - inter)
    return inter / np.maximum(union, 1e-10)


def iou_kmeans(wh: np.ndarray, k: int, iters: int = 100
               ) -> tuple[np.ndarray, float]:
    """Cluster (N, 2) box shapes into k priors under 1 − IoU: (the priors
    by ascending area as float32, the boxes' mean best IoU against them,
    the paper's "Avg IoU")."""
    wh = np.asarray(wh, np.float64).reshape(-1, 2)
    wh = wh[(wh > 0).all(axis=1)]
    if wh.shape[0] == 0:
        raise ValueError("no positive-size boxes to cluster")
    if wh.shape[0] < k:  # a tiny dataset: repeat what there is
        wh = np.tile(wh, (int(np.ceil(k / wh.shape[0])), 1))

    uniq = np.unique(wh, axis=0)
    order = np.argsort(uniq[:, 0] * uniq[:, 1], kind="stable")
    idx = np.linspace(0, len(order) - 1, k).round().astype(int)
    centroids = uniq[order[idx]].copy()
    # quantile picks coincide on small datasets: nudge duplicates apart
    for i in range(1, k):
        while any(np.array_equal(centroids[i], centroids[j])
                  for j in range(i)):
            centroids[i] = centroids[i] * (1.0 + 1e-3 * (i + 1))

    assign = None
    for _ in range(iters):
        iou = _shape_iou(wh, centroids)
        new_assign = np.argmax(iou, axis=1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        # an empty cluster takes the worst-covered box not taken yet
        # (ranked against the centroids before this update)
        reseed_order = iter(np.argsort(np.max(iou, axis=1), kind="stable"))
        for j in range(k):
            members = wh[assign == j]
            if members.shape[0]:
                centroids[j] = members.mean(axis=0)
            else:
                centroids[j] = wh[next(reseed_order)]
    centroids = centroids[np.argsort(centroids[:, 0] * centroids[:, 1],
                                     kind="stable")]
    avg_iou = float(np.mean(np.max(_shape_iou(wh, centroids), axis=1)))
    return centroids.astype(np.float32), avg_iou


def collect_voc_wh_cells(data_path: str, image_set: str, S: int,
                         image_size: int) -> np.ndarray:
    """Every ground-truth (w, h) of a VOC image set in grid-cell units,
    (N, 2) float32, with ``data.voc.PascalVOC.load_annotation``'s
    resized-space corners. The image size comes from the XML's size tag,
    else from the image (cv2)."""
    txtname = os.path.join(data_path, "ImageSets", "Main",
                           image_set + ".txt")
    with open(txtname) as f:
        image_index = [x.strip() for x in f if x.strip()]
    top = image_size - 1
    out = []
    for index in image_index:
        tree = ET.parse(os.path.join(data_path, "Annotations",
                                     index + ".xml"))
        size = tree.find("size")
        w = h = 0
        if size is not None:
            w = int(float(size.findtext("width") or 0))
            h = int(float(size.findtext("height") or 0))
        if w <= 0 or h <= 0:
            import cv2

            im = cv2.imread(os.path.join(data_path, "JPEGImages",
                                         index + ".jpg"))
            if im is None:
                continue
            h, w = im.shape[:2]
        w_ratio = float(image_size) / w
        h_ratio = float(image_size) / h
        for obj in tree.findall("object"):
            bbox = obj.find("bndbox")
            x1 = max(min((float(bbox.find("xmin").text) - 1) * w_ratio,
                         top), 0)
            y1 = max(min((float(bbox.find("ymin").text) - 1) * h_ratio,
                         top), 0)
            x2 = max(min((float(bbox.find("xmax").text) - 1) * w_ratio,
                         top), 0)
            y2 = max(min((float(bbox.find("ymax").text) - 1) * h_ratio,
                         top), 0)
            bw = (x2 - x1) * S / image_size
            bh = (y2 - y1) * S / image_size
            if bw > 0 and bh > 0:
                out.append((bw, bh))
    return np.asarray(out, np.float32).reshape(-1, 2)


def save_anchors(ckpt_dir: str, anchors, S: int) -> str:
    """Write priors (cell units at grid size S) to ``ckpt_dir``'s
    ``anchors.json``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, ANCHORS_FILE)
    payload = {"S": int(S),
               "anchors": [[float(w), float(h)] for w, h in anchors]}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def persist_anchors(ckpt_dir: str, anchors, S: int,
                    has_snapshots: bool) -> str | None:
    """``save_anchors``, refusing to re-prior a run.

    Every snapshot in ``ckpt_dir`` decodes with its ``anchors.json``.
    When the dir holds snapshots (``has_snapshots``) and the priors they
    decode with (the file's, else the classic ones) differ from
    ``anchors``, this exits with an error instead of writing; when they
    match, the file is left as it is. Returns the path written, or None.
    """
    new = np.asarray([[float(w), float(h)] for w, h in anchors])
    stored = load_anchors(ckpt_dir, S)
    if has_snapshots:
        effective = (stored if stored is not None
                     else yolo_v2_config(int(S) * 32).anchors)
        effective = np.asarray(effective, np.float64).reshape(-1, 2)
        if (effective.shape != new.shape
                or not np.allclose(effective, new, rtol=1e-5, atol=1e-6)):
            raise SystemExit(
                f"{ckpt_dir} already contains snapshots trained against "
                f"different anchor priors ({effective.tolist()} vs this "
                f"run's {new.tolist()}). Retraining here would silently "
                "re-prior their decode. Move/delete the old snapshots or "
                "train under a different run root (TFY2_ROOT).")
        if stored is not None:
            return None  # the same priors are there already
    return save_anchors(ckpt_dir, anchors, S)


def load_anchors(ckpt_dir: str, S: int
                 ) -> tuple[tuple[float, float], ...] | None:
    """Priors from ``ckpt_dir/anchors.json`` rescaled to grid size S, or
    None when there is no such file.

    Like ``YoloConfig.at_scale`` they rescale linearly with S (constant
    as image fractions), so a snapshot serves at any 32·k resolution.
    """
    path = os.path.join(ckpt_dir, ANCHORS_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        payload = json.load(f)
    factor = S / float(payload["S"])
    return tuple((w * factor, h * factor) for w, h in payload["anchors"])


def v2_config_for_snapshot(snapshot_dir: str | None, image_size: int,
                           external_weights: bool = False) -> YoloConfig:
    """Anchor-head config with the priors of ``snapshot_dir/anchors.json``,
    else (no file, or no directory) the classic VOC priors.
    ``external_weights`` (imported TF checkpoints) skips the lookup: a
    stale ``anchors.json`` of an unrelated training run must not re-prior
    an imported checkpoint, which decodes with the classic priors."""
    stored = None
    if snapshot_dir is not None and not external_weights:
        stored = load_anchors(snapshot_dir, image_size // 32)
    return yolo_v2_config(image_size, anchors=stored)
