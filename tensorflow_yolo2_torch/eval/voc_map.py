"""VOC-style mAP@IoU evaluator (a copy of
tensorflow_yolo2_tpu/eval/voc_map.py, which imports only numpy).

The Pascal VOC average-precision protocol:

- per class: rank all detections by score across the dataset, greedy-match
  each to the best unmatched ground-truth box with IoU ≥ threshold;
  matched → TP, otherwise FP; each GT matches at most once;
- AP = area under the interpolated precision/recall curve: the VOC2010+
  "all points" integration (default) or the VOC07 11-point variant;
- mAP = mean AP over classes with ≥1 GT box.

Matching runs on the host in numpy; the detections come from the decode +
NMS on the device (``entries.pascal_eval_map.run_eval``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def _np_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one (4,) corners box vs (N, 4)."""
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-10)


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a recall/precision curve."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class VocMapEvaluator:
    """Accumulates per-image detections + ground truth, reports mAP."""

    def __init__(self, num_classes: int, iou_thresh: float = 0.5,
                 use_07_metric: bool = False):
        self.num_classes = num_classes
        self.iou_thresh = iou_thresh
        self.use_07_metric = use_07_metric
        self.reset()

    def reset(self) -> None:
        # per class: list of (image_id, score, box)
        self._dets: dict[int, list] = defaultdict(list)
        # per (class, image): array of GT boxes
        self._gts: dict[tuple[int, int], list] = defaultdict(list)
        self._n_images = 0

    def add_image(self, image_id: int,
                  det_boxes: np.ndarray, det_scores: np.ndarray,
                  det_classes: np.ndarray,
                  gt_boxes: np.ndarray, gt_classes: np.ndarray) -> None:
        """All boxes are (N, 4) corners in any consistent coordinate frame;
        detections with score <= 0 are ignored (masked NMS slots)."""
        self._n_images += 1
        for b, s, c in zip(det_boxes, det_scores, det_classes):
            if s > 0:
                self._dets[int(c)].append((image_id, float(s), np.asarray(b)))
        for b, c in zip(gt_boxes, gt_classes):
            self._gts[(int(c), image_id)].append(np.asarray(b))

    def add_label_grid(self, image_id: int, det_boxes, det_scores,
                       det_classes, label_grid: np.ndarray,
                       image_size: int) -> None:
        """Convenience: pull GT from a (S, S, 5+C) YOLO label grid — or
        the per-slot (S, S, B, 5+C) anchor-mode grid, every responsible
        slot contributing one object; the stored pixel cxcywh
        (pascal_voc label layout) is converted to [0, 1] corners to
        match decoded detections."""
        if label_grid.ndim == 4:  # per-slot: flatten slots into cells
            label_grid = label_grid.reshape(
                label_grid.shape[0], -1, label_grid.shape[-1])
        resp = label_grid[..., 0] > 0
        ys, xs = np.nonzero(resp)
        gt_boxes, gt_classes = [], []
        for y, x in zip(ys, xs):
            cx, cy, w, h = label_grid[y, x, 1:5] / float(image_size)
            gt_boxes.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
            gt_classes.append(int(np.argmax(label_grid[y, x, 5:])))
        self.add_image(image_id, np.asarray(det_boxes),
                       np.asarray(det_scores), np.asarray(det_classes),
                       np.asarray(gt_boxes).reshape(-1, 4),
                       np.asarray(gt_classes, np.int32))

    def class_ap(self, cls: int) -> float | None:
        gt_count = sum(len(v) for (c, _), v in self._gts.items() if c == cls)
        if gt_count == 0:
            return None
        dets = sorted(self._dets.get(cls, []), key=lambda d: -d[1])
        matched: dict[int, np.ndarray] = {}
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (img, _score, box) in enumerate(dets):
            gts = self._gts.get((cls, img), [])
            if not gts:
                fp[i] = 1
                continue
            arr = np.stack(gts)
            ious = _np_iou(box, arr)
            j = int(np.argmax(ious))
            if img not in matched:
                matched[img] = np.zeros(len(gts), bool)
            if ious[j] >= self.iou_thresh and not matched[img][j]:
                matched[img][j] = True
                tp[i] = 1
            else:
                fp[i] = 1
        if len(dets) == 0:
            return 0.0
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / gt_count
        precision = ctp / np.maximum(ctp + cfp, 1e-10)
        return voc_ap(recall, precision, self.use_07_metric)

    def mean_ap(self) -> tuple[float, dict[int, float]]:
        aps = {}
        for cls in range(self.num_classes):
            ap = self.class_ap(cls)
            if ap is not None:
                aps[cls] = ap
        mAP = float(np.mean(list(aps.values()))) if aps else 0.0
        return mAP, aps
