"""Fixed-shape greedy NMS (port of tensorflow_yolo2_tpu/ops/nms.py).

Sort by score once, run a static N-step suppression sweep, keep the
``max_outputs`` best survivors; suppressed and invalid boxes keep a slot
with score 0.
"""

from __future__ import annotations

import torch

from tensorflow_yolo2_torch.ops.boxes import Detections
from tensorflow_yolo2_torch.ops.iou import pairwise_corners_iou


def nms_fixed(dets: Detections, iou_thresh: float = 0.5,
              max_outputs: int = 32, class_aware: bool = True) -> Detections:
    """Greedy NMS over one image's dense detections (N, 4) / (N,).

    Candidates with score 0 never survive. When ``class_aware``, boxes only
    suppress boxes of the same class. Returns ``min(max_outputs, N)`` slots,
    score-descending.
    """
    boxes, scores, classes = dets
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    boxes = boxes[order]
    scores = scores[order]
    classes = classes[order]

    iou = pairwise_corners_iou(boxes, boxes)  # (N, N)
    suppresses = iou > iou_thresh
    if class_aware:
        suppresses &= classes[:, None] == classes[None, :]

    later = torch.arange(n, device=boxes.device)
    alive = scores > 0.0
    for i in range(n):
        # If candidate i is still alive (and valid), kill everything later
        # in score order that it suppresses.
        kill = suppresses[i] & alive & (later > i)
        alive = torch.where(alive[i] & (scores[i] > 0.0), alive & ~kill, alive)
    kept_scores = torch.where(alive, scores, torch.zeros_like(scores))

    top_scores, top_idx = torch.topk(kept_scores, min(max_outputs, n))
    return Detections(boxes[top_idx], top_scores, classes[top_idx])
