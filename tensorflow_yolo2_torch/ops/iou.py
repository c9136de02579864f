"""Box IoU on tensors (port of tensorflow_yolo2_tpu/ops/iou.py).

Elementwise IoU of co-indexed boxes, clipped to [0, 1] with a 1e-10 union
floor. Shapes are arbitrary leading dims + a trailing 4-dim.
"""

from __future__ import annotations

import torch


def cxcywh_to_corners(b: torch.Tensor) -> torch.Tensor:
    """(..., cx, cy, w, h) -> (..., x1, y1, x2, y2)."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of (..., 4) cxcywh boxes; returns (...)."""
    return corners_iou(cxcywh_to_corners(boxes1), cxcywh_to_corners(boxes2))


def corners_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of (..., 4) (x1, y1, x2, y2) boxes; returns (...)."""
    lu = torch.maximum(b1[..., :2], b2[..., :2])
    rd = torch.minimum(b1[..., 2:], b2[..., 2:])
    inter_wh = torch.clamp(rd - lu, min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = torch.clamp(area1 + area2 - inter, min=1e-10)
    return torch.clamp(inter / union, 0.0, 1.0)


def pairwise_corners_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: (N, 4) × (M, 4) → (N, M)."""
    return corners_iou(b1[:, None, :], b2[None, :, :])
