"""YOLOv1 grid decode: raw head output → corner boxes + scores (port of
tensorflow_yolo2_tpu/ops/boxes.py, v1 family).

These are the eager twins of the CUDA decode kernels (ops.cuda_decode).
Everything is fixed-shape: the decode returns dense (…, S·S·B) tensors and
masks invalid slots with score 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tensorflow_yolo2_torch.config import YoloConfig
from tensorflow_yolo2_torch.ops.iou import cxcywh_to_corners


class Detections(NamedTuple):
    """Dense, fixed-shape detections.

    boxes:   (..., N, 4) corners (x1, y1, x2, y2) in [0, 1] image fractions.
    scores:  (..., N) confidence (already threshold-masked to 0 where invalid).
    classes: (..., N) int32 class index.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor


def split_grid(net: torch.Tensor, cfg: YoloConfig):
    """Split a (..., S, S, 5B+C) grid into (classes, conf, boxes).

    Layout per cell is ``[num_class | B conf | B*(x,y,w,h)]``. Returns class
    scores (..., S, S, C), confidences (..., S, S, B) and raw boxes
    (..., S, S, B, 4).
    """
    C, B = cfg.num_class, cfg.B
    classes = net[..., :C]
    conf = net[..., C:C + B]
    boxes = net[..., C + B:].reshape(net.shape[:-1] + (B, 4))
    return classes, conf, boxes


def grid_to_absolute(raw_boxes: torch.Tensor, cfg: YoloConfig) -> torch.Tensor:
    """YOLOv1 box transform: raw (..., S, S, B, 4) → absolute cxcywh in [0,1].

    x_abs = (tx + col) / S, y_abs = (ty + row) / S, w = tw², h = th².
    """
    offset = torch.from_numpy(cfg.offset).to(raw_boxes.device,
                                             raw_boxes.dtype)
    offset_t = offset.permute(1, 0, 2)
    # Divide by a tensor on the same device, not a Python number: on CUDA
    # PyTorch turns division by a CPU scalar into a multiplication by its
    # reciprocal, which is not the IEEE quotient the kernels compute.
    S = torch.full((), float(cfg.S), dtype=raw_boxes.dtype,
                   device=raw_boxes.device)
    xs = (raw_boxes[..., 0] + offset) / S
    ys = (raw_boxes[..., 1] + offset_t) / S
    ws = torch.square(raw_boxes[..., 2])
    hs = torch.square(raw_boxes[..., 3])
    return torch.stack([xs, ys, ws, hs], dim=-1)


def decode_grid(net: torch.Tensor, cfg: YoloConfig,
                object_thresh: float = 0.5) -> Detections:
    """Reference-parity decode of (..., S, S, 5B+C) predictions.

    Score = raw confidence, zeroed at or below ``object_thresh``; class =
    per-cell argmax (the first maximum wins). Slots are in ``cell·B + b``
    order: boxes (..., S·S·B, 4), scores and classes (..., S·S·B).
    """
    if cfg.per_slot_classes:
        raise NotImplementedError(
            "the anchor (per_slot_classes) decode is not ported yet")
    classes, conf, raw_boxes = split_grid(net, cfg)
    corners = cxcywh_to_corners(grid_to_absolute(raw_boxes, cfg))
    cls_idx = torch.argmax(classes, dim=-1).to(torch.int32)  # (..., S, S)
    cls_per_box = cls_idx[..., None].expand(conf.shape)
    scores = torch.where(conf > object_thresh, conf, torch.zeros_like(conf))
    lead = net.shape[:-3]
    n = cfg.S * cfg.S * cfg.B
    return Detections(corners.reshape(lead + (n, 4)),
                      scores.reshape(lead + (n,)),
                      cls_per_box.reshape(lead + (n,)))
