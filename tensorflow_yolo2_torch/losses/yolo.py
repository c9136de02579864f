"""The YOLOv1 grid loss (port of tensorflow_yolo2_tpu/losses/yolo.py).

Sum-squared loss over an S×S grid with B box slots per cell: class MSE on
responsible cells; coordinate loss on the cell-relative (x, y, √w, √h)
deltas × λ_coord for the responsible box; object loss (confidence
regressed to the live IoU); no-object confidence loss × λ_noobj. Each
term is the batch mean of a sum over the grid.

- The responsible box is the per-cell IoU argmax by ``ious >= cell_max``
  (ties mark both boxes) on responsible cells; the comparison carries no
  gradient, while the IoU inside the object delta does.
- Labels are the (S, S, 5+C) grid ``[responsible, cx, cy, w, h (pixels
  of the resized image), one-hot class]`` of ``data.voc.build_label_grid``.
- The loss runs in float32 whatever the network's compute type.
- Every term is a sum of per-cell squares, so the loss over a
  row-sharded grid is the sum of the shards' term sums
  (``yolo_loss_term_sums`` with ``offsets``, parallel.spatial).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tensorflow_yolo2_torch.config import YoloConfig
from tensorflow_yolo2_torch.ops.boxes import (
    grid_to_absolute,
    offset_tensor,
    split_grid,
)
from tensorflow_yolo2_torch.ops.iou import box_iou


class YoloLossAux(NamedTuple):
    """The four loss terms and the live tensors behind the metrics."""

    class_loss: torch.Tensor
    object_loss: torch.Tensor
    noobject_loss: torch.Tensor
    coord_loss: torch.Tensor
    ious: torch.Tensor         # (batch, S, S, B)
    object_mask: torch.Tensor  # (batch, S, S, B)


def yolo_loss_term_sums(net: torch.Tensor, labels: torch.Tensor,
                        cfg: YoloConfig, offsets=None):
    """Per-image λ-weighted sums over the grid of the four loss terms.

    ``offsets``, a ``(col_offset, row_offset)`` pair of (rows, S, B)
    tensors with global row indices, replaces ``cfg.offset`` and its
    transpose for a shard that owns ``rows`` grid rows. Returns
    ``(class_s, object_s, noobject_s, coord_s, ious, object_mask)``, the
    four sums shaped (batch,).
    """
    net = net.float()
    labels = labels.float()
    S, B = cfg.S, cfg.B

    predict_classes, predict_conf, predict_boxes = split_grid(net, cfg)

    responsible = labels[..., 0:1]  # (batch, S, S, 1)
    class_delta = responsible * (predict_classes - labels[..., 5:])
    class_s = torch.sum(torch.square(class_delta), dim=(1, 2, 3))

    # both box sets as absolute cxcywh in [0, 1]
    gt_boxes = labels[..., 1:5][:, :, :, None, :]
    gt_boxes = gt_boxes.expand(gt_boxes.shape[:3] + (B, 4)) / \
        float(cfg.image_size)
    ious = box_iou(grid_to_absolute(predict_boxes, cfg, offsets), gt_boxes)

    cell_max = torch.amax(ious, dim=3, keepdim=True)
    object_mask = (ious >= cell_max).float() * responsible
    noobject_mask = 1.0 - object_mask

    if offsets is None:
        offset = offset_tensor(cfg, net.device)  # (S, S, B)
        offset_t = offset.permute(1, 0, 2)
    else:
        offset, offset_t = offsets
    gt_rel = torch.stack([gt_boxes[..., 0] * S - offset,
                          gt_boxes[..., 1] * S - offset_t,
                          torch.sqrt(gt_boxes[..., 2]),
                          torch.sqrt(gt_boxes[..., 3])], dim=-1)
    boxes_delta = object_mask[..., None] * (predict_boxes - gt_rel)
    coord_s = torch.sum(torch.square(boxes_delta),
                        dim=(1, 2, 3, 4)) * cfg.lambda_coord

    object_delta = object_mask * (predict_conf - ious)
    object_s = torch.sum(torch.square(object_delta), dim=(1, 2, 3))
    noobject_delta = noobject_mask * predict_conf
    noobject_s = torch.sum(torch.square(noobject_delta),
                           dim=(1, 2, 3)) * cfg.lambda_noobj

    return class_s, object_s, noobject_s, coord_s, ious, object_mask


def yolo_loss(net: torch.Tensor, labels: torch.Tensor,
              cfg: YoloConfig) -> tuple[torch.Tensor, YoloLossAux]:
    """The YOLOv1 grid loss of a (batch, S, S, 5B+C) head output against
    (batch, S, S, 5+C) labels: (total, ``YoloLossAux``)."""
    class_s, object_s, noobject_s, coord_s, ious, object_mask = \
        yolo_loss_term_sums(net, labels, cfg)
    class_loss = class_s.mean()
    object_loss = object_s.mean()
    noobject_loss = noobject_s.mean()
    coord_loss = coord_s.mean()
    total = class_loss + object_loss + noobject_loss + coord_loss
    return total, YoloLossAux(class_loss, object_loss, noobject_loss,
                              coord_loss, ious, object_mask)
