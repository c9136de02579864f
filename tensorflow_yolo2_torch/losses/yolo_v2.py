"""The YOLOv2 anchor loss (port of tensorflow_yolo2_tpu/losses/yolo_v2.py).

The head predicts per-anchor slots ``(tx, ty, tw, th, conf, C class
logits)``, decoded as sigmoid xy and anchor-scaled exp wh
(``ops.boxes.grid_to_absolute_v2``). The terms, each the batch mean of a
sum over the grid:

- anchor assignment: in a responsible cell, the anchor whose shape (w, h,
  centred) best IoU-matches the ground-truth box owns it, ties to the
  lowest index;
- coordinates: (σ(tx), σ(ty)) against the cell-relative centre and (tw,
  th) against log(gt / anchor), × λ_coord, on owner slots; with
  ``cfg.v2_coord_scale`` each object's term is scaled by (2 − w·h);
- objectness: σ(conf) regressed to the live IoU of the decoded box on
  owner slots (the IoU carries no gradient); σ(conf)² × λ_noobj on the
  other slots, except those whose decoded box overlaps any ground-truth
  box of the image by more than ``cfg.v2_ignore_iou`` (no gradient
  through that test either);
- burn-in: while ``step · batch < cfg.v2_burnin_samples``, non-owner raw
  boxes are regressed toward their prior at the cell centre with weight
  ``cfg.v2_prior_weight``; off when ``step`` is None (evaluation);
- classes: softmax cross-entropy on the owner slot's logits.

Two label layouts: the (batch, S, S, 5+C) v1 grid
(``data.voc.build_label_grid``, one object a cell, assigned to an anchor
here) and the per-slot (batch, S, S, B, 5+C) grid
(``data.voc.build_label_grid_v2``, each object already in its best free
slot). The loss runs in float32 whatever the network's compute type.

Every term but the ignore test is a per-cell sum, so the loss splits
over grid rows; the keyword hooks of ``yolo_v2_loss`` give a shard its
global row offsets, the whole image's ground-truth boxes for the ignore
test, and a mask of its padding rows (parallel.spatial).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from tensorflow_yolo2_torch.config import YoloConfig
from tensorflow_yolo2_torch.ops.boxes import (
    anchor_tensor,
    grid_to_absolute_v2,
    offset_tensor,
    split_grid_v2,
)
from tensorflow_yolo2_torch.ops.iou import box_iou


class YoloV2LossAux(NamedTuple):
    """The five loss terms and the live tensors behind the metrics."""

    class_loss: torch.Tensor
    object_loss: torch.Tensor
    noobject_loss: torch.Tensor
    coord_loss: torch.Tensor
    burnin_loss: torch.Tensor
    ious: torch.Tensor        # (batch, S, S, B) decoded box vs its gt
    owner_mask: torch.Tensor  # (batch, S, S, B)


def _anchor_shape_iou(anchors: torch.Tensor,
                      gt_wh: torch.Tensor) -> torch.Tensor:
    """Shape-only IoU of centred anchors (B, 2) and boxes (..., 2), both
    in grid-cell units."""
    inter = torch.minimum(anchors[..., 0], gt_wh[..., 0]) * \
        torch.minimum(anchors[..., 1], gt_wh[..., 1])
    union = anchors[..., 0] * anchors[..., 1] + \
        gt_wh[..., 0] * gt_wh[..., 1] - inter
    return inter / torch.clamp(union, min=1e-10)


def yolo_v2_loss(net: torch.Tensor, labels: torch.Tensor, cfg: YoloConfig,
                 step: int | None = None, *, offsets=None, ignore_gt=None,
                 noobj_valid=None) -> tuple[torch.Tensor, YoloV2LossAux]:
    """The YOLOv2 loss of a (batch, S, S, B·(5+C)) head output against
    (batch, S, S, 5+C) or (batch, S, S, B, 5+C) labels: (total,
    ``YoloV2LossAux``). ``step``, the optimizer's step count before this
    update, switches the burn-in term on; None leaves it off.

    The keyword hooks make the loss row-splittable (the spatially
    sharded trainer, parallel.spatial):

    - ``offsets``: ``(col_offset, row_offset)``, (rows, S, B) tensors
      with global row indices, in place of ``cfg.offset`` and its
      transpose, for a shard that owns ``rows`` grid rows;
    - ``ignore_gt``: ``(gt_all, gt_valid)``, (batch, N, 4) and (batch, N):
      the whole image's ground-truth boxes (fractions) and their
      validity, in place of the shard's own in the ignore test;
    - ``noobj_valid``: a mask broadcastable to (batch, rows, S, B) that
      takes padding rows out of the no-object term (σ(0)² is not 0).
    """
    if not (cfg.per_slot_classes and cfg.anchors):
        raise ValueError("yolo_v2_loss needs the per-slot head layout with "
                         "anchor priors (config.yolo_v2_config)")
    net = net.float()
    labels = labels.float()
    S, B = cfg.S, cfg.B
    anchors = anchor_tensor(cfg, net.device)   # (B, 2), cell units
    if offsets is None:
        offset = offset_tensor(cfg, net.device)  # (S, S, B), column index
        offset_t = offset.permute(1, 0, 2)
    else:
        offset, offset_t = offsets

    cls_logits, conf, raw_boxes = split_grid_v2(net, cfg)

    if labels.dim() == 4:
        # the v1 grid, one object a cell: its best-shaped anchor owns it
        responsible = labels[..., 0]
        gt_px = labels[..., 1:5] / float(cfg.image_size)
        shape_iou = _anchor_shape_iou(anchors, gt_px[..., None, 2:4] * S)
        owner = F.one_hot(torch.argmax(shape_iou, dim=-1), B).float() * \
            responsible[..., None]
        gt_slot = gt_px[..., None, :].expand(gt_px.shape[:3] + (B, 4))
        gt_classes = torch.argmax(labels[..., 5:], dim=-1)[..., None] \
            .expand(owner.shape)
    else:
        # the per-slot grid: the loader put each object in its slot
        if labels.dim() != 5 or labels.shape[3] != B:
            raise ValueError(f"per-slot labels must be (b, S, S, {B}, 5+C), "
                             f"got {tuple(labels.shape)}")
        owner = labels[..., 0]
        gt_slot = labels[..., 1:5] / float(cfg.image_size)
        gt_classes = torch.argmax(labels[..., 5:], dim=-1)

    # -- coordinates, on owner slots --
    gt_wh_slot = torch.clamp(gt_slot[..., 2:4] * S, min=1e-6)
    tx_target = gt_slot[..., 0] * S - offset
    ty_target = gt_slot[..., 1] * S - offset_t
    tw_target = torch.log(gt_wh_slot[..., 0] / anchors[:, 0])
    th_target = torch.log(gt_wh_slot[..., 1] / anchors[:, 1])
    sx = torch.sigmoid(raw_boxes[..., 0])
    sy = torch.sigmoid(raw_boxes[..., 1])
    coord_sq = (torch.square(sx - tx_target) + torch.square(sy - ty_target) +
                torch.square(raw_boxes[..., 2] - tw_target) +
                torch.square(raw_boxes[..., 3] - th_target))
    if cfg.v2_coord_scale:
        coord_sq = coord_sq * (2.0 - gt_slot[..., 2] * gt_slot[..., 3])
    coord_loss = cfg.lambda_coord * torch.mean(
        torch.sum(owner * coord_sq, dim=(1, 2, 3)))

    # -- the decoded boxes' IoUs, which carry no gradient --
    noobj_mask = 1.0 - owner
    if noobj_valid is not None:
        noobj_mask = noobj_mask * noobj_valid
    with torch.no_grad():
        decoded = grid_to_absolute_v2(raw_boxes, cfg, offsets)
        ious = box_iou(decoded, gt_slot)
        # a non-owner slot whose box overlaps any object of its image
        # above the threshold is not suppressed
        b = labels.shape[0]
        if ignore_gt is None:
            gt_all = gt_slot.reshape(b, -1, 4)
            gt_valid = owner.reshape(b, -1)
        else:
            gt_all, gt_valid = ignore_gt
        pair = box_iou(decoded.reshape(b, -1, 1, 4), gt_all[:, None])
        best_any = torch.amax(pair * gt_valid[:, None, :], dim=-1)
        noobj_mask = noobj_mask * (
            best_any.reshape(owner.shape) <= cfg.v2_ignore_iou).float()

    # -- objectness --
    sconf = torch.sigmoid(conf)
    object_loss = torch.mean(torch.sum(
        owner * torch.square(sconf - ious), dim=(1, 2, 3)))
    noobject_loss = cfg.lambda_noobj * torch.mean(torch.sum(
        noobj_mask * torch.square(sconf), dim=(1, 2, 3)))

    # -- burn-in: non-owner boxes toward their prior at the cell centre --
    burnin_loss = torch.zeros((), dtype=torch.float32, device=net.device)
    if step is not None and \
            int(step) * labels.shape[0] < cfg.v2_burnin_samples:
        prior_sq = (torch.square(sx - 0.5) + torch.square(sy - 0.5) +
                    torch.square(raw_boxes[..., 2]) +
                    torch.square(raw_boxes[..., 3]))
        burnin_loss = cfg.v2_prior_weight * torch.mean(
            torch.sum((1.0 - owner) * prior_sq, dim=(1, 2, 3)))

    # -- per-slot class softmax cross-entropy on the owner slot --
    ce = torch.logsumexp(cls_logits, dim=-1) - torch.gather(
        cls_logits, -1, gt_classes[..., None]).squeeze(-1)
    class_loss = torch.mean(torch.sum(owner * ce, dim=(1, 2, 3)))

    total = (coord_loss + object_loss + noobject_loss + class_loss +
             burnin_loss)
    return total, YoloV2LossAux(class_loss, object_loss, noobject_loss,
                                coord_loss, burnin_loss, ious, owner)


def yolo_v2_task(cfg: YoloConfig) -> Callable:
    """Detection task of the anchor heads: (head output, labels, step) →
    (YOLOv2 loss, metrics). The label grid's S picks the re-gridded
    config (``cfg.at_scale``), so one task serves every multiscale size;
    the trainer passes ``step``, which drives the burn-in. Metrics are
    0-d tensors ``loss``, ``class_loss``, ``object_loss``,
    ``noobject_loss``, ``coord_loss``, ``burnin_loss`` and ``mean_iou``
    (the owner slots' IoU)."""

    def task(outputs: torch.Tensor, labels: torch.Tensor,
             step: int | None = None):
        total, aux = yolo_v2_loss(outputs, labels,
                                  cfg.at_scale(labels.shape[1]), step=step)
        metrics = {
            "loss": total,
            "class_loss": aux.class_loss,
            "object_loss": aux.object_loss,
            "noobject_loss": aux.noobject_loss,
            "coord_loss": aux.coord_loss,
            "burnin_loss": aux.burnin_loss,
            "mean_iou": torch.sum(aux.ious * aux.owner_mask) /
            torch.clamp(torch.sum(aux.owner_mask), min=1.0),
        }
        return total, metrics

    return task
