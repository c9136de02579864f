"""Grid decode: raw head output → corner boxes + scores (port of
tensorflow_yolo2_tpu/ops/boxes.py).

- ``decode_grid``: the YOLOv1 decode, the plain twin of the CUDA decode
  kernels (ops.cuda_decode).
- ``decode_grid_v2``: the YOLOv2 anchor decode of a ``per_slot_classes``
  grid (sigmoid xy, anchor-scaled exp wh, per-slot class softmax). It is
  the serving decode of the anchor heads with NMS off, plain PyTorch as
  the JAX package's is plain jnp.

Everything is fixed-shape: the decode returns dense (…, S·S·B) tensors and
masks invalid slots with score 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tensorflow_yolo2_torch.config import YoloConfig, yolo_grid_offset
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


def grid_to_absolute(raw_boxes: torch.Tensor, cfg: YoloConfig,
                     offsets=None) -> torch.Tensor:
    """YOLOv1 box transform: raw (..., S, S, B, 4) → absolute cxcywh in [0,1].

    x_abs = (tx + col) / S, y_abs = (ty + row) / S, w = tw², h = th².

    ``offsets`` overrides the (column, row) index grids: a ``(col_offset,
    row_offset)`` pair of (rows, S, B) tensors with GLOBAL row indices,
    for a shard that owns only ``rows`` grid rows (parallel.spatial).
    """
    offset, offset_t, S = _grid_terms(raw_boxes, cfg, offsets)
    xs = (raw_boxes[..., 0] + offset) / S
    ys = (raw_boxes[..., 1] + offset_t) / S
    ws = torch.square(raw_boxes[..., 2])
    hs = torch.square(raw_boxes[..., 3])
    return torch.stack([xs, ys, ws, hs], dim=-1)


@functools.cache
def _offset_on(S: int, B: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so
    # that a later train step may use it
    with torch.inference_mode(False):
        return torch.from_numpy(yolo_grid_offset(S, B)).to(device, dtype)


def offset_tensor(cfg: YoloConfig, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``cfg.offset``, the (S, S, B) column offsets, on ``device`` in
    ``dtype``. Cached: a host-to-device copy waits for the card's stream,
    so a train step or a serving call makes none after the first."""
    return _offset_on(cfg.S, cfg.B, torch.device(device), dtype)


def _grid_terms(raw_boxes: torch.Tensor, cfg: YoloConfig, offsets=None):
    """Column and row offsets (S, S, B), or the given ``offsets`` pair,
    and S as a 0-d tensor, on the device and in the dtype of
    ``raw_boxes``."""
    S = torch.full((), float(cfg.S), dtype=raw_boxes.dtype,
                   device=raw_boxes.device)
    if offsets is not None:
        return offsets[0], offsets[1], S
    offset = offset_tensor(cfg, raw_boxes.device, raw_boxes.dtype)
    # Divide by a tensor on the same device, not a Python number: on CUDA
    # PyTorch turns division by a CPU scalar into a multiplication by its
    # reciprocal, which is not the IEEE quotient the kernels compute.
    return offset, offset.permute(1, 0, 2), S


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(−x)), written out: the anchor decode kernel computes
    this formula with the same roundings (``torch.sigmoid`` may not)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


@functools.cache
def _anchors_on(anchors: tuple, B: int, device: torch.device
                ) -> torch.Tensor:
    values = anchors if anchors else ((1.0, 1.0),) * B
    return torch.tensor(values, dtype=torch.float32, device=device)


def anchor_tensor(cfg: YoloConfig, device: torch.device) -> torch.Tensor:
    """The priors (B, 2) in cell units as float32 on ``device``, (1, 1)
    each when ``cfg.anchors`` is empty. The doubles of the config are
    rounded to float32 once, here; the plain decode and the kernel
    multiply by these values. Cached, so that a call on the card makes
    no host-to-device copy after the first."""
    return _anchors_on(tuple(cfg.anchors), cfg.B, torch.device(device))


def split_grid_v2(net: torch.Tensor, cfg: YoloConfig):
    """Split a per-slot (..., S, S, B·(5+C)) grid into (class logits
    (..., S, S, B, C), conf logits (..., S, S, B), raw boxes
    (..., S, S, B, 4)); each slot is ``(x, y, w, h, conf, C logits)``."""
    slots = net.reshape(net.shape[:-1] + (cfg.B, 5 + cfg.num_class))
    return slots[..., 5:], slots[..., 4], slots[..., :4]


def grid_to_absolute_v2(raw_boxes: torch.Tensor, cfg: YoloConfig,
                        offsets=None) -> torch.Tensor:
    """YOLOv2 anchor transform: raw (..., S, S, B, 4) → cxcywh in [0, 1].

    x = (σ(tx) + col)/S, y = (σ(ty) + row)/S, w = (anchor_w·exp(tw))/S,
    h likewise; tw, th are clipped to ±8 before the exp so that it stays
    finite. ``offsets`` as in ``grid_to_absolute``.
    """
    offset, offset_t, S = _grid_terms(raw_boxes, cfg, offsets)
    anchors = anchor_tensor(cfg, raw_boxes.device).to(raw_boxes.dtype)
    xs = (sigmoid(raw_boxes[..., 0]) + offset) / S
    ys = (sigmoid(raw_boxes[..., 1]) + offset_t) / S
    tw = torch.clamp(raw_boxes[..., 2], -8.0, 8.0)
    th = torch.clamp(raw_boxes[..., 3], -8.0, 8.0)
    ws = anchors[:, 0] * torch.exp(tw) / S
    hs = anchors[:, 1] * torch.exp(th) / S
    return torch.stack([xs, ys, ws, hs], dim=-1)


def decode_grid(net: torch.Tensor, cfg: YoloConfig,
                object_thresh: float = 0.5) -> Detections:
    """Reference-parity decode of (..., S, S, 5B+C) predictions.

    Score = raw confidence, zeroed at or below ``object_thresh``; class =
    per-cell argmax (the first maximum wins). Slots are in ``cell·B + b``
    order: boxes (..., S·S·B, 4), scores and classes (..., S·S·B).
    """
    if cfg.per_slot_classes:
        raise ValueError("decode_grid decodes the v1 layout; a "
                         "per_slot_classes grid decodes with decode_grid_v2")
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


def decode_grid_v2(net: torch.Tensor, cfg: YoloConfig,
                   object_thresh: float = 0.5) -> Detections:
    """YOLOv2 anchor decode of (..., S, S, B·(5+C)) predictions.

    Score = σ(conf) × the largest per-slot class softmax probability,
    zeroed at or below ``object_thresh``; class = per-slot argmax. Slots
    are in ``cell·B + b`` order: boxes (..., S·S·B, 4), scores and
    classes (..., S·S·B).
    """
    if not cfg.per_slot_classes:
        raise ValueError("decode_grid_v2 needs a per_slot_classes config")
    cls_logits, conf, raw_boxes = split_grid_v2(net, cfg)
    corners = cxcywh_to_corners(grid_to_absolute_v2(raw_boxes, cfg))
    cls_prob = torch.softmax(cls_logits, dim=-1)
    best, cls_idx = torch.max(cls_prob, dim=-1)
    score = sigmoid(conf) * best
    scores = torch.where(score > object_thresh, score,
                         torch.zeros_like(score))
    lead = net.shape[:-3]
    n = cfg.S * cfg.S * cfg.B
    return Detections(corners.reshape(lead + (n, 4)),
                      scores.reshape(lead + (n,)),
                      cls_idx.to(torch.int32).reshape(lead + (n,)))


def decode_to_detections(net: torch.Tensor, cfg: YoloConfig,
                         object_thresh: float = 0.5,
                         v2: bool = False) -> Detections:
    """Decode with either family."""
    if v2:
        return decode_grid_v2(net, cfg, object_thresh)
    return decode_grid(net, cfg, object_thresh)
