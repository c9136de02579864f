"""Fused grid decode and decode + greedy NMS: CUDA kernels and their plain
PyTorch versions (port of tensorflow_yolo2_tpu/ops/pallas_decode.py).

Three kernels, in ``csrc/decode.cu``:

- ``decode_grid_fused`` replaces ``decode_grid_pallas`` (``_decode_kernel``):
  the v1 dense decode, boxes (N, S·S·B, 4), scores and classes (N, S·S·B)
  in slot order ``cell·B + b``. One thread per cell; a block stages its
  run of cells with 16-byte loads, all in flight at once, and writes each
  output as one contiguous run of 16-byte stores. It reads the grid once
  and writes the slots once, so it is bound by bytes: at batch 256, 448²
  (S=14) it reads 6.02 MB and writes 2.41 MB, ≈2.5 µs at 3.35 TB/s.
- ``decode_nms_fused`` on a v1 grid replaces ``decode_nms_pallas``'s
  ``_decode_nms_kernel`` + ``_nms_sweep``: decode, confidence threshold
  and K greedy class-aware NMS steps, K kept slots per image. One block
  per image: the grid staged in shared memory a chunk at a time while
  the previous chunk is decoded, the candidates (score > 0) sorted once
  by buckets of their scores, then a greedy scan over chunks of 32
  sorted candidates with two block barriers a chunk. Its bytes bound at
  batch 256, 448² is ≈1.9 µs (6.02 MB in, 0.20 MB out).
- ``decode_nms_fused`` on a ``per_slot_classes`` grid replaces
  ``_decode_nms_v2_kernel``: the YOLOv2 anchor decode (σ xy, anchor ·
  exp(clip(t, ±8)) / S wh, per-slot argmax, score σ(conf) / Σ exp(l −
  l_max)) feeding the same sort and scan. At batch 256, 416² (S=13,
  B=5) it reads 21.6 MB, ≈6.5 µs at 3.35 TB/s.

``*_plain`` are the same functions in plain PyTorch. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
its kernel or raises. ``DECODE_GRID_LAUNCHES`` / ``DECODE_NMS_LAUNCHES`` /
``DECODE_NMS_V2_LAUNCHES`` count kernel launches.

The NMS picks the highest alive score with ties going to the lowest key
``b·S·S + cell`` (the TPU kernel's rule, not ``nms_fixed``'s argsort
order); the picked box's area is recomputed from its corners while each
candidate keeps the ``w·h`` of its decode. Scores of empty kept slots are
0, and their boxes and classes are 0 too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tensorflow_yolo2_torch.config import YoloConfig
from tensorflow_yolo2_torch.ops.boxes import (
    Detections,
    anchor_tensor,
    decode_grid,
    grid_to_absolute_v2,
    sigmoid,
    split_grid,
    split_grid_v2,
)
from tensorflow_yolo2_torch.ops.iou import cxcywh_to_corners
from tensorflow_yolo2_torch.utils import cuda_build

DECODE_GRID_LAUNCHES = 0
DECODE_NMS_LAUNCHES = 0
DECODE_NMS_V2_LAUNCHES = 0


def reset_launch_counts() -> None:
    global DECODE_GRID_LAUNCHES, DECODE_NMS_LAUNCHES, DECODE_NMS_V2_LAUNCHES
    DECODE_GRID_LAUNCHES = 0
    DECODE_NMS_LAUNCHES = 0
    DECODE_NMS_V2_LAUNCHES = 0


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entries of a library built from ``csrc/decode.cu``."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfy2_decode_grid.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                     f32, ptr]
    lib.tfy2_decode_grid.restype = i32
    lib.tfy2_decode_nms.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                    f32, f32, i32, i32, ptr]
    lib.tfy2_decode_nms.restype = i32
    lib.tfy2_decode_nms_v2.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, f32, f32, i32, i32, ptr]
    lib.tfy2_decode_nms_v2.restype = i32
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(cuda_build.load("decode"))


def _check_grid(net: torch.Tensor, cfg: YoloConfig) -> None:
    want = (cfg.S, cfg.S, cfg.cell_channels)
    if net.dim() != 4 or tuple(net.shape[1:]) != want:
        raise ValueError(f"grid must be (N, {cfg.S}, {cfg.S}, "
                         f"{cfg.cell_channels}), got {tuple(net.shape)}")
    if net.dtype != torch.float32:
        raise TypeError(f"grid must be float32, got {net.dtype}")
    if net.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {net.device}")
    if net.device.type == "cuda" and not net.is_contiguous():
        raise ValueError("the CUDA kernels read a contiguous grid")


def _check_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# Dense decode (B3)
# ---------------------------------------------------------------------------


def decode_grid_plain(net: torch.Tensor, cfg: YoloConfig,
                      object_thresh: float = 0.5) -> Detections:
    """Plain version of ``decode_grid_fused``: ``ops.boxes.decode_grid``
    over the batch."""
    return decode_grid(net, cfg, object_thresh)


def decode_grid_fused(net: torch.Tensor, cfg: YoloConfig,
                      object_thresh: float = 0.5) -> Detections:
    """Dense decode of a (N, S, S, 5B+C) float32 grid.

    Returns boxes (N, S·S·B, 4), scores and classes (N, S·S·B) in slot
    order ``cell·B + b``.
    """
    global DECODE_GRID_LAUNCHES
    if cfg.per_slot_classes:
        raise ValueError("decode_grid_fused decodes the v1 layout; a "
                         "per_slot_classes grid decodes with "
                         "ops.boxes.decode_grid_v2")
    _check_grid(net, cfg)
    if net.device.type == "cpu":
        return decode_grid_plain(net, cfg, object_thresh)
    batch, n = net.shape[0], cfg.S * cfg.S * cfg.B
    boxes = torch.empty((batch, n, 4), dtype=torch.float32, device=net.device)
    scores = torch.empty((batch, n), dtype=torch.float32, device=net.device)
    classes = torch.empty((batch, n), dtype=torch.int32, device=net.device)
    if batch == 0:
        return Detections(boxes, scores, classes)
    with torch.cuda.device(net.device):
        err = _lib().tfy2_decode_grid(
            net.data_ptr(), boxes.data_ptr(), scores.data_ptr(),
            classes.data_ptr(), batch, cfg.S, cfg.B, cfg.num_class,
            float(object_thresh), _stream(net.device))
    _check_error(err, "tfy2_decode_grid")
    DECODE_GRID_LAUNCHES += 1
    return Detections(boxes, scores, classes)


# ---------------------------------------------------------------------------
# Decode + greedy NMS (B1)
# ---------------------------------------------------------------------------


def _slot_major(t: torch.Tensor, S: int, B: int) -> torch.Tensor:
    """(N, S·S·B, ...) in ``cell·B + b`` order → key order ``b·S·S + cell``."""
    batch = t.shape[0]
    t = t.reshape((batch, S * S, B) + t.shape[2:]).transpose(1, 2)
    return t.reshape((batch, S * S * B) + t.shape[3:])


def _greedy_sweep(boxes: torch.Tensor, area: torch.Tensor,
                  scores: torch.Tensor, cls: torch.Tensor, K: int,
                  iou_thresh: float, class_aware: bool) -> Detections:
    """The K greedy NMS steps that both decode+NMS kernels run, one tensor
    op at a time over the batch.

    Takes the decoded slots in key order: corners (N, n, 4), the decode's
    w·h (N, n), thresholded scores (N, n) and classes (N, n).
    """
    batch, n = scores.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    keys = torch.arange(n, device=scores.device)
    alive = scores > 0.0
    out_b = torch.zeros((batch, K, 4), dtype=torch.float32,
                        device=scores.device)
    out_s = torch.zeros((batch, K), dtype=torch.float32, device=scores.device)
    out_c = torch.zeros((batch, K), dtype=torch.int32, device=scores.device)
    for k in range(K):
        m = torch.where(alive, scores, -1.0).amax(dim=1)
        valid = m > 0.0
        is_max = alive & (scores == m[:, None])
        pick = torch.where(is_max, keys, n).amin(dim=1)
        idx = pick.clamp(max=n - 1)
        picked = boxes.gather(1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
        b = torch.where(valid[:, None], picked, 0.0)
        bcls = torch.where(valid, cls.gather(1, idx[:, None])[:, 0], 0)
        bx1, by1, bx2, by2 = (v[:, None] for v in b.unbind(-1))
        out_b[:, k] = b
        out_s[:, k] = torch.where(valid, m, 0.0)
        out_c[:, k] = bcls

        barea = (bx2 - bx1) * (by2 - by1)
        iw = torch.clamp(torch.minimum(x2, bx2) - torch.maximum(x1, bx1),
                         min=0.0)
        ih = torch.clamp(torch.minimum(y2, by2) - torch.maximum(y1, by1),
                         min=0.0)
        inter = iw * ih
        iou = torch.clamp(inter / torch.clamp(area + barea - inter, min=1e-10),
                          0.0, 1.0)
        kill = iou > iou_thresh
        if class_aware:
            kill &= cls == bcls[:, None]
        alive &= ~((kill | (keys == pick[:, None])) & valid[:, None])
    return Detections(out_b, out_s, out_c)


def decode_nms_plain(net: torch.Tensor, cfg: YoloConfig,
                     object_thresh: float = 0.5, iou_thresh: float = 0.5,
                     max_outputs: int = 32,
                     class_aware: bool = True) -> Detections:
    """Plain version of ``decode_nms_fused`` on a v1 grid (B1):
    ``decode_grid``, then the K-step sweep."""
    S, B = cfg.S, cfg.B
    boxes, scores, cls = (_slot_major(t, S, B)
                          for t in decode_grid(net, cfg, object_thresh))
    _, _, raw = split_grid(net, cfg)
    raw = _slot_major(raw.reshape(net.shape[0], S * S * B, 4), S, B)
    area = torch.square(raw[..., 2]) * torch.square(raw[..., 3])
    return _greedy_sweep(boxes, area, scores, cls, max_outputs, iou_thresh,
                         class_aware)


def decode_nms_v2_plain(net: torch.Tensor, cfg: YoloConfig,
                        object_thresh: float = 0.5, iou_thresh: float = 0.5,
                        max_outputs: int = 32,
                        class_aware: bool = True) -> Detections:
    """Plain version of ``decode_nms_fused`` on a ``per_slot_classes``
    grid (B2): the anchor decode of ``_decode_nms_v2_kernel``, then the
    K-step sweep.

    The score is σ(conf) / Σ_c exp(l_c − l_max), the sum taken class by
    class from c = 0 as the kernel takes it (a ``torch.sum`` adds in
    another order); boxes are ``grid_to_absolute_v2``'s.
    """
    S, B = cfg.S, cfg.B
    batch, n = net.shape[0], S * S * B
    logits, conf, raw = split_grid_v2(net, cfg)
    xywh = grid_to_absolute_v2(raw, cfg)
    best = logits.amax(dim=-1)
    denom = torch.zeros_like(best)
    for c in range(cfg.num_class):
        denom = denom + torch.exp(logits[..., c] - best)
    score = sigmoid(conf) / denom
    scores = torch.where(score > object_thresh, score, 0.0)
    cls = logits.argmax(dim=-1).to(torch.int32)
    boxes = cxcywh_to_corners(xywh).reshape(batch, n, 4)
    area = (xywh[..., 2] * xywh[..., 3]).reshape(batch, n)
    return _greedy_sweep(
        _slot_major(boxes, S, B), _slot_major(area, S, B),
        _slot_major(scores.reshape(batch, n), S, B),
        _slot_major(cls.reshape(batch, n), S, B),
        max_outputs, iou_thresh, class_aware)


def decode_nms_fused(net: torch.Tensor, cfg: YoloConfig,
                     object_thresh: float = 0.5, iou_thresh: float = 0.5,
                     max_outputs: int = 32,
                     class_aware: bool = True) -> Detections:
    """Decode + confidence threshold + greedy NMS of a (N, S, S, cc)
    float32 grid, cc = ``cfg.cell_channels``: the v1 kernel, or the
    anchor kernel for a ``per_slot_classes`` config.

    Returns boxes (N, K, 4), scores (N, K) score-descending and classes
    (N, K) int32 for K = ``max_outputs``; empty slots have score 0.
    """
    global DECODE_NMS_LAUNCHES, DECODE_NMS_V2_LAUNCHES
    _check_grid(net, cfg)
    if max_outputs < 1:
        raise ValueError(f"max_outputs must be >= 1, got {max_outputs}")
    v2 = cfg.per_slot_classes
    if net.device.type == "cpu":
        plain = decode_nms_v2_plain if v2 else decode_nms_plain
        return plain(net, cfg, object_thresh, iou_thresh, max_outputs,
                     class_aware)
    batch, K = net.shape[0], max_outputs
    boxes = torch.empty((batch, K, 4), dtype=torch.float32, device=net.device)
    scores = torch.empty((batch, K), dtype=torch.float32, device=net.device)
    classes = torch.empty((batch, K), dtype=torch.int32, device=net.device)
    if batch == 0:
        return Detections(boxes, scores, classes)
    outs = (boxes.data_ptr(), scores.data_ptr(), classes.data_ptr())
    args = (batch, cfg.S, cfg.B, cfg.num_class, float(object_thresh),
            float(iou_thresh), K, int(class_aware), _stream(net.device))
    with torch.cuda.device(net.device):
        if v2:
            anchors = anchor_tensor(cfg, net.device)
            err = _lib().tfy2_decode_nms_v2(net.data_ptr(),
                                            anchors.data_ptr(), *outs, *args)
        else:
            err = _lib().tfy2_decode_nms(net.data_ptr(), *outs, *args)
    _check_error(err, "tfy2_decode_nms_v2" if v2 else "tfy2_decode_nms")
    if v2:
        DECODE_NMS_V2_LAUNCHES += 1
    else:
        DECODE_NMS_LAUNCHES += 1
    return Detections(boxes, scores, classes)
