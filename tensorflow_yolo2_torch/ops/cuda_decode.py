"""Fused YOLOv1 decode and decode + greedy NMS: CUDA kernels and their
plain PyTorch versions (port of tensorflow_yolo2_tpu/ops/pallas_decode.py,
v1 layout).

Two kernels, in ``csrc/decode.cu``:

- ``decode_grid_fused`` replaces ``decode_grid_pallas`` (``_decode_kernel``):
  the dense decode, boxes (N, S·S·B, 4), scores and classes (N, S·S·B) in
  slot order ``cell·B + b``. One thread per cell. It reads the grid once
  and writes the slots once, so it is bound by bytes: at batch 256, 448²
  (S=14) it reads 6.02 MB and writes 2.41 MB, ≈2.5 µs at 3.35 TB/s.
- ``decode_nms_fused`` replaces ``decode_nms_pallas`` (``_decode_nms_kernel``
  + ``_nms_sweep``): decode, confidence threshold and K greedy class-aware
  NMS steps, K kept slots per image. One block per image with the
  image's grid staged in shared memory and each slot in a thread's
  registers. Its bytes bound at batch 256, 448² is ≈1.9 µs (6.02 MB in,
  0.20 MB out), but what bounds it is the chain of K dependent
  block-wide max reductions per image, each ending in a __syncthreads.

``*_plain`` are the same functions in plain PyTorch. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
its kernel or raises. ``DECODE_GRID_LAUNCHES`` / ``DECODE_NMS_LAUNCHES``
count kernel launches.

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
    decode_grid,
    split_grid,
)
from tensorflow_yolo2_torch.utils import cuda_build

DECODE_GRID_LAUNCHES = 0
DECODE_NMS_LAUNCHES = 0


def reset_launch_counts() -> None:
    global DECODE_GRID_LAUNCHES, DECODE_NMS_LAUNCHES
    DECODE_GRID_LAUNCHES = 0
    DECODE_NMS_LAUNCHES = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("decode")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfy2_decode_grid.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                     f32, ptr]
    lib.tfy2_decode_grid.restype = i32
    lib.tfy2_decode_nms.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                    f32, f32, i32, i32, ptr]
    lib.tfy2_decode_nms.restype = i32
    return lib


def _check_grid(net: torch.Tensor, cfg: YoloConfig) -> None:
    if cfg.per_slot_classes:
        raise NotImplementedError(
            "the anchor (per_slot_classes) decode kernel is not ported yet")
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


def decode_nms_plain(net: torch.Tensor, cfg: YoloConfig,
                     object_thresh: float = 0.5, iou_thresh: float = 0.5,
                     max_outputs: int = 32,
                     class_aware: bool = True) -> Detections:
    """Plain version of ``decode_nms_fused``: the same K-step sweep, one
    tensor op at a time, over the whole batch."""
    S, B, K = cfg.S, cfg.B, max_outputs
    batch, n = net.shape[0], S * S * B
    dets = decode_grid(net, cfg, object_thresh)
    _, _, raw = split_grid(net, cfg)

    def slot_major(t):  # (N, S·S·B, ...) in cell·B + b order → b·S·S + cell
        t = t.reshape((batch, S * S, B) + t.shape[2:]).transpose(1, 2)
        return t.reshape((batch, n) + t.shape[3:])

    boxes, scores, cls = (slot_major(t) for t in dets)
    raw = slot_major(raw.reshape(batch, n, 4))
    area = torch.square(raw[..., 2]) * torch.square(raw[..., 3])
    x1, y1, x2, y2 = boxes.unbind(-1)

    keys = torch.arange(n, device=net.device)
    alive = scores > 0.0
    out_b = torch.zeros((batch, K, 4), dtype=torch.float32, device=net.device)
    out_s = torch.zeros((batch, K), dtype=torch.float32, device=net.device)
    out_c = torch.zeros((batch, K), dtype=torch.int32, device=net.device)
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


def decode_nms_fused(net: torch.Tensor, cfg: YoloConfig,
                     object_thresh: float = 0.5, iou_thresh: float = 0.5,
                     max_outputs: int = 32,
                     class_aware: bool = True) -> Detections:
    """Decode + confidence threshold + greedy NMS of a (N, S, S, 5B+C)
    float32 grid.

    Returns boxes (N, K, 4), scores (N, K) score-descending and classes
    (N, K) int32 for K = ``max_outputs``; empty slots have score 0.
    """
    global DECODE_NMS_LAUNCHES
    _check_grid(net, cfg)
    if max_outputs < 1:
        raise ValueError(f"max_outputs must be >= 1, got {max_outputs}")
    if net.device.type == "cpu":
        return decode_nms_plain(net, cfg, object_thresh, iou_thresh,
                                max_outputs, class_aware)
    batch, K = net.shape[0], max_outputs
    boxes = torch.empty((batch, K, 4), dtype=torch.float32, device=net.device)
    scores = torch.empty((batch, K), dtype=torch.float32, device=net.device)
    classes = torch.empty((batch, K), dtype=torch.int32, device=net.device)
    if batch == 0:
        return Detections(boxes, scores, classes)
    with torch.cuda.device(net.device):
        err = _lib().tfy2_decode_nms(
            net.data_ptr(), boxes.data_ptr(), scores.data_ptr(),
            classes.data_ptr(), batch, cfg.S, cfg.B, cfg.num_class,
            float(object_thresh), float(iou_thresh), K, int(class_aware),
            _stream(net.device))
    _check_error(err, "tfy2_decode_nms")
    DECODE_NMS_LAUNCHES += 1
    return Detections(boxes, scores, classes)
