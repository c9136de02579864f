"""Darknet19 YOLO detection (port of
tensorflow_yolo2_tpu/entries/pascal_detect_darknet.py, v1 head).

The serving path: a batch of NHWC images → the BN-folded
``Darknet19Detector`` (bf16 by default) → the CUDA decode+NMS kernel
(``ops.cuda_decode.decode_nms_fused``, K=32 kept slots per image) or, with
NMS off, the CUDA dense decode (``decode_grid_fused``).

Weights come from a ``.npz`` written by ``convert.save_npz`` (a flax
params / batch_stats pair); reading Orbax snapshots or TF checkpoints
needs JAX or TensorFlow and is not part of this package.

    python -m tensorflow_yolo2_torch.entries.pascal_detect_darknet \\
        image.jpg --weights darknet19.npz --image-size 448 --nms
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping

import numpy as np
import torch

from tensorflow_yolo2_torch.config import VOC_CLASSES, YoloConfig
from tensorflow_yolo2_torch.convert import load_npz, state_dict_from_flax
from tensorflow_yolo2_torch.models.darknet import Darknet19Detector
from tensorflow_yolo2_torch.models.fold import fold_params
from tensorflow_yolo2_torch.ops.boxes import Detections
from tensorflow_yolo2_torch.ops.cuda_decode import (
    decode_grid_fused,
    decode_nms_fused,
)
from tensorflow_yolo2_torch.utils.device import resolve_device


def as_state_dict(params_or_state_dict: Mapping[str, Any],
                  batch_stats: Mapping[str, Any] | None = None
                  ) -> dict[str, torch.Tensor]:
    """A flax params tree (nested dicts, numpy leaves) + batch_stats, or a
    port state dict (flat ``.``-joined keys) → a port state dict."""
    if any(isinstance(v, Mapping) for v in params_or_state_dict.values()):
        return state_dict_from_flax(params_or_state_dict, batch_stats)
    return {k: torch.as_tensor(v) for k, v in params_or_state_dict.items()}


def build_detector(yolo: YoloConfig, state_dict: Mapping[str, torch.Tensor],
                   fold_bn: bool = True, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None
                   ) -> Darknet19Detector:
    """The v1 ``Darknet19Detector`` in eval mode on ``device`` in ``dtype``.

    With ``fold_bn`` and BN entries in the state dict, BN is folded (in
    float32) before the cast; a state dict without BN entries is taken
    as folded already.
    """
    device = resolve_device(device)
    has_bn = any(".bn." in k for k in state_dict)
    if fold_bn and has_bn:
        state_dict = fold_params(state_dict)
    model = Darknet19Detector(output_channels=yolo.cell_channels,
                              bn_on_output=True,
                              fold_bn=not has_bn or fold_bn)
    model.load_state_dict(state_dict)
    model.eval().requires_grad_(False)
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last)


def make_detect_fn(yolo: YoloConfig, params_or_state_dict, batch_stats=None,
                   object_thresh: float = 0.5, use_nms: bool = False,
                   nms_iou: float = 0.5, fold_bn: bool = True,
                   dtype: torch.dtype = torch.bfloat16, device=None,
                   v2: bool = False, passthrough: bool = False,
                   int8: bool = False, pallas_stem: bool = False,
                   downsample: str = "pool"):
    """Build the batched images → detections function of the v1 head.

    ``params_or_state_dict`` is a flax params tree (with ``batch_stats``)
    or a port state dict. The weights move to ``device`` (default
    ``cuda``; raises without a card) once. The returned function takes
    an NHWC (N, H, W, 3) batch, float in [-1, 1] or raw uint8 (normalized
    on the device as x/255·2−1), as a tensor or numpy array, and returns
    ``Detections`` on the device: K=32 kept slots per image with
    ``use_nms``, else the dense S·S·B slots.
    """
    for name, flag in (("v2", v2), ("passthrough", passthrough),
                       ("int8", int8), ("pallas_stem", pallas_stem),
                       ("downsample='stride'", downsample != "pool"),
                       ("the per_slot_classes head", yolo.per_slot_classes)):
        if flag:
            raise NotImplementedError(f"{name} serving is not ported yet")
    device = resolve_device(device)
    model = build_detector(yolo, as_state_dict(params_or_state_dict,
                                               batch_stats),
                           fold_bn=fold_bn, dtype=dtype, device=device)

    @torch.inference_mode()
    def detect(images) -> Detections:
        images = torch.as_tensor(images).to(device)
        if images.dtype == torch.uint8:
            images = images.float() / 255.0 * 2.0 - 1.0
        grid = model(images.to(dtype))
        if use_nms:
            return decode_nms_fused(grid, yolo, object_thresh, nms_iou,
                                    max_outputs=32)
        return decode_grid_fused(grid, yolo, object_thresh)

    return detect


def image_read(path: str, image_size: int) -> np.ndarray:
    """Read (BGR), warp-resize and scale to [-1, 1], as the reference does."""
    import cv2

    image = cv2.imread(path)
    if image is None:
        raise FileNotFoundError(path)
    image = cv2.resize(image, (image_size, image_size))
    return (image.astype(np.float32) / 255.0) * 2.0 - 1.0


def draw_detections(image_path: str, boxes: np.ndarray, scores: np.ndarray,
                    classes: np.ndarray, out_path: str) -> str:
    """Draw the boxes with score > 0 (fractional corners) onto the image."""
    import cv2

    image = cv2.imread(image_path)
    if image is None:
        raise FileNotFoundError(image_path)
    h, w = image.shape[:2]
    for box, score, cls in zip(boxes, scores, classes):
        if score <= 0:
            continue
        x1, y1, x2, y2 = (int(box[0] * w), int(box[1] * h),
                          int(box[2] * w), int(box[3] * h))
        print(f"predicted bounding box: ({x1}, {y1}), width:{x2 - x1}, "
              f"height:{y2 - y1}")
        cv2.rectangle(image, (x1, y1), (x2, y2), (0, 0, 255), 2)
        cv2.putText(image, f"{VOC_CLASSES[int(cls)]}:{float(score):.2f}",
                    (x1, max(y1 - 4, 12)), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 0, 255), 1)
    if not cv2.imwrite(out_path, image):
        raise OSError(f"could not write {out_path}")
    return out_path


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("image")
    p.add_argument("--weights", required=True, metavar="NPZ",
                   help="params / batch_stats written by convert.save_npz")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--nms", action="store_true",
                   help="apply class-aware NMS (the reference has none)")
    p.add_argument("--image-size", type=int, default=224,
                   help="multiple of 32; the grid is S = size/32 (448 is "
                        "the Darknet19-448 config)")
    p.add_argument("--out", default=None)
    p.add_argument("--no-fold-bn", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.image_size % 32:
        p.error("--image-size must be a multiple of 32")

    yolo = YoloConfig(S=args.image_size // 32, image_size=args.image_size)
    params, stats = load_npz(args.weights)
    detect = make_detect_fn(yolo, params, stats, args.threshold,
                            use_nms=args.nms, fold_bn=not args.no_fold_bn,
                            device=args.device)
    dets = detect(image_read(args.image, yolo.image_size)[None])
    boxes, scores, classes = (t[0].cpu().numpy() for t in dets)
    out = draw_detections(args.image, boxes, scores, classes,
                          args.out or args.image + ".detections.png")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
