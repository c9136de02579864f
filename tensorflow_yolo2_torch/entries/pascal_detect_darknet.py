"""Darknet19 YOLO detection (port of
tensorflow_yolo2_tpu/entries/pascal_detect_darknet.py).

The serving path: a batch of NHWC images → the BN-folded detector (bf16
by default) → with NMS, the CUDA decode+NMS kernel
(``ops.cuda_decode.decode_nms_fused``, K=32 kept slots per image), else
the dense decode. Three heads:

- v1 (default): ``Darknet19Detector`` with the reference's BN + leaky on
  the output conv; dense decode by the CUDA kernel ``decode_grid_fused``.
- ``--v2``: the same trunk and head with a linear output conv and the
  YOLOv2 anchor layout (``per_slot_classes``); dense decode by
  ``ops.boxes.decode_grid_v2`` (plain PyTorch, as in the JAX package).
- ``--v2 --passthrough``: ``Darknet19DetectorV2``, the YOLOv2
  architecture with the reorg route.

``--pallas-stem`` (v1 or ``--v2``) runs conv1 + pool + conv2 + pool as one
CUDA kernel, ``ops.cuda_stem.fused_stem`` (B4 for a bf16 detector, B4-f32
for a float32 one), which keeps the conv1 activation out of device
memory; the folded detector runs on from there.

Weights come from a ``.npz`` written by ``convert.save_npz`` (a flax
params / batch_stats pair); reading Orbax snapshots or TF checkpoints
needs JAX or TensorFlow and is not part of this package. An anchor head
decodes with the priors of an ``anchors.json`` beside the ``.npz``, else
with the classic VOC priors.

    python -m tensorflow_yolo2_torch.entries.pascal_detect_darknet \\
        image.jpg --weights darknet19.npz --image-size 448 --nms
    python -m tensorflow_yolo2_torch.entries.pascal_detect_darknet \\
        image.jpg --weights v2p.npz --image-size 416 --nms --v2 --passthrough
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Mapping

import numpy as np
import torch

from tensorflow_yolo2_torch.config import VOC_CLASSES, YoloConfig
from tensorflow_yolo2_torch.convert import load_npz, state_dict_from_flax
from tensorflow_yolo2_torch.data.anchors import (
    ANCHORS_FILE,
    v2_config_for_snapshot,
)
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Detector,
    Darknet19DetectorV2,
)
from tensorflow_yolo2_torch.models.fold import fold_params
from tensorflow_yolo2_torch.ops.boxes import Detections, decode_grid_v2
from tensorflow_yolo2_torch.ops.cuda_decode import (
    decode_grid_fused,
    decode_nms_fused,
)
from tensorflow_yolo2_torch.ops.cuda_stem import (
    StemWeights,
    cuda_kernel,
    fused_detect_forward,
    pack_stem_weights,
)
from tensorflow_yolo2_torch.utils.device import (
    device_normalize,
    resolve_device,
)


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
                   device: str | torch.device | None = None,
                   v2: bool = False, passthrough: bool = False,
                   downsample: str = "pool") -> torch.nn.Module:
    """The detector in eval mode on ``device`` in ``dtype``:
    ``Darknet19DetectorV2`` with ``passthrough``, else
    ``Darknet19Detector`` with a linear output conv for ``v2`` and the
    reference's BN + leaky output otherwise.

    With ``fold_bn`` and BN entries in the state dict, BN is folded (in
    float32) before the cast; a state dict without BN entries is taken
    as folded already.
    """
    device = resolve_device(device)
    has_bn = any(".bn." in k for k in state_dict)
    if fold_bn and has_bn:
        state_dict = fold_params(state_dict)
    folded = not has_bn or fold_bn
    if passthrough:
        model = Darknet19DetectorV2(output_channels=yolo.cell_channels,
                                    fold_bn=folded, downsample=downsample)
    else:
        model = Darknet19Detector(output_channels=yolo.cell_channels,
                                  bn_on_output=not v2, fold_bn=folded,
                                  downsample=downsample)
    model.load_state_dict(state_dict)
    model.eval().requires_grad_(False)
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last)


def stem_weights(state_dict: Mapping[str, torch.Tensor],
                 device: str | torch.device) -> StemWeights:
    """The folded conv1 and conv2 of a port state dict, packed once for
    ``ops.cuda_stem`` on ``device``. BN is folded here in float32 when the
    state dict carries it, so the stem keeps float32 biases whatever type
    the detector is cast to."""
    if any(".bn." in k for k in state_dict):
        state_dict = fold_params(state_dict)
    conv1, conv2 = ((state_dict[f"backbone.{n}.conv.weight"]
                     .permute(2, 3, 1, 0),  # OIHW → HWIO
                     state_dict[f"backbone.{n}.conv.bias"])
                    for n in ("conv1", "conv2"))
    return pack_stem_weights(*conv1, *conv2, device=device)


def make_detect_fn(yolo: YoloConfig, params_or_state_dict, batch_stats=None,
                   object_thresh: float = 0.5, use_nms: bool = False,
                   nms_iou: float = 0.5, fold_bn: bool = True,
                   dtype: torch.dtype = torch.bfloat16, device=None,
                   v2: bool = False, passthrough: bool = False,
                   int8: bool = False, pallas_stem: bool = False,
                   downsample: str = "pool"):
    """Build the batched images → detections function.

    ``v2`` selects the anchor head (linear output, ``per_slot_classes``
    layout; ``yolo`` from ``config.yolo_v2_config``), ``passthrough``
    with it the YOLOv2 reorg head. ``params_or_state_dict`` is a flax
    params tree (with ``batch_stats``) or a port state dict. The weights
    move to ``device`` (default ``cuda``; raises without a card) once.
    The returned function takes an NHWC (N, H, W, 3) batch, float in
    [-1, 1] or raw uint8 (normalized on the device as x/255·2−1), as a
    tensor or numpy array, and returns ``Detections`` on the device: K=32
    kept slots per image with ``use_nms``, else the dense S·S·B slots.

    ``pallas_stem`` runs the first two conv + pool stages through
    ``ops.cuda_stem`` (on the card the CUDA kernel of ``dtype``: B4 for
    bfloat16, B4-f32 for float32; any other type raises ``TypeError``)
    and the rest of the folded detector after them; it takes the v1 or
    ``v2`` head with the pool downsample and BN folding.
    """
    if v2 != yolo.per_slot_classes:
        raise ValueError(
            f"v2={v2} disagrees with yolo.per_slot_classes="
            f"{yolo.per_slot_classes}: the anchor head needs a per-slot "
            "config (config.yolo_v2_config), the v1 head a plain "
            "YoloConfig; a mismatch would decode with the wrong kernel")
    if passthrough and not v2:
        raise ValueError("passthrough is the YOLOv2 reorg head; it "
                         "requires v2=True (the anchor layout)")
    if pallas_stem:
        # checked before the int8 refusal below, so that pallas_stem with
        # int8 is refused as a combination, as the JAX package refuses it
        if passthrough or int8:
            raise ValueError("--pallas-stem covers the sequential Darknet19 "
                             "chain (no passthrough route, no int8)")
        if downsample != "pool":
            raise ValueError("--pallas-stem fuses the pool-based stem; the "
                             "stride variant has no pools to fuse")
        if not fold_bn:
            raise ValueError("--pallas-stem serves the BN-folded chain; "
                             "fold_bn=True is required")
    if int8:
        raise NotImplementedError("int8 serving is not ported yet")
    device = resolve_device(device)
    if pallas_stem and device.type == "cuda":
        cuda_kernel(dtype)  # a type with no stem kernel raises here
    state_dict = as_state_dict(params_or_state_dict, batch_stats)
    model = build_detector(yolo, state_dict, fold_bn=fold_bn, dtype=dtype,
                           device=device, v2=v2, passthrough=passthrough,
                           downsample=downsample)
    stem = stem_weights(state_dict, device) if pallas_stem else None

    @torch.inference_mode()
    def detect(images) -> Detections:
        images = device_normalize(torch.as_tensor(images).to(device))
        images = images.to(dtype)
        if pallas_stem:
            grid = fused_detect_forward(model, images.contiguous(), stem)
        else:
            grid = model(images)
        if use_nms:
            return decode_nms_fused(grid, yolo, object_thresh, nms_iou,
                                    max_outputs=32)
        if v2:
            return decode_grid_v2(grid, yolo, object_thresh)
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
    p.add_argument("--v2", action="store_true",
                   help="anchor-head weights (pascal_train_darknet --v2)")
    p.add_argument("--passthrough", action="store_true",
                   help="the YOLOv2 reorg head (pascal_train_darknet --v2 "
                        "--passthrough); requires --v2")
    p.add_argument("--downsample", default="pool", choices=["pool", "stride"],
                   help="'stride' serves weights trained with "
                        "pascal_train_darknet --downsample stride")
    p.add_argument("--pallas-stem", action="store_true",
                   help="the first two conv + pool stages as one fused "
                        "CUDA kernel (bf16; not with --passthrough)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.image_size % 32:
        p.error("--image-size must be a multiple of 32")
    if args.passthrough and not args.v2:
        p.error("--passthrough is the YOLOv2 reorg head; it requires --v2")

    if args.v2:
        weights_dir = os.path.dirname(os.path.abspath(args.weights))
        yolo = v2_config_for_snapshot(weights_dir, args.image_size)
        stored = os.path.join(weights_dir, ANCHORS_FILE)
        print("anchors: " + (stored if os.path.isfile(stored) else
                             f"the classic VOC priors (no {ANCHORS_FILE} "
                             "beside the weights)"))
    else:
        yolo = YoloConfig(S=args.image_size // 32,
                          image_size=args.image_size)
    params, stats = load_npz(args.weights)
    detect = make_detect_fn(yolo, params, stats, args.threshold,
                            use_nms=args.nms, fold_bn=not args.no_fold_bn,
                            device=args.device, v2=args.v2,
                            passthrough=args.passthrough,
                            pallas_stem=args.pallas_stem,
                            downsample=args.downsample)
    dets = detect(image_read(args.image, yolo.image_size)[None])
    boxes, scores, classes = (t[0].cpu().numpy() for t in dets)
    out = draw_detections(args.image, boxes, scores, classes,
                          args.out or args.image + ".detections.png")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
