"""ResNet50 + YOLO-head detection of one image (port of
tensorflow_yolo2_tpu/entries/pascal_detect_resnet.py).

The inference twin of ``pascal_train_resnet``: restores the newest
``ckpts/resnet50/voc_2007`` snapshot (this package's own format), runs
``models.resnet.ResNet50Detector`` in bf16 with BatchNorm unfolded, as
the JAX package does (eval mode: running statistics, no dropout), then
decodes the 7×7 grid of the 224² image at ``--threshold`` (0.2): with
``--nms`` by the CUDA decode+NMS kernel B1 (K=32 kept slots, IoU 0.5),
else by the dense CUDA decode B3 (``ops.cuda_decode``). The image is read
as the Darknet CLI reads it (``data.augment.image_read``) and the boxes
are drawn onto it with PIL and matplotlib (``utils.visualize``). Runs on
``cuda`` unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.pascal_detect_resnet \\
        image.jpg --nms
"""

from __future__ import annotations

import argparse
from typing import Mapping

import torch

from tensorflow_yolo2_torch.config import VOC_CLASSES, Paths, YoloConfig
from tensorflow_yolo2_torch.data.augment import image_read
from tensorflow_yolo2_torch.entries.pascal_detect_darknet import decode
from tensorflow_yolo2_torch.models.resnet import ResNet50Detector
from tensorflow_yolo2_torch.ops.boxes import Detections
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.utils.device import (
    device_normalize,
    resolve_device,
)
from tensorflow_yolo2_torch.utils.visualize import draw_detections

NET_NAME = "resnet50"
IMDB_NAME = "voc_2007"


def build_resnet_detector(yolo: YoloConfig,
                          state_dict: Mapping[str, torch.Tensor],
                          dtype: torch.dtype = torch.bfloat16,
                          device=None) -> ResNet50Detector:
    """The detector of ``state_dict`` for ``yolo`` (its grid and image
    size) in eval mode on ``device`` (default ``cuda``) in ``dtype``,
    BatchNorm unfolded."""
    device = resolve_device(device)
    with torch.device(device):  # no host draw of the discarded weights
        model = ResNet50Detector(output_channels=yolo.cell_channels,
                                 S=yolo.S, image_size=yolo.image_size)
    model.load_state_dict(state_dict)
    model.eval().requires_grad_(False)
    return model.to(dtype=dtype, memory_format=torch.channels_last)


def make_resnet_detect_fn(yolo: YoloConfig,
                          state_dict: Mapping[str, torch.Tensor],
                          object_thresh: float = 0.2, use_nms: bool = False,
                          nms_iou: float = 0.5,
                          dtype: torch.dtype = torch.bfloat16, device=None):
    """The batched images → detections function of the ResNet detector.

    The weights move to ``device`` (default ``cuda``; raises without a
    card) once. The returned function takes an NHWC (N, H, W, 3) batch,
    float in [-1, 1] or raw uint8 (normalized on the device), as a tensor
    or numpy array, and returns ``Detections`` on the device: K=32 kept
    slots per image from the decode+NMS kernel with ``use_nms``, else the
    dense S·S·B slots of the dense decode kernel.
    """
    device = resolve_device(device)
    model = build_resnet_detector(yolo, state_dict, dtype, device)

    @torch.inference_mode()
    def detect(images) -> Detections:
        images = device_normalize(torch.as_tensor(images).to(device))
        grid = model(images.to(dtype))
        return decode(grid, yolo, object_thresh, use_nms, nms_iou, v2=False)

    return detect


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("image", nargs="?", default="assets/demo.jpg")
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--nms", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    yolo = YoloConfig()
    mgr = CheckpointManager(NET_NAME, IMDB_NAME, paths=Paths())
    state_dict = mgr.restore_raw()["model"]
    detect = make_resnet_detect_fn(yolo, state_dict, args.threshold,
                                   use_nms=args.nms, device=args.device)
    image = image_read(args.image, yolo.image_size)  # BGR, [-1, 1]
    boxes, scores, classes = (t[0].cpu().numpy()
                              for t in detect(image[None]))
    out = draw_detections(args.image, boxes, scores, classes, VOC_CLASSES,
                          out_path=args.out)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
