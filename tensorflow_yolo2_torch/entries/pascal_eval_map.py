"""VOC mAP@0.5 evaluation over a Pascal image set (port of
tensorflow_yolo2_tpu/entries/pascal_eval_map.py).

The serving path (the BN-folded detector, then the CUDA decode+NMS kernel
at a low threshold, K=32) runs over a VOC split in batches; the
detections and the split's label grids go to ``eval.VocMapEvaluator``,
which prints each class's AP and the mAP. 224² as in the JAX package.

Weights come from ``--weights NPZ`` (``convert.save_npz``), else as in
the JAX package (``pascal_detect_darknet.load_detector_params``): from
the TF checkpoint of ``--tf-checkpoint``, else
``<weights>/darknet19_pascal.ckpt`` (v1 only), else the newest snapshot
of this package's own training run (``ckpts/<net>/voc_2007``:
``darknet19``, ``darknet19_v2`` with ``--v2``, ``darknet19_v2p`` with
``--v2 --passthrough``). An anchor head decodes with the
``anchors.json`` of that directory (the one holding the ``.npz``, or the
run's), else (and always for ``--tf-checkpoint``) with the classic VOC
priors. Runs on ``cuda`` unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.pascal_eval_map --v2 --passthrough

``--int8`` evaluates the post-training-quantized int8 chain
(``ops.quant``), calibrated on the first batch of ``--int8-calib-set``
(``trainval`` by default: the evaluated split never calibrates the
quantizer); not with ``--passthrough``, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tensorflow_yolo2_torch.config import Paths, YoloConfig, yolo_v2_config
from tensorflow_yolo2_torch.convert import load_npz
from tensorflow_yolo2_torch.data.anchors import v2_config_for_snapshot
from tensorflow_yolo2_torch.data.voc import PascalVOC
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
    as_state_dict,
    load_detector_params,
    make_detect_fn,
)
from tensorflow_yolo2_torch.eval import VocMapEvaluator

IMAGE_SIZE = 224


def run_eval(detect, imdb, yolo: YoloConfig, iou: float = 0.5,
             use_07_metric: bool = False,
             max_images: int | None = None) -> tuple[float, dict]:
    """mAP of a detect function over one image set: (mAP, APs by class).

    ``imdb`` is anything with ``get()`` (a batch of images and label
    grids), ``gt_labels``, ``batch_size`` and ``num_class``; ``detect``
    maps a batch of images to ``Detections``. At most ``max_images``
    images are evaluated."""
    evaluator = VocMapEvaluator(imdb.num_class, iou_thresh=iou,
                                use_07_metric=use_07_metric)
    n_images = min(max_images or len(imdb.gt_labels), len(imdb.gt_labels))
    image_id = 0
    while image_id < n_images:
        images, labels = imdb.get()
        boxes, scores, classes = (t.cpu().numpy() for t in detect(images))
        for b in range(imdb.batch_size):
            if image_id >= n_images:
                break
            evaluator.add_label_grid(image_id, boxes[b], scores[b],
                                     classes[b], labels[b], yolo.image_size)
            image_id += 1
        if image_id % (imdb.batch_size * 4) == 0:
            print(f"evaluated {image_id}/{n_images} images")
    return evaluator.mean_ap()


def load_weights(weights: str | None, net_name: str, paths: Paths,
                 tf_checkpoint: str | None = None,
                 v2: bool = False) -> tuple[dict, str | None]:
    """(state dict, the directory its anchors.json would be in): from the
    ``.npz`` when given, else ``load_detector_params``'s order for
    ``net_name`` on voc_2007."""
    if weights:
        params, stats = load_npz(weights)
        return (as_state_dict(params, stats),
                os.path.dirname(os.path.abspath(weights)))
    yolo = (yolo_v2_config(IMAGE_SIZE) if v2
            else YoloConfig(S=IMAGE_SIZE // 32, image_size=IMAGE_SIZE))
    try:
        state_dict = load_detector_params(yolo, tf_checkpoint, paths,
                                          network_name=net_name)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"{e}; train one or pass --weights NPZ "
                                "or --tf-checkpoint") from None
    return state_dict, os.path.join(paths.ckpts, net_name, "voc_2007")


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--image-set", default="test")
    p.add_argument("--threshold", type=float, default=0.005,
                   help="low decode threshold: mAP wants deep recall")
    p.add_argument("--nms-iou", type=float, default=0.5)
    p.add_argument("--iou", type=float, default=0.5, help="match IoU")
    p.add_argument("--use-07-metric", action="store_true")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="params / batch_stats written by convert.save_npz "
                        "(default: the newest snapshot of the run)")
    p.add_argument("--v2", action="store_true",
                   help="evaluate an anchor-head snapshot "
                        "(pascal_train_darknet --v2)")
    p.add_argument("--passthrough", action="store_true",
                   help="evaluate a YOLOv2 reorg-head snapshot "
                        "(pascal_train_darknet --v2 --passthrough)")
    p.add_argument("--int8", action="store_true",
                   help="evaluate the post-training-quantized int8 serving "
                        "chain (ops.quant)")
    p.add_argument("--int8-calib-set", default="trainval",
                   help="image set whose first batch calibrates the int8 "
                        "activations (kept apart from --image-set, so that "
                        "the evaluated data never calibrates the "
                        "quantizer)")
    args = p.parse_args(argv)
    if args.weights and args.tf_checkpoint:
        p.error("--weights and --tf-checkpoint both name the weights; "
                "pass one")
    common.require_tf_checkpoint(p, "--tf-checkpoint", args.tf_checkpoint)
    if args.passthrough and not args.v2:
        p.error("--passthrough is the YOLOv2 reorg head; it requires --v2")
    if args.passthrough and args.int8:
        p.error("int8 serving does not cover the passthrough head's concat "
                "route yet")

    batch_size = args.batch_size or 32
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    paths = Paths()
    if args.v2:
        net_name = "darknet19_v2p" if args.passthrough else "darknet19_v2"
    else:
        net_name = "darknet19"
    state_dict, anchors_dir = load_weights(args.weights, net_name, paths,
                                           args.tf_checkpoint, args.v2)
    # an anchor head decodes with the priors it was trained against
    yolo = (v2_config_for_snapshot(
        anchors_dir, IMAGE_SIZE,
        external_weights=args.tf_checkpoint is not None) if args.v2
            else YoloConfig(S=IMAGE_SIZE // 32, image_size=IMAGE_SIZE))
    imdb = PascalVOC(args.image_set, batch_size=batch_size, yolo=yolo,
                     data_path=args.data_path, paths=paths,
                     rng=np.random.default_rng(args.seed))
    calib = None
    if args.int8:
        calib, _ = PascalVOC(args.int8_calib_set, batch_size=batch_size,
                             yolo=yolo, data_path=args.data_path,
                             paths=paths,
                             rng=np.random.default_rng(args.seed)).get()
    detect = make_detect_fn(yolo, state_dict, object_thresh=args.threshold,
                            use_nms=True, nms_iou=args.nms_iou, dtype=dtype,
                            device=args.device, v2=args.v2,
                            passthrough=args.passthrough, int8=args.int8,
                            calib_images=calib)
    mAP, aps = run_eval(detect, imdb, yolo, iou=args.iou,
                        use_07_metric=args.use_07_metric,
                        max_images=args.max_images)
    for cls, ap in sorted(aps.items()):
        print(f"AP[{imdb.classes[cls]}] = {ap:.4f}")
    print(f"mAP@{args.iou} = {mAP:.4f} "
          f"({'VOC07 11-point' if args.use_07_metric else 'all-points'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
