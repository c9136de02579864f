"""int8-vs-bf16 serving accuracy: mAP@0.5 deltas on a held-out split
(port of benchmarks/int8_quality.py).

Loads a trained detector snapshot (a ``quality_curve`` run root under
``$TFY2_ROOT``), serves the same weights through the bf16 folded path and
the post-training-quantized int8 path (``make_detect_fn(int8=True)``,
activations calibrated on one ``trainval`` batch of 8, never the eval
split), and scores both on the held-out ``test`` split and on the train
split. Prints ``INT8_QUALITY`` with both mAPs of each split and the
int8 − bf16 deltas.

One departure from the JAX program: each (split, path) pair reads its
split from a fresh loader with one seed, so that with ``--max-images``
below a split's size both paths score the same images (the JAX program
reads the int8 path's images on from where the bf16 path stopped).

Runs on ``cuda`` unless ``--device`` names another device:

    TFY2_ROOT=_q5_torch python -m \\
        tensorflow_yolo2_torch.entries.int8_quality --v2 --passthrough \\
        --max-images 256
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tensorflow_yolo2_torch.config import Paths
from tensorflow_yolo2_torch.data.voc import PascalVOC
from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
    load_detector_params,
    make_detect_fn,
)
from tensorflow_yolo2_torch.entries.pascal_eval_map import run_eval
from tensorflow_yolo2_torch.entries.quality_curve import (
    curve_net,
    snapshot_yolo,
)

BATCH = 8  # the calibration and evaluation batch


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--v2", action="store_true",
                    help="score the anchor-head snapshot")
    ap.add_argument("--passthrough", action="store_true",
                    help="with --v2: the reorg-head snapshot "
                         "(darknet19_v2p)")
    ap.add_argument("--threshold", type=float, default=0.005)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.passthrough and not args.v2:
        ap.error("--passthrough requires --v2")

    net_name = curve_net(args.v2, args.passthrough)
    yolo = snapshot_yolo(Paths(), net_name, args.v2)
    state_dict = load_detector_params(yolo, network_name=net_name)
    calib, _ = PascalVOC("trainval", batch_size=BATCH, yolo=yolo).get()
    serving = dict(object_thresh=args.threshold, use_nms=True,
                   device=args.device, v2=args.v2,
                   passthrough=args.passthrough)
    detectors = {
        "bf16": make_detect_fn(yolo, state_dict, **serving),
        "int8": make_detect_fn(yolo, state_dict, int8=True,
                               calib_images=calib, **serving),
    }
    result: dict = {"head": ("v2p" if args.passthrough else "v2")
                    if args.v2 else "v1"}
    for split, set_name in (("train", "trainval"), ("val", "test")):
        for mode, detect in detectors.items():
            imdb = PascalVOC(set_name, batch_size=BATCH, yolo=yolo,
                             rng=np.random.default_rng(0))
            mAP, _ = run_eval(detect, imdb, yolo,
                              max_images=args.max_images)
            result[f"map_{split}_{mode}"] = round(float(mAP), 4)
        result[f"delta_{split}"] = round(
            result[f"map_{split}_int8"] - result[f"map_{split}_bf16"], 4)
    print("INT8_QUALITY " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
