"""Released-checkpoint check (port of
tensorflow_yolo2_tpu/entries/verify_released_ckpts.py): one command for
the day the reference's published weights are in the run root.

The reference ships three trained checkpoint bundles:

- **darknet19-Pascal**, the YOLO detector trained on VOC2007
  (``weights/darknet19_pascal.ckpt``);
- **darknet19-ImageNet**, the classifier
  (``weights/darknet19_imagenet.ckpt``, or the reference's literal
  ``darkent19_imagenet.ckpt``, typo included);
- **resnet50-Pascal**, the slim ResNet-50 + YOLO-head detector
  (``weights/resnet50_pascal.ckpt``).

For each bundle that exists this runs the TF import (``compat.tf_import``,
read in numpy alone: no TensorFlow needed) → the serving path (the
BN-folded bf16 detector and the CUDA decode + NMS kernel B1, or the
folded classifier) → boxes or top-5 classes on the given images, and,
where a VOCdevkit or ILSVRC tree is given, mAP@0.5 on VOC2007 test or
val top-1 / top-5. A bundle that is absent is skipped, and with none
present the command prints its skips and exits 0.

``--golden-out golden.json`` records every detection; a later run with
``--golden-check golden.json`` runs again and exits 1 if a box moved
more than ``--tol-box`` pixels, a score more than ``--tol-score``, or a
class changed. Runs on ``cuda`` unless ``--device`` names another
device.

    python -m tensorflow_yolo2_torch.entries.verify_released_ckpts \\
        --images assets/demo.jpg --golden-out golden.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any

import numpy as np
import torch

from tensorflow_yolo2_torch.compat.tf_bundle import checkpoint_present
from tensorflow_yolo2_torch.config import VOC_CLASSES, Paths, YoloConfig
from tensorflow_yolo2_torch.data.augment import image_read
from tensorflow_yolo2_torch.utils.device import resolve_device

RESULT: dict[str, Any] = {}


def _first_present(*paths: str) -> str | None:
    for p in paths:
        if checkpoint_present(p):
            return p
    return paths[0] if paths else None


def _detections_record(name: str, image_path: str, dets, i: int = 0):
    scores = dets.scores[i].float().cpu().numpy()
    kept = scores > 0
    return {
        "artifact": name,
        "image": os.path.basename(image_path),
        "boxes": dets.boxes[i].float().cpu().numpy()[kept]
        .round(2).tolist(),
        "scores": scores[kept].round(5).tolist(),
        "classes": dets.classes[i].cpu().numpy()[kept].astype(int).tolist(),
    }


def _check_golden(records, golden_path: str, tol_box: float,
                  tol_score: float) -> list[str]:
    """Fresh records against a saved golden file: the mismatches, as
    lines to print (none: it passes)."""
    with open(golden_path) as f:
        golden = json.load(f)["records"]
    fresh = {(r["artifact"], r["image"]): r for r in records}
    errors = []
    for g in golden:
        key = (g["artifact"], g["image"])
        r = fresh.get(key)
        if r is None:
            errors.append(f"{key}: golden entry has no fresh counterpart "
                          "(artifact skipped or image list changed)")
            continue
        if len(g["boxes"]) != len(r["boxes"]):
            errors.append(f"{key}: {len(g['boxes'])} golden boxes vs "
                          f"{len(r['boxes'])} fresh")
            continue
        if g.get("classes") != r.get("classes"):
            errors.append(f"{key}: class ids changed "
                          f"{g['classes']} -> {r['classes']}")
        db = np.abs(np.asarray(g["boxes"], np.float64).reshape(-1, 4)
                    - np.asarray(r["boxes"], np.float64).reshape(-1, 4))
        ds = np.abs(np.asarray(g["scores"], np.float64)
                    - np.asarray(r["scores"], np.float64))
        if db.size and db.max() > tol_box:
            errors.append(f"{key}: max box delta {db.max():.3f}px "
                          f"> {tol_box}")
        if ds.size and ds.max() > tol_score:
            errors.append(f"{key}: max score delta {ds.max():.5f} "
                          f"> {tol_score}")
    return errors


def _detect_images(name: str, detect, yolo: YoloConfig, images, voc_root,
                   max_images, records) -> dict:
    info: dict[str, Any] = {"images": {}}
    for path in images:
        dets = detect(image_read(path, yolo.image_size)[None])
        rec = _detections_record(name, path, dets)
        records.append(rec)
        info["images"][os.path.basename(path)] = [
            f"{VOC_CLASSES[c]}:{s:.3f}"
            for c, s in zip(rec["classes"], rec["scores"])]
    if voc_root:
        info["map_voc2007_test"] = _voc_map(detect, yolo, voc_root,
                                            max_images)
    return info


def _verify_darknet_pascal(ckpt: str, images: list[str], voc_root,
                           threshold: float, max_images, records,
                           device) -> dict:
    """Import → the folded bf16 detector and B1 → boxes (→ mAP)."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        load_detector_params,
        make_detect_fn,
    )

    yolo = YoloConfig()
    state_dict = load_detector_params(yolo, tf_checkpoint=ckpt)
    detect = make_detect_fn(yolo, state_dict, object_thresh=threshold,
                            use_nms=True, dtype=torch.bfloat16,
                            device=device)
    return {"ckpt": ckpt, **_detect_images(
        "darknet19_pascal", detect, yolo, images, voc_root, max_images,
        records)}


def _verify_resnet_pascal(ckpt: str, images: list[str], voc_root,
                          threshold: float, max_images, records,
                          device) -> dict:
    """The resnet50-Pascal detector: named-mapping import → the bf16
    detector (BatchNorm on its statistics) → B1."""
    from tensorflow_yolo2_torch.compat.tf_import import (
        import_resnet_detector_checkpoint,
        state_dict_for,
    )
    from tensorflow_yolo2_torch.entries.pascal_detect_resnet import (
        make_resnet_detect_fn,
    )

    yolo = YoloConfig()
    params, stats = import_resnet_detector_checkpoint(ckpt)
    if "yolo_fc1" not in params:
        raise ValueError(
            f"{ckpt}: resnet trunk imported but no yolo_fc1/yolo_fc2 "
            "head variables — this looks like the *classification* "
            "resnet_v1_50 release, not the Pascal detector bundle")
    detect = make_resnet_detect_fn(yolo, state_dict_for((params, stats)),
                                   object_thresh=threshold, use_nms=True,
                                   device=device)
    return {"ckpt": ckpt, **_detect_images(
        "resnet50_pascal", detect, yolo, images, voc_root, max_images,
        records)}


def _voc_map(detect, yolo, voc_root: str, max_images) -> float:
    from tensorflow_yolo2_torch.data.voc import PascalVOC
    from tensorflow_yolo2_torch.entries.pascal_eval_map import run_eval

    imdb = PascalVOC("test", batch_size=8, yolo=yolo,
                     data_path=os.path.join(voc_root, "VOC2007"))
    mAP, _ = run_eval(detect, imdb, yolo, max_images=max_images)
    return round(float(mAP), 4)


def _verify_darknet_imagenet(ckpt: str, images: list[str], ilsvrc_root,
                             max_images, records, device) -> dict:
    """The ImageNet classifier: import → BN fold → top-5 per image (→ val
    top-1 / top-5). The class count is the checkpoint's logits conv's, so
    the 1000-way release and a local subset verify alike."""
    from tensorflow_yolo2_torch.compat.tf_import import (
        import_darknet19_checkpoint,
        state_dict_for,
    )
    from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
    from tensorflow_yolo2_torch.models.fold import fold_params

    params, stats = import_darknet19_checkpoint(ckpt, detection=False)
    num_classes = int(params["conv19"]["conv"]["kernel"].shape[-1])
    model = Darknet19Classifier(num_classes=num_classes, fold_bn=True)
    model.load_state_dict(fold_params(state_dict_for((params, stats))))
    model.eval().requires_grad_(False)
    model.to(device=device, dtype=torch.bfloat16,
             memory_format=torch.channels_last)

    @torch.inference_mode()
    def predict(imgs) -> np.ndarray:
        imgs = torch.as_tensor(imgs).to(device, torch.bfloat16)
        return torch.softmax(model(imgs), -1).cpu().numpy()

    info: dict[str, Any] = {"ckpt": ckpt, "num_classes": num_classes,
                            "images": {}}
    for path in images:
        probs = predict(image_read(path, 224)[None])[0]
        top5 = np.argsort(-probs)[:5]
        rec = {"artifact": "darknet19_imagenet",
               "image": os.path.basename(path),
               "boxes": [], "classes": top5.astype(int).tolist(),
               "scores": probs[top5].round(5).tolist()}
        records.append(rec)
        info["images"][os.path.basename(path)] = [
            f"{c}:{s:.4f}" for c, s in zip(rec["classes"], rec["scores"])]
    if ilsvrc_root:
        from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls

        imdb = IlsvrcCls("val", batch_size=25, data_path=ilsvrc_root)
        n = min(max_images or 500, len(imdb.gt_labels))
        top1 = top5c = seen = 0
        while seen < n:
            imgs, labels = imdb.get()
            rank = np.argsort(-predict(imgs), axis=1)
            top1 += int((rank[:, 0] == labels).sum())
            top5c += int((rank[:, :5] == labels[:, None]).any(1).sum())
            seen += len(labels)
        info["val_top1"] = round(top1 / seen, 4)
        info["val_top5"] = round(top5c / seen, 4)
        info["val_images"] = seen
    return info


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights-dir", default=None,
                   help="where the released ckpts live (default "
                        "$TFY2_ROOT/weights)")
    p.add_argument("--darknet-pascal", default=None,
                   help="override the darknet19-Pascal ckpt path")
    p.add_argument("--darknet-imagenet", default=None,
                   help="override the darknet19-ImageNet ckpt path")
    p.add_argument("--resnet-pascal", default=None,
                   help="override the resnet50-Pascal ckpt path")
    p.add_argument("--images", nargs="*", default=None,
                   help="test images for golden boxes / top-5 "
                        "(default assets/demo.jpg if present)")
    p.add_argument("--voc-root", default=None,
                   help="a VOCdevkit/ — adds mAP@0.5 on VOC2007 test")
    p.add_argument("--ilsvrc-root", default=None,
                   help="an ILSVRC tree — adds val top-1/top-5")
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--max-images", type=int, default=None,
                   help="cap the mAP / accuracy sweeps")
    p.add_argument("--golden-out", default=None,
                   help="write all detections/predictions to this JSON")
    p.add_argument("--golden-check", default=None,
                   help="compare against a saved --golden-out file")
    p.add_argument("--tol-box", type=float, default=1.0,
                   help="golden-check box tolerance, pixels")
    p.add_argument("--tol-score", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    weights = args.weights_dir or Paths().weights
    images = args.images
    if images is None:
        images = ["assets/demo.jpg"] if os.path.exists(
            "assets/demo.jpg") else []
    for path in images:
        if not os.path.exists(path):
            p.error(f"test image not found: {path}")

    artifacts = [
        ("darknet19_pascal",
         _first_present(args.darknet_pascal
                        or os.path.join(weights, "darknet19_pascal.ckpt")),
         _verify_darknet_pascal,
         dict(images=images, voc_root=args.voc_root,
              threshold=args.threshold, max_images=args.max_images)),
        ("darknet19_imagenet",
         _first_present(*([args.darknet_imagenet] if args.darknet_imagenet
                          else [os.path.join(weights,
                                             "darknet19_imagenet.ckpt"),
                                # the reference's literal file name
                                os.path.join(weights,
                                             "darkent19_imagenet.ckpt")])),
         _verify_darknet_imagenet,
         dict(images=images, ilsvrc_root=args.ilsvrc_root,
              max_images=args.max_images)),
        ("resnet50_pascal",
         _first_present(args.resnet_pascal
                        or os.path.join(weights, "resnet50_pascal.ckpt")),
         _verify_resnet_pascal,
         dict(images=images, voc_root=args.voc_root,
              threshold=args.threshold, max_images=args.max_images)),
    ]

    records: list[dict] = []
    ran, skipped = [], []
    for name, path, fn, kwargs in artifacts:
        if not checkpoint_present(path):
            skipped.append(name)
            print(f"SKIP {name}: no checkpoint at {path}")
            continue
        info = fn(path, records=records, device=resolve_device(args.device),
                  **kwargs)
        ran.append(name)
        print(f"ARTIFACT {json.dumps({'name': name, **info})}")

    failures: list[str] = []
    if args.golden_check:
        failures = _check_golden(records, args.golden_check,
                                 args.tol_box, args.tol_score)
        for e in failures:
            print(f"GOLDEN MISMATCH {e}")
    if args.golden_out and records:
        with open(args.golden_out, "w") as f:
            json.dump({"records": records}, f, indent=1)
        print(f"Wrote golden file {args.golden_out} "
              f"({len(records)} records)")

    summary = {"ran": ran, "skipped": skipped,
               "golden_ok": not failures if args.golden_check else None,
               "ok": not failures}
    RESULT.clear()
    RESULT.update(summary, records=records)
    print("VERIFY " + json.dumps(summary))
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
