"""Detection-quality curve: train mAP and held-out val mAP over training
(port of benchmarks/quality_curve.py).

A hard synthetic VOC (2-5 objects an image, deliberate overlaps,
imbalanced classes: ``data.synthetic.make_voc_hard``) with a held-out
split; ``pascal_train_darknet`` trains in stages and mAP@0.5 is scored
on both splits after each (``pascal_eval_map.run_eval``, threshold 0.005,
NMS). One ``STAGE`` JSON line a stage, then a markdown table.

Stages are cumulative iteration counts and the program is resume-aware:
a fresh invocation reads the newest snapshot's step and trains only the
remaining delta, so a long program runs one process a stage with the
stage labels and the training budget exact across restarts. With
``--pretrain-iters N`` the Darknet19 classifier is first pretrained for N
iterations on a synthetic CLS-LOC tree of the same object vocabulary
(``data.synthetic.make_cls_pretrain``), unless its snapshot is there
already; the detector's trunk warm-starts from it. An anchor head is
scored with the priors of its snapshot's ``anchors.json``; the v1 head
against the per-slot label grid, so that objects past the first one in a
cell count in the ground truth.

One departure from the JAX program: each stage trains with ``--seed
<--seed + the stage's first iteration>``. The JAX trainer shuffles with
numpy's global generator, seeded by the OS in every process, whereas
``pascal_train_darknet`` seeds its shuffle with ``--seed``: with one seed
for every stage, a program run a process a stage would replay the same
shuffle from the start of each stage. Distinct seeds keep the stages
apart and every run reproducible.

Runs on ``cuda`` unless ``--device`` names another device; the run root
is ``$TFY2_ROOT``:

    TFY2_ROOT=_q5_torch python -m \\
        tensorflow_yolo2_torch.entries.quality_curve --stages 600 \\
        --n-train 1024 --n-val 128 --grad-clip 5 --pretrain-iters 1500
"""

from __future__ import annotations

import argparse
import json
import os

from tensorflow_yolo2_torch.config import Paths, YoloConfig, yolo_v2_config
from tensorflow_yolo2_torch.data import synthetic
from tensorflow_yolo2_torch.data.anchors import v2_config_for_snapshot
from tensorflow_yolo2_torch.data.voc import PascalVOC
from tensorflow_yolo2_torch.entries import (
    imagenet_train_darknet,
    pascal_train_darknet,
)
from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
    load_detector_params,
    make_detect_fn,
)
from tensorflow_yolo2_torch.entries.pascal_eval_map import run_eval
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager

EVAL_THRESH = 0.005
EVAL_BATCH = 32
PRETRAIN_BATCH = 48  # the classifier pretrain's batch, the reference's
NUM_WORKERS = 2
LOG_EVERY = 50


def curve_net(v2: bool, passthrough: bool) -> str:
    """The snapshot directory's network name of a head."""
    if passthrough:
        return "darknet19_v2p"
    return "darknet19_v2" if v2 else "darknet19"


def snapshot_yolo(paths: Paths, net_name: str, v2: bool) -> YoloConfig:
    """The config a trained head decodes with: an anchor head's priors
    from its snapshot dir's ``anchors.json``, the v1 grid otherwise."""
    if v2:
        return v2_config_for_snapshot(
            os.path.join(paths.ckpts, net_name, "voc_2007"),
            yolo_v2_config().image_size)
    return YoloConfig()


def score(detect, gt_yolo: YoloConfig, set_name: str,
          max_images: int | None = None) -> float:
    """mAP@0.5 of ``detect`` over one image set, its ground truth from the
    grids of ``gt_yolo``."""
    imdb = PascalVOC(set_name, batch_size=EVAL_BATCH, yolo=gt_yolo)
    mAP, _ = run_eval(detect, imdb, gt_yolo, max_images=max_images)
    return float(mAP)


def build_detect(yolo: YoloConfig, net_name: str, v2: bool,
                 passthrough: bool, device):
    """The newest snapshot of ``net_name`` served at threshold 0.005 with
    NMS."""
    state_dict = load_detector_params(yolo, network_name=net_name)
    return make_detect_fn(yolo, state_dict, object_thresh=EVAL_THRESH,
                          use_nms=True, device=device, v2=v2,
                          passthrough=passthrough)


def pretrain(args, paths: Paths) -> int:
    """The classifier pretrain on the synthetic CLS-LOC tree (written
    first where it is missing); ``pascal_train_darknet`` warm-starts from
    its snapshot. Returns the trainer's exit code."""
    if not os.path.exists(os.path.join(paths.ilsvrc, "ImageSets", "CLS-LOC",
                                       "train_cls.txt")):
        print(f"generating classification pretrain set at {paths.ilsvrc}")
        synthetic.make_cls_pretrain(paths.ilsvrc)
    return imagenet_train_darknet.main(
        ["--iters", str(args.pretrain_iters),
         "--batch-size", str(PRETRAIN_BATCH),
         "--num-workers", str(NUM_WORKERS), "--log-every", str(LOG_EVERY),
         "--eval-every", "100", "--uint8-transfer",
         "--save-every", str(args.pretrain_iters),
         "--seed", str(args.seed)]
        + (["--device", args.device] if args.device else []))


def train_argv(args, iters: int, seed: int) -> list[str]:
    """``pascal_train_darknet``'s arguments for a stage of ``iters``."""
    return (["--iters", str(iters), "--batch-size", str(args.batch),
             "--num-workers", str(NUM_WORKERS), "--save-every", str(iters),
             "--log-every", str(LOG_EVERY), "--uint8-transfer",
             "--bn-momentum", str(args.bn_momentum), "--seed", str(seed)]
            + (["--v2", "--anchors", args.anchors] if args.v2 else [])
            + (["--passthrough"] if args.passthrough else [])
            + (["--multiscale", args.multiscale] if args.multiscale else [])
            + (["--grad-clip", str(args.grad_clip)]
               if args.grad_clip is not None else [])
            + (["--lr-decay", args.lr_decay] if args.lr_decay else [])
            + (["--device", args.device] if args.device else []))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stages", default="400,800,1600",
                    help="cumulative iteration checkpoints")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=32)
    ap.add_argument("--bn-momentum", type=float, default=0.9,
                    help="lower than the 0.99 reference default so the "
                         "folded eval stats keep up in a short run")
    ap.add_argument("--eval-max-images", type=int, default=None)
    ap.add_argument("--easy", action="store_true",
                    help="moderate fixture (no overlaps, 1-2 objects): the "
                         "generalization sanity point")
    ap.add_argument("--v2", action="store_true",
                    help="train and score the anchor head "
                         "(pascal_train_darknet --v2)")
    ap.add_argument("--passthrough", action="store_true",
                    help="with --v2: the YOLOv2 reorg head "
                         "(pascal_train_darknet --passthrough)")
    ap.add_argument("--anchors", default="classic",
                    choices=["classic", "kmeans"],
                    help="with --v2: anchor priors; 'kmeans' clusters the "
                         "fixture's own boxes (pascal_train_darknet "
                         "--anchors kmeans)")
    ap.add_argument("--multiscale", default=None,
                    help="comma-separated input sizes for multiscale "
                         "training (requires --v2; passed to "
                         "pascal_train_darknet --multiscale)")
    ap.add_argument("--eval-sizes", default=None,
                    help="comma-separated input sizes to also score val "
                         "mAP at after the last stage (the detector "
                         "re-grids at S=size/32)")
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="passed to pascal_train_darknet --grad-clip")
    ap.add_argument("--lr-decay", default=None,
                    choices=["fixed", "cosine", "exponential"],
                    help="passed to pascal_train_darknet --lr-decay (the "
                         "schedule re-anchors at each resumed stage, so it "
                         "spans each stage's delta)")
    ap.add_argument("--pretrain-iters", type=int, default=0,
                    help="first pretrain the Darknet19 classifier for N "
                         "iterations on a synthetic CLS-LOC tree of the "
                         "same object vocabulary; the stages warm-start "
                         "from it")
    ap.add_argument("--seed", type=int, default=0,
                    help="base of the stages' seeds: a stage trains with "
                         "this plus its first iteration")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.passthrough and not args.v2:
        ap.error("--passthrough requires --v2 (the reorg head is the "
                 "anchor layout)")
    stages = [int(s) for s in args.stages.split(",")]
    sizes = sorted({int(s) for s in args.eval_sizes.split(",")}) \
        if args.eval_sizes else []
    if any(s % 32 for s in sizes):
        ap.error("--eval-sizes must be multiples of 32")

    paths = Paths()
    if not os.path.exists(os.path.join(paths.pascal, "VOC2007", "ImageSets",
                                       "Main", "test.txt")):
        kind = "easy" if args.easy else "hard"
        print(f"generating {kind} synthetic VOC at {paths.pascal} "
              f"({args.n_train} train / {args.n_val} val)")
        synthetic.make_voc_hard(paths.pascal, n_train=args.n_train,
                                n_val=args.n_val, easy=args.easy)

    if args.pretrain_iters and CheckpointManager(
            "darknet19", "ilsvrc_2017_cls",
            save_by_epoch=True).latest_step() is not None:
        # a re-invoked stage program does not pretrain again
        print("pretrain snapshot present; skipping --pretrain-iters")
        args.pretrain_iters = 0
    if args.pretrain_iters:
        rc = pretrain(args, paths)
        if rc:
            return rc

    net_name = curve_net(args.v2, args.passthrough)
    rows = []
    done = CheckpointManager(net_name, "voc_2007").latest_step() or 0
    if done:
        print(f"resuming stage program at iter {done} (newest {net_name} "
              "snapshot)")
    yolo = snapshot_yolo(paths, net_name, args.v2)
    for stage in stages:
        iters = stage - done
        if iters <= 0:
            print(f"stage {stage} already trained (at {done}); skipping")
            continue
        rc = pascal_train_darknet.main(
            train_argv(args, iters, args.seed + done + 1))
        if rc:
            return rc
        done = stage
        yolo = snapshot_yolo(paths, net_name, args.v2)
        # the per-slot grid counts every annotated object in the ground
        # truth; the v1 grid would drop a cell's second object
        gt_yolo = yolo if args.v2 else yolo_v2_config(yolo.image_size)
        detect = build_detect(yolo, net_name, args.v2, args.passthrough,
                              args.device)
        row = {"iters": stage}
        for split, set_name in (("train", "trainval"), ("val", "test")):
            row[f"map_{split}"] = round(
                score(detect, gt_yolo, set_name, args.eval_max_images), 4)
        rows.append(row)
        print("STAGE " + json.dumps(row), flush=True)

    print("\n| iters | train mAP@0.5 | val mAP@0.5 |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r['iters']} | {r['map_train']:.3f} | "
              f"{r['map_val']:.3f} |")

    if sizes:
        # the same weights re-gridded at S=size/32 (anchors in cell units
        # rescale as image fractions, YoloConfig.at_scale)
        multi = []
        for size in sizes:
            syolo = yolo.at_scale(size // 32)
            detect = build_detect(syolo, net_name, args.v2,
                                  args.passthrough, args.device)
            multi.append({"size": size, "map_val": round(
                score(detect, syolo, "test", args.eval_max_images), 4)})
            print("EVAL_SIZE " + json.dumps(multi[-1]), flush=True)
        print("\n| serve size | val mAP@0.5 |")
        print("|---|---|")
        for m in multi:
            print(f"| {m['size']} | {m['map_val']:.3f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
