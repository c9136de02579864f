"""Darknet19 YOLO detection training on Pascal VOC2007 (port of
tensorflow_yolo2_tpu/entries/pascal_train_darknet.py, the v1 head).

Darknet19 trunk + the v1 detection head + the YOLOv1 grid loss, Adam at
1e-3, batch 24, 80k added iterations, a snapshot every 40k; resume from
this run's newest snapshot, else a warm start from the newest ImageNet
classifier snapshot (``ckpts/darknet19/ilsvrc_2017_cls``). 224² (S=7,
B=2, C=20), bf16 compute with float32 parameters. Runs on ``cuda``
unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.pascal_train_darknet \\
        --iters 1000 --save-every 500

The anchor heads (``--v2``, ``--passthrough``, ``--anchors``), multiscale,
spatial sharding, TF checkpoint import and profiling are not ported yet
and are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
    YoloConfig,
)
from tensorflow_yolo2_torch.data.voc import PascalVOC
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.models.darknet import Darknet19Detector
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

# flags of the JAX entry point that the port does not have yet, with the
# value that means "not given"
_NOT_PORTED = {"v2": False, "passthrough": False, "anchors": "classic",
               "multiscale": None, "spatial": 0, "tf_checkpoint": None,
               "profile_dir": None}


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--image-set", default="trainval")
    p.add_argument("--flipped", action="store_true")
    p.add_argument("--downsample", default="pool",
                   choices=["pool", "stride"],
                   help="'stride' = pool-free variant: stride-2 convs "
                        "instead of max pools (not the reference's "
                        "architecture; snapshots go to <net>_sd dirs)")
    p.add_argument("--uint8-transfer", action="store_true",
                   help="ship uint8 batches to the device and normalize "
                        "there (4x fewer host-to-device bytes)")
    p.add_argument("--bn-momentum", type=float, default=0.99,
                   help="BatchNorm running-statistic momentum")
    p.add_argument("--grad-clip", type=float, default=None, metavar="NORM",
                   help="global-norm gradient clipping")
    p.add_argument("--lr-decay", default="fixed",
                   choices=["fixed", "cosine", "exponential"],
                   help="LR schedule over --iters (exponential: "
                        "--lr-decay-factor every iters/4 steps); after a "
                        "resume it re-anchors at the resumed step")
    p.add_argument("--lr-decay-factor", type=float, default=0.5)
    # not ported yet: refused below, never ignored
    p.add_argument("--v2", action="store_true", help="not ported yet")
    p.add_argument("--passthrough", action="store_true",
                   help="not ported yet")
    p.add_argument("--anchors", default="classic",
                   choices=["classic", "kmeans"], help="not ported yet")
    p.add_argument("--multiscale", default=None, help="not ported yet")
    p.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="not ported yet")
    args = p.parse_args(argv)
    given = [name for name, unset in _NOT_PORTED.items()
             if getattr(args, name) != unset]
    if given:
        p.error(", ".join("--" + n.replace("_", "-") for n in given) +
                " not ported yet (ROADMAP.md, queue A, slice 3b); the port "
                "trains the v1 head")

    batch_size = args.batch_size or 24
    iters = args.iters or 80_000
    lr = args.learning_rate or 1e-3
    save_every = args.save_every or 40_000
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    yolo = YoloConfig()
    model = Darknet19Detector(output_channels=yolo.cell_channels,
                              bn_momentum=args.bn_momentum,
                              downsample=args.downsample)
    net_name = "darknet19" + ("_sd" if args.downsample == "stride" else "")
    imdb = PascalVOC(args.image_set, batch_size=batch_size, yolo=yolo,
                     flipped=args.flipped, data_path=args.data_path,
                     uint8=args.uint8_transfer,
                     rng=np.random.default_rng(args.seed))
    paths = Paths()
    mgr = CheckpointManager(net_name, imdb.name, paths=paths, yolo=yolo)
    # a resumed run's optimizer count is cumulative: anchor a decaying
    # schedule at the resumed step so that it spans this run's --iters
    resume_step = mgr.latest_step() or 0
    sched = LRScheduleConfig(
        kind=args.lr_decay, learning_rate=lr,
        decay_steps=max(1, iters if args.lr_decay == "cosine"
                        else iters // 4),
        decay_factor=args.lr_decay_factor,
        offset_steps=resume_step if args.lr_decay != "fixed" else 0)
    writer = MetricsWriter(paths.tb_dirs(net_name, imdb.name, val=False)[0])
    trainer = Trainer(model, yolo_task(yolo, histograms=True),
                      OptimizerConfig(name="adam", schedule=sched,
                                      grad_clip_norm=args.grad_clip),
                      device=args.device, compute_dtype=dtype)
    # warm start from the newest ImageNet classifier snapshot, if any
    warm = CheckpointManager("darknet19", "ilsvrc_2017_cls",
                             save_by_epoch=True, paths=paths).latest_path()
    state, start = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed),
        warm_start_dir=warm)
    try:
        common.run_train_loop(
            trainer, state, imdb.get, mgr, writer, start_iter=start,
            num_iters=iters, log_every=args.log_every,
            save_every=save_every, num_workers=args.num_workers)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
