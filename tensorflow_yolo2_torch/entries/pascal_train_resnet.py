"""ResNet50 + YOLO-head detection training on VOC2007 (port of
tensorflow_yolo2_tpu/entries/pascal_train_resnet.py, the backbone-swap
path).

``models.resnet.ResNet50Detector`` (the slim resnet_v1_50 trunk, then
``yolo_fc1`` 4096 + dropout 0.5 + ``yolo_fc2``) at 224² (S=7, B=2,
C=20) with the YOLO grid loss (``yolo_task``, with histograms), Adam at
5e-4, batch 4, 200 000 added iterations, a snapshot every 40 000
(``ckpts/resnet50/<imdb>/train_iter_N``); a run resumes from its newest
snapshot, else starts from fresh weights (flax's initializers, from
``--seed``) with the trunk warm-started, by name and shape, from the slim
resnet_v1_50 TF checkpoint of ``--tf-checkpoint``, else
``weights/resnet_v1_50.ckpt[.index]`` where it exists (``yolo_fc1`` and
``yolo_fc2`` keep their fresh weights; the checkpoint is read in numpy
alone, ``compat.tf_import``). bf16 compute with float32 parameters; the
dropout masks come from the train state's generator. Runs on ``cuda``
unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.pascal_train_resnet \\
        --iters 1000 --save-every 500
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
from tensorflow_yolo2_torch.models.resnet import ResNet50Detector
from tensorflow_yolo2_torch.parallel.mesh import idle, in_mesh, release_idle
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

NET_NAME = "resnet50"
HEAD_SCOPES = ("yolo_fc1", "yolo_fc2")  # never taken from the TF trunk


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--image-set", default="trainval")
    args = p.parse_args(argv)
    paths = Paths()
    common.require_tf_checkpoint(p, "--tf-checkpoint", args.tf_checkpoint)
    trunk = common.resnet_tf_trunk(args.tf_checkpoint, paths.weights,
                                   prefix="backbone")

    batch_size = args.batch_size or 4
    mesh = common.start_mesh(batch_size, args.device)
    if not in_mesh(mesh):
        return idle(mesh)
    iters = args.iters or 200_000
    lr = args.learning_rate or 5e-4
    save_every = args.save_every or 40_000
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    yolo = YoloConfig()
    imdb = common.shard_dataset(PascalVOC(
        args.image_set, batch_size=common.local_batch(batch_size, mesh),
        yolo=yolo, data_path=args.data_path,
        rng=np.random.default_rng(args.seed)), mesh)
    model = ResNet50Detector(output_channels=yolo.cell_channels, S=yolo.S,
                             image_size=yolo.image_size)
    trainer = Trainer(model, yolo_task(yolo, histograms=True),
                      OptimizerConfig(name="adam", schedule=LRScheduleConfig(
                          learning_rate=lr)),
                      device=args.device, compute_dtype=dtype, mesh=mesh)
    mgr = CheckpointManager(NET_NAME, imdb.name, paths=paths, yolo=yolo)
    writer = MetricsWriter(paths.tb_dirs(NET_NAME, imdb.name, val=False)[0])
    state, start = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed),
        warm_start_tree=None if trunk is None else (trunk, None),
        warm_start_exclude=HEAD_SCOPES)
    try:
        common.run_train_loop(
            trainer, state, imdb.get, mgr, writer, start_iter=start,
            num_iters=iters, log_every=args.log_every,
            save_every=save_every, num_workers=args.num_workers,
            trace_dir=args.profile_dir)
        release_idle(mesh)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
