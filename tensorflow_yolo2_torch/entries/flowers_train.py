"""Darknet19 fine-tune on TF_flowers, the reference's fast end-to-end
recipe (port of tensorflow_yolo2_tpu/entries/flowers_train.py).

The Darknet19 classifier on the flowers classes (``data.flowers``,
under ``Paths().flowers`` or ``--data-path``), Adam at 1e-4, batch 16,
224², 1000 iterations; a validation batch every ``--eval-every``
iterations goes to its own metric writer; snapshots under
``ckpts/darknet19/tf_flowers`` every ``--save-every`` iterations (default:
the last). Its train steps run the trunk's five pools backward through
B5. Runs on ``cuda`` unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.flowers_train --iters 200
"""

from __future__ import annotations

import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
)
from tensorflow_yolo2_torch.data.flowers import TFFlowers
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
from tensorflow_yolo2_torch.parallel.mesh import idle, in_mesh, release_idle
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--image-size", type=int, default=224)
    args = p.parse_args(argv)
    common.refuse_ignored_tf_checkpoint(p, args.tf_checkpoint)

    batch_size = args.batch_size or 16
    mesh = common.start_mesh(batch_size, args.device)
    if not in_mesh(mesh):
        return idle(mesh)
    iters = args.iters or 1000
    lr = args.learning_rate or 1e-4
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    imdb = common.shard_dataset(TFFlowers(
        batch_size=common.local_batch(batch_size, mesh),
        image_size=args.image_size, val_split=args.val_split,
        data_path=args.data_path, seed=args.seed), mesh)
    paths = Paths()
    trainer = Trainer(
        Darknet19Classifier(num_classes=imdb.num_class), softmax_task(),
        OptimizerConfig(name="adam",
                        schedule=LRScheduleConfig(learning_rate=lr)),
        device=args.device, compute_dtype=dtype, mesh=mesh)
    mgr = CheckpointManager("darknet19", imdb.name, paths=paths)
    tb_train, tb_val = paths.tb_dirs("darknet19", imdb.name)
    writer, val_writer = MetricsWriter(tb_train), MetricsWriter(tb_val)
    state, start = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed))

    def eval_fn(state, step):
        metrics = trainer.eval_step(state, *imdb.get_val())
        if trainer.is_chief:
            val_writer.scalars(step, {k: float(v)
                                      for k, v in metrics.items()})

    try:
        common.run_train_loop(
            trainer, state, imdb.get_train, mgr, writer, start_iter=start,
            num_iters=iters, log_every=args.log_every,
            save_every=args.save_every or iters,
            num_workers=args.num_workers, eval_fn=eval_fn,
            eval_every=args.eval_every, trace_dir=args.profile_dir)
        release_idle(mesh)
    finally:
        writer.close()
        val_writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
