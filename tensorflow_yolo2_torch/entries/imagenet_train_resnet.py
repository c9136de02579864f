"""ResNet50 ImageNet fine-tune with a frozen trunk (port of
tensorflow_yolo2_tpu/entries/imagenet_train_resnet.py).

``models.resnet.ResNet50V1`` with a 1×1 ``logits`` conv over the global
mean, sparse softmax cross-entropy (``softmax_task``), momentum 0.9 at
1e-3, batch 32, 10 epochs, 224², on the augmented train split of ILSVRC
CLS-LOC (``data.ilsvrc.IlsvrcCls``). Only the ``logits`` scope trains
(``trainable_scopes``; ``--train-all`` trains the whole net); the frozen
trunk's BatchNorm still runs on batch statistics and updates its running
ones, as in the JAX package. A validation batch every ``--eval-every``
iterations goes to its own metric writer; snapshots are named by epoch
(``ckpts/resnet50/ilsvrc_2017_cls/train_epoch_N``), one every 2 epochs,
and a run resumes from the newest. A fresh run starts from the slim
resnet_v1_50 TF checkpoint of ``--tf-checkpoint``, else
``weights/resnet_v1_50.ckpt[.index]`` where it exists, merged by name and
shape (a ``logits`` of another class count keeps its fresh weights; read
in numpy alone, ``compat.tf_import``). Runs on ``cuda`` unless
``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.imagenet_train_resnet \\
        --iters 1000 --eval-every 100
"""

from __future__ import annotations

import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
)
from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls
from tensorflow_yolo2_torch.data.prefetch import PrefetchLoader
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.models.resnet import ResNet50V1
from tensorflow_yolo2_torch.parallel.mesh import idle, in_mesh, release_idle
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task

NET_NAME = "resnet50"
SAVE_EVERY_EPOCHS = 2
FINE_TUNE_SCOPES = ("logits",)


def fine_tune_config(lr: float, train_all: bool = False) -> OptimizerConfig:
    """The reference's optimizer: momentum 0.9 at a fixed rate, on the
    ``logits`` scope alone unless ``train_all``."""
    return OptimizerConfig(name="momentum", momentum=0.9,
                           trainable_scopes=() if train_all
                           else FINE_TUNE_SCOPES,
                           schedule=LRScheduleConfig(learning_rate=lr))


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--train-all", action="store_true",
                   help="train the whole net, not just the logits scope")
    args = p.parse_args(argv)
    paths = Paths()
    common.require_tf_checkpoint(p, "--tf-checkpoint", args.tf_checkpoint)
    trunk = common.resnet_tf_trunk(args.tf_checkpoint, paths.weights)

    batch_size = args.batch_size or 32
    mesh = common.start_mesh(batch_size, args.device)
    if not in_mesh(mesh):
        return idle(mesh)
    local = common.local_batch(batch_size, mesh)
    epochs = args.epochs or 10
    lr = args.learning_rate or 1e-3
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    train_imdb = common.shard_dataset(IlsvrcCls(
        "train", batch_size=local, data_aug=True, data_path=args.data_path,
        seed=args.seed), mesh)
    val_imdb = common.shard_dataset(IlsvrcCls(
        "val", batch_size=local, data_path=args.data_path, seed=args.seed),
        mesh)
    model = ResNet50V1(num_classes=train_imdb.num_class, global_pool=True)
    trainer = Trainer(model, softmax_task(),
                      fine_tune_config(lr, args.train_all),
                      device=args.device, compute_dtype=dtype, mesh=mesh)
    mgr = CheckpointManager(NET_NAME, train_imdb.name, save_by_epoch=True,
                            paths=paths)
    tb_train, tb_val = paths.tb_dirs(NET_NAME, train_imdb.name)
    state, last_epoch = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed),
        warm_start_tree=None if trunk is None else (trunk, None))
    train_imdb.epoch = last_epoch + 1
    total_batch = train_imdb.total_batch
    iters = args.iters or total_batch * (epochs - last_epoch)
    save_every = args.save_every or total_batch * SAVE_EVERY_EPOCHS

    writer, val_writer = MetricsWriter(tb_train), MetricsWriter(tb_val)
    val_stream = PrefetchLoader(val_imdb.get, num_workers=1,
                                prefetch_size=2)
    try:
        def eval_fn(state, step):
            metrics = trainer.eval_step(state, *next(val_stream))
            if trainer.is_chief:
                val_writer.scalars(step, {k: float(v)
                                          for k, v in metrics.items()})

        common.run_train_loop(
            trainer, state, train_imdb.get, mgr, writer,
            start_iter=last_epoch * total_batch, num_iters=iters,
            log_every=args.log_every, save_every=save_every,
            num_workers=args.num_workers, eval_fn=eval_fn,
            eval_every=args.eval_every, save_step_divisor=total_batch,
            trace_dir=args.profile_dir)
        release_idle(mesh)
    finally:
        val_stream.close()
        writer.close()
        val_writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
