"""Darknet19 ImageNet classification pretraining (port of
tensorflow_yolo2_tpu/entries/imagenet_train_darknet.py).

The Darknet19 classifier (``models.darknet.Darknet19Classifier``) with
sparse softmax cross-entropy (``train.trainer.softmax_task``), momentum
SGD at 1e-3 with momentum 0.9, batch 48, 10 epochs, 224², on the
augmented train split of ILSVRC CLS-LOC (``data.ilsvrc.IlsvrcCls``,
under ``Paths().ilsvrc`` or ``--data-path``). A validation batch every
``--eval-every`` iterations goes to its own metric writer. Snapshots are
named by epoch (``ckpts/darknet19/ilsvrc_2017_cls/train_epoch_N``), one
every 2 epochs, and a run resumes from the newest; the detector trainer
(``pascal_train_darknet``) warm-starts its trunk from them.

- ``--uint8-transfer`` ships uint8 batches and normalizes them on the
  device (``utils.device.device_normalize``: 4× fewer host-to-device
  bytes, the same values).
- ``--process-workers N`` decodes and augments in N worker processes
  (``data.prefetch.ProcessPrefetchLoader`` over an
  ``EpochShardedStream``: every image once an epoch); 0 uses
  ``--num-workers`` threads.
- ``--profile-dir`` writes a ``torch.profiler`` trace of the train loop.

Runs on ``cuda`` unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.imagenet_train_darknet \\
        --iters 1000 --eval-every 100 --uint8-transfer
"""

from __future__ import annotations

import functools

import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
)
from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls
from tensorflow_yolo2_torch.data.prefetch import (
    EpochShardedStream,
    PrefetchLoader,
    ProcessPrefetchLoader,
)
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
from tensorflow_yolo2_torch.parallel.mesh import idle, in_mesh, release_idle
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task

NET_NAME = "darknet19"
SAVE_EVERY_EPOCHS = 2


def _train_imdb_factory(batch_size, data_path, seed, uint8):
    """The train split as a worker process builds it: module level, so
    that it pickles under spawn."""
    return IlsvrcCls("train", batch_size=batch_size, data_aug=True,
                     data_path=data_path, seed=seed, uint8=uint8)


def momentum_config(lr: float) -> OptimizerConfig:
    """The reference's optimizer: momentum 0.9 at a fixed rate."""
    return OptimizerConfig(name="momentum", momentum=0.9,
                           schedule=LRScheduleConfig(learning_rate=lr))


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--uint8-transfer", action="store_true",
                   help="ship uint8 batches to the device and normalize "
                        "there (4x fewer host-to-device bytes)")
    p.add_argument("--process-workers", type=int, default=0,
                   help="decode and augment in N worker processes, every "
                        "image once an epoch (0: --num-workers threads)")
    args = p.parse_args(argv)
    common.refuse_ignored_tf_checkpoint(p, args.tf_checkpoint)

    batch_size = args.batch_size or 48
    mesh = common.start_mesh(batch_size, args.device)
    if not in_mesh(mesh):
        return idle(mesh)
    local = common.local_batch(batch_size, mesh)
    epochs = args.epochs or 10
    lr = args.learning_rate or 1e-3
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    train_imdb = common.shard_dataset(_train_imdb_factory(
        local, args.data_path, args.seed, args.uint8_transfer), mesh)
    val_imdb = common.shard_dataset(IlsvrcCls(
        "val", batch_size=local, data_path=args.data_path, seed=args.seed,
        uint8=args.uint8_transfer), mesh)
    paths = Paths()
    trainer = Trainer(Darknet19Classifier(num_classes=train_imdb.num_class),
                      softmax_task(), momentum_config(lr),
                      device=args.device, compute_dtype=dtype, mesh=mesh)
    mgr = CheckpointManager(NET_NAME, train_imdb.name, save_by_epoch=True,
                            paths=paths)
    tb_train, tb_val = paths.tb_dirs(NET_NAME, train_imdb.name)
    state, last_epoch = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed))
    train_imdb.epoch = last_epoch + 1
    total_batch = train_imdb.total_batch
    iters = args.iters or total_batch * (epochs - last_epoch)
    save_every = args.save_every or total_batch * SAVE_EVERY_EPOCHS

    writer, val_writer = MetricsWriter(tb_train), MetricsWriter(tb_val)
    val_stream = PrefetchLoader(val_imdb.get, num_workers=1,
                                prefetch_size=2)
    proc_loader = None
    try:
        def eval_fn(state, step):
            metrics = trainer.eval_step(state, *next(val_stream))
            if trainer.is_chief:
                val_writer.scalars(step, {k: float(v)
                                          for k, v in metrics.items()})

        get_batch, num_workers = train_imdb.get, args.num_workers
        if args.process_workers:
            stream = EpochShardedStream(
                functools.partial(_train_imdb_factory, local,
                                  args.data_path, args.seed,
                                  args.uint8_transfer),
                batch_size=local, seed=args.seed, drop_remainder=True,
                shard=common.data_shard(mesh))
            proc_loader = ProcessPrefetchLoader(
                stream, num_workers=args.process_workers,
                prefetch_size=2 * args.process_workers)
            get_batch = functools.partial(next, proc_loader)
            num_workers = 1  # one thread drains the process queue

        common.run_train_loop(
            trainer, state, get_batch, mgr, writer,
            start_iter=last_epoch * total_batch, num_iters=iters,
            log_every=args.log_every, save_every=save_every,
            num_workers=num_workers, eval_fn=eval_fn,
            eval_every=args.eval_every, save_step_divisor=total_batch,
            trace_dir=args.profile_dir)
        release_idle(mesh)
    finally:
        if proc_loader is not None:
            proc_loader.close()
        val_stream.close()
        writer.close()
        val_writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
