"""Classifier evaluation: streaming top-1 accuracy and recall@5 (port of
tensorflow_yolo2_tpu/entries/eval_classifier.py).

Any registered model on any dataset's evaluation split (``get_val``
where the dataset has one), from the newest snapshot of
``ckpts/<model>/<dataset>`` under the iter names, else under the epoch
names (the ImageNet entries'), else fresh weights with a warning; in
eval mode (BatchNorm on its running statistics). ``--use-ema`` scores
the snapshot's EMA parameters, and falls back to the raw ones, with the
JAX package's warning, when the restore carried no EMA tensors.
``--max-batches`` bounds the pass (default: one pass over the split);
as in the JAX entry, which shapes its state from it, the split's first
batch is drawn before the pass, so the pass scores the batches after it.
``--labels-offset`` strips a background slot as the trainer does;
``--preprocessing-name`` picks the factory preprocessing's eval form.
``--tf-checkpoint`` scores a TF checkpoint of ``--model-name`` as it is
(``compat.tf_import.import_checkpoint_for``, read in numpy alone; merged
by name and shape into fresh weights, no snapshot looked up, no EMA), as
slim's eval does. Runs on ``cuda`` unless ``--device`` names another
device.

    python -m tensorflow_yolo2_torch.entries.eval_classifier \\
        --model-name vgg_16 --dataset-name flowers --use-ema
"""

from __future__ import annotations

import torch

from tensorflow_yolo2_torch.config import OptimizerConfig, Paths
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.entries.datasets import get_dataset
from tensorflow_yolo2_torch.entries.train_classifier import (
    build_model,
    import_tf_for,
    offset_labels,
)
from tensorflow_yolo2_torch.parallel.mesh import idle, in_mesh, release_idle
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    merge_into_model,
)
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--model-name", default="darknet19")
    p.add_argument("--dataset-name", default="flowers")
    p.add_argument("--dataset-split-name", default="validation")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None,
                   help="input resolution for datasets that resize")
    p.add_argument("--preprocessing-name", default=None,
                   help="factory preprocessing instead of the dataset's "
                        "native convention (data.preprocessing)")
    p.add_argument("--labels-offset", type=int, default=0,
                   help="subtract this offset from dataset labels and "
                        "shrink the logits layer to num_classes-offset")
    p.add_argument("--use-ema", action="store_true",
                   help="evaluate the EMA weights from the snapshot")
    args = p.parse_args(argv)
    common.require_tf_checkpoint(p, "--tf-checkpoint", args.tf_checkpoint)

    batch_size = args.batch_size or 64
    mesh = common.start_mesh(batch_size, args.device)
    if not in_mesh(mesh):
        return idle(mesh)
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)
    size_kw = {"image_size": args.image_size} if args.image_size else {}
    imdb = get_dataset(args.dataset_name, args.dataset_split_name,
                       batch_size=common.local_batch(batch_size, mesh),
                       data_path=args.data_path,
                       preprocessing_name=args.preprocessing_name, **size_kw)
    if not 0 <= args.labels_offset < imdb.num_class:
        p.error(f"--labels-offset {args.labels_offset} out of range for "
                f"{imdb.num_class} classes")
    model = build_model(p, args, imdb, imdb.num_class - args.labels_offset)
    val_list = getattr(imdb, "val_list", None)
    split_batches = (max(1, len(val_list) // batch_size) if val_list
                     else imdb.total_batch)
    common.shard_dataset(imdb, mesh)  # its rows of each global batch
    # --use-ema: an EMA slot in the restore target, so that the
    # snapshot's EMA tensors are restored (the decay is never used)
    opt_cfg = OptimizerConfig(
        moving_average_decay=0.999 if args.use_ema else None)
    trainer = Trainer(model, softmax_task(), opt_cfg, device=args.device,
                      compute_dtype=dtype)
    mgr = CheckpointManager(args.model_name, imdb.name, paths=Paths())
    if mgr.latest_step() is None:
        epoch_mgr = CheckpointManager(args.model_name, imdb.name,
                                      save_by_epoch=True, paths=Paths())
        if epoch_mgr.latest_step() is not None:
            mgr = epoch_mgr
    get_batch = offset_labels(getattr(imdb, "get_val", imdb.get),
                              args.labels_offset)
    get_batch()  # the JAX entry's sample batch: the pass starts after it
    info: dict = {}
    if args.tf_checkpoint:
        from tensorflow_yolo2_torch.compat.tf_import import state_dict_for
        trees = import_tf_for(p, args.model_name, args.tf_checkpoint)
        state = trainer.create_state(torch.Generator().manual_seed(0))
        n, m = merge_into_model(state.model, state_dict_for(trees))
        step, info["ema_restored"] = 0, 0  # no EMA in a TF checkpoint
        print(f"Imported {n} param + {m} batch-stat tensors from TF "
              f"checkpoint {args.tf_checkpoint}")
    else:
        state, step = common.bootstrap_state(
            trainer, mgr, torch.Generator().manual_seed(0), info=info)
        if step == 0 and mgr.latest_step() is None:
            print("WARNING: no snapshot found under "
                  f"{mgr.dir} — evaluating freshly-initialized weights")
    use_ema = args.use_ema and state.ema_params is not None
    if use_ema and info.get("ema_restored") == 0:
        # the EMA slot still holds the restored raw parameters' copy:
        # score the raw parameters, as the reference does
        print("WARNING: restore carried no EMA tensors — "
              "falling back to the raw parameters")
        use_ema = False

    n_batches = args.max_batches or split_batches
    c1 = c5 = total = 0
    for _ in range(n_batches):
        images, labels = get_batch()
        logits = trainer.eval_outputs(state, images, ema=use_ema)
        labels = torch.as_tensor(labels).to(trainer.device).long()
        top5 = torch.topk(logits, min(5, logits.shape[-1]), dim=-1).indices
        c1 += int((torch.argmax(logits, -1) == labels).sum())
        c5 += int((top5 == labels[:, None]).any(-1).sum())
        total += labels.shape[0]
    c1, c5, total = (int(v) for v in common.sum_over_data(mesh, c1, c5,
                                                          total))
    if common.data_shard(mesh)[0] == 0:
        print(f"eval at step {step}: accuracy {c1 / total:.4f}, "
              f"recall@5 {c5 / total:.4f} over {total} images")
    release_idle(mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
