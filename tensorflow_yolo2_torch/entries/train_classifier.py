"""The flag-driven classifier trainer, the slim tier (port of
tensorflow_yolo2_tpu/entries/train_classifier.py).

Any registered model (``models.registry``) × any dataset
(``entries.datasets``) × the optimizer family {adadelta, adagrad, adam,
adamw, ftrl, momentum, sgd, rmsprop, lamb} × the schedules {fixed,
exponential, polynomial, cosine} with warmup, weight decay, global-norm
clipping, parameter EMA (``--moving-average-decay``), gradient
accumulation (``--grad-accum-steps``), a frozen remainder outside
``--trainable-scopes``, a warm start from another run's snapshot
(``--checkpoint-path``, minus ``--checkpoint-exclude-scopes``), label
smoothing, ``--labels-offset`` (a background slot stripped), activation
summaries, and snapshots every ``--save-every`` iterations and every
``--save-interval-secs`` seconds. The JAX package's defaults: darknet19
on flowers, rmsprop, an exponential schedule from 0.01, weight decay
4e-5, batch 32, 1000 iterations.

``--preprocessing-name`` picks a factory preprocessing
(``data.preprocessing``) in place of the dataset's own convention;
``--aux-loss`` trains the auxiliary head(s) of inception v1, v3 and v4
at 0.4 of the loss, and keeps the JAX package's error for a net without
one. ``--checkpoint-path`` may also name a TF checkpoint prefix (V1 or
V2; anything that is not a directory), imported for ``--model-name``
(``compat.tf_import.import_checkpoint_for``, read in numpy alone) and
merged by name and shape as slim's ``_get_init_fn`` does. Refused:
``--tf-checkpoint``, which the JAX entry ignores. Runs on ``cuda`` unless
``--device`` names another device.

Started by ``torchrun`` (one process a rank: NCCL on cards, gloo on the
CPU), the step is data-parallel over ``--num-clones`` ranks (default: the
largest rank count that divides the batch, ``parallel.mesh.
make_mesh_for_batch``) and tensor-parallel over ``--model-parallel``;
each rank reads its own shard of the data, and rank 0 writes snapshots
and metrics. Without a launcher both stay 1 (a larger value raises, as
the JAX entry does on one device).

    python -m tensorflow_yolo2_torch.entries.train_classifier \\
        --model-name vgg_16 --dataset-name flowers --optimizer momentum \\
        --moving-average-decay 0.999 --grad-accum-steps 2
"""

from __future__ import annotations

import os

import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
)
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.entries.datasets import get_dataset
from tensorflow_yolo2_torch.models.registry import get_network
from tensorflow_yolo2_torch.parallel.mesh import (
    MeshConfig,
    idle,
    in_mesh,
    make_mesh,
    make_mesh_for_batch,
    maybe_initialize_distributed,
    release_idle,
)
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task


def add_slim_flags(p) -> None:
    p.add_argument("--model-name", default="darknet19")
    p.add_argument("--dataset-name", default="flowers")
    p.add_argument("--dataset-split-name", default="train")
    p.add_argument("--optimizer", default="rmsprop",
                   choices=["adadelta", "adagrad", "adam", "adamw", "ftrl",
                            "momentum", "sgd", "rmsprop", "lamb"])
    p.add_argument("--learning-rate-decay-type", default="exponential",
                   choices=["fixed", "exponential", "polynomial", "cosine"])
    p.add_argument("--learning-rate-decay-factor", type=float, default=0.94)
    p.add_argument("--decay-steps", type=int, default=10_000)
    p.add_argument("--end-learning-rate", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--rmsprop-decay", type=float, default=0.9)
    p.add_argument("--opt-epsilon", type=float, default=1e-8)
    p.add_argument("--weight-decay", type=float, default=4e-5)
    p.add_argument("--moving-average-decay", type=float, default=None)
    p.add_argument("--trainable-scopes", default=None,
                   help="comma-separated scope prefixes to train")
    p.add_argument("--checkpoint-path", default=None,
                   help="warm-start snapshot dir, or a TF checkpoint prefix "
                        "of --model-name")
    p.add_argument("--checkpoint-exclude-scopes", default=None)
    p.add_argument("--clip-gradient-norm", type=float, default=None)
    p.add_argument("--num-clones", type=int, default=None,
                   help="data-parallel width (default: the largest rank "
                        "count that divides the batch); a run of more "
                        "than one rank starts under torchrun")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel width: weights with >= 512 "
                        "output channels are sharded over it")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--save-interval-secs", type=float, default=0,
                   help="additionally snapshot on a wall-clock cadence")
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help="accumulate gradients over k micro-batches "
                        "(effective batch = k x batch-size)")
    p.add_argument("--image-size", type=int, default=None,
                   help="input resolution for datasets that resize")
    p.add_argument("--preprocessing-name", default=None,
                   help="factory preprocessing to use instead of the "
                        "dataset's native convention (cifarnet, lenet, "
                        "vgg, inception, ...: data.preprocessing)")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="blend one-hot targets toward uniform by this "
                        "amount in the CE loss")
    p.add_argument("--labels-offset", type=int, default=0,
                   help="subtract this offset from dataset labels and "
                        "shrink the logits layer to num_classes-offset")
    p.add_argument("--aux-loss", action="store_true",
                   help="train with the model's auxiliary classifier "
                        "head(s) at 0.4 loss weight (inception v1/v3/v4)")
    p.add_argument("--activation-summaries", action="store_true",
                   help="per-module activation histograms + sparsity "
                        "scalars in the metrics stream")


def make_run_mesh(p, args, batch_size: int):
    """The run's mesh (JAX's rule): ``--num-clones`` × ``--model-parallel``
    where the clones are given, else the largest data axis that divides
    the batch; None for one process. A mesh the ranks cannot hold is the
    parser's error."""
    maybe_initialize_distributed(args.device)
    try:
        if args.num_clones is not None:
            return make_mesh(MeshConfig(data=args.num_clones,
                                        model=args.model_parallel))
        return make_mesh_for_batch(batch_size, model=args.model_parallel)
    except ValueError as e:
        p.error(str(e))


def import_tf_for(p, model_name: str, path: str):
    """A TF checkpoint of ``model_name`` as flax-shaped (params,
    batch_stats) trees; the parser's error where no importer takes the
    net."""
    from tensorflow_yolo2_torch.compat.tf_import import (
        _IMPORTERS,
        import_checkpoint_for,
    )
    if model_name not in _IMPORTERS:
        p.error(f"no TF importer for {model_name!r}; have "
                f"{sorted(_IMPORTERS)}")
    trees = import_checkpoint_for(model_name, path)
    print(f"Imported TF checkpoint {path}")
    return trees


def offset_labels(get_batch, offset: int):
    """``get_batch`` with ``offset`` subtracted from its labels; a label
    below the offset raises (it would wrap to the last class)."""
    if not offset:
        return get_batch

    def shifted():
        images, labels = get_batch()
        if (labels < offset).any():
            raise ValueError(
                f"--labels-offset {offset}: batch contains labels below "
                f"the offset (min {int(labels.min())}); this dataset "
                "has no background slot to strip")
        return images, labels - offset

    return shifted


def build_model(p, args, imdb, num_classes: int):
    """The registry's net for ``--model-name`` at the dataset's image size
    and, where its images are not RGB (MNIST's 1 channel), its channels
    (which flax reads from the first batch); the JAX package's parser
    error when the net takes no auxiliary head."""
    net_kw = {"aux_logits": True} if getattr(args, "aux_loss", False) else {}
    channels = getattr(imdb, "channels", 3)
    if channels != 3:
        net_kw["in_channels"] = channels
    try:
        return get_network(args.model_name, num_classes=num_classes,
                           image_size=imdb.image_size, **net_kw)
    except TypeError:
        if "in_channels" in net_kw:
            p.error(f"{args.model_name} takes {channels}-channel images "
                    "only as lenet and cifarnet do")
        p.error(f"--aux-loss: {args.model_name} has no auxiliary "
                "classifier head (inception_v1/v3/v4 do)")


def _scopes(text: str | None) -> tuple[str, ...]:
    return tuple(s.strip() for s in text.split(",")) if text else ()


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    add_slim_flags(p)
    args = p.parse_args(argv)
    common.refuse_ignored_tf_checkpoint(p, args.tf_checkpoint)

    batch_size = args.batch_size or 32
    mesh = make_run_mesh(p, args, batch_size)
    if not in_mesh(mesh):
        return idle(mesh)
    if mesh is not None and batch_size % mesh.size(0):
        p.error(f"--batch-size {batch_size} does not split over "
                f"--num-clones {mesh.size(0)}")
    iters = args.iters or 1000
    lr = args.learning_rate or 0.01
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    size_kw = {"image_size": args.image_size} if args.image_size else {}
    imdb = common.shard_dataset(get_dataset(
        args.dataset_name, args.dataset_split_name,
        batch_size=common.local_batch(batch_size, mesh),
        data_path=args.data_path, seed=args.seed,
        preprocessing_name=args.preprocessing_name, **size_kw), mesh)
    if not 0 <= args.labels_offset < imdb.num_class:
        p.error(f"--labels-offset {args.labels_offset} out of range for "
                f"{imdb.num_class} classes")
    model = build_model(p, args, imdb, imdb.num_class - args.labels_offset)
    if args.model_parallel > 1 and args.optimizer == "lamb":
        p.error("--model-parallel shards weights; lamb's per-tensor trust "
                "ratio needs them whole")

    opt_cfg = OptimizerConfig(
        name=args.optimizer, momentum=args.momentum,
        epsilon=args.opt_epsilon, rmsprop_decay=args.rmsprop_decay,
        weight_decay=args.weight_decay,
        grad_clip_norm=args.clip_gradient_norm,
        moving_average_decay=args.moving_average_decay,
        grad_accum_steps=args.grad_accum_steps,
        trainable_scopes=_scopes(args.trainable_scopes),
        schedule=LRScheduleConfig(
            kind=args.learning_rate_decay_type, learning_rate=lr,
            decay_factor=args.learning_rate_decay_factor,
            decay_steps=args.decay_steps,
            end_learning_rate=args.end_learning_rate,
            warmup_steps=args.warmup_steps))
    trainer = Trainer(
        model, softmax_task(label_smoothing=args.label_smoothing), opt_cfg,
        device=args.device, compute_dtype=dtype,
        activation_summaries=args.activation_summaries, mesh=mesh)
    paths = Paths()
    mgr = CheckpointManager(args.model_name, imdb.name, paths=paths)
    writer = MetricsWriter(
        paths.tb_dirs(args.model_name, imdb.name, val=False)[0])
    # a TF checkpoint is a file prefix (path or path.index), a snapshot
    # of this package a directory
    warm_dir, warm_tree = args.checkpoint_path, None
    if warm_dir and not os.path.isdir(warm_dir):
        common.require_tf_checkpoint(p, "--checkpoint-path", warm_dir)
        warm_tree = import_tf_for(p, args.model_name, warm_dir)
        warm_dir = None
    state, start = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed),
        warm_start_dir=warm_dir, warm_start_tree=warm_tree,
        warm_start_exclude=_scopes(args.checkpoint_exclude_scopes))
    try:
        common.run_train_loop(
            trainer, state, offset_labels(imdb.get, args.labels_offset), mgr,
            writer, start_iter=start, num_iters=iters,
            log_every=args.log_every,
            save_every=args.save_every or max(iters // 4, 1),
            num_workers=args.num_workers,
            save_interval_secs=args.save_interval_secs,
            trace_dir=args.profile_dir)
        release_idle(mesh)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
