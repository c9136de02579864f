"""Adversarial-robustness training (port of
tensorflow_yolo2_tpu/entries/imagenet_train_adversarial.py).

Every iteration a clean step and an FGSM step (``train.adversarial``) on
a contrast-channel classifier (``models.contrast.ContrastInputModel``
around ``--backbone``, resnet_v1_50 by default), sparse softmax
cross-entropy, momentum 0.9 at 1e-3, batch 18 (the reference's), 10 000
iterations, on the augmented train split of ILSVRC CLS-LOC
(``data.ilsvrc.IlsvrcCls``; ``--noise-aug`` adds its ±ε sign noise).
Four metric streams: train and val, each with ``clean/`` and ``adv/``
keys (a validation batch and its FGSM images every ``--eval-every``
iterations; without a usable val split the run trains on with a
warning). Snapshots go to ``ckpts/<backbone>_adv/ilsvrc_2017_cls``,
every ``--save-every`` iterations (a quarter of the run by default) and
after the last; a run resumes from the newest.

- The attack is white-box against the classifier being trained, unless
  ``--attack-model NAME`` names a separate, frozen generator (the
  reference's pretrained inception_v3: a transfer attack), fresh from
  ``--seed`` + 1, then ``--tf-attack-weights`` (a TF checkpoint,
  ``compat.tf_import.import_checkpoint_for``) and ``--attack-snapshot``
  (this package's snapshot dir, or a ``.npz`` of ``convert.save_npz``;
  an Orbax dir of the JAX package is refused, naming the ``.npz``
  carrier) merged in by name and shape.
- ``--tf-weights`` warm-starts a fresh run's backbone from a slim
  Inception-ResNet-v2 TF checkpoint, by name and shape (the
  ``input_transform`` conv and a reshaped logits layer keep their fresh
  weights).
- ``--grouped-opt``: the reference's two optimizers, Adam(1e-5) on the
  backbone's ``conv1a`` and ``conv2a`` and Adam(``--learning-rate``) on
  ``input_transform``, everything else frozen
  (``train.optimizers.make_grouped_optimizer``).

One device (the JAX entry's mesh is one device until parallelism is
ported). Runs on ``cuda`` unless ``--device`` names another device.

    python -m tensorflow_yolo2_torch.entries.imagenet_train_adversarial \\
        --backbone inception_resnet_v2 --image-size 299 \\
        --attack-model inception_v3 --grouped-opt --iters 100
"""

from __future__ import annotations

import os

import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
)
from tensorflow_yolo2_torch.convert import load_npz, state_dict_from_flax
from tensorflow_yolo2_torch.data.ilsvrc import IlsvrcCls
from tensorflow_yolo2_torch.data.prefetch import PrefetchLoader, device_prefetch
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.models.contrast import ContrastInputModel
from tensorflow_yolo2_torch.models.darknet import init_params_
from tensorflow_yolo2_torch.models.registry import get_network
from tensorflow_yolo2_torch.parallel.mesh import idle, in_mesh, release_idle
from tensorflow_yolo2_torch.train.adversarial import (
    adversarial_train_step_pair,
    make_attack,
)
from tensorflow_yolo2_torch.train.checkpoint import (
    SNAPSHOT_FILE,
    CheckpointManager,
    merge_into_model,
    read_snapshot,
)
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.optimizers import make_grouped_optimizer
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
from tensorflow_yolo2_torch.utils.device import device_normalize

GROUPED_STEM_LR = 1e-5
GROUPED_STEM_SCOPES = ("backbone/conv1a", "backbone/conv2a")


def read_attack_snapshot(path: str) -> dict:
    """A generator's weights as a state dict: this package's snapshot dir,
    or a ``.npz`` of ``convert.save_npz``. An Orbax dir of the JAX
    package needs JAX to read: ``ValueError`` naming the ``.npz``
    carrier."""
    if os.path.isdir(path):
        if not os.path.isfile(os.path.join(path, SNAPSHOT_FILE)):
            raise ValueError(
                f"--attack-snapshot {path} holds no {SNAPSHOT_FILE}: not a "
                "snapshot of this package. An Orbax snapshot of the JAX "
                "package needs JAX to read; write its params and "
                "batch_stats with convert.save_npz there and pass the .npz")
        return read_snapshot(path)["model"]
    return state_dict_from_flax(*load_npz(path))


def grouped_tx_factory(lr: float):
    """The reference's grouped optimizers: Adam(1e-5) on the backbone's
    stem convs, Adam(``lr``) on ``input_transform``, the rest frozen."""
    stem = OptimizerConfig(name="adam", schedule=LRScheduleConfig(
        learning_rate=GROUPED_STEM_LR))
    transform = OptimizerConfig(name="adam", schedule=LRScheduleConfig(
        learning_rate=lr))
    return lambda params: make_grouped_optimizer(
        [(GROUPED_STEM_SCOPES, stem), (("input_transform",), transform)],
        params)


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--backbone", default="resnet_v1_50")
    p.add_argument("--epsilon", type=float, default=8 / 255 * 2)
    p.add_argument("--noise-aug", action="store_true",
                   help="±ε sign-noise augmentation in the host loader")
    p.add_argument("--tf-weights", default=None,
                   help="slim inception_resnet_v2 TF checkpoint to "
                        "warm-start the backbone from (fresh runs only)")
    p.add_argument("--attack-model", default=None,
                   help="separate generator model for the FGSM attack "
                        "(reference: pretrained inception_v3); default "
                        "attacks the classifier being trained")
    p.add_argument("--attack-snapshot", default=None,
                   help="the generator's weights: a snapshot dir of this "
                        "package or a convert.save_npz .npz (merged by "
                        "name and shape); fresh weights if absent")
    p.add_argument("--tf-attack-weights", default=None,
                   help="TF checkpoint to load the attack generator from "
                        "(e.g. the reference's pretrained inception_v3)")
    p.add_argument("--image-size", type=int, default=None,
                   help="input resolution (default: the loader's)")
    p.add_argument("--grouped-opt", action="store_true",
                   help="the reference's grouped two-optimizer recipe: "
                        "Adam(1e-5) on the backbone stem convs "
                        "(conv1a/conv2a) + Adam(--learning-rate) on the "
                        "input-transform conv; all else frozen")
    args = p.parse_args(argv)
    common.refuse_ignored_tf_checkpoint(p, args.tf_checkpoint)
    if (args.attack_snapshot or args.tf_attack_weights) and \
            not args.attack_model:
        p.error("--attack-snapshot / --tf-attack-weights load the attack "
                "generator; name it with --attack-model")
    common.require_tf_checkpoint(p, "--tf-weights", args.tf_weights)
    common.require_tf_checkpoint(p, "--tf-attack-weights",
                                 args.tf_attack_weights)

    batch_size = args.batch_size or 18
    mesh = common.start_mesh(batch_size, args.device)
    if not in_mesh(mesh):
        return idle(mesh)
    local = common.local_batch(batch_size, mesh)
    iters = args.iters or 10_000
    lr = args.learning_rate or 1e-3
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    size_kw = {"image_size": args.image_size} if args.image_size else {}
    imdb = common.shard_dataset(IlsvrcCls(
        "train", batch_size=local, data_aug=True,
        random_noise=args.noise_aug, data_path=args.data_path,
        seed=args.seed, **size_kw), mesh)
    val_imdb = None
    if args.eval_every:
        try:
            val_imdb = common.shard_dataset(IlsvrcCls(
                "val", batch_size=local, data_aug=False,
                data_path=args.data_path, seed=args.seed, **size_kw), mesh)
        except (FileNotFoundError, OSError) as e:
            print(f"WARNING: no usable val split ({e}) — "
                  "training without validation streams")
    backbone = get_network(args.backbone, num_classes=imdb.num_class,
                           image_size=imdb.image_size)
    model = ContrastInputModel(backbone)
    trainer = Trainer(
        model, softmax_task(),
        OptimizerConfig(name="momentum", momentum=0.9,
                        schedule=LRScheduleConfig(learning_rate=lr)),
        device=args.device, compute_dtype=dtype,
        tx_factory=grouped_tx_factory(lr) if args.grouped_opt else None,
        mesh=mesh)
    paths = Paths()
    name = f"{args.backbone}_adv"
    mgr = CheckpointManager(name, imdb.name, save_by_epoch=False,
                            paths=paths)
    tb_train, tb_val = paths.tb_dirs(name, imdb.name)
    state, start = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed))

    if args.tf_weights and start == 0:
        from tensorflow_yolo2_torch.compat.tf_import import (
            import_inception_resnet_v2_checkpoint,
            state_dict_for,
        )
        n_p, n_s = merge_into_model(state.model, state_dict_for(
            import_inception_resnet_v2_checkpoint(args.tf_weights),
            prefix="backbone"))
        print(f"Warm-started {n_p} param / {n_s} stat tensors "
              f"from {args.tf_weights}")

    if args.attack_model:
        gen = get_network(args.attack_model, num_classes=imdb.num_class,
                          image_size=imdb.image_size)
        init_params_(gen, torch.Generator().manual_seed(args.seed + 1))
        if args.tf_attack_weights:
            from tensorflow_yolo2_torch.compat.tf_import import (
                import_checkpoint_for,
                state_dict_for,
            )
            n_p, n_s = merge_into_model(gen, state_dict_for(
                import_checkpoint_for(args.attack_model,
                                      args.tf_attack_weights)))
            print(f"Attack generator {args.attack_model}: imported {n_p} "
                  f"param / {n_s} stat tensors from "
                  f"{args.tf_attack_weights}")
        if args.attack_snapshot:
            n_p, n_s = merge_into_model(gen,
                                  read_attack_snapshot(args.attack_snapshot))
            print(f"Attack generator {args.attack_model}: restored {n_p} "
                  f"param / {n_s} stat tensors from {args.attack_snapshot}")
        gen.to(trainer.device, memory_format=torch.channels_last)
        gen.requires_grad_(False)  # frozen: only the images' gradient
        attack_fn = make_attack(gen, args.epsilon, dtype)
    else:
        attack_fn = make_attack(state.model, args.epsilon, dtype)

    save_every = args.save_every or max(iters // 4, 1)
    last_saved = start
    writer, val_writer = MetricsWriter(tb_train), MetricsWriter(tb_val)

    def scalars(clean, adv) -> dict[str, float]:
        vals = {f"clean/{k}": float(v) for k, v in clean.items()}
        vals.update({f"adv/{k}": float(v) for k, v in adv.items()})
        return vals

    try:
        with PrefetchLoader(imdb.get, num_workers=args.num_workers) as loader:
            stream = device_prefetch(iter(loader), size=2,
                                     device=trainer.device)
            for i in range(start + 1, start + iters + 1):
                images, labels = next(stream)
                state, clean_m, adv_m = adversarial_train_step_pair(
                    trainer, state, images, labels, epsilon=args.epsilon,
                    attack_fn=attack_fn)
                if trainer.is_chief and i % args.log_every == 0:
                    vals = scalars(clean_m, adv_m)
                    writer.scalars(i, vals)
                    print(f"iter {i}: " + ", ".join(
                        f"{k}: {v:.4f}" for k, v in vals.items()))
                if val_imdb is not None and i % args.eval_every == 0:
                    vx, vy = val_imdb.get()
                    vx = device_normalize(torch.as_tensor(vx).to(
                        trainer.device))
                    vy = torch.as_tensor(vy).to(trainer.device)
                    vm = trainer.eval_step(state, vx, vy)
                    vam = trainer.eval_step(state, attack_fn(vx, vy), vy)
                    vvals = scalars(vm, vam)
                    if trainer.is_chief:
                        val_writer.scalars(i, vvals)
                        print(f"iter {i} [val]: " + ", ".join(
                            f"{k}: {v:.4f}" for k, v in vvals.items()))
                if i % save_every == 0:
                    common.save_snapshot(trainer, mgr, i, state)
                    last_saved = i
        if iters > 0 and last_saved != start + iters:
            common.save_snapshot(trainer, mgr, start + iters, state)
            if trainer.is_chief:
                print(f"Saved final snapshot at iter {start + iters}")
        release_idle(mesh)
    finally:
        writer.close()
        val_writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
