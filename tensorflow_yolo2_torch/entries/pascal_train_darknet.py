"""Darknet19 YOLO detection training on Pascal VOC2007 (port of
tensorflow_yolo2_tpu/entries/pascal_train_darknet.py).

Darknet19 trunk + a detection head + its loss, Adam at 1e-3, batch 24,
80k added iterations, a snapshot every 40k; resume from this run's newest
snapshot, else a warm start from the newest ImageNet classifier snapshot
(``ckpts/darknet19/ilsvrc_2017_cls``). 224² (S=7), bf16 compute with
float32 parameters. Three heads:

- v1 (default): the reference's grid head (B=2, C=20) and YOLOv1 loss;
- ``--v2``: the anchor head (linear output conv, 5 classic VOC priors,
  or ``--anchors kmeans`` dimension clusters of this image set) and the
  YOLOv2 loss on per-slot label grids; ``--multiscale`` hops between
  input sizes every 10 batches;
- ``--v2 --passthrough``: the YOLOv2 architecture with the reorg route.

An anchor run writes its priors to ``anchors.json`` beside its snapshots
before the first step. Runs on ``cuda`` unless ``--device`` names another
device.

    python -m tensorflow_yolo2_torch.entries.pascal_train_darknet \\
        --iters 1000 --save-every 500
    python -m tensorflow_yolo2_torch.entries.pascal_train_darknet \\
        --v2 --passthrough --anchors kmeans --iters 1000

``--tf-checkpoint`` starts from the reference's detector checkpoint (TF
V1 or V2, read in numpy alone: ``compat.tf_import``) in place of fresh
weights; the classifier's snapshot, where there is one, still warm-starts
the trunk over it, as in the JAX package.

``--spatial N`` trains with the H dimension sharded over N ranks, one
process each (``torchrun --nproc-per-node N``): per-layer halo exchange
and live BatchNorm on the ranks' summed statistics
(``parallel.spatial``), Adam with ``--grad-clip``; any head and trunk.
Rank 0 reads the batches and writes the snapshots, which keep the
normal trainer's keys. Started under ``torchrun``, the normal path is
data-parallel over the ranks (``entries.common.start_mesh``).
"""

from __future__ import annotations

import contextlib
import os
import random
import threading

import numpy as np
import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
    YoloConfig,
    yolo_v2_config,
)
from tensorflow_yolo2_torch.data.anchors import (
    collect_voc_wh_cells,
    iou_kmeans,
    persist_anchors,
)
from tensorflow_yolo2_torch.data.prefetch import PrefetchLoader
from tensorflow_yolo2_torch.data.voc import PascalVOC
from tensorflow_yolo2_torch.entries import common
from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_task
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Detector,
    Darknet19DetectorV2,
)
from tensorflow_yolo2_torch.parallel.mesh import (
    in_mesh,
    idle,
    maybe_initialize_distributed,
    rank,
    release_idle,
)
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

MULTISCALE_HOP = 10  # batches between two multiscale size draws


def multiscale_batches(imdbs: dict, seed: int):
    """``get_batch`` of YOLO9000 multiscale training: every
    ``MULTISCALE_HOP`` batches a size drawn from ``imdbs`` (size →
    dataset) with ``random.Random(seed)``, then that size's next batch.
    Safe to call from several prefetch threads."""
    sizes = sorted(imdbs)
    rng = random.Random(seed)
    lock = threading.Lock()
    state = {"count": 0, "size": sizes[0]}

    def get_batch():
        with lock:
            if state["count"] % MULTISCALE_HOP == 0:
                state["size"] = rng.choice(sizes)
            state["count"] += 1
            imdb = imdbs[state["size"]]
        return imdb.get()

    return get_batch


def run_spatial_training(args, mesh, yolo, trainer: Trainer, get_batch,
                         mgr, writer, warm: str | None, imported,
                         iters: int, save_every: int) -> int:
    """The H-sharded training loop (``--spatial N``): the detector runs
    over the ranks of ``mesh`` (``parallel.spatial.spatial_mesh``;
    ``parallel.spatial.spatial_yolo_train_fn`` / ``_v2_train_fn``) and
    the trainer's optimizer (Adam, ``--grad-clip``) applies the summed
    gradients, the same on every rank. The state comes from
    ``common.bootstrap_state`` (a resume, a warm start, fresh weights)
    and is saved with the trainer's keys, so detect / eval serve it and
    a normal run resumes it. ``get_batch`` is rank 0's (None on the
    others)."""
    from tensorflow_yolo2_torch.parallel.spatial import (
        spatial_yolo_train_fn,
        spatial_yolo_v2_train_fn,
    )
    from tensorflow_yolo2_torch.train.optimizers import global_norm
    from tensorflow_yolo2_torch.utils.timer import Timer

    group = mesh.get_group("spatial")
    chief = torch.distributed.get_rank(group) == 0
    if args.v2:
        # the ignore term's global GT pool rides one all-gather of the
        # label boxes; --passthrough selects the reorg head
        step_fn = spatial_yolo_v2_train_fn(
            mesh, yolo, bn_momentum=args.bn_momentum,
            downsample=args.downsample,
            head="v2p" if args.passthrough else "v2")
    else:
        step_fn = spatial_yolo_train_fn(mesh, yolo, bn_on_output=True,
                                        bn_momentum=args.bn_momentum,
                                        downsample=args.downsample)
    state, start = common.bootstrap_state(
        trainer, mgr, torch.Generator().manual_seed(args.seed),
        warm_start_dir=warm, state_dict=imported)
    model = state.model
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    timer = Timer()
    last_saved = start

    def save(i: int) -> None:
        if chief:
            mgr.save(i, state)
            print(f"Saved snapshot at iter {i} (iter {i})")
        torch.distributed.barrier(group=group)

    with PrefetchLoader(get_batch, num_workers=args.num_workers) \
            if chief else contextlib.nullcontext() as loader:
        stream = iter(loader) if chief else None
        for i in range(start + 1, start + iters + 1):
            images, labels = next(stream) if chief else (None, None)
            timer.tic()
            extra = (state.step,) if args.v2 else ()
            loss, grads, new_stats = step_fn(params, stats, images, labels,
                                             *extra)
            trainer.optimizer.update_(grads, state.opt_state, params,
                                      global_norm(grads.values()))
            with torch.no_grad():
                for k, v in new_stats.items():
                    stats[k].copy_(v)
            state.step += 1
            timer.toc()
            if chief and i % args.log_every == 0:
                lv = float(loss)
                writer.scalars(i, {"loss": lv})
                print(f"iter {i}: loss: {lv:.4f}, "
                      f"avg step {timer.average_time * 1000:.1f} ms")
            if save_every and i % save_every == 0:
                save(i)
                last_saved = i
    final = start + iters
    if iters > 0 and last_saved != final:
        save(final)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = common.base_parser(__doc__)
    p.add_argument("--image-set", default="trainval")
    p.add_argument("--flipped", action="store_true")
    p.add_argument("--v2", action="store_true",
                   help="the anchor head and the YOLOv2 loss (per-slot "
                        "classes, 5 classic VOC priors) instead of the v1 "
                        "grid head")
    p.add_argument("--passthrough", action="store_true",
                   help="with --v2: the YOLOv2 architecture, the reorg "
                        "route from the H/16 map into the head")
    p.add_argument("--anchors", default="classic",
                   choices=["classic", "kmeans"],
                   help="with --v2: the priors, the paper's VOC clusters "
                        "('classic') or IoU k-means clusters of this image "
                        "set's boxes ('kmeans'); they are written to "
                        "anchors.json beside the snapshots")
    p.add_argument("--num-anchors", type=int, default=5,
                   help="k for --anchors kmeans (B follows it)")
    p.add_argument("--multiscale", default=None,
                   help="with --v2: comma-separated input sizes (multiples "
                        "of 32), one drawn every 10 batches (YOLO9000 "
                        "multiscale training)")
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
    p.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="train with the H dimension sharded over N ranks "
                        "(per-layer halo exchange, live BatchNorm on the "
                        "ranks' summed statistics: parallel.spatial); "
                        "the v1 head, --v2, or --v2 --passthrough, with "
                        "--downsample stride too; start one process a "
                        "rank: torchrun --nproc-per-node N -m <this "
                        "entry>")
    args = p.parse_args(argv)
    if args.spatial and args.spatial < 2:
        p.error("--spatial N needs N >= 2 (1 shard is the normal path)")
    if args.spatial and (args.multiscale or args.uint8_transfer):
        p.error("--spatial composes with --downsample/--grad-clip/"
                "--lr-decay but not --multiscale/--uint8-transfer")
    common.require_tf_checkpoint(p, "--tf-checkpoint", args.tf_checkpoint)
    if args.tf_checkpoint and (args.v2 or args.downsample != "pool"):
        p.error("--tf-checkpoint imports the reference's v1 detector "
                "(pool downsample); not with --v2 or --downsample stride")
    if args.multiscale and not args.v2:
        p.error("--multiscale requires --v2 (the anchor loss is "
                "grid-size polymorphic; the v1 grid loss is fixed S=7)")
    if args.passthrough and not args.v2:
        p.error("--passthrough is the YOLOv2 reorg head; it requires --v2")
    if args.anchors == "kmeans" and not args.v2:
        p.error("--anchors kmeans requires --v2 (the v1 head has no "
                "anchor priors)")
    sizes = None
    if args.multiscale:
        sizes = sorted({int(s) for s in args.multiscale.split(",")})
        if any(s % 32 for s in sizes):
            p.error("--multiscale sizes must be multiples of 32")

    batch_size = args.batch_size or 24
    if args.spatial:
        from tensorflow_yolo2_torch.parallel.spatial import spatial_mesh

        maybe_initialize_distributed(args.device)
        try:
            smesh = spatial_mesh(args.spatial)
        except ValueError as e:
            p.error(str(e))
        mesh = None
    else:
        mesh = common.start_mesh(batch_size, args.device)
        if not in_mesh(mesh):
            return idle(mesh)
    iters = args.iters or 80_000
    lr = args.learning_rate or 1e-3
    save_every = args.save_every or 40_000
    dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
             else torch.float32)

    if args.v2:
        custom_anchors = None
        if args.anchors == "kmeans":
            # YOLO9000 dimension clusters of this image set's boxes
            voc_path = args.data_path or os.path.join(Paths().pascal,
                                                      "VOC2007")
            base = yolo_v2_config()
            wh = collect_voc_wh_cells(voc_path, args.image_set, base.S,
                                      base.image_size)
            custom_anchors, avg_iou = iou_kmeans(wh, args.num_anchors)
            print(f"dimension clusters (k={args.num_anchors}, {len(wh)} "
                  f"boxes, avg best-IoU {avg_iou:.3f}): " +
                  ", ".join(f"({w:.2f},{h:.2f})" for w, h in custom_anchors))
        yolo = yolo_v2_config(anchors=custom_anchors)
        task = yolo_v2_task(yolo)
        if args.passthrough:
            model = Darknet19DetectorV2(yolo.cell_channels,
                                        downsample=args.downsample,
                                        bn_momentum=args.bn_momentum)
            net_name = "darknet19_v2p"
        else:
            # the anchor head's output conv is linear
            model = Darknet19Detector(yolo.cell_channels, bn_on_output=False,
                                      downsample=args.downsample,
                                      bn_momentum=args.bn_momentum)
            net_name = "darknet19_v2"
    else:
        yolo = YoloConfig()
        task = yolo_task(yolo, histograms=True)
        model = Darknet19Detector(output_channels=yolo.cell_channels,
                                  bn_momentum=args.bn_momentum,
                                  downsample=args.downsample)
        net_name = "darknet19"
    if args.downsample == "stride":
        net_name += "_sd"  # keep the non-reference variant apart

    def dataset(cfg: YoloConfig, seed: int) -> PascalVOC:
        return common.shard_dataset(PascalVOC(
            args.image_set, batch_size=common.local_batch(batch_size, mesh),
            yolo=cfg, flipped=args.flipped, data_path=args.data_path,
            uint8=args.uint8_transfer, rng=np.random.default_rng(seed)),
            mesh)

    # a spatial run's batches are rank 0's: it alone reads the set
    reads = not args.spatial or rank() == 0
    imdb = dataset(yolo, args.seed) if reads else None
    imdb_name = imdb.name if reads else "voc_2007"
    get_batch = imdb.get if reads else None
    if sizes:
        # one dataset a size, each with its own grids (S = size/32); the
        # anchor task re-grids itself from the labels' S
        imdbs = {s: imdb if s == yolo.image_size else
                 dataset(yolo.at_scale(s // 32), args.seed + s)
                 for s in sizes}
        get_batch = multiscale_batches(imdbs, args.seed)
    paths = Paths()
    mgr = CheckpointManager(net_name, imdb_name, paths=paths, yolo=yolo)
    # a resumed run's optimizer count is cumulative: anchor a decaying
    # schedule at the resumed step so that it spans this run's --iters
    resume_step = mgr.latest_step() or 0
    sched = LRScheduleConfig(
        kind=args.lr_decay, learning_rate=lr,
        decay_steps=max(1, iters if args.lr_decay == "cosine"
                        else iters // 4),
        decay_factor=args.lr_decay_factor,
        offset_steps=resume_step if args.lr_decay != "fixed" else 0)
    if args.v2 and rank() == 0:
        # detect and eval decode with the priors written here; refused if
        # the dir holds snapshots trained against other priors
        persist_anchors(mgr.dir, yolo.anchors, yolo.S,
                        has_snapshots=mgr.latest_path() is not None)
    writer = MetricsWriter(paths.tb_dirs(net_name, imdb_name, val=False)[0])
    trainer = Trainer(model, task,
                      OptimizerConfig(name="adam", schedule=sched,
                                      grad_clip_norm=args.grad_clip),
                      device=args.device, compute_dtype=dtype, mesh=mesh)
    # warm start from the newest ImageNet classifier snapshot, if any
    warm = CheckpointManager("darknet19", "ilsvrc_2017_cls",
                             save_by_epoch=True, paths=paths).latest_path()
    imported = None
    if args.tf_checkpoint:
        from tensorflow_yolo2_torch.compat.tf_import import (
            import_darknet19_checkpoint,
            state_dict_for,
        )
        imported = state_dict_for(import_darknet19_checkpoint(
            args.tf_checkpoint, detection=True))
    try:
        if args.spatial:
            return run_spatial_training(args, smesh, yolo, trainer,
                                        get_batch, mgr, writer, warm,
                                        imported, iters, save_every)
        state, start = common.bootstrap_state(
            trainer, mgr, torch.Generator().manual_seed(args.seed),
            warm_start_dir=warm, state_dict=imported)
        common.run_train_loop(
            trainer, state, get_batch, mgr, writer, start_iter=start,
            num_iters=iters, log_every=args.log_every,
            save_every=save_every, num_workers=args.num_workers,
            trace_dir=args.profile_dir)
        release_idle(mesh)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
