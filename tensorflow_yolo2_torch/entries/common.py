"""Shared wiring of the training entry points (port of
tensorflow_yolo2_tpu/entries/common.py): the base CLI flags, the
resume / warm-start bootstrap, the train loop (dataset → prefetch
threads → device copies → step → metrics → snapshots), and the data
mesh of a run started by ``torchrun`` (``start_mesh``: each rank reads
its own shard of the data, ``shard_dataset``; rank 0 alone writes
snapshots, metrics and logs)."""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist

from tensorflow_yolo2_torch.compat.tf_bundle import checkpoint_present
from tensorflow_yolo2_torch.compat.tf_import import (
    import_resnet50_checkpoint,
    state_dict_for,
)
from tensorflow_yolo2_torch.convert import state_dict_from_flax
from tensorflow_yolo2_torch.data.memory import InMemoryImdb
from tensorflow_yolo2_torch.data.prefetch import PrefetchLoader, device_prefetch
from tensorflow_yolo2_torch.parallel.mesh import (
    make_mesh_for_batch,
    maybe_initialize_distributed,
)
from tensorflow_yolo2_torch.train.checkpoint import (
    CheckpointManager,
    load_into,
    merge_pytrees,
    warm_start_params,
)
from tensorflow_yolo2_torch.train.metrics import MetricsWriter
from tensorflow_yolo2_torch.train.trainer import Trainer, TrainState
from tensorflow_yolo2_torch.utils.profiling import maybe_trace
from tensorflow_yolo2_torch.utils.timer import Timer


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--iters", type=int, default=None,
                   help="additional training iterations")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--save-every", type=int, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num-workers", type=int, default=4,
                   help="host prefetch threads")
    p.add_argument("--data-path", default=None)
    p.add_argument("--tf-checkpoint", default=None,
                   help="TF1 checkpoint to import weights from (where the "
                        "entry reads one)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of the "
                        "train loop into this dir")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def start_mesh(batch_size: int, device, model: int = 1):
    """The run's (data, model) mesh: the process group from torchrun's
    environment (``parallel.mesh.maybe_initialize_distributed``) and
    ``make_mesh_for_batch(batch_size, model)``; None for a run without a
    launcher, which stays one process."""
    maybe_initialize_distributed(device)
    return make_mesh_for_batch(batch_size, model)


def data_shard(mesh) -> tuple[int, int]:
    """(this rank's data index, the data axis's size): (0, 1) without a
    mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_coordinate()[0], mesh.size(0)


def local_batch(batch_size: int, mesh) -> int:
    """This rank's rows of a global batch of ``batch_size``."""
    return batch_size // data_shard(mesh)[1]


def shard_dataset(imdb, mesh):
    """``imdb`` cut to this rank's shard, in place: every ``count``-th
    entry of its seeded listing from its data index on (the ranks build
    the listing with the same seed, so the shards partition it); each
    rank then shuffles its shard anew each epoch. Lists of entries
    (``gt_labels``; TF_flowers' ``train_list`` / ``val_list``) and the
    in-memory datasets' arrays are cut; another dataset raises."""
    index, count = data_shard(mesh)
    if count == 1:
        return imdb
    if hasattr(imdb, "gt_labels"):
        imdb.gt_labels = imdb.gt_labels[index::count]
    elif hasattr(imdb, "train_list"):
        imdb.train_list = imdb.train_list[index::count]
        imdb.val_list = imdb.val_list[index::count]
    elif isinstance(imdb, InMemoryImdb):
        imdb._images = imdb._images[index::count]
        imdb._labels = imdb._labels[index::count]
        imdb._order = imdb._rng.permutation(len(imdb._labels))
    else:
        raise ValueError(f"cannot shard {type(imdb).__name__} over the "
                         "data axis")
    return imdb


def sum_over_data(mesh, *values: float) -> list[float]:
    """Counts summed over the data axis (the evaluators' hits and
    totals); as they are without a mesh."""
    if mesh is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64,
                     device="cuda" if dist.get_backend() == "nccl"
                     else "cpu")
    dist.all_reduce(t, group=mesh.get_group("data"))
    return t.tolist()


def _any_rank(trainer: Trainer, flag: bool) -> bool:
    """Whether ``flag`` holds on any rank of the trainer's mesh, so that
    every rank takes a wall-clock save together."""
    t = torch.tensor([float(flag)], device=trainer.device)
    for g in (trainer.data_group, trainer.model_group):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return bool(t.item())


def save_snapshot(trainer: Trainer, mgr: CheckpointManager, step: int,
                  state: TrainState) -> None:
    """``mgr.save`` of the whole state (``Trainer.snapshot_state``) by
    rank 0 alone, then a barrier over the mesh."""
    whole = trainer.snapshot_state(state)
    if trainer.is_chief:
        mgr.save(step, whole)
    trainer.barrier()


def require_tf_checkpoint(parser: argparse.ArgumentParser, flag: str,
                          path: Optional[str]) -> None:
    """A TF checkpoint named on the command line must be there: the
    parser's error otherwise (the JAX entries pass over a missing one and
    start from other weights)."""
    if path and not checkpoint_present(path):
        parser.error(f"{flag} {path}: no TF checkpoint there (neither "
                     f"{path}.index nor {path})")


def refuse_ignored_tf_checkpoint(parser: argparse.ArgumentParser,
                                 tf_checkpoint: Optional[str]) -> None:
    """The JAX entries that take ``--tf-checkpoint`` with the shared flags
    and read no TF checkpoint through it (``flowers_train``,
    ``imagenet_train_darknet``, ``imagenet_test_darknet``,
    ``train_classifier``, ``imagenet_train_adversarial``) ignore it; the
    port refuses it, so that a run never looks as if it started from
    weights it did not read."""
    if tf_checkpoint:
        parser.error("--tf-checkpoint: the JAX entry reads no TF checkpoint "
                     "through this flag (it ignores it); refused here "
                     "rather than ignored")


def resnet_tf_trunk(tf_checkpoint: Optional[str], weights_dir: str,
                    prefix: Optional[str] = None
                    ) -> Optional[dict[str, torch.Tensor]]:
    """The ResNet entries' TF warm start, as in the JAX package: the slim
    resnet_v1_50 checkpoint given with ``--tf-checkpoint``, else
    ``<weights>/resnet_v1_50.ckpt[.index]``, imported as a state dict
    (under ``prefix``, a module path such as ``"backbone"``); None when
    neither exists."""
    path = tf_checkpoint or os.path.join(weights_dir, "resnet_v1_50.ckpt")
    if not checkpoint_present(path):
        return None
    print(f"Importing TF checkpoint {path}")
    return state_dict_for(import_resnet50_checkpoint(path), prefix)


def _as_state_dict(params: Mapping[str, Any],
                   batch_stats: Mapping[str, Any] | None
                   ) -> dict[str, Any]:
    """A (params, batch_stats) pair of flax trees (nested dicts of
    arrays) or of flat state dicts → one state dict."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return state_dict_from_flax(params, batch_stats)
    return {**params, **(batch_stats or {})}


def bootstrap_state(trainer: Trainer, mgr: CheckpointManager,
                    generator: torch.Generator,
                    warm_start_dir: Optional[str] = None,
                    warm_start_exclude: tuple[str, ...] = (),
                    warm_start_tree: Optional[tuple[Any, Any]] = None,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                    info: Optional[dict] = None
                    ) -> tuple[TrainState, int]:
    """Resume or initialize:

    1. the newest snapshot of this run → exact resume; when its optimizer
       state does not fit, the model's tensors by name and shape and a
       fresh optimizer (the optimizer swap);
    2. otherwise parameters from ``warm_start_dir`` (another run's
       snapshot) outside the excluded scopes, or parameters and BatchNorm
       statistics from ``warm_start_tree``, a (params, batch_stats) pair
       of flax trees or state dicts;
    3. otherwise fresh weights from ``generator`` (or ``state_dict``).

    With EMA the EMA comes from the snapshot where it holds one (by name
    and shape in the swap), and restarts from the restored or
    warm-started parameters otherwise, never from the fresh ones.
    ``info`` (if given) receives ``ema_restored``: how many EMA tensors
    came from the snapshot, −1 for an exact restore with EMA, 0 for none.

    Returns (state, step).
    """
    if info is None:
        info = {}
    info["ema_restored"] = 0
    last = mgr.latest_step()
    if last is not None:
        # an exact restore overwrites every tensor: no fresh weights drawn
        seed_state = generator.get_state()
        try:
            state, step = mgr.restore(trainer.create_state(generator,
                                                           init=False))
            if state.ema_params is not None:
                info["ema_restored"] = -1
        except ValueError:
            generator.set_state(seed_state)
            state = trainer.create_state(generator, state_dict)
            raw = mgr.restore_raw()
            merged, _ = merge_pytrees(state.model.state_dict(), raw["model"])
            load_into(state.model, merged)
            trainer.restart_ema(state)
            if state.ema_params is not None and raw.get("ema") is not None:
                ema, info["ema_restored"] = merge_pytrees(state.ema_params,
                                                          raw["ema"])
                state.ema_params = {k: v.to(state.ema_params[k].device)
                                    for k, v in ema.items()}
            state = trainer.resume_optimizer(state)
            state.step = step = last
            print("Optimizer state in snapshot does not match — restored "
                  "params/stats only, optimizer re-initialized")
        print(f"Restored snapshot at {mgr.interval} {step} from {mgr.dir}")
        return state, step
    state = trainer.create_state(generator, state_dict)
    if warm_start_dir:
        params = {k: p.detach() for k, p in state.params.items()}
        params, n = warm_start_params(params, warm_start_dir,
                                      warm_start_exclude)
        load_into(state.model, params)
        trainer.restart_ema(state)
        print(f"Warm-started {n} tensors from {warm_start_dir}")
    elif warm_start_tree is not None:
        tree = _as_state_dict(*warm_start_tree)
        own = state.model.state_dict()
        merged, n = merge_pytrees(
            {k: own[k] for k in state.params}, tree, warm_start_exclude)
        merged_stats, m = merge_pytrees(state.batch_stats, tree,
                                        warm_start_exclude)
        load_into(state.model, {**merged, **merged_stats})
        trainer.restart_ema(state)
        print(f"Warm-started {n} param + {m} batch-stat tensors from "
              "imported checkpoint")
    return state, 0


def run_train_loop(trainer: Trainer, state: TrainState,
                   get_batch: Callable[[], tuple],
                   mgr: CheckpointManager, writer: MetricsWriter,
                   start_iter: int, num_iters: int,
                   log_every: int = 10, save_every: int = 1000,
                   num_workers: int = 4,
                   eval_fn: Optional[Callable[[TrainState, int], None]] = None,
                   eval_every: int = 0,
                   trace_dir: Optional[str] = None,
                   save_step_divisor: int = 1,
                   save_interval_secs: float = 0) -> TrainState:
    """Prefetched host batches → device copies kept two ahead → the train
    step. Right after a step is queued, its scalar metrics (stacked into
    one tensor) and, on logging steps, its histograms start their copy to
    pinned host memory behind it on the stream; they are read one step
    later, after the next step is queued, so that logging waits for the
    step before, never for the step in flight. With ``trace_dir``, the
    loop runs under a ``torch.profiler`` trace written there
    (``utils.profiling.maybe_trace``).

    ``eval_fn(state, i)`` runs after every ``eval_every``-th iteration i
    (a validation batch, say). Snapshots are saved every ``save_every``
    iterations (rank 0 alone writes them, metrics and logs under a
    mesh), as step ``i // save_step_divisor`` (an epoch-interval
    manager names snapshots by epoch: the divisor is the iterations of an
    epoch), also whenever ``save_interval_secs`` (> 0) have passed on the
    wall clock since the last save or the start, and after the last
    iteration, unless that one was saved; a tail whose step already names
    a snapshot of this run (a mid-epoch end after an epoch's snapshot) is
    not saved over it."""
    timer = Timer()
    last_save = time.monotonic()
    on_card = trainer.device.type == "cuda"
    pending: list[tuple[int, list[str], dict[str, torch.Tensor],
                        Optional[torch.cuda.Event]]] = []
    last_saved_iter = start_iter
    saved_steps: set[int] = set()

    def stage(it: int, metrics: Mapping[str, torch.Tensor]) -> None:
        names = [k for k, v in metrics.items() if v.dim() == 0]
        out = {k: v.float() for k, v in metrics.items()
               if v.dim() > 0 and it % log_every == 0}
        if names:
            out["scalars"] = torch.stack([metrics[k].float() for k in names])
        done = None
        if on_card:
            out = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                   .copy_(v, non_blocking=True) for k, v in out.items()}
            done = torch.cuda.Event()
            done.record()
        pending.append((it, names, out, done))

    def flush(upto: int) -> None:
        while len(pending) > upto:
            it, names, host, done = pending.pop(0)
            if done is not None:
                done.synchronize()
            if not trainer.is_chief:
                continue
            vals = dict(zip(names, host.pop("scalars").tolist())) \
                if names else {}
            writer.scalars(it, vals)
            if it % log_every == 0:
                for k, arr in host.items():
                    writer.histogram(it, k, arr.numpy())
                msg = ", ".join(f"{k}: {v:.4f}" for k, v in vals.items())
                print(f"iter {it}: {msg}, "
                      f"avg step {timer.average_time * 1000:.1f} ms")

    with PrefetchLoader(get_batch, num_workers=num_workers) as loader, \
            maybe_trace(trace_dir, trainer.device):
        stream = device_prefetch(iter(loader), size=2, device=trainer.device)
        for i in range(start_iter + 1, start_iter + num_iters + 1):
            images, labels = next(stream)
            timer.tic()
            state, metrics = trainer.train_step(state, images, labels)
            timer.toc()
            stage(i, metrics)
            flush(1)
            if eval_fn is not None and eval_every and i % eval_every == 0:
                eval_fn(state, i)
            due_timed = (save_interval_secs > 0 and time.monotonic() -
                         last_save >= save_interval_secs)
            if save_interval_secs > 0 and trainer.mesh is not None:
                due_timed = _any_rank(trainer, due_timed)
            if (save_every and i % save_every == 0) or due_timed:
                step = i // save_step_divisor
                save_snapshot(trainer, mgr, step, state)
                saved_steps.add(step)
                last_saved_iter = i
                last_save = time.monotonic()
                if trainer.is_chief:
                    print(f"Saved snapshot at iter {i} ({mgr.interval} "
                          f"{step})")
        flush(0)
    final = start_iter + num_iters
    if num_iters > 0 and last_saved_iter != final:
        tail = final // save_step_divisor
        if tail in saved_steps:
            if trainer.is_chief:
                print(f"Skipping tail save at iter {final}: {mgr.interval} "
                      f"{tail} already holds the epoch-boundary snapshot")
        else:
            save_snapshot(trainer, mgr, tail, state)
            if trainer.is_chief:
                print(f"Saved final snapshot at iter {final} "
                      f"({mgr.interval} {tail})")
    return state
