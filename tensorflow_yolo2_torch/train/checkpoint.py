"""Snapshots of a training run (port of
tensorflow_yolo2_tpu/train/checkpoint.py).

The JAX package's layout and naming: ``ckpts/<net>/<imdb>/train_iter_N/``
(``train_epoch_N`` for epoch intervals), the newest by step, at most
``keep`` kept. A snapshot dir holds one torch file, ``state.pt``: the
model's state dict, the optimizer's state (its count and its slots: Adam's
``mu`` and ``nu``, momentum's ``trace``, ..., of the trained parameters;
under gradient accumulation also ``mini_step`` and ``acc_grads``, so that
a resume in the middle of an accumulation is exact), the step, the
dropout generator's state where the run has one, the parameters' EMA
(``ema``) where the run keeps one, and the ``YoloConfig`` fields of the
run. Orbax snapshots of the JAX package need
JAX to read and are not read here.

Restore modes: exact resume (``restore``; ``ValueError`` when the
snapshot's model or optimizer state does not fit the target), and
intersection by name and shape (``merge_pytrees``, ``warm_start_params``)
for a warm start from another run or an optimizer swap, with excluded
scopes given as ``.``-joined module prefixes.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any, Mapping

import torch

from tensorflow_yolo2_torch.config import (
    TRAIN_SNAPSHOT_PREFIX,
    Paths,
    YoloConfig,
    scope_matches,
)
from tensorflow_yolo2_torch.train.trainer import TrainState

SNAPSHOT_FILE = "state.pt"


def merge_pytrees(init: Mapping[str, torch.Tensor],
                  restored: Mapping[str, Any] | None,
                  exclude_scopes: tuple[str, ...] = ()
                  ) -> tuple[dict[str, torch.Tensor], int]:
    """``init`` with each entry replaced by ``restored``'s entry of the
    same name and shape (cast to the init entry's type), unless the name
    lies in an excluded scope. Returns (merged, number replaced): the
    name-intersection warm start."""
    restored = restored or {}
    merged, count = dict(init), 0
    for key, leaf in init.items():
        if scope_matches(key, exclude_scopes):
            continue
        cand = restored.get(key)
        if cand is not None and tuple(cand.shape) == tuple(leaf.shape):
            merged[key] = torch.as_tensor(cand).to(leaf.dtype)
            count += 1
    return merged, count


def load_into(model: torch.nn.Module,
              entries: Mapping[str, torch.Tensor]) -> None:
    """Copy state-dict entries into the model's tensors, in place."""
    own = model.state_dict()
    with torch.no_grad():
        for key, value in entries.items():
            own[key].copy_(value)


def merge_into_model(model: torch.nn.Module,
                     state_dict: Mapping[str, Any]) -> tuple[int, int]:
    """``state_dict``'s entries merged into ``model`` by name and shape, in
    place: (parameters replaced, BatchNorm statistics replaced)."""
    own = model.state_dict()
    params = {k: own[k] for k, _ in model.named_parameters()}
    stats = {k: v for k, v in own.items()
             if k.endswith(("running_mean", "running_var"))}
    merged_p, n_p = merge_pytrees(params, state_dict)
    merged_s, n_s = merge_pytrees(stats, state_dict)
    load_into(model, {**merged_p, **merged_s})
    return n_p, n_s


def optimizer_slots(opt_state: Any) -> dict[str, dict[str, torch.Tensor]]:
    """The per-parameter tensors of an optimizer state by name (Adam's
    ``mu`` and ``nu``, momentum's ``trace``, ..., and ``acc_grads`` under
    gradient accumulation): everything but the counts."""
    slots = dict(opt_state.slots)
    if opt_state.acc_grads is not None:
        slots["acc_grads"] = opt_state.acc_grads
    return slots


def read_snapshot(path: str) -> dict[str, Any]:
    """The contents of one snapshot dir (tensors on the CPU)."""
    return torch.load(os.path.join(path, SNAPSHOT_FILE), map_location="cpu",
                      weights_only=True)


class CheckpointManager:
    """Per-(network, dataset) snapshot directory. ``yolo`` is stored in
    every snapshot."""

    def __init__(self, network_name: str, imdb_name: str,
                 save_by_epoch: bool = False, keep: int = 10,
                 paths: Paths | None = None,
                 yolo: YoloConfig | None = None):
        self.paths = paths or Paths()
        self.dir = self.paths.ckpts_dir(network_name, imdb_name)
        self.interval = "epoch" if save_by_epoch else "iter"
        self.keep = keep
        self.yolo = yolo

    def _name(self, step: int) -> str:
        return f"{TRAIN_SNAPSHOT_PREFIX}_{self.interval}_{step}"

    def _step_of(self, name: str) -> int | None:
        m = re.fullmatch(
            rf"{TRAIN_SNAPSHOT_PREFIX}_{self.interval}_(\d+)", name)
        return int(m.group(1)) if m else None

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        steps = [self._step_of(n) for n in os.listdir(self.dir)]
        return sorted(s for s in steps if s is not None)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_path(self) -> str | None:
        step = self.latest_step()
        return (os.path.join(self.dir, self._name(step))
                if step is not None else None)

    def _path(self, step: int | None) -> tuple[str, int]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return os.path.join(self.dir, self._name(step)), step

    def save(self, step: int, state: TrainState) -> str:
        """Write the snapshot into ``<name>.tmp`` and rename it to its
        name once complete, so that a save cut short (a killed process)
        leaves no snapshot dir behind, only a temporary one that
        ``all_steps`` ignores and the next save of that step replaces."""
        path = os.path.join(self.dir, self._name(step))
        tmp = path + ".tmp"
        for stale in (tmp, path):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        os.makedirs(tmp)
        opt = state.opt_state
        optimizer = {"count": opt.count,
                     **{name: {k: v.cpu() for k, v in slot.items()}
                        for name, slot in optimizer_slots(opt).items()}}
        if opt.acc_grads is not None:
            optimizer["mini_step"] = opt.mini_step
        raw = {
            "step": int(state.step),
            "model": {k: v.detach().cpu() for k, v in
                      state.model.state_dict().items()},
            "optimizer": optimizer,
            "rng": state.rng.get_state(),
            "yolo": (dataclasses.asdict(self.yolo)
                     if self.yolo is not None else None),
        }
        if state.ema_params is not None:
            raw["ema"] = {k: v.cpu() for k, v in state.ema_params.items()}
        torch.save(raw, os.path.join(tmp, SNAPSHOT_FILE))
        os.replace(tmp, path)
        self._gc()
        return path

    def restore(self, target: TrainState,
                step: int | None = None) -> tuple[TrainState, int]:
        """Exact resume into ``target`` (in place): returns (state, step).
        Raises ``ValueError`` when the snapshot's model, optimizer state
        or EMA differs from the target's in names or shapes, or holds an
        EMA where the target has none or the other way round."""
        path, step = self._path(step)
        raw = read_snapshot(path)
        own = target.model.state_dict()
        opt, saved = target.opt_state, raw.get("optimizer") or {}
        slots = optimizer_slots(opt)
        if set(saved) - {"count", "mini_step"} != set(slots) or \
                (target.ema_params is None) != (raw.get("ema") is None):
            raise ValueError(f"snapshot {path} does not match the train "
                             "state")
        pairs = [(own, raw["model"])] + [
            (slot, saved[name]) for name, slot in slots.items()]
        if target.ema_params is not None:
            pairs.append((target.ema_params, raw["ema"]))
        for mine, theirs in pairs:
            if mine.keys() != theirs.keys() or any(
                    mine[k].shape != theirs[k].shape for k in mine):
                raise ValueError(f"snapshot {path} does not match the "
                                 "train state")
        with torch.no_grad():
            for mine, theirs in pairs:
                for k, v in theirs.items():
                    mine[k].copy_(v)
        opt.count = int(saved["count"])
        opt.mini_step = int(saved.get("mini_step", 0))
        target.step = int(raw["step"])
        if raw.get("rng") is not None:  # none in an older snapshot
            target.rng.set_state(raw["rng"])
        return target, step

    def restore_raw(self, step: int | None = None) -> dict[str, Any]:
        """The snapshot's contents, for a warm start by intersection."""
        return read_snapshot(self._path(step)[0])

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, self._name(s)),
                          ignore_errors=True)


def warm_start_params(init_params: Mapping[str, torch.Tensor],
                      ckpt_path: str,
                      exclude_scopes: tuple[str, ...] = ()
                      ) -> tuple[dict[str, torch.Tensor], int]:
    """Parameters from one snapshot dir merged into ``init_params`` by
    name and shape; a full snapshot's model state dict is used."""
    raw = read_snapshot(ckpt_path)
    return merge_pytrees(init_params, raw.get("model", raw), exclude_scopes)
