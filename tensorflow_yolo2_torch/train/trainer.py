"""The train step (port of tensorflow_yolo2_tpu/train/trainer.py).

One step: images → the model in train mode (BatchNorm on batch
statistics, running statistics updated as flax does) → the task's loss in
float32 → gradients → global norm → Adam or momentum
(``train.optimizers``). Tasks: the YOLO grid loss (``yolo_task``,
``losses.yolo_v2.yolo_v2_task``) and the classifier's softmax
cross-entropy (``softmax_task``). The JAX step is one jitted function
that donates its input state; here the step runs eagerly on
``Trainer.device`` and updates the parameters, BatchNorm statistics and
optimizer slots of the state in place.

Mixed precision follows ``compute_dtype``: with bfloat16 the forward runs
under ``torch.autocast``, so that convs compute in bf16, while parameters,
gradients and optimizer slots stay float32, and the head output and the
loss are float32 (the JAX package's ``dtype`` / ``param_dtype`` split).

On the card the trunk's activations stay in ``channels_last`` memory and
the Darknet trunk's five pools run backward through the CUDA kernel of
``ops.cuda_pool`` (B5).

With ``trainable_scopes`` (``train.optimizers.trainable_names``) the
parameters outside them are frozen: ``requires_grad`` off, no gradient
computed, no optimizer slot. BatchNorm still runs in train mode there and
updates its running statistics, as the JAX package's
``mutable=["batch_stats"]`` apply does. ``grad_norm`` is then the norm of
the trained parameters' gradients (the JAX package computes the frozen
ones too and counts them in its metric).

A model may return ``(logits, aux_logits)`` (an inception net built with
``aux_logits``): both come out float32 and ``softmax_task`` adds the
auxiliary head's loss, as in the JAX package.

Every model's ``forward`` takes ``generator``: a train step passes
``TrainState.rng``, a generator on the trainer's device seeded from the
caller's, and an eval step passes none. Only a model with dropout
(``models.resnet.ResNet50Detector``) draws from it, once a step, as the
JAX step splits ``state.rng``; the others ignore it.

The optimizer is any of ``train.optimizers``'s family, with weight
decay, and with ``grad_accum_steps`` > 1 a ``MultiSteps`` that applies
the update on every k-th step (``TrainState.step`` counts every
micro-step, the optimizer's count only applied updates). With
``moving_average_decay`` the state keeps ``ema_params``, distinct copies
of the parameters that advance after each applied update, and
``eval_step`` evaluates them (``eval_with_ema``) with the live BatchNorm
statistics, through ``torch.func.functional_call``.

``remat=True`` rematerializes the forward in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the JAX step's
``jax.checkpoint`` of the whole apply. Its recompute restores what a
pure JAX function never changes: it leaves the BatchNorm running
statistics alone (``layers.frozen_running_stats``), so they move once a
step, and it starts ``TrainState.rng`` from where the forward started
it and hands it back where the forward left it, so that it draws the
same dropout mask. A remat step leaves parameters, statistics and
generator where the plain step does.

``activation_summaries=True`` adds, for every direct child module of the
model (flax's depth-1 modules, under its names), ``sparsity/<name>``,
the share of the child's float32 output that is ≤ 0, and
``hist/act_<name>``, the flattened output sampled at a stride to at most
4096 values; a 4-D output is flattened in NHWC order, as the JAX
package's. Outputs that are not tensors are skipped. As in the JAX step,
such a step does not rematerialize.

With a ``mesh`` (``parallel.mesh.make_mesh``, one process a rank) the
step is data- and tensor-parallel, as the JAX package's GSPMD step over
its mesh: each rank passes its rows of the global batch (``put_batch``
broadcasts them over the model axis, whose ranks compute on the same
rows); BatchNorm takes its statistics over the data axis; every
gradient is all-reduced (mean) over it before the global norm, the clip
and the update; the weights ``parallel.mesh.param_spec`` shards are
sliced over the model axis with their optimizer slots and EMA, and
their layers compute column-parallel; the global norm adds each sharded
slice's squares over the model axis once. The first step on a state
distributes it (``distribute``), so that a state is restored or
warm-started whole. The 0-d metrics are the data axis's means; the
YOLOv2 task's burn-in counts the global batch. ``snapshot_state``
gathers a state whole for a snapshot.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tensorflow_yolo2_torch.config import OptimizerConfig, YoloConfig
from tensorflow_yolo2_torch.losses.yolo import yolo_loss
from tensorflow_yolo2_torch.models.darknet import init_params_
from tensorflow_yolo2_torch.models.layers import (
    frozen_running_stats,
    sync_batch_norm_,
)
from tensorflow_yolo2_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_tensors,
    apply_tensor_parallel,
    group_barrier,
)
from tensorflow_yolo2_torch.train.optimizers import (
    OptState,
    global_norm,
    make_ema,
    make_optimizer,
)
from tensorflow_yolo2_torch.utils.device import (
    device_normalize,
    resolve_device,
)

Metrics = dict[str, torch.Tensor]


@dataclass
class TrainState:
    """What a step updates: the model (parameters and BatchNorm running
    statistics, on the trainer's device), the optimizer's state, the step
    count, the dropout generator on that device, and the parameters' EMA
    (by name; None without ``moving_average_decay``)."""

    step: int
    model: nn.Module
    opt_state: OptState
    rng: torch.Generator
    ema_params: dict[str, torch.Tensor] | None = None

    @property
    def params(self) -> dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}


class _StateDict:
    """A stand-in model that only gives a state dict (a gathered
    snapshot's)."""

    def __init__(self, state_dict: dict[str, torch.Tensor]):
        self._state_dict = state_dict

    def state_dict(self) -> dict[str, torch.Tensor]:
        return self._state_dict


def _slot_tables(opt: OptState):
    """The optimizer state's per-parameter tables (each slot's, and the
    accumulated gradients' under accumulation)."""
    yield from opt.slots.values()
    if opt.acc_grads is not None:
        yield opt.acc_grads


def yolo_task(yolo_cfg: YoloConfig, histograms: bool = False) -> Callable:
    """Detection task: (head output, labels) → (YOLO grid loss, metrics).

    Metrics are 0-d tensors ``loss``, ``class_loss``, ``object_loss``,
    ``noobject_loss``, ``coord_loss`` and ``mean_iou`` (the IoU of the
    responsible boxes); ``histograms`` adds the arrays ``hist/iou`` and
    ``hist/confidence`` (the predicted confidences)."""

    def task(outputs: torch.Tensor, labels: torch.Tensor):
        total, aux = yolo_loss(outputs, labels, yolo_cfg)
        metrics = {
            "loss": total,
            "class_loss": aux.class_loss,
            "object_loss": aux.object_loss,
            "noobject_loss": aux.noobject_loss,
            "coord_loss": aux.coord_loss,
            "mean_iou": torch.sum(aux.ious * aux.object_mask) /
            torch.clamp(torch.sum(aux.object_mask), min=1.0),
        }
        if histograms:
            C = yolo_cfg.num_class
            metrics["hist/iou"] = aux.ious
            metrics["hist/confidence"] = outputs[..., C:C + yolo_cfg.B]
        return total, metrics

    return task


def softmax_task(aux_weight: float = 0.4,
                 label_smoothing: float = 0.0) -> Callable:
    """Classification task: (logits, integer labels) → (mean sparse
    softmax cross-entropy, metrics ``loss`` and ``accuracy``), in the
    logits' type (float32 for the classifier).

    ``label_smoothing`` ε blends the one-hot target toward uniform,
    ``onehot·(1−ε) + ε/K``. A model that returns ``(logits, aux_logits)``
    adds ``aux_weight`` times the aux head's cross-entropy (with the same
    smoothing) to the loss and reports it as ``aux_loss``; ``accuracy`` is
    the main head's."""

    def ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if label_smoothing:
            k = logits.shape[-1]
            onehot = F.one_hot(labels, k).to(logits.dtype)
            smoothed = onehot * (1.0 - label_smoothing) + label_smoothing / k
            return torch.mean(-(smoothed * F.log_softmax(logits, -1)).sum(-1))
        picked = logits.gather(-1, labels[:, None])[:, 0]
        return torch.mean(torch.logsumexp(logits, -1) - picked)

    def task(outputs, labels: torch.Tensor):
        labels = labels.long()
        aux = None
        if isinstance(outputs, tuple):
            outputs, aux = outputs
        loss = ce(outputs, labels)
        metrics = {"loss": loss}
        if aux is not None:
            aux_loss = ce(aux, labels)
            loss = loss + aux_weight * aux_loss
            metrics = {"loss": loss, "aux_loss": aux_loss}
        metrics["accuracy"] = torch.mean(
            (torch.argmax(outputs, -1) == labels).float())
        return loss, metrics

    return task


def _takes_step(task: Callable) -> bool:
    try:
        return "step" in inspect.signature(task).parameters
    except (TypeError, ValueError):
        return False


ACT_SAMPLE = 4096  # at most this many values of each activation histogram


def _activation_metrics(name: str, out: torch.Tensor) -> Metrics:
    """``sparsity/<name>`` and ``hist/act_<name>`` of one child's output
    (NCHW maps read in NHWC order)."""
    act = out.detach().float()
    if act.dim() == 4:
        act = act.permute(0, 2, 3, 1)
    flat = act.reshape(-1)
    n = min(ACT_SAMPLE, flat.shape[0])
    stride = max(1, flat.shape[0] // n)
    return {f"sparsity/{name}": torch.mean((act <= 0.0).float()),
            f"hist/act_{name}": flat[::stride][:n]}


class Trainer:
    """The train and eval steps of (model, task, optimizer) on one device.

    ``compute_dtype`` is ``torch.bfloat16`` (autocast) or
    ``torch.float32``; ``device`` defaults to ``cuda``. A task whose
    signature has ``step`` (``losses.yolo_v2.yolo_v2_task``, whose
    burn-in it drives) gets the step count before the update in a train
    step and None in an eval step, as in the JAX package. ``remat``,
    ``activation_summaries`` and ``eval_with_ema`` are the JAX
    trainer's options (module docstring). ``tx_factory(params)``, given
    the parameters by name, builds the optimizer in place of ``opt_cfg``'s
    (``train.optimizers.make_grouped_optimizer``), on ``create_state``
    and on every ``resume_optimizer``; the parameters its state does not
    train are frozen. ``mesh`` makes the step data- and tensor-parallel
    (module docstring).
    """

    def __init__(self, model: nn.Module, task: Callable,
                 opt_cfg: OptimizerConfig = OptimizerConfig(),
                 device: str | torch.device | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, activation_summaries: bool = False,
                 eval_with_ema: bool = True,
                 tx_factory: Callable[[dict], Any] | None = None,
                 mesh: Any = None):
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, "
                             f"got {compute_dtype}")
        self.model = model
        self.task = task
        self._task_takes_step = _takes_step(task)
        self.opt_cfg = opt_cfg
        self._tx_factory = tx_factory
        self.optimizer = make_optimizer(opt_cfg)
        self._ema = (make_ema(opt_cfg.moving_average_decay)
                     if opt_cfg.moving_average_decay else None)
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.activation_summaries = activation_summaries
        self.eval_with_ema = eval_with_ema
        self.mesh = mesh
        self.data_group = self.model_group = None
        self.data_size = self.model_size = 1
        if mesh is not None:
            self.data_group = mesh.get_group("data")
            self.model_group = mesh.get_group("model")
            self.data_size, self.model_size = mesh.size(0), mesh.size(1)
        self._distributed: nn.Module | None = None
        self._sharded: dict[str, int] = {}  # name → full size of dim 0

    @property
    def is_chief(self) -> bool:
        """Whether this process writes snapshots, metrics and logs: rank
        0, or the only process."""
        return self.mesh is None or dist.get_rank() == 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing without one)."""
        if self.mesh is not None:
            group_barrier(self.data_group, self.model_group)
    # -- state --------------------------------------------------------------

    def create_state(self, generator: torch.Generator,
                     state_dict: Mapping[str, torch.Tensor] | None = None,
                     init: bool = True) -> TrainState:
        """Fresh seeded weights (``models.darknet.init_params_``, flax's
        defaults; ``generator`` is a CPU generator), or ``state_dict``'s,
        on the device, with a fresh optimizer state; the parameters
        outside ``trainable_scopes`` frozen (a ``ValueError`` when the
        scopes take none); the dropout generator on the device, seeded
        from ``generator`` after the weights; with EMA, its copies of
        the parameters. Without ``state_dict``, ``init=False`` leaves the
        model's tensors as they are, for a state that a whole snapshot is
        restored into."""
        self.model.to("cpu")
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        elif init:
            init_params_(self.model, generator)
        self.model.to(self.device, memory_format=torch.channels_last)
        params = dict(self.model.named_parameters())
        opt_state = self._init_optimizer(params)
        trained = set(opt_state.names)
        if not trained:
            scopes = self.opt_cfg.trainable_scopes
            raise ValueError(f"trainable_scopes {scopes} (or the optimizer "
                             "groups) take no parameter of the model")
        for name, p in params.items():
            p.requires_grad_(name in trained)
        seed = int(torch.randint(2**62, (), generator=generator))
        rng = torch.Generator(self.device).manual_seed(seed)
        state = TrainState(0, self.model, opt_state, rng)
        return self.restart_ema(state)

    def _init_optimizer(self, params: dict) -> OptState:
        """A fresh optimizer state for ``params``, the optimizer rebuilt
        from them first where a ``tx_factory`` is given."""
        if self._tx_factory is not None:
            self.optimizer = self._tx_factory(params)
        return self.optimizer.init(params)

    def restart_ema(self, state: TrainState) -> TrainState:
        """The EMA restarted from the state's parameters (distinct
        tensors); None without EMA."""
        state.ema_params = (
            {k: p.detach().clone() for k, p in state.params.items()}
            if self._ema else None)
        return state

    def resume_optimizer(self, state: TrainState) -> TrainState:
        """The optimizer swap of a resume: a fresh optimizer state for the
        current parameters."""
        state.opt_state = self._init_optimizer(state.params)
        return state

    # -- the mesh -------------------------------------------------------------

    def distribute(self, state: TrainState) -> TrainState:
        """Lay ``state`` out on the mesh, in place, once: BatchNorm synced
        over the data axis; over the model axis the sharded weights
        sliced (``parallel.mesh.apply_tensor_parallel``) with their
        optimizer slots and EMA. Nothing without a mesh."""
        if self.mesh is None or self._distributed is state.model:
            return state
        sync_batch_norm_(state.model, self.data_group)
        if self.model_size > 1:
            self._sharded = apply_tensor_parallel(state.model, self.mesh)
            r = dist.get_rank(self.model_group)
            tables = list(_slot_tables(state.opt_state))
            if state.ema_params is not None:
                tables.append(state.ema_params)
            for table in tables:
                for name, full in self._sharded.items():
                    if name in table:
                        size = full // self.model_size
                        table[name] = table[name].narrow(
                            0, r * size, size).clone()
        self._distributed = state.model
        return state

    def snapshot_state(self, state: TrainState) -> TrainState:
        """``state`` whole, for a snapshot: where weights are sharded over
        the model axis, a state whose model, optimizer slots and EMA hold
        them gathered (every rank of the model axis must call it);
        otherwise ``state`` itself."""
        if not self._sharded or self._distributed is not state.model:
            return state

        def whole(table: dict) -> dict:
            return {k: all_gather_rows(v.detach(), self.model_group)
                    if k in self._sharded else v for k, v in table.items()}

        opt = state.opt_state
        gathered = OptState(
            opt.count, list(opt.names),
            {s: whole(t) for s, t in opt.slots.items()},
            whole(opt.acc_grads) if opt.acc_grads is not None else None,
            opt.mini_step)
        model_sd = whole(state.model.state_dict())
        ema = whole(state.ema_params) if state.ema_params is not None \
            else None
        return TrainState(state.step, _StateDict(model_sd), gathered,
                          state.rng, ema)

    def put_batch(self, images: Any, labels: Any) -> tuple[Any, Any]:
        """This rank's rows of the global batch on the device; over a
        model axis, its first rank's rows on every rank of it (they
        compute on the same rows, whatever order each rank's loader
        read them in)."""
        images = torch.as_tensor(images).to(self.device)
        labels = torch.as_tensor(labels).to(self.device)
        if self.model_size > 1:
            src = dist.get_global_rank(self.model_group, 0)
            for t in (images, labels):
                dist.broadcast(t, src, group=self.model_group)
        return images, labels

    def _mean_over_data(self, metrics: Metrics) -> Metrics:
        """The 0-d metrics averaged over the data axis (one all-reduce)."""
        names = [k for k, v in metrics.items() if v.dim() == 0]
        if not names:
            return metrics
        stacked = torch.stack([metrics[k].float() for k in names])
        dist.all_reduce(stacked, group=self.data_group)
        stacked /= self.data_size
        return {**metrics, **dict(zip(names, stacked.unbind()))}

    def _global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the (data-averaged) gradients: the sharded
        slices' squares summed over the model axis once, the replicated
        gradients' once."""
        if not self._sharded:
            return global_norm(grads.values())
        parts = [grads[k] for k in grads if k in self._sharded]
        rest = [grads[k] for k in grads if k not in self._sharded]
        zero = torch.zeros((), device=self.device)
        sq_parts = global_norm(parts) ** 2 if parts else zero
        dist.all_reduce(sq_parts, group=self.model_group)
        sq_rest = global_norm(rest) ** 2 if rest else zero.to(sq_parts.dtype)
        return torch.sqrt(sq_parts + sq_rest)

    # -- steps ----------------------------------------------------------------

    def _forward(self, images: torch.Tensor,
                 generator: torch.Generator | None = None,
                 params: Mapping[str, torch.Tensor] | None = None,
                 remat: bool = False):
        images = device_normalize(torch.as_tensor(images).to(self.device))
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            if params is not None:
                outputs = torch.func.functional_call(
                    self.model, dict(params), (images,),
                    {"generator": generator})
            elif remat:
                outputs = self._remat_forward(images, generator)
            else:
                outputs = self.model(images, generator=generator)
        if isinstance(outputs, tuple):  # (logits, aux logits)
            return tuple(o.float() for o in outputs)
        return outputs.float()

    def _remat_forward(self, images: torch.Tensor,
                       generator: torch.Generator | None):
        """The model's forward under ``torch.utils.checkpoint``; its
        recompute leaves the running statistics and the generator as the
        forward left them and draws what the forward drew."""
        start = generator.get_state() if generator is not None else None

        @contextlib.contextmanager
        def recompute():
            after = generator.get_state() if generator is not None else None
            if generator is not None:
                generator.set_state(start)
            try:
                with frozen_running_stats():
                    yield
            finally:
                if generator is not None:
                    generator.set_state(after)

        return torch.utils.checkpoint.checkpoint(
            lambda x: self.model(x, generator=generator), images,
            use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), recompute()))

    def _labels(self, labels: Any) -> torch.Tensor:
        """Labels on the device: float ones (label grids) in float32,
        integer ones (class indices) as they are."""
        labels = torch.as_tensor(labels).to(self.device)
        return labels.float() if labels.is_floating_point() else labels

    def loss_and_grads(self, state: TrainState, images: Any, labels: Any
                       ) -> tuple[Metrics, dict[str, torch.Tensor]]:
        """Forward in train mode (updating the BatchNorm running
        statistics, drawing the dropout mask from ``state.rng``) and
        backward: (metrics, gradients by name of the trained
        parameters). The parameters are not changed. With a mesh the
        batch is this rank's rows, the gradients and the 0-d metrics are
        the data axis's means (the global batch's), and the gradients of
        sharded weights are this rank's slices."""
        if self.mesh is not None:
            self.distribute(state)
            images, labels = self.put_batch(images, labels)
        state.model.train()
        params = {k: p for k, p in state.params.items() if p.requires_grad}
        labels = self._labels(labels)
        # the burn-in counts step · batch samples; each data rank's loss
        # sees 1/data_size of the global batch
        kw = ({"step": state.step * self.data_size}
              if self._task_takes_step else {})
        acts: Metrics = {}
        hooks = []
        if self.activation_summaries:
            def capture(name):
                def hook(module, args, out):
                    if isinstance(out, torch.Tensor) and \
                            f"sparsity/{name}" not in acts:
                        acts.update(_activation_metrics(name, out))
                return hook

            hooks = [child.register_forward_hook(capture(name))
                     for name, child in state.model.named_children()]
        try:
            outputs = self._forward(
                images, state.rng,
                remat=self.remat and not self.activation_summaries)
        finally:
            for h in hooks:
                h.remove()
        loss, metrics = self.task(outputs, labels, **kw)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(acts)
        if self.mesh is not None:
            grads = all_reduce_tensors(grads, self.data_group,
                                       self.data_size)
            metrics = self._mean_over_data(metrics)
        return metrics, grads

    def train_step(self, state: TrainState, images: Any, labels: Any
                   ) -> tuple[TrainState, Metrics]:
        """One step on a batch (NHWC images, float or uint8, and label
        grids or class indices; numpy or tensors): an optimizer update,
        or under gradient accumulation a micro-step that applies one on
        every k-th call. Updates ``state`` in place and returns it with
        the step's metrics, ``grad_norm`` (the global norm of the
        trained parameters' gradients of this batch, before clipping)
        among them; the metrics stay on the device. The EMA advances
        only where an update was applied. With a mesh, ``images`` and
        ``labels`` are this rank's rows of the global batch."""
        metrics, grads = self.loss_and_grads(state, images, labels)
        norm = self._global_norm(grads)
        metrics["grad_norm"] = norm
        self.optimizer.update_(grads, state.opt_state, state.params, norm)
        if self._ema is not None and state.opt_state.mini_step == 0:
            params = state.params
            self._ema([state.ema_params[k] for k in params],
                      [p.detach() for p in params.values()])
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, images: Any,
                  labels: Any) -> Metrics:
        """The task's metrics in eval mode (running statistics), from the
        EMA parameters when the trainer tracks them and
        ``eval_with_ema``; a task that takes ``step`` gets None (no
        burn-in at evaluation). With a mesh, the batch is this rank's rows
        and the 0-d metrics are the data axis's means."""
        if self.mesh is not None:
            self.distribute(state)
            images, labels = self.put_batch(images, labels)
        state.model.eval()
        labels = self._labels(labels)
        kw = {"step": None} if self._task_takes_step else {}
        ema = self._ema is not None and self.eval_with_ema
        params = state.ema_params if ema else None
        metrics = self.task(self._forward(images, params=params), labels,
                            **kw)[1]
        if self.mesh is not None:
            metrics = self._mean_over_data(metrics)
        return metrics

    @torch.no_grad()
    def eval_outputs(self, state: TrainState, images: Any,
                     ema: bool = False) -> torch.Tensor:
        """The model's float32 outputs in eval mode, from the EMA
        parameters with ``ema`` (the state must hold them)."""
        state.model.eval()
        return self._forward(images, params=state.ema_params if ema else None)
