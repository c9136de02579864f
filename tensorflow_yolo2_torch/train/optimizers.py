"""Learning-rate schedules and the Adam and momentum optimizers (port of
tensorflow_yolo2_tpu/train/optimizers.py).

The JAX package builds optax chains; here the same functions are written
out on tensors, so that a step equals optax's:

- ``make_schedule``: fixed, exponential (staircase), polynomial and cosine
  schedules after an optional linear warmup, with the ``offset_steps``
  clamp, as optax's ``constant_schedule``, ``exponential_decay``,
  ``polynomial_schedule``, ``cosine_decay_schedule`` and
  ``join_schedules``. A schedule maps the optimizer's step count *before*
  the update (optax's ``scale_by_schedule``) to a learning rate.
- ``make_optimizer``: Adam (epsilon outside the square root, bias
  correction), or momentum SGD (optax's ``sgd(lr, momentum)``: the trace
  ``t ← g + μ·t``, then the step ``−lr·t``), after optax's
  ``clip_by_global_norm``, which scales the
  gradients by ``max_norm / ‖g‖`` as ``(g / ‖g‖) · max_norm`` only when
  ``‖g‖ ≥ max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``‖g‖ + 1e-6`` instead). ``torch.optim`` and its schedulers are not
  used.

The update runs in place on the parameters and the optimizer's slots
with ``torch._foreach_*`` operations: a few multi-tensor launches a
step.

``trainable_scopes`` trains only the parameters inside those scopes, as
the JAX package's ``optax.multi_transform({"train": tx, "freeze":
set_to_zero()})`` over its ``trainable_mask``: the optimizer's slots
hold the trained parameters only, an update touches no other, and the
global-norm clip, inside the trained branch, takes its norm over the
trained gradients. Other optimizers, weight decay, EMA and gradient
accumulation are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch

from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    scope_matches,
)

Schedule = Callable[[int], float]
NOT_PORTED = "not ported yet (ROADMAP.md, queue A, A6)"


def make_schedule(cfg: LRScheduleConfig) -> Schedule:
    """The learning rate as a function of the optimizer's step count."""
    lr = cfg.learning_rate
    if cfg.kind == "fixed":
        def base(count: int) -> float:
            return lr
    elif cfg.kind == "exponential":
        def base(count: int) -> float:
            if count <= 0 or cfg.decay_steps <= 0:
                return lr
            return lr * cfg.decay_factor ** (count // cfg.decay_steps)
    elif cfg.kind == "polynomial":
        def base(count: int) -> float:
            if cfg.decay_steps <= 0:
                return lr
            frac = 1.0 - min(max(count, 0), cfg.decay_steps) / \
                cfg.decay_steps
            return (lr - cfg.end_learning_rate) * frac ** cfg.power + \
                cfg.end_learning_rate
    elif cfg.kind == "cosine":
        if cfg.decay_steps <= 0:
            raise ValueError(f"cosine needs decay_steps > 0, got "
                             f"{cfg.decay_steps}")
        alpha = cfg.end_learning_rate / max(lr, 1e-12)

        def base(count: int) -> float:
            cosine = 0.5 * (1.0 + math.cos(
                math.pi * min(count, cfg.decay_steps) / cfg.decay_steps))
            return lr * ((1.0 - alpha) * cosine + alpha)
    else:
        raise ValueError(f"unknown schedule {cfg.kind!r}")

    schedule = base
    if cfg.warmup_steps > 0:
        warm = cfg.warmup_steps

        def schedule(count: int) -> float:
            if count >= warm:
                return base(count - warm)
            return -lr * (1.0 - max(count, 0) / warm) + lr

    if cfg.offset_steps:
        inner, offset = schedule, cfg.offset_steps
        return lambda count: inner(max(count - offset, 0))
    return schedule


def trainable_names(names, scopes: tuple[str, ...]) -> list[str]:
    """The parameter names inside any of ``scopes`` (all of them without
    scopes), matched per path component. A scope may be written with the
    flax path's ``/`` or the port's ``.``: ``"logits"`` takes
    ``logits.weight`` and ``logits.bias``, ``"backbone/block4"`` every
    ``backbone.block4...`` name but no ``backbone.block40...`` one."""
    if not scopes:
        return list(names)
    scopes = tuple(s.replace("/", ".") for s in scopes)
    return [n for n in names if scope_matches(n, scopes)]


@dataclass
class AdamState:
    """Adam's moments, keyed like the parameters, and the step count."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over a list of tensors, as a 0-d float32 tensor
    (float64 for float64 tensors)."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    if norms.dtype != torch.float64:
        norms = norms.float()
    return torch.linalg.vector_norm(norms)


def _bias_correction(decay: float, count: int, dtype: torch.dtype) -> float:
    """1 − decay^count in float32 (float64 for float64 parameters), as
    optax computes it: for b2 = 0.999 the float32 difference is 1.3e-5
    away from the double one."""
    t = np.float64 if dtype == torch.float64 else np.float32
    return float(t(1.0) - t(decay) ** t(count))


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float | None,
                        norm: torch.Tensor | None = None
                        ) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``(g / ‖g‖) · max_norm`` when
    ``‖g‖ ≥ max_norm``, else ``g`` as it is (no clipping without
    ``max_norm``). ``norm`` is ‖g‖ where the caller has it already."""
    if not max_norm:
        return grads
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, float(max_norm)))
    return grads


class Adam:
    """Adam after optional global-norm clipping (optax's
    ``chain(clip_by_global_norm, adam)``), updating in place."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg.schedule)

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        """Zero moments for the trained parameters of ``params``."""
        zeros = {k: torch.zeros_like(params[k],
                                     memory_format=torch.preserve_format)
                 for k in trainable_names(params, self.cfg.trainable_scopes)}
        return AdamState(0, zeros, {k: torch.zeros_like(z)
                                    for k, z in zeros.items()})

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: AdamState,
                params: Mapping[str, torch.Tensor],
                grad_norm: torch.Tensor | None = None) -> AdamState:
        """One step of the trained parameters (those with slots in
        ``state``): params ← params − lr · m̂ / (√v̂ + ε), in place.

        ``grad_norm`` is the global norm of their gradients when the
        caller has it already (it is computed otherwise, if clipping
        needs it).
        """
        cfg = self.cfg
        keys = list(state.mu)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        lr = self.schedule(state.count)
        g = clip_by_global_norm(g, cfg.grad_clip_norm, grad_norm)
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_add_(nu, sq)
        state.count += 1
        dtype = p[0].dtype
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, state.count,
                                                         dtype))
        denom = torch._foreach_div(nu, _bias_correction(b2, state.count,
                                                        dtype))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.epsilon)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_mul_(mu_hat, -lr)
        torch._foreach_add_(p, mu_hat)
        return state


@dataclass
class MomentumState:
    """The momentum trace, keyed like the parameters, and the step
    count."""

    count: int
    trace: dict[str, torch.Tensor]


class Momentum:
    """SGD with momentum after optional global-norm clipping (optax's
    ``chain(clip_by_global_norm, sgd(lr, momentum))``), updating in
    place."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg.schedule)

    def init(self, params: Mapping[str, torch.Tensor]) -> MomentumState:
        """A zero trace for the trained parameters of ``params``."""
        return MomentumState(0, {
            k: torch.zeros_like(params[k], memory_format=torch.preserve_format)
            for k in trainable_names(params, self.cfg.trainable_scopes)})

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor],
                state: MomentumState, params: Mapping[str, torch.Tensor],
                grad_norm: torch.Tensor | None = None) -> MomentumState:
        """One step of the trained parameters (those with a trace in
        ``state``): t ← g + μ·t, params ← params + (−lr)·t, in place."""
        keys = list(state.trace)
        p = [params[k] for k in keys]
        t = [state.trace[k] for k in keys]
        lr = self.schedule(state.count)
        g = clip_by_global_norm([grads[k] for k in keys],
                                self.cfg.grad_clip_norm, grad_norm)
        torch._foreach_mul_(t, self.cfg.momentum)
        torch._foreach_add_(t, g)
        torch._foreach_add_(p, torch._foreach_mul(t, -lr))
        state.count += 1
        return state


OPTIMIZERS = {"adam": Adam, "momentum": Momentum}


def make_optimizer(cfg: OptimizerConfig) -> Adam | Momentum:
    """The optimizer of ``cfg``: Adam or momentum, with clipping when
    ``grad_clip_norm`` is set and a frozen remainder outside
    ``trainable_scopes``. Anything else raises ``ValueError``."""
    if cfg.name.lower() not in OPTIMIZERS:
        raise ValueError(f"optimizer {cfg.name!r} is {NOT_PORTED}; the "
                         "port trains with 'adam' or 'momentum'")
    for name, value in (("weight_decay", cfg.weight_decay),
                        ("moving_average_decay", cfg.moving_average_decay),
                        ("grad_accum_steps", cfg.grad_accum_steps > 1)):
        if value:
            raise ValueError(f"{name} is {NOT_PORTED}")
    return OPTIMIZERS[cfg.name.lower()](cfg)
