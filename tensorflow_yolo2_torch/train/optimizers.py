"""Learning-rate schedules, the optimizer family, gradient accumulation
and the parameter EMA (port of tensorflow_yolo2_tpu/train/optimizers.py).

The JAX package builds optax chains; here the same functions are written
out on tensors, so that a step equals optax 0.2.6's:

- ``make_schedule``: fixed, exponential (staircase), polynomial and cosine
  schedules after an optional linear warmup, with the ``offset_steps``
  clamp, as optax's ``constant_schedule``, ``exponential_decay``,
  ``polynomial_schedule``, ``cosine_decay_schedule`` and
  ``join_schedules``. A schedule maps the optimizer's step count *before*
  the update (optax's ``scale_by_schedule``) to a learning rate.
- ``make_optimizer``: optax's ``clip_by_global_norm`` (the gradients
  scaled as ``(g / ‖g‖) · max_norm`` only when ``‖g‖ ≥ max_norm``;
  ``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6``
  instead), then ``add_decayed_weights`` (``g + wd·p`` on every trained
  parameter, BatchNorm scales and biases too) for every optimizer but
  ``adamw`` and ``lamb``, then the core, each the optax chain that the
  JAX package's ``_core`` builds:

  ====================  ==============================================
  ``sgd``               ``−lr·g``
  ``momentum``          ``t ← g + μ·t``, ``−lr·t``
  ``adam``              ``m̂ / (√v̂ + ε)`` (bias-corrected), ``−lr·``
  ``adamw``             Adam's, ``+ wd·p`` (decoupled), ``−lr·``
  ``lamb``              Adam's with ε = 1e-6, ``+ wd·p``, times the
                        per-tensor trust ratio ‖p‖ / ‖u‖ (1 where
                        either norm is 0), ``−lr·``
  ``rmsprop``           ``ν ← ρ·ν + (1−ρ)·g²`` from 0,
                        ``g · rsqrt(ν + ε)`` (ε inside the root),
                        ``−lr·``, then the trace ``t ← u + μ·t``
  ``adagrad``           ``s ← s + g²`` from 0.1,
                        ``g · rsqrt(s + 1e-7)`` (optax's defaults,
                        not ``cfg.epsilon``), ``−lr·``
  ``ftrl``              ``+ l2·p`` when ``ftrl_l2``, then adagrad from
                        ``ftrl_initial_accumulator_value``: the JAX
                        package's stand-in for TF's FTRL (its ``l1``
                        and learning-rate power are unused there too)
  ``adadelta``          ``E[g²] ← ρ·E[g²] + (1−ρ)·g²``,
                        ``u = √(E[Δ²] + ε) / √(E[g²] + ε) · g``,
                        ``E[Δ²] ← ρ·E[Δ²] + (1−ρ)·u²``, ``−lr·u``
  ====================  ==============================================

- ``grad_accum_steps`` k > 1 wraps the optimizer in ``MultiSteps``,
  optax's ``MultiSteps(every_k_schedule=k)``: the running mean of the
  micro-step gradients (Welford's update), the inner update on the k-th
  micro-step only, so the step count and with it the schedule advance
  once per applied update;
- ``make_ema``: ``e ← decay·e + (1−decay)·p``, in place.

``torch.optim`` and its schedulers are not used. The update runs in
place on the parameters and the optimizer's slots with
``torch._foreach_*`` operations: a few multi-tensor launches a step.

``trainable_scopes`` trains only the parameters inside those scopes, as
the JAX package's ``optax.multi_transform({"train": tx, "freeze":
set_to_zero()})`` over its ``trainable_mask``: the optimizer's slots
hold the trained parameters only, an update touches no other, and the
global-norm clip and the weight decay, inside the trained branch, see
the trained gradients only. Per-scope optimizer groups
(``make_grouped_optimizer``) are optax's ``multi_transform`` of one
optimizer per group, with a frozen remainder when no default is given.
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
Tensors = list[torch.Tensor]


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


@dataclass
class OptState:
    """An optimizer's state: the step count (of applied updates), the
    trained parameters' names, and the per-parameter slots by slot name
    (Adam's ``mu`` and ``nu``, momentum's ``trace``, ...), each keyed
    like the parameters; a slot reads as an attribute too
    (``state.mu``). Under gradient accumulation (``MultiSteps``) also
    the running mean of the micro-step gradients, ``acc_grads``, and
    ``mini_step``, the micro-steps taken since the last applied
    update."""

    count: int
    names: list[str]
    slots: dict[str, dict[str, torch.Tensor]]
    acc_grads: dict[str, torch.Tensor] | None = None
    mini_step: int = 0

    def __getattr__(self, name: str):
        slots = self.__dict__.get("slots") or {}
        if name in slots:
            return slots[name]
        raise AttributeError(name)


class Optimizer:
    """The shared part of the family: slots for the trained parameters,
    then ``update_``: clip, weight decay (unless the core decays its own
    way), the core's update, applied in place. A core is ``_updates(g,
    slots, p, lr, count)``: the lists of gradients, of each slot's
    tensors and of parameters → the tensors to add to the parameters;
    it may update its slots in place but not ``g``."""

    slots: tuple[str, ...] = ()
    decays_weights = False  # adamw and lamb: decay inside the core

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg.schedule)

    def initial(self, slot: str) -> float:
        """A slot's initial value."""
        return 0.0

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        """Fresh slots for the trained parameters of ``params``."""
        names = trainable_names(params, self.cfg.trainable_scopes)
        return OptState(0, names, {
            s: {k: torch.full_like(params[k], self.initial(s),
                                   memory_format=torch.preserve_format)
                for k in names} for s in self.slots})

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: OptState,
                params: Mapping[str, torch.Tensor],
                grad_norm: torch.Tensor | None = None) -> OptState:
        """One step of the trained parameters (``state.names``), in
        place. ``grad_norm`` is the global norm of their gradients when
        the caller has it already (it is computed otherwise, if clipping
        needs it)."""
        cfg, keys = self.cfg, state.names
        p = [params[k] for k in keys]
        g = clip_by_global_norm([grads[k] for k in keys], cfg.grad_clip_norm,
                                grad_norm)
        if cfg.weight_decay and not self.decays_weights:
            g = torch._foreach_add(g, p, alpha=cfg.weight_decay)
        slots = {s: [state.slots[s][k] for k in keys] for s in self.slots}
        lr = self.schedule(state.count)
        state.count += 1
        torch._foreach_add_(p, self._updates(g, slots, p, lr, state.count))
        return state

    def _updates(self, g: Tensors, slots: dict[str, Tensors], p: Tensors,
                 lr: float, count: int) -> Tensors:
        raise NotImplementedError


class Sgd(Optimizer):
    """optax's ``sgd(lr)``."""

    def _updates(self, g, slots, p, lr, count):
        return torch._foreach_mul(g, -lr)


class Momentum(Optimizer):
    """optax's ``sgd(lr, momentum)``: ``t ← g + μ·t``, then ``−lr·t``."""

    slots = ("trace",)

    def _updates(self, g, slots, p, lr, count):
        t = slots["trace"]
        torch._foreach_mul_(t, self.cfg.momentum)
        torch._foreach_add_(t, g)
        return torch._foreach_mul(t, -lr)


def _adam_direction(g: Tensors, mu: Tensors, nu: Tensors, b1: float,
                    b2: float, eps: float, count: int) -> Tensors:
    """optax's ``scale_by_adam`` (``eps_root`` 0): the moments updated in
    place, and m̂ / (√v̂ + ε)."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1.0 - b2)
    torch._foreach_add_(nu, sq)
    dtype = mu[0].dtype
    mu_hat = torch._foreach_div(mu, _bias_correction(b1, count, dtype))
    denom = torch._foreach_div(nu, _bias_correction(b2, count, dtype))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(mu_hat, denom)
    return mu_hat


class Adam(Optimizer):
    """optax's ``adam(lr, b1, b2, eps)``: epsilon outside the square
    root, bias correction in the parameters' type."""

    slots = ("mu", "nu")

    def _updates(self, g, slots, p, lr, count):
        cfg = self.cfg
        u = _adam_direction(g, slots["mu"], slots["nu"], cfg.adam_beta1,
                            cfg.adam_beta2, cfg.epsilon, count)
        torch._foreach_mul_(u, -lr)
        return u


class AdamW(Optimizer):
    """optax's ``adamw(lr, b1, b2, eps, weight_decay)``, ``mask=None``:
    the decoupled decay ``+ wd·p`` on every trained parameter."""

    slots = ("mu", "nu")
    decays_weights = True

    def _updates(self, g, slots, p, lr, count):
        cfg = self.cfg
        u = _adam_direction(g, slots["mu"], slots["nu"], cfg.adam_beta1,
                            cfg.adam_beta2, cfg.epsilon, count)
        torch._foreach_add_(u, p, alpha=cfg.weight_decay)
        torch._foreach_mul_(u, -lr)
        return u


LAMB_EPS = 1e-6  # optax's lamb default; the JAX package passes no eps


class Lamb(Optimizer):
    """optax's ``lamb(lr, weight_decay=wd)``: Adam's direction (b1 0.9,
    b2 0.999, ε 1e-6), ``+ wd·p``, scaled per tensor by the trust ratio
    ‖p‖ / ‖u‖, which is 1 where either norm is 0."""

    slots = ("mu", "nu")
    decays_weights = True

    def _updates(self, g, slots, p, lr, count):
        u = _adam_direction(g, slots["mu"], slots["nu"], 0.9, 0.999,
                            LAMB_EPS, count)
        if self.cfg.weight_decay:
            torch._foreach_add_(u, p, alpha=self.cfg.weight_decay)
        p_norm = torch.stack(torch._foreach_norm(p))
        u_norm = torch.stack(torch._foreach_norm(u))
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        torch._foreach_mul_(u, list(ratio.unbind()))
        torch._foreach_mul_(u, -lr)
        return u


class RmsProp(Optimizer):
    """optax's ``rmsprop(lr, decay, eps, momentum)``: ``initial_scale``
    0, ε inside the square root, the rate, then the momentum trace."""

    slots = ("nu", "trace")

    def _updates(self, g, slots, p, lr, count):
        cfg, nu, t = self.cfg, slots["nu"], slots["trace"]
        torch._foreach_mul_(nu, cfg.rmsprop_decay)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - cfg.rmsprop_decay)
        torch._foreach_add_(nu, sq)
        scale = torch._foreach_add(nu, cfg.epsilon)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, g)
        torch._foreach_mul_(scale, -lr)
        torch._foreach_mul_(t, cfg.momentum)
        torch._foreach_add_(t, scale)
        return t


ADAGRAD_EPS = 1e-7  # optax's adagrad default


class Adagrad(Optimizer):
    """optax's ``adagrad(lr)``: the sum of squares from 0.1, and
    ``g · rsqrt(s + 1e-7)`` where ``s > 0`` (0 elsewhere)."""

    slots = ("sum_of_squares",)

    def initial(self, slot: str) -> float:
        return 0.1

    def _updates(self, g, slots, p, lr, count):
        s = slots["sum_of_squares"]
        torch._foreach_add_(s, torch._foreach_mul(g, g))
        scale = torch._foreach_add(s, ADAGRAD_EPS)
        torch._foreach_rsqrt_(scale)
        scale = [torch.where(si > 0, sc, 0.0) for si, sc in zip(s, scale)]
        torch._foreach_mul_(scale, g)
        torch._foreach_mul_(scale, -lr)
        return scale


class Ftrl(Adagrad):
    """The JAX package's ``ftrl``: ``+ l2·p`` when ``ftrl_l2``, then
    adagrad from ``ftrl_initial_accumulator_value``."""

    def initial(self, slot: str) -> float:
        return self.cfg.ftrl_initial_accumulator_value

    def _updates(self, g, slots, p, lr, count):
        if self.cfg.ftrl_l2:
            g = torch._foreach_add(g, p, alpha=self.cfg.ftrl_l2)
        return super()._updates(g, slots, p, lr, count)


class Adadelta(Optimizer):
    """optax's ``adadelta(lr, rho, eps)`` (its own weight decay 0)."""

    slots = ("e_g", "e_x")

    def _updates(self, g, slots, p, lr, count):
        rho, eps = self.cfg.adadelta_rho, self.cfg.epsilon
        e_g, e_x = slots["e_g"], slots["e_x"]
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - rho)
        torch._foreach_mul_(e_g, rho)
        torch._foreach_add_(e_g, sq)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        u = torch._foreach_mul(num, g)
        sq = torch._foreach_mul(u, u)
        torch._foreach_mul_(sq, 1.0 - rho)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_add_(e_x, sq)
        torch._foreach_mul_(u, -lr)
        return u


OPTIMIZERS = {"sgd": Sgd, "momentum": Momentum, "adam": Adam,
              "adamw": AdamW, "lamb": Lamb, "rmsprop": RmsProp,
              "adagrad": Adagrad, "ftrl": Ftrl, "adadelta": Adadelta}


class MultiSteps:
    """optax's ``MultiSteps(inner, every_k_schedule=k)`` around an
    optimizer: each micro-step folds its gradients into ``acc_grads``,
    their running mean (``acc + (g − acc) / (n + 1)``); the k-th applies
    the inner update to that mean and zeroes it. The other micro-steps
    leave the parameters and the inner slots as they are."""

    def __init__(self, inner: Optimizer, k: int):
        self.inner, self.k = inner, k
        self.cfg = inner.cfg

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        state = self.inner.init(params)
        state.acc_grads = {k: torch.zeros_like(
            params[k], memory_format=torch.preserve_format)
            for k in state.names}
        return state

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: OptState,
                params: Mapping[str, torch.Tensor],
                grad_norm: torch.Tensor | None = None) -> OptState:
        """One micro-step; ``state.mini_step`` is 0 after it exactly when
        it applied the update. ``grad_norm`` (the micro-step's) is not
        the norm the clip needs, that of the mean: unused."""
        acc = [state.acc_grads[k] for k in state.names]
        delta = torch._foreach_sub([grads[k] for k in state.names], acc)
        torch._foreach_div_(delta, state.mini_step + 1)
        torch._foreach_add_(acc, delta)
        if state.mini_step == self.k - 1:
            self.inner.update_(state.acc_grads, state, params)
            torch._foreach_zero_(acc)
            state.mini_step = 0
        else:
            state.mini_step += 1
        return state


def make_optimizer(cfg: OptimizerConfig) -> Optimizer | MultiSteps:
    """The optimizer of ``cfg``, with clipping when ``grad_clip_norm`` is
    set, weight decay, a frozen remainder outside ``trainable_scopes``,
    and ``MultiSteps`` when ``grad_accum_steps`` > 1. An unknown name
    raises ``ValueError``, with optax's words."""
    name = cfg.name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"Optimizer [{cfg.name}] was not recognized")
    opt = OPTIMIZERS[name](cfg)
    if cfg.grad_accum_steps and cfg.grad_accum_steps > 1:
        return MultiSteps(opt, cfg.grad_accum_steps)
    return opt


class GroupedOptimizer:
    """The JAX package's ``make_grouped_optimizer``: per-scope optimizer
    groups, as optax's ``multi_transform``. Each trained parameter
    belongs to one group, the first whose scopes take it, or to the
    ``default`` group; without ``default`` the rest is frozen (no slot,
    never updated). Each group runs its own optimizer on its own
    parameters (its clip and weight decay see its gradients only); all
    groups step together, so one count serves them all. The state's
    slots are named ``group<i>/<slot>`` (``rest/<slot>`` for the
    default)."""

    def __init__(self, groups: list[tuple[str, Optimizer | MultiSteps,
                                          list[str]]]):
        self.groups = groups  # (label, optimizer, parameter names)

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        names, slots = [], {}
        for label, opt, keys in self.groups:
            sub = opt.init({k: params[k] for k in keys})
            names += sub.names
            slots.update({f"{label}/{s}": v for s, v in sub.slots.items()})
        return OptState(0, names, slots)

    @staticmethod
    def _sub(state: OptState, label: str, keys: list[str]) -> OptState:
        prefix = f"{label}/"
        return OptState(state.count, keys,
                        {s[len(prefix):]: v for s, v in state.slots.items()
                         if s.startswith(prefix)})

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: OptState,
                params: Mapping[str, torch.Tensor],
                grad_norm: torch.Tensor | None = None) -> OptState:
        """One step of every group (``grad_norm``, of all the trained
        gradients, is not any group's: unused)."""
        for label, opt, keys in self.groups:
            if keys:
                opt.update_(grads, self._sub(state, label, keys), params)
        state.count += 1
        return state


def make_grouped_optimizer(
        groups: list[tuple[tuple[str, ...], OptimizerConfig]],
        params: Mapping[str, torch.Tensor],
        default: OptimizerConfig | None = None) -> GroupedOptimizer:
    """Per-scope optimizer groups (the JAX package's
    ``make_grouped_optimizer``): ``groups`` lists (scopes, config); a
    parameter joins the first group one of whose scopes takes it (the
    flax path's ``/`` or the port's ``.``, matched per path component);
    the rest uses ``default`` when given, else stays frozen."""
    taken: set[str] = set()
    built = []
    for i, (scopes, cfg) in enumerate(groups):
        keys = [k for k in trainable_names(params, scopes) if k not in taken]
        taken.update(keys)
        built.append((f"group{i}", make_optimizer(cfg), keys))
    if default is not None:
        built.append(("rest", make_optimizer(default),
                      [k for k in params if k not in taken]))
    return GroupedOptimizer(built)


def make_ema(decay: float) -> Callable[[Tensors, Tensors], None]:
    """The parameter EMA's in-place update ``e ← decay·e + (1−decay)·p``
    of a list of EMA tensors from the list of parameters."""

    @torch.no_grad()
    def update_(ema: Tensors, params: Tensors) -> None:
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))

    return update_
