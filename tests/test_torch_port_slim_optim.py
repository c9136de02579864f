"""The port's optimizer family, gradient accumulation and parameter EMA
against optax on the CPU, in float64 (``train/optimizers.py`` of each
package).

Each of the nine optimizers takes 4 steps from the same parameters and
gradients in both packages, with and without weight decay, the
global-norm clip (the first and third gradients above the norm) and
``trainable_scopes``; ``MultiSteps`` at k = 2 and 3, a snapshot of its
state in the middle of an accumulation and the resume from it; EMA; a
zero tensor under ``lamb`` (its trust ratio falls back to 1); adagrad's
initial accumulator. Bound: 1e-10 relative per tensor (the same formulas
in float64, summed in other orders: measured below 1e-15); the slots to
the same bound.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
from tensorflow_yolo2_torch.train import optimizers as pt_opt
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.train import optimizers as jx_opt

NAMES = ["sgd", "momentum", "adam", "adamw", "lamb", "rmsprop", "adagrad",
         "ftrl", "adadelta"]
SHAPES = {"head": {"kernel": (4, 3), "bias": (3,)},
          "trunk": {"kernel": (2, 3, 3, 2), "scale": (2,)}}
REL = 1e-10


def _tree(fn):
    return {m: {k: fn(s) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}


def _flat(tree):
    return {k.replace("/", "."): v
            for k, v in convert.flatten(jax.device_get(tree)).items()}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    den = max(np.linalg.norm(want), 1e-300)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / den)


def _run(cfg_kw, steps=4, clip=None, scopes=(), seed=0, zero=None,
         snapshot_at=None):
    """``steps`` updates of both packages from one seeded start: returns
    (port params, jax params, port state, jax state). ``zero`` names a
    parameter that starts at 0; ``snapshot_at`` deep-copies the port's
    parameters and state after that step and resumes from the copies."""
    rng = np.random.RandomState(seed)
    params = _tree(lambda s: rng.normal(0, 1, s))
    if zero is not None:
        m, k = zero.split("/")
        params[m][k] = np.zeros(SHAPES[m][k])
    scale = (3.0, 0.01, 2.0, 0.5, 1.0, 0.2)
    grads = [_tree(lambda s, c=c: rng.normal(0, 1, s) * c)
             for c in scale[:steps]]
    cfg = dict(cfg_kw, grad_clip_norm=clip, trainable_scopes=scopes)
    sched = dict(learning_rate=0.1)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jtx = jx_opt.make_optimizer(jx_config.OptimizerConfig(
            **cfg, schedule=jx_config.LRScheduleConfig(**sched)), jp)
        jstate = jtx.init(jp)
        ptx = pt_opt.make_optimizer(OptimizerConfig(
            **cfg, schedule=LRScheduleConfig(**sched)))
        pp = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
        pstate = ptx.init(pp)
        for i, g in enumerate(grads):
            updates, jstate = jtx.update(
                jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
            jp = optax.apply_updates(jp, updates)
            ptx.update_({k: torch.from_numpy(v)
                         for k, v in _flat(g).items()
                         if k in pstate.names}, pstate, pp)
            if snapshot_at == i + 1:
                pp, pstate = copy.deepcopy((pp, pstate))
            for k, v in _flat(jp).items():
                assert _rel(pp[k], v) <= REL, (cfg_kw, i, k, _rel(pp[k], v))
    return pp, _flat(jp), pstate, jstate


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_each_optimizer_matches_optax(name, weight_decay):
    _, _, state, _ = _run(dict(name=name, weight_decay=weight_decay))
    assert state.count == 4


@pytest.mark.parametrize("name", NAMES)
def test_each_optimizer_with_clip_and_scopes_matches_optax(name):
    """Clip 1.0 over the trained gradients only, weight decay 1e-2 on
    the trained parameters only; the frozen ones stay bit for bit."""
    pp, _, state, _ = _run(dict(name=name, weight_decay=1e-2), clip=1.0,
                           scopes=("head",), seed=1)
    assert sorted(state.names) == ["head.bias", "head.kernel"]
    rng = np.random.RandomState(1)
    start = _flat(_tree(lambda s: rng.normal(0, 1, s)))
    for k in ("trunk.kernel", "trunk.scale"):
        np.testing.assert_array_equal(pp[k].numpy(), start[k])


@pytest.mark.parametrize("name", ["adam", "rmsprop", "momentum", "lamb"])
@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(name, k):
    """6 micro-steps: the inner update applied on every k-th, the other
    micro-steps leave the parameters as they are (checked against optax
    after every micro-step), the count advances once an applied update;
    with weight decay and the clip on the mean gradient."""
    pp, jp, state, jstate = _run(
        dict(name=name, grad_accum_steps=k, weight_decay=1e-2), steps=6,
        clip=1.0)
    assert state.count == 6 // k and state.mini_step == 0
    assert int(jstate.mini_step) == 0 and int(jstate.gradient_step) == 6 // k


def test_multisteps_resumes_mid_accumulation():
    """A deep copy of the parameters and the state (what a snapshot
    keeps: ``acc_grads``, ``mini_step``, the slots, the count) after
    micro-step 2 of 3 carries on exactly as optax's."""
    pp, jp, state, jstate = _run(
        dict(name="rmsprop", grad_accum_steps=3), steps=6,
        snapshot_at=2)
    assert state.count == 2
    for name, slot in state.slots.items():
        assert set(slot) == set(state.names)


def test_lamb_zero_tensor_and_adagrad_accumulator():
    """A parameter that is 0 has a trust ratio of 1 under ``lamb`` (its
    update is Adam's); adagrad's sum of squares starts at optax's 0.1 and
    ftrl's at ``ftrl_initial_accumulator_value``."""
    pp, jp, _, _ = _run(dict(name="lamb"), zero="head/bias")
    assert float(pp["head.bias"].abs().max()) > 0
    p = {"w": torch.zeros(3, dtype=torch.float64)}
    assert float(pt_opt.make_optimizer(OptimizerConfig(name="adagrad"))
                 .init(p).sum_of_squares["w"][0]) == 0.1
    ftrl = OptimizerConfig(name="ftrl", ftrl_initial_accumulator_value=0.3,
                           ftrl_l2=0.05)
    assert float(pt_opt.make_optimizer(ftrl).init(p)
                 .sum_of_squares["w"][0]) == 0.3
    _run(dict(name="ftrl", ftrl_initial_accumulator_value=0.3, ftrl_l2=0.05))


def test_ema_matches_the_jax_update():
    rng = np.random.RandomState(3)
    ema = {k: rng.normal(0, 1, (3, 2)) for k in "ab"}
    params = {k: rng.normal(0, 1, (3, 2)) for k in "ab"}
    with jax.enable_x64(True):
        want = jx_opt.make_ema(0.9)(ema, params)
    got = [torch.from_numpy(ema[k].copy()) for k in "ab"]
    pt_opt.make_ema(0.9)(got, [torch.from_numpy(params[k]) for k in "ab"])
    for k, g in zip("ab", got):
        assert _rel(g, want[k]) <= REL


def test_grouped_optimizer_is_refused():
    """The per-scope groups are ported now (held to optax's
    ``multi_transform`` in ``tests/test_torch_port_adversarial.py``):
    without groups and without a default, every parameter is frozen."""
    params = {"w": torch.zeros(2)}
    grouped = pt_opt.make_grouped_optimizer([], params)
    state = grouped.init(params)
    assert state.names == [] and state.slots == {}
    grouped.update_({"w": torch.ones(2)}, state, params)
    assert state.count == 1 and not params["w"].any()
