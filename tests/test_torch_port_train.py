"""The port's v1 training path against the JAX package on the CPU: the
YOLOv1 loss, the BatchNorm running statistics, the schedules and
Adam + clipping, whole train steps of Darknet19, the VOC label grids and
loader, the resume / warm-start bootstrap and the training CLI.

Tolerances, each with its reason:

- loss (value, terms, gradient w.r.t. the grid): rtol 1e-5 — float32
  sums in another order (XLA fuses the jitted loss); atol 1e-5 on the
  gradient, whose elements reach ~10.
- BatchNorm train mode (output, running mean and variance): rtol 1e-5 —
  float32; the unbiased variance misses by 8/7 at 8 values a channel.
- schedules: rtol 1e-6, atol 1e-7·lr — the same formulas, in double here
  and in float32 in optax, where 1 + cos(·) cancels near a cosine's end
  (measured 5e-8·lr).
- Adam + clipping: rtol 1e-6 — the same float32 formulas (the global
  norm sums in another order); atol 1e-8 on the first moment, where
  0.9·m + 0.1·g cancels.
- whole train steps, float64, each of three steps: gradients (of the
  first) rtol 1e-9 (measured 1.5e-13); losses and metrics 1e-6, as the
  loss is float32 on both sides; parameters and running variances 1e-7:
  flax keeps running statistics in float32, so its first update rounds
  0.99·1 in float32 (9.5e-9; the port's is exact), atol 1e-6·lr for the
  few elements whose gradient is near Adam's ε, where the step moves by
  lr·ε/(|g| + ε)² per unit of gradient. The conv biases in front of BN
  have a true gradient of 0, so Adam steps them on rounding noise (up to
  ±lr) on each side: atol 2·lr, and atol 1e-8 on the running means that
  take them in.
- whole train steps, float32: train-mode BatchNorm over 2×2 maps makes
  the step ill-conditioned. Rounding alone moves the port's own float32
  gradients ~1e-2 (relative norm, worst tensor) from its float64 ones,
  and Adam's first step, ±lr·sign(g), flips wherever a gradient is below
  that noise: ~0.2% of the elements move by 2·lr. So: step-1 losses rtol
  1e-3, mean IoU and gradient norm 3e-3, gradients 6e-2 relative norm,
  statistics 1e-4; every parameter within 2·lr after step 1 (the conv
  biases in front of BN are pure noise, as above) and 99% of the
  elements within 1e-2·lr; after three steps losses within 3e-2 and
  updates within 0.3 relative norm. Measured: 2e-5, 7e-4, 1.5e-2, 2e-5,
  99.76%, 6e-3 and ~0.1 (see ``train_steps``).
- label grids and loader: exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as jnn

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
    YoloConfig,
)
from tensorflow_yolo2_torch.data import voc as pt_voc
from tensorflow_yolo2_torch.losses.yolo import yolo_loss
from tensorflow_yolo2_torch.models.darknet import Darknet19Detector
from tensorflow_yolo2_torch.models.layers import BatchNorm
from tensorflow_yolo2_torch.train import optimizers as pt_opt
from tensorflow_yolo2_torch.train.checkpoint import load_into
from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.data import voc as jx_voc
from tensorflow_yolo2_tpu.losses.yolo import yolo_loss as jx_yolo_loss
from tensorflow_yolo2_tpu.models import Darknet19Detector as JxDetector
from tensorflow_yolo2_tpu.parallel import MeshConfig, make_mesh
from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import TrainState as JxTrainState
from tensorflow_yolo2_tpu.train.trainer import yolo_task as jx_yolo_task
from tests import synthetic

LR = 1e-3
TINY = dict(S=2, B=2, num_class=4, image_size=64)


def rel_norm(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


# -- (a) the loss ------------------------------------------------------------


def _loss_inputs(cfg, batch=3, seed=0):
    """A grid with predicted boxes near some ground-truth boxes (so the
    IoUs and both responsibility cases occur) and labels with several
    responsible cells."""
    rng = np.random.RandomState(seed)
    S, B, C = cfg.S, cfg.B, cfg.num_class
    net = rng.normal(0, 0.5, (batch, S, S, cfg.cell_channels))
    labels = np.zeros((batch, S, S, 5 + C))
    for n in range(batch):
        for _ in range(4):
            y, x = rng.randint(0, S, 2)
            cx = (x + rng.uniform(0.1, 0.9)) * cfg.image_size / S
            cy = (y + rng.uniform(0.1, 0.9)) * cfg.image_size / S
            w, h = rng.uniform(20, 120, 2)
            labels[n, y, x, :5] = (1, cx, cy, w, h)
            labels[n, y, x, 5:] = 0
            labels[n, y, x, 5 + rng.randint(C)] = 1
            # slot 0 near the box: offsets in the cell, √ of the size
            net[n, y, x, C + B:C + B + 4] = (
                cx * S / cfg.image_size - x + rng.normal(0, 0.05),
                cy * S / cfg.image_size - y + rng.normal(0, 0.05),
                np.sqrt(w / cfg.image_size) + rng.normal(0, 0.05),
                np.sqrt(h / cfg.image_size) + rng.normal(0, 0.05))
    return net.astype(np.float32), labels.astype(np.float32)


@pytest.mark.parametrize("S,B,C", [(7, 2, 20), (4, 3, 5)])
def test_yolo_loss_matches_jax(S, B, C):
    cfg = YoloConfig(S=S, B=B, num_class=C, image_size=32 * S)
    jcfg = jx_config.YoloConfig(S=S, B=B, num_class=C, image_size=32 * S)
    net, labels = _loss_inputs(cfg)

    def jloss(n):
        return jx_yolo_loss(n, jnp.asarray(labels), jcfg)

    (jtotal, jaux), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(net))
    t = torch.from_numpy(net).requires_grad_()
    total, aux = yolo_loss(t, torch.from_numpy(labels), cfg)
    grad, = torch.autograd.grad(total, t)

    assert float(jaux.object_mask.sum()) > 0 and float(jaux.ious.max()) > 0.3
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for name in ("class_loss", "object_loss", "noobject_loss", "coord_loss"):
        np.testing.assert_allclose(float(getattr(aux, name)),
                                   float(getattr(jaux, name)), rtol=1e-5)
    np.testing.assert_allclose(aux.ious.detach().numpy(),
                               np.asarray(jaux.ious), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(aux.object_mask.numpy(),
                                  np.asarray(jaux.object_mask))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)


# -- (b) BatchNorm -----------------------------------------------------------


def test_batchnorm_running_stats_match_flax():
    """8 values a channel (batch 2, 2×2), where the unbiased variance is
    8/7 of the biased one that flax averages in."""
    rng = np.random.RandomState(3)
    C = 6
    x = rng.normal(0.5, 2.0, (2, 2, 2, C)).astype(np.float32)  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, C), rng.normal(0, 0.3, C)
    mean0, var0 = rng.normal(0, 0.2, C), rng.uniform(0.5, 2.0, C)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       variables)
    jbn = jnn.BatchNorm(use_running_average=False, momentum=0.99,
                        epsilon=1e-3)
    want, stats = jbn.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])

    bn = BatchNorm(C, momentum=0.99).train()
    bn.load_state_dict({"weight": torch.tensor(scale),
                        "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(mean0),
                        "running_var": torch.tensor(var0),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    new = stats["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-5)
    # the unbiased update torch's own BatchNorm2d makes is another result
    unbiased = 0.99 * var0 + 0.01 * x.reshape(-1, C).var(0, ddof=1)
    assert not np.allclose(unbiased, np.asarray(new["var"]), rtol=1e-5)

    bn.eval()
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = jnn.BatchNorm(use_running_average=True, epsilon=1e-3).apply(
        {"params": variables["params"], "batch_stats": new}, jnp.asarray(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


# -- (c) schedules and Adam ----------------------------------------------------


SCHEDULES = [
    dict(kind="fixed"),
    dict(kind="exponential", decay_steps=7, decay_factor=0.5),
    dict(kind="polynomial", decay_steps=30, end_learning_rate=1e-4,
         power=2.0),
    dict(kind="cosine", decay_steps=40, end_learning_rate=1e-5),
    dict(kind="cosine", decay_steps=20, warmup_steps=5),
    dict(kind="exponential", decay_steps=4, decay_factor=0.8,
         offset_steps=12),
    dict(kind="cosine", decay_steps=25, warmup_steps=3, offset_steps=9),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_matches_optax(kw):
    got = pt_opt.make_schedule(LRScheduleConfig(learning_rate=0.01, **kw))
    want = jx_opt.make_schedule(jx_config.LRScheduleConfig(
        learning_rate=0.01, **kw))
    steps = np.arange(51)
    np.testing.assert_allclose(
        [got(int(s)) for s in steps],
        [float(want(jnp.asarray(s, jnp.int32))) for s in steps], rtol=1e-6,
        atol=1e-7 * 0.01)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adam_matches_optax(clip):
    """Three steps fed the same gradients, with an exponential schedule
    (the rate of each step is taken at the count before it); with clip,
    the first and third gradients are above the norm and the second
    below."""
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.01, 2.0)]
    sched = dict(kind="exponential", learning_rate=0.1, decay_steps=1,
                 decay_factor=0.5)
    jtx = jx_opt.make_optimizer(jx_config.OptimizerConfig(
        grad_clip_norm=clip, schedule=jx_config.LRScheduleConfig(**sched)))
    ptx = pt_opt.make_optimizer(OptimizerConfig(
        grad_clip_norm=clip, schedule=LRScheduleConfig(**sched)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = ptx.init(pp)
    for g in grads:
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ptx.update_(
            {k: torch.from_numpy(v) for k, v in g.items()}, pstate, pp)
        for k in shapes:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    adam = jstate[-1][0] if clip else jstate[0]
    assert pstate.count == int(adam.count) == 3
    for k in shapes:
        np.testing.assert_allclose(pstate.mu[k].numpy(),
                                   np.asarray(adam.mu[k]), rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(pstate.nu[k].numpy(),
                                   np.asarray(adam.nu[k]), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(name="sgd"), dict(weight_decay=1e-4),
                                dict(moving_average_decay=0.999),
                                dict(name="adamw"),
                                dict(grad_accum_steps=2)])
def test_unported_optimizer_options_raise(kw):
    """These options are ported now (held to optax in
    ``tests/test_torch_port_slim_optim.py``) and build, and so do the
    per-scope optimizer groups (``tests/test_torch_port_adversarial.py``):
    a group without scopes takes every parameter."""
    opt = pt_opt.make_optimizer(OptimizerConfig(**kw))
    assert opt.cfg == OptimizerConfig(**kw)
    params = {"a.w": torch.zeros(2), "b.w": torch.zeros(3)}
    grouped = pt_opt.make_grouped_optimizer([((), OptimizerConfig(**kw))],
                                            params)
    assert grouped.groups[0][1].cfg == OptimizerConfig(**kw)
    assert grouped.init(params).names == ["a.w", "b.w"]


# -- (d) whole train steps ----------------------------------------------------


def _tiny_batch(dtype):
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(dtype)
    labels = np.zeros((4, 2, 2, 9), dtype)
    labels[:, 0, 1, :5] = (1, 40, 12, 20, 16)
    labels[:, 0, 1, 5 + 2] = 1
    labels[:2, 1, 0, :5] = (1, 10, 50, 30, 12)
    labels[:2, 1, 0, 5 + 1] = 1
    return images, labels


def _scalars(metrics):
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


@pytest.fixture(scope="module", params=["float32", "float64"])
def train_steps(request):
    """Train steps of Darknet19 (full depth, tiny grid, 64², batch 4, Adam
    at 1e-3) in the JAX package and in the port from the same
    JAX-initialised weights: gradients of the first step, and metrics,
    parameters and statistics after each of three steps (the float64
    XLA convs take ~10 s a step on the CPU)."""
    dtype = np.dtype(request.param)
    n_steps = 3
    images, labels = _tiny_batch(dtype)
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32

    def to_sd(params, stats=None):
        """``convert.state_dict_from_flax``, exact in float64 too: the
        converter gives float32 tensors, so a float64 tree goes through
        as its float32 rounding plus the float32 rounding of the rest
        (within 2^-48 of the value)."""
        sd = convert.state_dict_from_flax(params, stats)
        if dtype != np.float64:
            return sd
        def rest(tree):
            return jax.tree_util.tree_map(
                lambda a: a - np.asarray(a, np.float32).astype(np.float64),
                tree)

        lo = convert.state_dict_from_flax(
            rest(params), None if stats is None else rest(stats))
        return {k: v.double() + lo[k].double() if v.is_floating_point()
                else v for k, v in sd.items()}

    def flax_sd(state):
        return to_sd(jax.device_get(state.params),
                     jax.device_get(state.batch_stats))

    with jax.enable_x64(dtype == np.float64):
        jcfg = jx_config.YoloConfig(**TINY)
        model = JxDetector(output_channels=jcfg.cell_channels, dtype=jdtype,
                           param_dtype=jdtype)
        trainer = JxTrainer(
            model, jx_yolo_task(jcfg),
            jx_config.OptimizerConfig(
                schedule=jx_config.LRScheduleConfig(learning_rate=LR)),
            mesh=make_mesh(MeshConfig(data=1, model=1)))
        # Trainer.create_state with a jitted init (eagerly it takes ~20 s)
        variables = jax.jit(lambda rng, x: model.init(rng, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(images[:1]))
        trainer.tx = jx_opt.make_optimizer(trainer.opt_cfg)
        state = trainer.shard_state(JxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=trainer.tx.init(variables["params"]),
            rng=jax.random.PRNGKey(1)))
        init = flax_sd(state)

        jsteps = []
        for i in range(n_steps):
            state, metrics = trainer.train_step(state, images, labels)
            jsteps.append((_scalars(metrics), flax_sd(state)))
            # the shardings of the first call, so that XLA does not
            # compile the step again for the second
            state = trainer.shard_state(state)
            if i == 0:
                # the first step's gradients, from Adam's first moment
                # (1 − b1)·g: no second compile of the network
                b1 = trainer.opt_cfg.adam_beta1
                jgrads = to_sd(jax.device_get(jax.tree_util.tree_map(
                    lambda m: m / (1 - b1), state.opt_state[0].mu)))

    cfg = YoloConfig(**TINY)
    model = Darknet19Detector(cfg.cell_channels).to(
        torch.float64 if dtype == np.float64 else torch.float32)
    # compute_dtype float32 = no autocast: the model runs in its own type
    port = Trainer(model, yolo_task(cfg), OptimizerConfig(
        schedule=LRScheduleConfig(learning_rate=LR)), device="cpu",
        compute_dtype=torch.float32)
    pstate = port.create_state(torch.Generator().manual_seed(0), init)
    _, pgrads = port.loss_and_grads(pstate, images, labels)
    load_into(pstate.model, init)  # undo that pass's statistics update
    psteps = []
    for _ in range(n_steps):
        pstate, metrics = port.train_step(pstate, images, labels)
        psteps.append((_scalars(metrics), {
            k: v.clone() for k, v in pstate.model.state_dict().items()}))
    return {"dtype": request.param, "init": init, "jgrads": jgrads,
            "pgrads": {k: v.detach() for k, v in pgrads.items()},
            "jsteps": jsteps, "psteps": psteps}


def _pre_bn_bias(key, keys) -> bool:
    return key.endswith("conv.bias") and \
        key.replace("conv.bias", "bn.weight") in keys


def _param_keys(run):
    """Parameter names, without the conv biases in front of BN."""
    return [k for k in run["pgrads"] if not _pre_bn_bias(k, run["pgrads"])]


def test_train_steps_losses_and_metrics_match_jax(train_steps):
    f64 = train_steps["dtype"] == "float64"
    for i, ((got, _), (want, _)) in enumerate(zip(train_steps["psteps"],
                                                  train_steps["jsteps"])):
        assert set(got) == set(want)
        for k in want:
            atol = 0.0
            if f64:
                rtol = 1e-6
            elif i == 0:
                rtol = 3e-3 if k in ("mean_iou", "grad_norm") else 1e-3
            elif k in ("loss", "grad_norm"):
                rtol = 3e-2
            else:  # a loss term, or the IoU
                rtol, atol = 0.0, 1e-2 if k == "mean_iou" else \
                    3e-2 * want["loss"]
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=f"step {i + 1} {k}")


def test_train_step_gradients_match_jax(train_steps):
    keys = _param_keys(train_steps)
    got, want = train_steps["pgrads"], train_steps["jgrads"]
    if train_steps["dtype"] == "float64":
        for k in keys:
            assert rel_norm(got[k], want[k]) < 1e-9, k
        # the true gradient of a conv bias in front of BN is 0
        scale = max(float(want[k].abs().max()) for k in keys)
        for k in set(got) - set(keys):
            assert float((got[k] - want[k]).abs().max()) < 1e-9 * scale, k
    else:
        assert rel_norm(np.concatenate([got[k].ravel() for k in keys]),
                        np.concatenate([want[k].ravel() for k in keys])) \
            < 6e-2


def test_train_step_batch_stats_match_jax(train_steps):
    """After each float64 step, and after the first float32 step (after
    three float32 steps the trajectories have parted: see the module
    docstring)."""
    f64 = train_steps["dtype"] == "float64"
    n = len(train_steps["psteps"]) if f64 else 1
    for (_, got), (_, want) in zip(train_steps["psteps"][:n],
                                   train_steps["jsteps"][:n]):
        for k in want:
            if f64 and k.endswith("running_mean"):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-8, err_msg=k)
            elif "running" in k:
                assert rel_norm(got[k], want[k]) < (1e-7 if f64 else 1e-4), k


def test_train_step_params_match_jax(train_steps):
    init = train_steps["init"]
    keys = _param_keys(train_steps)
    (_, got1), (_, want1) = train_steps["psteps"][0], train_steps["jsteps"][0]
    for k in set(train_steps["pgrads"]) - set(keys):  # conv bias before BN
        np.testing.assert_allclose(got1[k], want1[k], rtol=0, atol=2 * LR)
    if train_steps["dtype"] == "float64":
        for (_, got), (_, want) in zip(train_steps["psteps"],
                                       train_steps["jsteps"]):
            for k in keys:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-7,
                                           atol=1e-6 * LR, err_msg=k)
        return
    diff = np.concatenate([(got1[k] - want1[k]).abs().ravel().numpy()
                           for k in keys]) / LR
    assert diff.max() <= 2.0 + 1e-3
    assert np.mean(diff < 1e-2) > 0.99
    (_, got3), (_, want3) = train_steps["psteps"][2], train_steps["jsteps"][2]
    step = lambda sd: np.concatenate([(sd[k] - init[k]).ravel()
                                      for k in keys])
    assert rel_norm(step(got3), step(want3)) < 0.3


# -- (e) label grids and the VOC loader ---------------------------------------


def test_build_label_grid_matches_jax():
    rng = np.random.RandomState(5)
    for _ in range(20):
        n = rng.randint(1, 9)
        xy = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(1, 60, (n, 2))
        corners = np.concatenate([xy, np.minimum(xy + wh, 223)],
                                 1).astype(np.float32)
        cls = rng.randint(0, 20, n).astype(np.int32)
        corners[-1] = corners[0]  # a second object in a taken cell
        np.testing.assert_array_equal(
            pt_voc.build_label_grid(corners, cls, 7, 20, 224.0),
            jx_voc.build_label_grid(corners, cls, 7, 20, 224.0))


@pytest.mark.parametrize("uint8,flipped", [(False, False), (True, True)])
def test_pascal_voc_first_epoch_matches_jax(tmp_path, monkeypatch, uint8,
                                            flipped):
    """The same images and labels, batch by batch, over the first epoch.
    The JAX package shuffles with numpy's global generator and resizes
    with its native C++ kernel when that builds; here both shuffle with
    the same seed and resize with cv2."""
    from tensorflow_yolo2_tpu.utils import native

    monkeypatch.setattr(native, "_load", lambda: None)
    voc = synthetic.make_voc(str(tmp_path / "VOCdevkit"), n_images=5)
    np.random.seed(11)
    jds = jx_voc.PascalVOC(
        "trainval", batch_size=2, data_path=voc, uint8=uint8,
        flipped=flipped, paths=jx_config.Paths(root=str(tmp_path / "jax")))
    pds = pt_voc.PascalVOC(
        "trainval", batch_size=2, data_path=voc, uint8=uint8,
        flipped=flipped, paths=Paths(root=str(tmp_path / "port")),
        rng=np.random.RandomState(11))
    assert os.path.isfile(tmp_path / "port" / "cache" /
                          "pascal_trainval_gt_labels.pkl")
    n = len(jds.gt_labels)
    assert len(pds.gt_labels) == n == (10 if flipped else 5)
    for _ in range(n // 2):
        (ji, jl), (pi, pl) = jds.get(), pds.get()
        assert pi.dtype == (np.uint8 if uint8 else np.float32)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)


def test_prefetch_order_and_worker_error():
    """One worker delivers the batches in order, then the error a
    ``get_batch`` call raised; the device copies keep the order."""
    from tensorflow_yolo2_torch.data.prefetch import (
        PrefetchLoader,
        device_prefetch,
    )

    calls = iter(range(10))

    def get_batch():
        i = next(calls)
        if i == 3:
            raise ValueError("unreadable image")
        return np.full((2, 3), i, np.uint8), np.full((2,), i, np.float32)

    got = []
    with PrefetchLoader(get_batch, num_workers=1, prefetch_size=2) as loader:
        with pytest.raises(ValueError, match="unreadable image"):
            for images, labels in loader:
                got.append(int(images[0, 0]))
    assert got == [0, 1, 2]
    batches = [(np.full(2, i), np.full(1, i)) for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert [int(b[0][0]) for b in out] == list(range(5))
    assert all(isinstance(t, torch.Tensor) for b in out for t in b)


# -- (f) the CLI ----------------------------------------------------------------


def test_train_cli_snapshots_resumes_and_serves(tmp_root, capsys):
    from tensorflow_yolo2_torch.entries import pascal_train_darknet
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_detect_fn,
    )
    from tensorflow_yolo2_torch.train.checkpoint import read_snapshot

    voc = synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"),
                             n_images=3)
    argv = ["--batch-size", "2", "--num-workers", "1", "--device", "cpu",
            "--log-every", "1"]
    assert pascal_train_darknet.main(
        ["--iters", "2", "--save-every", "2"] + argv) == 0
    ckpts = tmp_root / "ckpts" / "darknet19" / "voc_2007"
    assert (ckpts / "train_iter_2").is_dir()
    events = tmp_root / "tensorboard" / "darknet19" / "voc_2007" / \
        "train" / "events.jsonl"
    recs = [json.loads(line) for line in events.read_text().splitlines()]
    names = set().union(*(r.keys() for r in recs if "hist" not in r))
    assert {"loss", "class_loss", "object_loss", "noobject_loss",
            "coord_loss", "mean_iou", "grad_norm"} <= names
    assert {r["hist"] for r in recs if "hist" in r} == {"hist/iou",
                                                        "hist/confidence"}

    assert pascal_train_darknet.main(["--iters", "1"] + argv) == 0
    assert "Restored snapshot at iter 2" in capsys.readouterr().out
    snap = read_snapshot(str(ckpts / "train_iter_3"))
    assert snap["step"] == 3 and snap["optimizer"]["count"] == 3
    assert snap["yolo"]["S"] == 7 and snap["yolo"]["lambda_coord"] == 5.0

    cfg = YoloConfig()
    detect = make_detect_fn(cfg, snap["model"], object_thresh=0.0,
                            use_nms=True, dtype=torch.float32, device="cpu")
    images = np.stack([pt_voc.image_read_u8(os.path.join(
        voc, "JPEGImages", f"00000{i}.jpg"), 224) for i in range(2)])
    dets = detect(images)
    assert dets.boxes.shape == (2, 32, 4)
    assert bool(torch.isfinite(dets.scores).all())

    with pytest.raises(SystemExit):
        pascal_train_darknet.main(["--spatial", "2"] + argv)
    assert "--spatial 2 runs one process a shard: start it with torchrun " \
        "--nproc-per-node 2" in capsys.readouterr().err


def _flax_tree(sd):
    """A port state dict as a flax (params, batch_stats) pair of numpy
    trees, the inverse of ``convert.state_dict_from_flax``."""
    leaves = {"conv.weight": ("params", "conv/kernel"),
              "conv.bias": ("params", "conv/bias"),
              "bn.weight": ("params", "bn/scale"),
              "bn.bias": ("params", "bn/bias"),
              "bn.running_mean": ("batch_stats", "bn/mean"),
              "bn.running_var": ("batch_stats", "bn/var")}
    flat = {"params": {}, "batch_stats": {}}
    for key, value in sd.items():
        for suffix, (coll, leaf) in leaves.items():
            if key.endswith("." + suffix):
                value = value.numpy()
                if suffix == "conv.weight":
                    value = value.transpose(2, 3, 1, 0)  # OIHW → HWIO
                module = key[:-len(suffix) - 1].replace(".", "/")
                flat[coll][f"{module}/{leaf}"] = value
    return (convert.unflatten(flat["params"]),
            convert.unflatten(flat["batch_stats"]))


def _small_trainer() -> Trainer:
    """A trainer of a net with Darknet19's names at a fraction of its
    size, for the snapshot plumbing."""
    from tensorflow_yolo2_torch.models.layers import ConvBN

    net = torch.nn.Module()
    net.backbone = torch.nn.Module()
    net.backbone.conv1 = ConvBN(3, 8, 3)
    net.detection = torch.nn.Module()
    net.detection.output = ConvBN(8, 4, 1)
    return Trainer(net, yolo_task(YoloConfig(**TINY)), device="cpu",
                   compute_dtype=torch.float32)


def test_bootstrap_warm_starts_and_swaps_optimizer(tmp_root):
    """``bootstrap_state`` without a snapshot of its own: parameters from
    another run's snapshot dir outside an excluded scope, or parameters
    and statistics from a flax tree; with a snapshot whose optimizer
    state does not fit: the model restored, a fresh optimizer, the
    snapshot's step."""
    from tensorflow_yolo2_torch.entries.common import bootstrap_state
    from tensorflow_yolo2_torch.train.checkpoint import (
        SNAPSHOT_FILE,
        CheckpointManager,
        read_snapshot,
    )

    make = _small_trainer

    def gen():
        return torch.Generator().manual_seed(0)

    src = make().create_state(torch.Generator().manual_seed(1))
    with torch.no_grad():  # statistics away from their fresh values
        for k, v in src.model.state_dict().items():
            if "running" in k:
                v.add_(0.5)
    want = {k: v.clone() for k, v in src.model.state_dict().items()}
    fresh = make().create_state(gen()).model.state_dict()
    src_mgr = CheckpointManager("src", "voc_2007")
    src_mgr.save(7, src)
    params = set(dict(src.model.named_parameters()))

    state, step = bootstrap_state(
        make(), CheckpointManager("a", "voc_2007"), gen(),
        warm_start_dir=src_mgr.latest_path(),
        warm_start_exclude=("detection",))
    assert step == 0 and state.step == 0
    for k, v in state.model.state_dict().items():
        from_src = k in params and not k.startswith("detection.")
        torch.testing.assert_close(v, (want if from_src else fresh)[k],
                                   rtol=0, atol=0, msg=k)

    state, step = bootstrap_state(make(), CheckpointManager("b", "voc_2007"),
                                  gen(), warm_start_tree=_flax_tree(want))
    assert step == 0
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)

    raw = read_snapshot(src_mgr.latest_path())
    raw["optimizer"] = {"count": 3, "mu": {}, "nu": {}}  # another optimizer
    torch.save(raw, os.path.join(src_mgr.latest_path(), SNAPSHOT_FILE))
    state, step = bootstrap_state(make(), src_mgr, gen())
    assert step == state.step == 7 and state.opt_state.count == 0
    assert all(float(m.abs().max()) == 0 for m in state.opt_state.mu.values())
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_save_cut_short_leaves_the_previous_snapshot(tmp_root):
    """A save killed while writing leaves only ``train_iter_N.tmp``: the
    run resumes from the snapshot before it, and the next save of that
    step replaces the temporary dir."""
    from tensorflow_yolo2_torch.entries.common import bootstrap_state
    from tensorflow_yolo2_torch.train.checkpoint import (
        SNAPSHOT_FILE,
        CheckpointManager,
    )

    mgr = CheckpointManager("net", "voc_2007")
    state = _small_trainer().create_state(torch.Generator().manual_seed(0))
    state.step = 2
    mgr.save(2, state)
    cut = os.path.join(mgr.dir, "train_iter_4.tmp")
    os.makedirs(cut)
    with open(os.path.join(mgr.dir, "train_iter_2", SNAPSHOT_FILE),
              "rb") as f:
        head = f.read(100)
    with open(os.path.join(cut, SNAPSHOT_FILE), "wb") as f:
        f.write(head)  # a truncated torch file
    assert mgr.latest_step() == 2
    resumed, step = bootstrap_state(_small_trainer(), mgr,
                                    torch.Generator().manual_seed(1))
    assert step == resumed.step == 2
    mgr.save(4, resumed)
    assert sorted(os.listdir(mgr.dir)) == ["train_iter_2", "train_iter_4"]
    assert mgr.restore(_small_trainer().create_state(
        torch.Generator().manual_seed(1)))[1] == 4
