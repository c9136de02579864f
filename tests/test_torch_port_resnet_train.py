"""Training the port's ResNet50 detector against the JAX package on the
CPU: one float64 Adam step (dropout off). The frozen-trunk fine-tune and
``trainable_scopes``: ``tests/test_torch_port_resnet_freeze.py``; the
dropout generator: ``tests/test_torch_port_resnet_model.py``.

Full width, 32² input (a 1×1 block4 map; the root pool's map is 16×16,
even, so its SAME padding shows), batch 4, seeded random weights.
Tolerances, each with its reason:

- the float64 values before each cast to float32, 1e-10 relative norm
  (float64 convs and BatchNorms summed in other orders; measured 8.4e-12
  and 5e-16): the JAX detector casts its trunk's output to float32
  (``ResNet50V1`` returns float32) and then its grid, and both packages'
  losses run in float32 (``losses/yolo.py`` in each), so there is no
  float64 loss on either side. Held there: the block4 map of the step's
  forward, and ``yolo_fc2``'s output from the JAX trunk's cast output;
- the loss and the metrics after the casts, summed in another order:
  1e-6 relative (the Darknet step's bound; measured 8.5e-8, a float32
  ulp);
- each gradient tensor of the float64 step: 1e-6 relative norm (the
  float32 loss's rounding reaches the gradients; measured 1.3e-7); each
  parameter's move: see ``test_detector_step_params_and_stats_match_jax``
  (Adam's first step turns gradients at that noise into moves up to lr);
- the running statistics after a step: 1e-9 relative norm, the running
  means 1e-9 absolute (float64 batch statistics of the same float64
  maps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    YoloConfig,
)
from tensorflow_yolo2_torch.models.resnet import ResNet50Detector
from tensorflow_yolo2_torch.train.checkpoint import load_into
from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.models import resnet as jx_resnet
from tensorflow_yolo2_tpu.parallel import MeshConfig, make_mesh
from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import TrainState as JxTrainState
from tensorflow_yolo2_tpu.train.trainer import yolo_task as jx_yolo_task
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_train import _scalars, rel_norm

SIZE = 32
LR = 5e-4  # the detector's Adam rate
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """torch's intra-op threads at 2 for the module, then as they were.
    The full-width ResNet ops at these small shapes gain little from 8
    threads, and the tier-1 run puts 6 test processes on 8 cores: 8
    OpenMP threads each then spin against each other (the four ResNet
    files took 378 s with 8 threads and 81 s with 2, 4 files at a time
    on 8 cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def to_sd(params, stats=None):
    """``convert.state_dict_from_flax``, exact in float64: the converter
    gives float32 tensors, so a float64 tree goes through as its float32
    rounding plus the float32 rounding of the rest (within 2^-48 of the
    value)."""
    params, stats = jax.device_get((params, stats))
    sd = convert.state_dict_from_flax(params, stats)

    def rest(tree):
        return jax.tree_util.tree_map(
            lambda a: a - np.asarray(a, np.float32).astype(np.float64), tree)

    lo = convert.state_dict_from_flax(rest(params),
                                      None if stats is None else rest(stats))
    return {k: v.double() + lo[k].double() if v.is_floating_point() else v
            for k, v in sd.items()}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jx_step(model, task, opt_cfg, variables, images, labels):
    """One float64 JAX train step: (metrics, state after, the gradients
    as a state dict). The gradients come from the optimizer state:
    Adam's first moment is (1 − b1)·g, momentum's first trace g."""
    trainer = JxTrainer(model, task, opt_cfg,
                        mesh=make_mesh(MeshConfig(data=1, model=1)))
    trainer.tx = jx_opt.make_optimizer(opt_cfg, variables["params"])
    state = trainer.shard_state(JxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=trainer.tx.init(variables["params"]),
        rng=jax.random.PRNGKey(1)))
    state, metrics = trainer.train_step(state, images, labels)
    return _scalars(metrics), state


def _port_step(model, task, opt_cfg, init, images, labels):
    """The port's float64 step from ``init``: (gradients, metrics, the
    state dict after the step, the state)."""
    port = Trainer(model.double(), task, opt_cfg, device="cpu",
                   compute_dtype=torch.float32)
    counters = {k: v for k, v in model.state_dict().items()
                if k.endswith("num_batches_tracked")}
    pstate = port.create_state(torch.Generator().manual_seed(0),
                               {**counters, **init})
    _, grads = port.loss_and_grads(pstate, images, labels)
    load_into(pstate.model, init)  # the statistics before that forward
    pstate, metrics = port.train_step(pstate, images, labels)
    return ({k: g.detach() for k, g in grads.items()}, _scalars(metrics),
            {k: v.clone() for k, v in pstate.model.state_dict().items()},
            pstate)


# -- the detector: one float64 Adam step, dropout off -------------------------


@pytest.fixture(scope="module")
def detector_step():
    rng = np.random.RandomState(5)
    images = rng.uniform(-1, 1, (4, SIZE, SIZE, 3))
    yolo = YoloConfig()
    labels = np.zeros((4, 7, 7, 25), np.float32)
    for i in range(4):
        for _ in range(2):
            r, c = rng.randint(0, 7, 2)
            labels[i, r, c, :5] = (1, *rng.uniform(20, 200, 2),
                                   *rng.uniform(16, 120, 2))
            labels[i, r, c, 5 + rng.randint(20)] = 1
    opt = dict(name="adam")
    sched = dict(learning_rate=LR)
    with jax.enable_x64(True):
        variables = _f64(random_variables(jx_resnet.ResNet50Detector(),
                                          (1, SIZE, SIZE, 3), seed=9))
        init = to_sd(variables["params"], variables["batch_stats"])
        jmodel = jx_resnet.ResNet50Detector(
            dropout_rate=0.0, dtype=jnp.float64, param_dtype=jnp.float64)
        _, captured = jmodel.apply(
            variables, images, train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in (
                "block4_unit3", "backbone", "yolo_fc2"))
        jx = {name: np.asarray(captured["intermediates"][name]["__call__"][0])
              for name in ("backbone", "yolo_fc2")}
        jx["block4_unit3"] = np.asarray(captured["intermediates"]["backbone"]
                                        ["block4_unit3"]["__call__"][0])
        jmetrics, jstate = _jx_step(
            jmodel, jx_yolo_task(jx_config.YoloConfig()),
            jx_config.OptimizerConfig(
                **opt, schedule=jx_config.LRScheduleConfig(**sched)),
            variables, images, labels)
        b1 = jx_config.OptimizerConfig().adam_beta1
        jgrads = to_sd(jax.tree_util.tree_map(lambda m: m / (1 - b1),
                                              jstate.opt_state[0].mu))
        jafter = to_sd(jstate.params, jstate.batch_stats)
    model = ResNet50Detector(yolo.cell_channels, image_size=SIZE,
                             dropout_rate=0.0).double()
    load_into(model, init)
    with torch.no_grad():  # the port's head on the JAX trunk's output
        trunk = torch.from_numpy(jx["backbone"].astype(np.float64))
        head = model.yolo_fc2(F.relu(model.yolo_fc1(trunk.reshape(4, -1))))
    maps = []  # block4's output, the first from the step's forward
    model.backbone.block4_unit3.register_forward_hook(
        lambda module, args, out: maps.append(out.detach()))
    pgrads, pmetrics, pafter, _ = _port_step(
        model, yolo_task(yolo), OptimizerConfig(
            **opt, schedule=LRScheduleConfig(**sched)),
        init, images, labels)
    return {"jmetrics": jmetrics, "jgrads": jgrads, "jafter": jafter,
            "pmetrics": pmetrics, "pgrads": pgrads, "pafter": pafter,
            "init": init, "jx": jx, "head": head,
            "block4": maps[0].permute(0, 2, 3, 1)}


def test_detector_step_forward_before_the_casts_matches_jax(detector_step):
    """The float64 values before each cast to float32 agree below
    float32's rounding: the block4 map of the step's forward (before the
    JAX trunk's cast), and ``yolo_fc2``'s output (before the ReLU and the
    grid's cast) from the JAX trunk's cast output through the port's
    ``yolo_fc1``, ReLU and ``yolo_fc2``."""
    jx = detector_step["jx"]
    for got, want in ((detector_step["block4"], jx["block4_unit3"]),
                      (detector_step["head"], jx["yolo_fc2"])):
        assert got.dtype == torch.float64 and want.dtype == np.float64
        assert got.shape == want.shape and float(want.std()) > 0
        assert rel_norm(got, want) <= 1e-10


def test_detector_step_loss_and_metrics_match_jax(detector_step):
    got, want = detector_step["pmetrics"], detector_step["jmetrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_detector_step_gradients_match_jax(detector_step):
    """Each gradient tensor on its own, the FCs' and every BatchNorm's
    among them."""
    got, want = detector_step["pgrads"], detector_step["jgrads"]
    assert got.keys() == {k for k in want if "running" not in k and
                          not k.endswith("num_batches_tracked")}
    assert {"yolo_fc1.weight", "yolo_fc2.bias",
            "backbone.conv1.weight"} <= got.keys()
    for k in got:
        assert rel_norm(got[k], want[k]) <= 1e-6, k


def test_detector_step_params_and_stats_match_jax(detector_step):
    """The running statistics; each parameter's move, element by element,
    where its gradient is more than 1e-5 of the tensor's largest. Below
    that a gradient is at the float32 loss's noise (a BatchNorm bias
    whose true gradient is 0 reads 1e-11 against 5.7e3), and Adam's
    first step, −lr·g/(|g| + ε), turns noise into a move of any size up
    to lr (measured: 2.5% of lr on 65 of yolo_fc1's 8.4M weights): there
    each move is held to lr."""
    got, want = detector_step["pafter"], detector_step["jafter"]
    init, grads = detector_step["init"], detector_step["jgrads"]
    held = nonzero = 0
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            assert rel_norm(got[k], want[k]) <= 1e-9, k
            assert not torch.equal(got[k], init[k]), k
            if k.endswith("running_mean"):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-9, err_msg=k)
            continue
        moved, want_moved = got[k] - init[k], want[k] - init[k]
        g = grads[k].abs()
        signal = g > 1e-5 * g.max()
        held += int(signal.sum())
        nonzero += int((g > 0).sum())
        np.testing.assert_allclose(moved[signal], want_moved[signal],
                                   rtol=0, atol=1e-6 * LR, err_msg=k)
        assert float(moved.abs().max()) <= LR * (1 + 1e-9), k
    assert held > 0.99 * nonzero
