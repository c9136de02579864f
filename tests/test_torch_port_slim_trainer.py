"""The port's Trainer options against the JAX package's on the CPU, in
float64: EMA, gradient accumulation (``MultiSteps``, k = 2) and
activation summaries together in one run of two micro-steps, on
``yolo1_pretrain`` (no BatchNorm) and ``resnet_v2_50`` (BatchNorm), both
at 64², batch 2, 10 classes, momentum 0.9 at 0.1 with weight decay 1e-3
and the clip at 1.0; and ``remat`` against the plain port step, bit for
bit. ``resnet_v2_50``'s run is collected by
``tests/test_torch_port_slim_trainer_bn.py``, so that each file stays
under a minute. Neither net has dropout, so the two packages' steps see the same
function (their dropout generators differ).

Tolerances, each with its reason (both packages cast the nets' float64
logits to float32 and take a float32 loss, as in
``tests/test_torch_port_resnet_train.py``):

- the loss 1e-6 relative (a float32 value summed in another order);
- after the first micro-step the parameters and the EMA bit-equal to
  their start (nothing applied), the running statistics 1e-9 relative
  norm (float64 batch statistics);
- after the second, each parameter and EMA tensor 1e-8 relative norm:
  the float32 loss puts ~1e-7 relative noise into the gradients, and a
  step moves a parameter by lr·g, a small part of it;
- the activation summaries: the same names, each ``sparsity/*`` within
  1e-6 and each ``hist/act_*`` (float32 casts of float64 values) 1e-6
  relative norm;
- ``remat``: parameters, running statistics, optimizer slots and the
  generator's state bit-equal to the plain step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
from tensorflow_yolo2_torch.models import registry
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.models import registry as jx_registry
from tensorflow_yolo2_tpu.parallel import MeshConfig, make_mesh
from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import TrainState as JxTrainState
from tensorflow_yolo2_tpu.train.trainer import softmax_task as jx_softmax
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_train import (  # noqa: F401
    _f64,
    few_torch_threads,  # autouse
    to_sd,
)
from tests.test_torch_port_train import rel_norm

SIZE = 64
BATCH = 2
NUM_CLASSES = 10
OPT = dict(name="momentum", momentum=0.9, weight_decay=1e-3,
           grad_clip_norm=1.0, moving_average_decay=0.9, grad_accum_steps=2)
SCHED = dict(learning_rate=0.1)


def _batches(seed):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)),
             rng.randint(0, NUM_CLASSES, BATCH).astype(np.int32))
            for _ in range(2)]


NETS = ["yolo1_pretrain"]


def make_runs(name):
    """Two micro-steps of ``name`` in each package from the same
    float64 weights: the start, and after each micro-step JAX's (metrics,
    state dict, EMA) and the port's (metrics, state dict, EMA,
    ``mini_step``, count)."""
    batches = _batches(len(name))
    with jax.enable_x64(True):
        variables = _f64(random_variables(
            jx_registry.get_network(name, num_classes=NUM_CLASSES),
            (1, SIZE, SIZE, 3), seed=7))
        params = variables["params"]
        stats = variables.get("batch_stats", {})
        init = to_sd(params, stats or None)
        cfg = jx_config.OptimizerConfig(
            **OPT, schedule=jx_config.LRScheduleConfig(**SCHED))
        jtrainer = JxTrainer(
            jx_registry.get_network(name, num_classes=NUM_CLASSES,
                                    dtype=jnp.float64),
            jx_softmax(), cfg, mesh=make_mesh(MeshConfig(data=1, model=1)),
            activation_summaries=True)
        jtrainer.tx = jx_opt.make_optimizer(cfg, params)
        jstate = jtrainer.shard_state(JxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jtrainer.tx.init(params),
            ema_params=jax.tree_util.tree_map(jnp.copy, params),
            rng=jax.random.PRNGKey(1)))
        jsteps = []
        for images, labels in batches:
            jstate, metrics = jtrainer.train_step(jstate, images, labels)
            jsteps.append((jax.device_get(metrics),
                           to_sd(jstate.params, jstate.batch_stats or None),
                           to_sd(jstate.ema_params)))
    port = Trainer(registry.get_network(name, num_classes=NUM_CLASSES,
                                        image_size=SIZE).double(),
                   softmax_task(), OptimizerConfig(
                       **OPT, schedule=LRScheduleConfig(**SCHED)),
                   device="cpu", compute_dtype=torch.float32,
                   activation_summaries=True)
    counters = {k: v for k, v in port.model.state_dict().items()
                if k.endswith("num_batches_tracked")}
    pstate = port.create_state(torch.Generator().manual_seed(0),
                               {**counters, **init})
    psteps = []
    for images, labels in batches:
        pstate, metrics = port.train_step(pstate, images, labels)
        psteps.append((metrics,
                       {k: v.clone() for k, v in
                        pstate.model.state_dict().items()},
                       {k: v.clone() for k, v in pstate.ema_params.items()},
                       pstate.opt_state.mini_step, pstate.opt_state.count))
    return {"init": init, "jax": jsteps, "port": psteps}


@pytest.fixture(scope="module", params=NETS)
def runs(request):
    return make_runs(request.param)


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", NETS)


def test_losses_match(runs):
    for (jm, *_), (pm, *_) in zip(runs["jax"], runs["port"]):
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)


def test_first_micro_step_applies_nothing(runs):
    _, after, ema, mini_step, count = runs["port"][0]
    _, jafter, jema = runs["jax"][0]
    assert (mini_step, count) == (1, 0)
    for k, v in runs["init"].items():
        if k.endswith(("running_mean", "running_var")):
            assert rel_norm(after[k], jafter[k]) <= 1e-9, k
        elif not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(after[k], v, rtol=0, atol=0)
            torch.testing.assert_close(ema[k], v, rtol=0, atol=0)
            np.testing.assert_array_equal(jafter[k].numpy(), v.numpy())


def test_second_micro_step_matches_jax(runs):
    _, after, ema, mini_step, count = runs["port"][1]
    _, jafter, jema = runs["jax"][1]
    assert (mini_step, count) == (0, 1)
    moved = 0
    for k, want in jafter.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert rel_norm(after[k], want) <= 1e-8, k
        if k in ema:
            assert rel_norm(ema[k], jema[k]) <= 1e-8, k
            moved += int(not torch.equal(ema[k], runs["init"][k]))
    assert moved > 0


def test_activation_summaries_match_jax(runs):
    for (jm, *_), (pm, *_) in zip(runs["jax"], runs["port"]):
        names = {k for k in jm if k.startswith(("sparsity/", "hist/act_"))}
        assert names == {k for k in pm
                         if k.startswith(("sparsity/", "hist/act_"))}
        assert len(names) >= 4
        for k in names:
            got, want = pm[k].numpy(), np.array(jm[k])
            assert got.dtype == np.float32 and got.shape == want.shape, k
            if k.startswith("sparsity/"):
                assert abs(float(got) - float(want)) <= 1e-6, k
            else:
                assert rel_norm(torch.from_numpy(got),
                                torch.from_numpy(want)) <= 1e-6, k


def test_remat_step_is_bit_equal_to_the_plain_step(name):
    """Two Adam steps with and without ``remat``, from one seed: the
    recompute leaves the running statistics (moved once a step) and the
    generator (here also drawn from, by a dropout-free net: never) where
    the plain step leaves them."""
    images, labels = _batches(3)[0]
    images = images.astype(np.float32)

    def run(remat):
        trainer = Trainer(registry.get_network(
            name, num_classes=NUM_CLASSES, image_size=SIZE), softmax_task(),
            OptimizerConfig(name="adam"), device="cpu",
            compute_dtype=torch.float32, remat=remat)
        state = trainer.create_state(torch.Generator().manual_seed(5))
        for _ in range(2):
            state, metrics = trainer.train_step(state, images, labels)
        return (state.model.state_dict(), state.opt_state.slots,
                state.rng.get_state(), float(metrics["loss"]))

    plain, remat = run(False), run(True)
    for k, v in plain[0].items():
        torch.testing.assert_close(remat[0][k], v, rtol=0, atol=0)
    for slot, tensors in plain[1].items():
        for k, v in tensors.items():
            torch.testing.assert_close(remat[1][slot][k], v, rtol=0, atol=0)
    assert torch.equal(plain[2], remat[2]) and plain[3] == remat[3]
