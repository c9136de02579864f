"""The frozen-trunk fine-tune of the port's ResNet50 classifier against
the JAX package on the CPU: one float64 momentum step with only
``logits`` trained (``trainable_scopes``), and ``trainable_scopes`` in
the optimizers, with and without the global-norm clip, against optax's
``multi_transform``.

Full width, 32² input, batch 4, 10 classes, seeded random weights
(``tests/test_torch_port_resnet_train.py``'s helpers). Tolerances, each
with its reason:

- frozen parameters: bit-equal to their values before the step, in both
  packages;
- the logits after the step: 1e-9 relative norm, their move 1e-6 (the
  float32 logits' rounding reaches the gradient, as for the detector);
- the loss 1e-6 relative (a float32 value in both packages);
- the running statistics: 1e-9 relative norm, the means 1e-9 absolute;
- ``trainable_scopes`` against optax in float64: rtol 1e-12 (the same
  formulas at a fixed rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
from tensorflow_yolo2_torch.models.resnet import ResNet50V1
from tensorflow_yolo2_torch.train import optimizers as pt_opt
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.models import resnet as jx_resnet
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import softmax_task as jx_softmax
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_train import (  # noqa: F401
    SIZE,
    _f64,
    _jx_step,
    _port_step,
    few_torch_threads,  # autouse
    to_sd,
)
from tests.test_torch_port_train import rel_norm

NUM_CLASSES = 10


# -- the frozen-trunk fine-tune: one float64 momentum step --------------------


@pytest.fixture(scope="module")
def fine_tune_step():
    rng = np.random.RandomState(6)
    images = rng.uniform(-1, 1, (4, SIZE, SIZE, 3))
    labels = rng.randint(0, NUM_CLASSES, 4).astype(np.int32)
    opt = dict(name="momentum", momentum=0.9, trainable_scopes=("logits",))
    sched = dict(learning_rate=1e-3)
    with jax.enable_x64(True):
        variables = _f64(random_variables(
            jx_resnet.ResNet50V1(num_classes=NUM_CLASSES, global_pool=True),
            (1, SIZE, SIZE, 3), seed=10))
        init = to_sd(variables["params"], variables["batch_stats"])
        jmetrics, jstate = _jx_step(
            jx_resnet.ResNet50V1(num_classes=NUM_CLASSES, global_pool=True,
                                 dtype=jnp.float64, param_dtype=jnp.float64),
            jx_softmax(), jx_config.OptimizerConfig(
                **opt, schedule=jx_config.LRScheduleConfig(**sched)),
            variables, images, labels)
        jafter = to_sd(jstate.params, jstate.batch_stats)
    pgrads, pmetrics, pafter, pstate = _port_step(
        ResNet50V1(NUM_CLASSES, global_pool=True), softmax_task(),
        OptimizerConfig(**opt, schedule=LRScheduleConfig(**sched)),
        init, images, labels)
    return {"jmetrics": jmetrics, "jafter": jafter, "pmetrics": pmetrics,
            "pgrads": pgrads, "pafter": pafter, "init": init,
            "pstate": pstate}


def test_fine_tune_trains_only_the_logits(fine_tune_step):
    """Gradients and optimizer slots for ``logits`` alone; every frozen
    parameter bit-equal to its value before the step, in both packages;
    the logits moved, as JAX's did."""
    got, want, init = (fine_tune_step[k] for k in ("pafter", "jafter",
                                                   "init"))
    assert set(fine_tune_step["pgrads"]) == {"logits.weight", "logits.bias"}
    assert set(fine_tune_step["pstate"].opt_state.trace) == \
        {"logits.weight", "logits.bias"}
    params = dict(fine_tune_step["pstate"].model.named_parameters())
    frozen = [k for k in params if not k.startswith("logits.")]
    assert len(frozen) == len(params) - 2
    assert not any(params[k].requires_grad for k in frozen)
    for k in frozen:
        assert torch.equal(got[k], init[k]), k
        assert torch.equal(want[k], init[k]), k
    for k in ("logits.weight", "logits.bias"):
        assert not torch.equal(got[k], init[k])
        assert rel_norm(got[k] - init[k], want[k] - init[k]) <= 1e-6, k
        assert rel_norm(got[k], want[k]) <= 1e-9, k


def test_fine_tune_updates_the_frozen_trunks_statistics(fine_tune_step):
    """The frozen trunk's BatchNorm ran on batch statistics and moved its
    running ones, as JAX's ``mutable=["batch_stats"]`` apply does."""
    got, want, init = (fine_tune_step[k] for k in ("pafter", "jafter",
                                                   "init"))
    stats = [k for k in want if "running" in k]
    assert len(stats) == 2 * 53
    for k in stats:
        assert not torch.equal(got[k], init[k]), k
        assert rel_norm(got[k], want[k]) <= 1e-9, k
        if k.endswith("running_mean"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                       err_msg=k)


def test_fine_tune_loss_matches_jax(fine_tune_step):
    """The loss and accuracy; ``grad_norm`` is the trained gradients'
    norm in the port (JAX's counts the frozen gradients too)."""
    got, want = fine_tune_step["pmetrics"], fine_tune_step["jmetrics"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["accuracy"] == want["accuracy"]
    logits_norm = torch.linalg.vector_norm(torch.cat(
        [g.ravel() for g in fine_tune_step["pgrads"].values()])).item()
    np.testing.assert_allclose(got["grad_norm"], logits_norm, rtol=1e-12)
    assert got["grad_norm"] < want["grad_norm"]


# -- trainable_scopes in the optimizers ---------------------------------------


def test_trainable_names_match_per_component():
    names = ["backbone.conv1.weight", "backbone.conv19.weight",
             "backbone.block4_unit1.conv1.weight", "logits.weight",
             "logits.bias", "logits_aux.weight"]
    assert pt_opt.trainable_names(names, ()) == names
    assert pt_opt.trainable_names(names, ("logits",)) == ["logits.weight",
                                                          "logits.bias"]
    assert pt_opt.trainable_names(names, ("backbone/conv1",)) == \
        ["backbone.conv1.weight"]
    assert pt_opt.trainable_names(names, ("backbone.block4_unit1", "logits"
                                          )) == names[2:5]


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_trainable_scopes_match_optax(name, clip):
    """Three float64 steps with ``trainable_scopes=("head",)`` against the
    JAX package's optax chain (``multi_transform`` over
    ``trainable_mask``, the clip inside the trained branch): the trained
    tensors, the frozen ones unchanged, slots for the trained ones only.
    With the clip, every step's trained gradients are above the norm, so
    that each step clips by their norm alone."""
    rng = np.random.RandomState(4)
    shapes = {"head": {"kernel": (3, 4), "bias": (4,)},
              "trunk": {"kernel": (5, 6)}}
    params = jax.tree_util.tree_map(lambda s: rng.normal(0, 1, s), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s) * scale, shapes,
        is_leaf=lambda s: isinstance(s, tuple)) for scale in (3.0, 1.0, 2.0)]
    cfg = dict(name=name, grad_clip_norm=clip, trainable_scopes=("head",))
    sched = dict(learning_rate=0.1)
    flat = convert.flatten
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jtx = jx_opt.make_optimizer(jx_config.OptimizerConfig(
            **cfg, schedule=jx_config.LRScheduleConfig(**sched)), jp)
        jstate = jtx.init(jp)
        ptx = pt_opt.make_optimizer(OptimizerConfig(
            **cfg, schedule=LRScheduleConfig(**sched)))
        pp = {k.replace("/", "."): torch.from_numpy(v.copy())
              for k, v in flat(params).items()}
        pstate = ptx.init(pp)
        slots = pstate.mu if name == "adam" else pstate.trace
        assert set(slots) == {"head.kernel", "head.bias"}
        for g in grads:
            if clip:
                assert np.sqrt(sum((v ** 2).sum() for k, v in
                                   flat(g).items() if k.startswith("head"))
                               ) > clip
            updates, jstate = jtx.update(
                jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
            jp = optax.apply_updates(jp, updates)
            ptx.update_({k.replace("/", "."): torch.from_numpy(v)
                         for k, v in flat(g).items()
                         if k.startswith("head")}, pstate, pp)
            for k, v in flat(jax.device_get(jp)).items():
                np.testing.assert_allclose(pp[k.replace("/", ".")].numpy(),
                                           v, rtol=1e-12, atol=1e-15,
                                           err_msg=k)
        np.testing.assert_array_equal(pp["trunk.kernel"].numpy(),
                                      params["trunk"]["kernel"])


def test_trainable_scopes_that_take_nothing_raise():
    trainer = Trainer(ResNet50V1(NUM_CLASSES, global_pool=True),
                      softmax_task(), OptimizerConfig(
                          name="momentum", trainable_scopes=("logit",)),
                      device="cpu", compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="take no parameter"):
        trainer.create_state(torch.Generator().manual_seed(0))
