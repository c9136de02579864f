"""Training the port's inception nets against the JAX package's on the
CPU: one float64 train step of ``inception_v3`` with its auxiliary head
(``--aux-loss``: the softmax loss plus 0.4 of the auxiliary head's) from
the same weights.

The step: full width, 112² (the least size whose last 17×17-grid map,
5×5 here, holds the auxiliary tower's 5×5/3 pool), batch 4, 10 classes,
momentum 0.9 at 1e-3, dropout replaced by the identity in both packages
(their generators differ). Bounds, each with its reason:

- the loss, ``aux_loss`` and ``grad_norm``: 1e-6 relative (both packages
  cast the float64 logits to float32 and take a float32 loss);
- each gradient tensor: 1e-6 relative norm (that float32 loss's rounding
  reaches the gradients; the momentum's first trace is the gradient);
- each parameter after the step 1e-6 relative norm, each running
  statistic 1e-9 (float64 batch statistics of the same float64 maps).

The fold (``tests/test_torch_port_inception_fold.py``): on
``inception_v2`` (no conv bias, no BN scale: the offset goes into the BN
bias; its separable stem, ``depthwise`` / ``pointwise`` / ``bn``, is no
conv→BN pair and passes through), on the Darknet19 classifier (conv bias
and BN scale) and on ResNet-50 (``conv1`` / ``conv1_bn`` siblings, which
pass through), each tensor of the port's fold within 1e-6 relative norm
of JAX's fold converted (float32 arithmetic in another order; the
identity statistics, unit scales and zeroed conv biases exactly); the
folded port model's eval logits within 1e-5 relative norm of the
unfolded ones (float32 convs of rescaled kernels); the refusal where
neither slot can carry the offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
from tensorflow_yolo2_torch.models import inception as pt_inception
from tensorflow_yolo2_torch.models import registry
from tensorflow_yolo2_torch.train.checkpoint import load_into
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
from tests.test_torch_port_train import _scalars, rel_norm

NUM_CLASSES = 10
SIZE = 112
LR = 1e-3


@pytest.fixture(scope="module")
def aux_step():
    rng = np.random.RandomState(5)
    images = rng.uniform(-1, 1, (4, SIZE, SIZE, 3))
    labels = rng.randint(0, NUM_CLASSES, 4).astype(np.int32)
    opt = dict(name="momentum", momentum=0.9)
    kw = dict(num_classes=NUM_CLASSES, aux_logits=True)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        import flax.linen as fnn

        mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda y: y))
        mp.setattr(pt_inception, "dropout", lambda x, rate, gen: x)
        variables = _f64(random_variables(
            jx_registry.get_network("inception_v3", **kw),
            (1, SIZE, SIZE, 3), seed=3))
        trainer = JxTrainer(
            jx_registry.get_network("inception_v3", dtype=jnp.float64, **kw),
            jx_softmax(), jx_config.OptimizerConfig(
                **opt, schedule=jx_config.LRScheduleConfig(learning_rate=LR)),
            mesh=make_mesh(MeshConfig(data=1, model=1)))
        trainer.tx = jx_opt.make_optimizer(trainer.opt_cfg)
        state = trainer.shard_state(JxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=trainer.tx.init(variables["params"]),
            rng=jax.random.PRNGKey(1)))
        init = to_sd(state.params, state.batch_stats)
        state, metrics = trainer.train_step(state, images, labels)
        want = (_scalars(metrics), to_sd(state.params, state.batch_stats))
        jgrads = to_sd(state.opt_state[0].trace)

        port = Trainer(registry.get_network("inception_v3", image_size=SIZE,
                                            **kw).double(),
                       softmax_task(), OptimizerConfig(
                           **opt, schedule=LRScheduleConfig(
                               learning_rate=LR)),
                       device="cpu", compute_dtype=torch.float32)
        pstate = port.create_state(torch.Generator().manual_seed(0), init)
        _, pgrads = port.loss_and_grads(pstate, images, labels)
        load_into(pstate.model, init)  # the statistics before that forward
        pstate, pmetrics = port.train_step(pstate, images, labels)
    return {"jgrads": jgrads, "want": want, "init": init,
            "pgrads": {k: v.detach() for k, v in pgrads.items()},
            "got": (_scalars(pmetrics), pstate.model.state_dict())}


def test_aux_step_loss_and_metrics_match_jax(aux_step):
    (got, _), (want, _) = aux_step["got"], aux_step["want"]
    assert set(got) == set(want) == {"loss", "aux_loss", "accuracy",
                                     "grad_norm"}
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["accuracy"] == want["accuracy"]
    assert got["loss"] > got["aux_loss"] * 0.4  # the main head's share


def test_aux_step_gradients_match_jax(aux_step):
    """Each gradient tensor on its own: the auxiliary tower's (whose only
    gradient is the 0.4-weighted aux loss's) and the trunk's below it,
    which both heads reach."""
    got, want = aux_step["pgrads"], aux_step["jgrads"]
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    assert {"aux_logits.weight", "aux_conv.bn.bias", "logits.weight",
            "conv1a.conv.weight"} <= got.keys()
    assert not any(k.endswith("bn.weight") for k in got)
    for k in want:
        assert float(want[k].abs().max()) > 0, k
        assert rel_norm(got[k], want[k]) <= 1e-6, k


def test_aux_step_params_and_stats_match_jax(aux_step):
    (_, got), (_, want) = aux_step["got"], aux_step["want"]
    init = aux_step["init"]
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            assert rel_norm(got[k], want[k]) <= 1e-9, k
        else:
            assert rel_norm(got[k], want[k]) <= 1e-6, k
        assert not torch.equal(got[k], init[k]), k
