"""``models.fold.fold_params_identity`` against the JAX package's
``fold_params_identity`` on the CPU (see
``tests/test_torch_port_inception_train.py`` for the cases and bounds):
at 112², 10 classes, seeded random weights with the statistics off the
identity.
"""

import jax
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.models import registry
from tensorflow_yolo2_torch.models.fold import fold_params_identity
from tensorflow_yolo2_tpu.models import registry as jx_registry
from tensorflow_yolo2_tpu.models.fold import (
    fold_params_identity as jx_fold_identity,
)
from tests.test_torch_port_models import random_variables, rel_err
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

NUM_CLASSES = 10
SIZE = 112


@pytest.fixture(scope="module")
def v2_variables():
    model = jx_registry.get_network("inception_v2", num_classes=NUM_CLASSES)
    return random_variables(model, (1, SIZE, SIZE, 3), seed=6)


def _jx_fold_as_sd(variables):
    """JAX's fold, converted."""
    params, stats = jx_fold_identity(variables["params"],
                                     variables["batch_stats"])
    return convert.state_dict_from_flax(jax.device_get(params),
                                        jax.device_get(stats))


@pytest.mark.parametrize("net", ["inception_v2", "darknet19",
                                 "resnet_v1_50"])
def test_fold_identity_matches_jax(net, v2_variables):
    """The port's fold of the converted state dict against JAX's fold
    converted: the same keys, each tensor within 1e-6 (the identity
    statistics, unit scales and zeroed conv biases exactly)."""
    if net == "inception_v2":
        variables = v2_variables
    else:
        kw = {"num_classes": NUM_CLASSES}
        variables = random_variables(jx_registry.get_network(net, **kw),
                                     (1, 64, 64, 3), seed=7)
    sd = convert.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    got, want = fold_params_identity(sd), _jx_fold_as_sd(variables)
    assert got.keys() == want.keys()
    changed = 0
    for k in want:
        if k.endswith(("running_mean", "running_var", "bn.weight")) or \
                not want[k].is_floating_point() or not want[k].any():
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        else:
            assert rel_err(got[k].numpy(), want[k].numpy()) <= 1e-6, k
        changed += not torch.equal(got[k], sd[k])
    if net == "resnet_v1_50":  # siblings, not conv→BN children: unchanged
        assert changed == 0 and "conv1_bn.bn.running_var" in sd
    else:
        assert changed > 0
    if net == "inception_v2":  # the separable stem passes through
        for k in ("conv1.depthwise.weight", "conv1.bn.running_var"):
            assert torch.equal(got[k], sd[k]), k


@pytest.mark.parametrize("name", ["inception_v1", "inception_v2"])
def test_folded_inception_logits_equal_the_unfolded(name):
    """Eval logits (and v1's auxiliary ones) of the folded state dict
    within 1e-5 of the unfolded ones, and of JAX's folded tree's."""
    kw = {"num_classes": NUM_CLASSES,
          **({"aux_logits": True} if name == "inception_v1" else {})}
    jx_model = jx_registry.get_network(name, **kw)
    variables = random_variables(jx_model, (1, SIZE, SIZE, 3), seed=8)
    sd = convert.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    x = np.random.RandomState(1).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    outs = []
    for weights in (sd, fold_params_identity(sd)):
        model = registry.get_network(name, image_size=SIZE, **kw)
        model.load_state_dict(weights)
        with torch.no_grad():
            y = model.eval()(torch.from_numpy(x))
        outs.append([t.numpy() for t in (y if isinstance(y, tuple) else
                                         (y,))])
    params, stats = jx_fold_identity(variables["params"],
                                     variables["batch_stats"])
    y = jax.jit(lambda v, x: jx_model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x)
    jx_folded = [np.asarray(t) for t in (y if isinstance(y, tuple) else
                                         (y,))]
    for a, b, c in zip(*outs, jx_folded):
        assert rel_err(b, a) <= 1e-5
        assert rel_err(b, c) <= 1e-5


def test_fold_identity_refuses_a_pair_without_a_bias_slot():
    """conv without a bias beside a BatchNorm with a scale and no center:
    nowhere to carry the offset, in both packages."""
    params = {"blk": {"conv": {"kernel": np.ones((1, 1, 2, 3), np.float32)},
                      "bn": {"scale": np.ones(3, np.float32)}}}
    stats = {"blk": {"bn": {"mean": np.zeros(3, np.float32),
                            "var": np.ones(3, np.float32)}}}
    with pytest.raises(ValueError, match="cannot fold 'blk'"):
        jx_fold_identity(params, stats)
    with pytest.raises(ValueError, match="cannot fold 'blk'"):
        fold_params_identity(convert.state_dict_from_flax(params, stats))


def test_npz_carrier_round_trip(v2_variables, tmp_path):
    """An inception tree (``bn`` children with a bias alone, the separable
    stem's ``depthwise`` / ``pointwise``) through ``save_npz`` /
    ``load_npz`` loads strictly into the port's net, tensor for tensor."""
    path = str(tmp_path / "inception_v2.npz")
    convert.save_npz(path, v2_variables["params"], v2_variables["batch_stats"])
    params, stats = convert.load_npz(path)
    sd = convert.state_dict_from_flax(params, stats)
    model = registry.get_network("inception_v2", num_classes=NUM_CLASSES,
                                 image_size=SIZE)
    model.load_state_dict(sd)
    want = convert.state_dict_from_flax(v2_variables["params"],
                                        v2_variables["batch_stats"])
    assert sd.keys() == want.keys()
    assert "conv1.pointwise.weight" in sd and "conv1.bn.weight" not in sd
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
