"""The plain YOLOv2 anchor head (``pascal_train_darknet --v2``:
``Darknet19Detector(125, bn_on_output=False)``) at full width against the
JAX package on the CPU: its warm start from a classifier snapshot and
the weights that the warm start leaves fresh.

Tolerances: the set of tensors taken from the classifier, their count
and values, exact; the fresh head's kernels against lecun-normal's mean,
standard deviation and truncation bound (flax's initializer, which both
packages draw from: the port's ``init_params_``, JAX's ``model.init``),
within a few standard errors of each statistic (``STD_TOL``,
``MEAN_TOL``, ``EDGE_TOL``); biases, BatchNorm terms and statistics
exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Detector,
    init_params_,
)
from tensorflow_yolo2_torch.train.checkpoint import (
    SNAPSHOT_FILE,
    warm_start_params,
)
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.models import darknet as jx_darknet
from tensorflow_yolo2_tpu.train.checkpoint import (
    CheckpointManager as JxCheckpointManager,
)
from tensorflow_yolo2_tpu.train.checkpoint import (
    warm_start_params as jx_warm_start_params,
)
from tests.test_torch_port_models import random_variables
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)


def _flax_keys(params) -> dict[str, str]:
    """Flax path (``/``-joined) → the port's state-dict key."""
    ones = jax.tree_util.tree_map(
        lambda a: np.zeros((1,) * np.ndim(a), np.float32), params)
    keys = [k for k in convert.state_dict_from_flax(ones)
            if not k.endswith("num_batches_tracked")]
    return dict(zip(convert.flatten(params), keys, strict=True))


@pytest.fixture(scope="module")
def v2_warm_start(tmp_path_factory):
    """A seeded full-width classifier state, saved as each package's
    classifier snapshot; the plain v2 detector (``--v2``: B=5, C=20,
    linear output) initialised by flax and by ``init_params_``, then
    warm-started from its package's snapshot by its package's
    ``warm_start_params``."""
    root = tmp_path_factory.mktemp("v2_warm")
    cls = random_variables(jx_darknet.Darknet19Classifier(num_classes=1000),
                           (1, 224, 224, 3), seed=11)
    cls_params, cls_stats = cls["params"], cls["batch_stats"]
    jx_snap = JxCheckpointManager(
        "darknet19", "ilsvrc_2017_cls", save_by_epoch=True,
        paths=jx_config.Paths(root=str(root / "jax"))).save(
            1, {"params": cls_params, "batch_stats": cls_stats})
    pt_snap = root / "port" / "train_epoch_1"
    pt_snap.mkdir(parents=True)
    torch.save({"model": convert.state_dict_from_flax(cls_params, cls_stats)},
               pt_snap / SNAPSHOT_FILE)

    model = jx_darknet.Darknet19Detector(output_channels=125,
                                         bn_on_output=False)
    fresh = jax.device_get(jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    jx_params, jx_n = jx_warm_start_params(fresh["params"], jx_snap)
    net = init_params_(Darknet19Detector(125, bn_on_output=False),
                       torch.Generator().manual_seed(0))
    pt_fresh = {k: p.detach().clone() for k, p in net.named_parameters()}
    pt_params, pt_n = warm_start_params(pt_fresh, str(pt_snap))
    return {"cls": convert.flatten(cls_params),
            "jx_fresh": convert.flatten(fresh["params"]),
            "jx_stats": convert.flatten(fresh["batch_stats"]),
            "jx": convert.flatten(jx_params), "jx_n": jx_n,
            "keys": _flax_keys(fresh["params"]),
            "pt_fresh": pt_fresh, "pt": pt_params, "pt_n": pt_n,
            "pt_stats": {k: v for k, v in net.state_dict().items()
                         if "running" in k}}


def test_v2_warm_start_takes_jax_tensor_set(v2_warm_start):
    """Both packages take the same 72 tensors (the 18 trunk convs' kernel,
    bias, BN scale and bias) from the classifier, with the classifier's
    values, and leave the rest as initialised."""
    w = v2_warm_start
    jx_taken = {p for p, v in w["jx"].items()
                if p in w["cls"] and np.array_equal(v, w["cls"][p])}
    pt_taken = {k for k, v in w["pt"].items()
                if not torch.equal(v, w["pt_fresh"][k])}
    assert w["jx_n"] == w["pt_n"] == len(jx_taken) == 72
    assert pt_taken == {w["keys"][p] for p in jx_taken}
    assert {k.split(".")[1] for k in pt_taken} == \
        {f"conv{i}" for i in range(1, 19)}
    by_key = {w["keys"][p]: p for p in w["cls"] if p in w["keys"]}
    for k in pt_taken:
        want = w["cls"][by_key[k]]
        want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want
        np.testing.assert_array_equal(w["pt"][k].numpy(), want, err_msg=k)
    for p in set(w["jx"]) - jx_taken:
        np.testing.assert_array_equal(w["jx"][p], w["jx_fresh"][p])


# flax's lecun_normal draws N(0, σ'²) truncated at ±2σ', σ' = σ / 0.8796, so
# that the draws' standard deviation is σ = 1/√fan_in. The sample standard
# deviation of n such draws has a standard error of ~0.58·σ/√n (the
# truncated normal's kurtosis is 2.36); its mean's is σ/√n.
STD_TOL = 4.0   # / √n, relative to σ: ≥ 6.9 standard errors
MEAN_TOL = 6.0  # σ / √n
EDGE_TOL = 100.0  # / n: the largest |w| within that of the bound; the
# chance that none of n draws comes so close is below 1e-9


def test_v2_fresh_head_has_flax_init_distribution(v2_warm_start):
    """Every tensor the warm start leaves fresh, in both packages: each
    conv kernel's mean, standard deviation and largest magnitude against
    lecun-normal's (and the port's against flax's draw), its bias 0, the
    BN scale 1 and bias 0, the running mean 0 and variance 1. Measured:
    the 9.4M-element 3×3×1024 kernels' standard deviations within 4.9e-4
    of σ (bound 1.3e-3), the 128000-element output kernel's within 2.0e-3
    (bound 1.1e-2); the means within 2.9 standard errors (bound 6); the
    largest magnitudes within 5.3e-6 of the truncation bound (bound
    100/n: 1.1e-5 and 7.8e-4)."""
    w = v2_warm_start
    fresh = [p for p in w["jx"] if p not in w["cls"]]
    assert sorted({p.split("/")[1] for p in fresh}) == \
        ["conv1", "conv2", "conv3", "output"]
    assert len(fresh) == 3 * 4 + 2
    for p in fresh:
        k = w["keys"][p]
        jx = np.asarray(w["jx"][p], np.float64)
        pt = w["pt"][k].double().numpy()
        if not p.endswith("kernel"):
            want = 1.0 if p.endswith("bn/scale") else 0.0
            assert np.all(jx == want) and np.all(pt == want), p
            continue
        n = jx.size
        sigma = 1.0 / np.sqrt(np.prod(jx.shape[:-1]))
        bound = 2.0 * sigma / 0.87962566103423978
        for name, x in (("jax", jx), ("port", pt)):
            assert abs(x.mean()) <= MEAN_TOL * sigma / np.sqrt(n), (p, name)
            assert abs(x.std() / sigma - 1) <= STD_TOL / np.sqrt(n), \
                (p, name, x.std() / sigma)
            top = np.abs(x).max()
            assert bound * (1 - EDGE_TOL / n) <= top <= bound * (1 + 1e-6), \
                (p, name, top / bound)
        assert abs(pt.std() - jx.std()) / sigma <= 2 * STD_TOL / np.sqrt(n)
    assert len(w["pt_stats"]) == len(w["jx_stats"]) == 2 * 21
    for name, table in (("jax", w["jx_stats"]), ("port", w["pt_stats"])):
        for k, v in table.items():
            want = 0.0 if k.endswith(("mean", "running_mean")) else 1.0
            assert np.all(np.asarray(v) == want), (name, k)
