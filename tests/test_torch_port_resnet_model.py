"""The port's ResNet50 (``models/resnet.py``) against the JAX package on
the CPU: names, the root SAME pool, the trunk, the detector and the
classifier forwards, the flatten order, the bf16 forward, the dropout
rule and the trainer's dropout generator, flax's initializers, and the
``.npz`` carrier.

Full width, 64² input (a 2×2 block4 map, so the flatten order shows; the
root pool's 32×32 map is even, so its SAME padding shows), seeded weights
converted from the JAX package's trees by ``convert``. Tolerances:

- float32 forwards in eval mode: 1e-5 relative norm (53 float32 convs
  summed in other orders; measured 1.6e-6 for the detector);
- the bf16 port grid against the float32 JAX grid: 5e-2 relative norm
  (``chip_smoke.py``'s bound for a bf16 card grid);
- the root pool and the dropout rule: bit for bit (a max; one float32
  division).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as jnn

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import (
    LRScheduleConfig,
    OptimizerConfig,
    Paths,
    YoloConfig,
)
from tensorflow_yolo2_torch.entries.pascal_detect_resnet import (
    build_resnet_detector,
)
from tensorflow_yolo2_torch.models.darknet import (
    Darknet19Classifier,
    init_params_,
)
from tensorflow_yolo2_torch.models.layers import dropout, max_pool_same
from tensorflow_yolo2_torch.models.resnet import ResNet50Detector, ResNet50V1
from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
from tensorflow_yolo2_torch.train.trainer import (
    Trainer,
    softmax_task,
    yolo_task,
)
from tensorflow_yolo2_tpu.models import resnet as jx_resnet
from tests.test_torch_port_models import random_variables, rel_err
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

SIZE = 64
NUM_CLASSES = 10
YOLO = YoloConfig(image_size=SIZE)


def _apply(module, variables, x):
    return np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        variables, x))


def _load(model, variables):
    model.load_state_dict(convert.state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    return model.eval()


@pytest.fixture(scope="module")
def jx_trees():
    """The JAX detector's and classifier's variables at 64²: flax's init
    tree and seeded random weights (BN away from the identity)."""
    shape = (1, SIZE, SIZE, 3)
    det = jx_resnet.ResNet50Detector()
    cls = jx_resnet.ResNet50V1(num_classes=NUM_CLASSES, global_pool=True)
    return {
        "detector": {
            "init": jax.device_get(jax.jit(lambda r, x: det.init(
                r, x, train=False))(jax.random.PRNGKey(0),
                                    jnp.zeros(shape))),
            "random": random_variables(det, shape, seed=3)},
        "classifier": random_variables(cls, shape, seed=4)}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).uniform(
        -1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jx_grids(jx_trees, images):
    """The JAX detector's float32 grids of ``images`` for each tree."""
    return {kind: _apply(jx_resnet.ResNet50Detector(), variables, images)
            for kind, variables in jx_trees["detector"].items()}


def test_names_and_shapes_match_flax(jx_trees):
    """The JAX trees map onto the port's state dicts unchanged, keys and
    shapes: bare convs (``conv1``, ``shortcut_conv``, ``logits`` with its
    bias), nested BatchNorms (``bn1.bn``), dense layers (``yolo_fc1``)."""
    for tree, model in ((jx_trees["detector"]["init"],
                         ResNet50Detector(image_size=SIZE)),
                        (jx_trees["classifier"],
                         ResNet50V1(NUM_CLASSES, global_pool=True))):
        sd = convert.state_dict_from_flax(tree["params"],
                                          tree["batch_stats"])
        own = model.state_dict()
        assert own.keys() == sd.keys()
        assert all(own[k].shape == sd[k].shape for k in sd)
    assert sd["logits.bias"].shape == (NUM_CLASSES,)
    det = convert.state_dict_from_flax(jx_trees["detector"]["init"]["params"])
    assert det["yolo_fc1.weight"].shape == (4096, 2048 * 2 * 2)
    np.testing.assert_array_equal(
        det["yolo_fc1.weight"].numpy(),
        jx_trees["detector"]["init"]["params"]["yolo_fc1"]["kernel"].T)
    assert "backbone.block1_unit1.bn1.bn.weight" in det
    assert "backbone.block1_unit1.shortcut_conv.weight" in det
    assert "backbone.block1_unit2.shortcut_conv.weight" not in det


@pytest.mark.parametrize("hw", [(32, 32), (16, 10), (15, 15), (7, 8)])
def test_root_pool_is_flax_same_pool(hw):
    """3×3/2 SAME: equal to flax's pool, bit for bit; on an even map
    ``nn.MaxPool2d(3, 2, 1)`` gives the same shape and other values."""
    x = np.random.RandomState(2).normal(size=(2, *hw, 5)).astype(np.float32)
    want = np.asarray(jnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = max_pool_same(t, 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    symmetric = torch.nn.MaxPool2d(3, 2, 1)(t).permute(0, 2, 3, 1).numpy()
    if hw[0] % 2 == 0 and hw[1] % 2 == 0:
        assert symmetric.shape == want.shape
        assert not np.array_equal(symmetric, want)


@pytest.mark.parametrize("kind", ["init", "random"])
def test_detector_matches_jax(jx_trees, jx_grids, images, kind):
    variables, want = jx_trees["detector"][kind], jx_grids[kind]
    with torch.no_grad():
        got = _load(ResNet50Detector(image_size=SIZE), variables)(
            torch.from_numpy(images))
    assert got.shape == (2, 7, 7, 30) and got.dtype == torch.float32
    assert (want > 0).mean() > 0.2  # the output ReLU leaves a grid
    assert rel_err(got.numpy(), want) <= 1e-5


def test_trunk_matches_jax(jx_trees, images):
    """``ResNet50V1()`` returns the float32 NHWC block4 map."""
    variables = {k: v["backbone"] for k, v in
                 jx_trees["detector"]["random"].items()}
    want = _apply(jx_resnet.ResNet50V1(), variables, images)
    with torch.no_grad():
        got = _load(ResNet50V1(), variables)(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 2, 2, 2048)
    assert rel_err(got.numpy(), want) <= 1e-5


def test_classifier_matches_jax(jx_trees, images):
    variables = jx_trees["classifier"]
    want = _apply(jx_resnet.ResNet50V1(num_classes=NUM_CLASSES,
                                       global_pool=True), variables, images)
    with torch.no_grad():
        got = _load(ResNet50V1(NUM_CLASSES, global_pool=True), variables)(
            torch.from_numpy(images))
    assert got.shape == (2, NUM_CLASSES) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 1e-5


def test_flatten_order_is_nhwc(jx_trees, jx_grids, images):
    """The detector flattens its 2×2×2048 map as JAX's NHWC reshape does
    (``test_detector_matches_jax``); the NCHW order of the same map with
    the same weights gives another grid."""
    variables, want = jx_trees["detector"]["random"], jx_grids["random"]
    model = _load(ResNet50Detector(image_size=SIZE), variables)
    with torch.no_grad():
        m = model.backbone.trunk(torch.from_numpy(images).permute(0, 3, 1, 2))
        nchw = F.relu(model.yolo_fc2(F.relu(model.yolo_fc1(
            m.reshape(2, -1)))))
    assert rel_err(nchw.reshape(want.shape).numpy(), want) > 0.1


def test_bf16_forward(jx_trees, jx_grids, images):
    """The serving build (``build_resnet_detector``: bf16, BN unfolded)
    against the float32 JAX grid."""
    variables, want = jx_trees["detector"]["random"], jx_grids["random"]
    model = build_resnet_detector(
        YOLO, convert.state_dict_from_flax(variables["params"],
                                           variables["batch_stats"]),
        dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(images).to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 5e-2


def test_npz_carrier_round_trip(jx_trees, tmp_path):
    """A JAX tree written by ``save_npz`` and read by ``load_npz`` gives
    the same state dict, which the detector loads."""
    variables = jx_trees["detector"]["random"]
    path = str(tmp_path / "resnet.npz")
    convert.save_npz(path, variables["params"], variables["batch_stats"])
    got = convert.state_dict_from_flax(*convert.load_npz(path))
    want = convert.state_dict_from_flax(variables["params"],
                                        variables["batch_stats"])
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    ResNet50Detector(image_size=SIZE).load_state_dict(got)


def test_init_params_gives_flax_defaults():
    """lecun-normal kernels of convs and dense layers (variance 1/fan_in,
    truncated at 2σ), zero biases, BatchNorm scale 1, bias 0, statistics
    0 and 1."""
    model = init_params_(ResNet50Detector(image_size=32),
                         torch.Generator().manual_seed(0))
    for name, w in (("yolo_fc2", model.yolo_fc2.weight.detach()),
                    ("yolo_fc1", model.yolo_fc1.weight.detach()),
                    ("block4_unit1.conv2",
                     model.backbone.block4_unit1.conv2.weight.detach())):
        fan_in = w[0].numel()
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.02, name
        assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / \
            fan_in ** 0.5 * (1 + 1e-6), name
    assert not model.yolo_fc1.bias.any() and not model.yolo_fc2.bias.any()
    assert model.backbone.conv1.bias is None
    bn = model.backbone.block2_unit1.bn3.bn
    assert bn.weight.eq(1).all() and not bn.bias.any()
    assert not bn.running_mean.any() and bn.running_var.eq(1).all()
    assert (bn.eps, bn.flax_momentum) == (1e-5, 0.997)


# -- dropout ------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_dropout_rule_is_flax_s(rate):
    """``where(keep, x / keep_prob, 0)``: each output is 0 or flax's
    quotient, bit for bit; the mask comes from the generator given (the
    same seed, the same mask) and keeps about keep_prob of the values."""
    x = torch.from_numpy(np.random.RandomState(3).normal(
        size=(64, 4096)).astype(np.float32))
    got = dropout(x, rate, torch.Generator().manual_seed(5))
    again = dropout(x, rate, torch.Generator().manual_seed(5))
    other = dropout(x, rate, torch.Generator().manual_seed(6))
    keep = got != 0
    want = np.asarray(jnp.where(jnp.asarray(keep.numpy()),
                                jnp.asarray(x.numpy()) / (1.0 - rate), 0.0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, again) and not torch.equal(got, other)
    assert abs(float(keep.float().mean()) - (1.0 - rate)) < 0.01


def test_dropout_runs_only_in_training(jx_trees, images):
    """Eval mode ignores the generator; training draws a mask from it and
    refuses to run without one, as a flax apply without a dropout rng."""
    model = _load(ResNet50Detector(image_size=SIZE),
                  jx_trees["detector"]["random"])
    x = torch.from_numpy(images)
    with torch.no_grad():
        plain = model(x)
        assert torch.equal(model(x, torch.Generator().manual_seed(0)), plain)
        model.train()
        with pytest.raises(ValueError, match="dropout generator"):
            model(x)
        a = model(x, torch.Generator().manual_seed(0))
        b = model(x, torch.Generator().manual_seed(0))
        assert torch.equal(a, b)
        model.dropout_rate = 0.0
        assert not torch.equal(model(x), a)


def _dropout_trainer(state_dict, seed=3):
    yolo = YoloConfig()
    trainer = Trainer(ResNet50Detector(yolo.cell_channels, image_size=32),
                      yolo_task(yolo), OptimizerConfig(
                          schedule=LRScheduleConfig(learning_rate=5e-4)),
                      device="cpu", compute_dtype=torch.float32)
    return trainer, trainer.create_state(torch.Generator().manual_seed(seed),
                                         state_dict)


def test_dropout_generator_is_seeded_advanced_and_resumed(tmp_path):
    """``TrainState.rng`` comes from the caller's seed: two runs from seed
    3 take the same steps, the same weights with seed 4's generator other
    masks. It advances once a step (the second step's mask is not the
    first's), an eval step draws nothing from it, and a snapshot restores
    it."""
    rng = np.random.RandomState(7)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    labels = np.zeros((2, 7, 7, 25), np.float32)
    labels[:, 2, 3, :5] = (1, 100, 90, 60, 40)
    labels[:, 2, 3, 9] = 1
    # weights of any kind: torch's default draw, not flax's slower one
    fresh = ResNet50Detector(YoloConfig().cell_channels,
                             image_size=32).state_dict()
    trainer, state = _dropout_trainer(fresh)
    assert state.rng.device.type == "cpu"

    def steps(trainer, state, n=2):
        losses = []
        for _ in range(n):
            before = state.rng.get_state()
            trainer.eval_step(state, images, labels)
            assert torch.equal(state.rng.get_state(), before)
            state, metrics = trainer.train_step(state, images, labels)
            assert not torch.equal(state.rng.get_state(), before)
            losses.append(metrics["loss"].item())
        return losses

    losses = steps(trainer, state)
    assert len(set(losses)) == 2
    assert steps(*_dropout_trainer(fresh)) == losses
    assert steps(*_dropout_trainer(fresh, seed=4), n=1) != losses[:1]

    mgr = CheckpointManager("resnet50", "voc_2007",
                            paths=Paths(str(tmp_path)))
    mgr.save(state.step, state)
    want = trainer.train_step(state, images, labels)[1]["loss"].item()
    other, target = _dropout_trainer(fresh, seed=99)
    restored, _ = mgr.restore(target)
    assert other.train_step(restored, images, labels)[1]["loss"].item() \
        == want


def test_a_model_without_dropout_leaves_the_generator_alone():
    """Every train state holds a generator on the trainer's device, and a
    train step passes it to every model: the Darknet classifier takes it
    and draws nothing from it."""
    trainer = Trainer(Darknet19Classifier(NUM_CLASSES), softmax_task(),
                      OptimizerConfig(name="momentum"), device="cpu",
                      compute_dtype=torch.float32)
    state = trainer.create_state(torch.Generator().manual_seed(0))
    assert state.rng.device.type == "cpu"
    before = state.rng.get_state()
    images = np.random.RandomState(0).uniform(-1, 1, (2, 32, 32, 3))
    trainer.train_step(state, images.astype(np.float32), np.array([1, 2]))
    assert state.step == 1 and torch.equal(state.rng.get_state(), before)
