"""Adversarial training in the port (``models/contrast.py``,
``train/adversarial.py``, ``train/optimizers.make_grouped_optimizer``,
``Trainer(tx_factory=...)``) against the JAX package on the CPU.

The net is the contrast wrapper around ``lenet`` at 32², 10 classes,
batch 4, seeded weights converted from the JAX package's tree; dropout
is the identity in both packages (their generators differ; the port's
rule is held in ``tests/test_torch_port_resnet_model.py``). Bounds, each
with its reason:

- the float32 eval forward: 1e-5 relative norm (float32 convs summed in
  other orders);
- the grouped optimizers against optax's ``multi_transform``, 3 steps in
  float64: 1e-12 relative norm a tensor (the same float64 arithmetic);
- FGSM and the clean + adversarial pair in float64. The port's nets give
  float32 logits (``lenet``'s ``.float()``), so its loss and the
  gradients from it carry float32 rounding (relative ~1e-7): the losses
  agree to 1e-6 relative, the input gradients to 1e-5 relative norm, and
  the signs of FGSM are compared where |g| > 1e-5·max|g| (SIGN_THRESH),
  where float32 rounding cannot flip them; there the adversarial images
  are equal bit for bit. The parameters after the pair: 1e-6 relative
  norm a tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
from tensorflow_yolo2_torch.models import zoo as pt_zoo
from tensorflow_yolo2_torch.models.contrast import ContrastInputModel
from tensorflow_yolo2_torch.train import adversarial as pt_adv
from tensorflow_yolo2_torch.train import optimizers as pt_opt
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
from tensorflow_yolo2_tpu.config import LRScheduleConfig as JxSchedule
from tensorflow_yolo2_tpu.config import OptimizerConfig as JxOptimizerConfig
from tensorflow_yolo2_tpu.models.contrast import (
    ContrastInputModel as JxContrastInputModel,
)
from tensorflow_yolo2_tpu.models.zoo import LeNet as JxLeNet
from tensorflow_yolo2_tpu.parallel import MeshConfig, make_mesh
from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
from tensorflow_yolo2_tpu.train import adversarial as jx_adv
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import TrainState as JxTrainState
from tensorflow_yolo2_tpu.train.trainer import softmax_task as jx_softmax_task
from tests.test_torch_port_models import random_variables, rel_err
from tests.test_torch_port_resnet_train import (  # noqa: F401
    _f64,
    few_torch_threads,  # autouse
    to_sd,
)

SIZE, CLASSES, BATCH = 32, 10, 4
EPS = 8 / 255 * 2
SIGN_THRESH = 1e-5  # of max|g|: float32 rounding flips no sign above it
LR = 0.05


def close(got, want, tol: float) -> bool:
    """Within ``tol`` relative norm (equal where ``want`` is all 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
                or np.array_equal(got, want))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(21)
    images = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3))
    labels = rng.randint(0, CLASSES, BATCH)
    variables = random_variables(
        JxContrastInputModel(backbone=JxLeNet(num_classes=CLASSES)),
        (1, SIZE, SIZE, 3), seed=8)
    return images, labels, variables


def port_model(variables, double=False):
    model = ContrastInputModel(pt_zoo.LeNet(CLASSES, image_size=SIZE))
    if double:
        model.double().load_state_dict(to_sd(_f64(variables["params"])))
    else:
        model.load_state_dict(to_sd(variables["params"]))
        model.float()
    return model


def jx_model64():
    return JxContrastInputModel(
        backbone=JxLeNet(num_classes=CLASSES, dtype=jnp.float64),
        dtype=jnp.float64)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout",
                        lambda rate, deterministic: (lambda y: y))
    monkeypatch.setattr(pt_zoo, "_drop", lambda x, training, gen: x)


def test_contrast_model_matches_jax(data):
    images, _, variables = data
    x = images.astype(np.float32)
    want = np.asarray(JxContrastInputModel(
        backbone=JxLeNet(num_classes=CLASSES)).apply(variables, x,
                                                     train=False))
    model = port_model(variables).eval()
    assert [n for n, _ in model.named_children()] == ["input_transform",
                                                      "backbone"]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, CLASSES)
    assert rel_err(got, want) <= 1e-5


# -- the grouped optimizers ---------------------------------------------------

SHAPES = {"backbone.conv1a.weight": (4, 3), "backbone.conv1a.bias": (4,),
          "backbone.conv2a.weight": (3, 5), "backbone.conv2b.weight": (6,),
          "input_transform.weight": (2, 3, 3), "logits.weight": (5, 2)}


def _groups(jax_side: bool, clip: float | None):
    cfg = JxOptimizerConfig if jax_side else OptimizerConfig
    sched = JxSchedule if jax_side else LRScheduleConfig
    stem = cfg(name="adam", grad_clip_norm=clip,
               schedule=sched(learning_rate=1e-2))
    trf = cfg(name="adam", weight_decay=1e-3,
              schedule=sched(learning_rate=3e-2))
    rest = cfg(name="momentum", momentum=0.9,
               schedule=sched(learning_rate=0.1))
    # backbone/conv1a also lies in the third group's scope: first match
    return [(("backbone/conv1a", "backbone/conv2a"), stem),
            (("input_transform",), trf), (("backbone",), rest)]


def _jx_tree(flat):
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("default", [False, True])
def test_grouped_optimizer_matches_optax(default):
    rng = np.random.RandomState(4)
    params = {k: rng.normal(0, 1, s) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1, s) for k, s in SHAPES.items()}
             for _ in range(3)]
    with jax.enable_x64(True):
        jx_params = _jx_tree(params)
        tx = jx_opt.make_grouped_optimizer(
            _groups(True, 0.5), jx_params,
            default=JxOptimizerConfig(name="sgd") if default else None)
        opt_state = tx.init(jx_params)
        for g in grads:
            updates, opt_state = tx.update(_jx_tree(g), opt_state, jx_params)
            jx_params = optax.apply_updates(jx_params, updates)
    pt_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = pt_opt.make_grouped_optimizer(
        _groups(False, 0.5), pt_params,
        default=OptimizerConfig(name="sgd") if default else None)
    state = opt.init(pt_params)
    assert ("logits.weight" in state.names) == default
    for g in grads:
        opt.update_({k: torch.from_numpy(v) for k, v in g.items()}, state,
                    pt_params)
    assert state.count == 3
    for k, v in pt_params.items():
        *path, leaf = k.split(".")
        want = jx_params
        for p in path + [leaf]:
            want = want[p]
        assert close(v.numpy(), want, 1e-12), k
    if not default:  # frozen: untouched
        assert np.array_equal(pt_params["logits.weight"].numpy(),
                              params["logits.weight"])


def test_tx_factory_trainer_matches_optax(data, no_dropout):
    """``Trainer(tx_factory=...)``: the optimizer built from the model's
    parameters on ``create_state`` (and again on ``resume_optimizer``),
    the parameters no group takes frozen, 3 float64 steps equal to
    optax's ``multi_transform`` on the same gradients."""
    images, labels, variables = data
    trainer = Trainer(
        port_model(variables, double=True), softmax_task(),
        device="cpu", compute_dtype=torch.float32,
        tx_factory=lambda params: pt_opt.make_grouped_optimizer(
            _groups(False, None)[:2], params))
    state = trainer.create_state(torch.Generator().manual_seed(0))
    trained = {k for k, p in state.params.items() if p.requires_grad}
    assert trained == {"input_transform.weight", "input_transform.bias"}
    start = {k: p.detach().clone() for k, p in state.params.items()}
    with jax.enable_x64(True):
        jx_params = _jx_tree({k: v.numpy() for k, v in start.items()})
        tx = jx_opt.make_grouped_optimizer(_groups(True, None)[:2],
                                           jx_params)
        opt_state = tx.init(jx_params)
        for _ in range(3):
            _, grads = trainer.loss_and_grads(state, images, labels)
            full = {k: grads.get(k, torch.zeros_like(v)).detach().numpy()
                    for k, v in start.items()}
            updates, opt_state = tx.update(_jx_tree(full), opt_state,
                                           jx_params)
            jx_params = optax.apply_updates(jx_params, updates)
            trainer.optimizer.update_(grads, state.opt_state, state.params)
    for k, p in state.params.items():
        *path, leaf = k.split(".")
        want = jx_params
        for part in path + [leaf]:
            want = want[part]
        assert close(p.detach().numpy(), want, 1e-12), k
    assert torch.equal(state.params["backbone.fc4.weight"],
                       start["backbone.fc4.weight"])
    before = trainer.optimizer
    state = trainer.resume_optimizer(state)
    assert trainer.optimizer is not before and state.opt_state.count == 0


# -- FGSM and the clean + adversarial pair ------------------------------------


def test_fgsm_matches_jax(data):
    images, labels, variables = data
    with jax.enable_x64(True):
        jmod = jx_model64()
        params = _f64(variables["params"])

        @jax.jit
        def attack(x):  # the input gradient and JAX's fgsm, one program
            loss = jx_adv.make_attack_loss(jmod, {"params": params},
                                           jnp.asarray(labels))
            return jax.grad(loss)(x), jx_adv.fgsm(loss, x, EPS)

        g, want = (np.asarray(a) for a in attack(jnp.asarray(images)))
    model = port_model(variables, double=True)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    loss_fn = pt_adv.make_attack_loss(model, y)
    xg = x.clone().requires_grad_(True)
    (got_g,) = torch.autograd.grad(loss_fn(xg), xg)
    assert rel_err(got_g.numpy(), g) <= 1e-5
    got = pt_adv.make_attack(model, EPS)(x, y).numpy()
    assert np.array_equal(got, pt_adv.fgsm(loss_fn, x, EPS).numpy())
    firm = np.abs(g) > SIGN_THRESH * np.abs(g).max()
    assert firm.mean() > 0.9
    assert np.array_equal(got[firm], want[firm])
    assert np.abs(got - want).max() <= 2 * EPS
    assert got.min() >= -1.0 and got.max() <= 1.0
    assert model.training  # the attack's eval mode is restored


def test_adversarial_pair_matches_jax(data, no_dropout):
    images, labels, variables = data
    with jax.enable_x64(True):
        jmod = jx_model64()
        cfg = JxOptimizerConfig(name="momentum", momentum=0.9,
                                schedule=JxSchedule(learning_rate=LR))
        trainer = JxTrainer(jmod, jx_softmax_task(), cfg,
                            mesh=make_mesh(MeshConfig(data=1, model=1)))
        params = _f64(variables["params"])
        trainer.tx = jx_opt.make_optimizer(cfg, params)
        state = trainer.shard_state(JxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
            opt_state=trainer.tx.init(params), rng=jax.random.PRNGKey(1)))
        state, jclean, jadv = jx_adv.adversarial_train_step_pair(
            trainer, state, jnp.asarray(images), jnp.asarray(labels),
            epsilon=EPS)
        want_params = jax.device_get(state.params)
    port = Trainer(port_model(variables, double=True), softmax_task(),
                   OptimizerConfig(name="momentum", momentum=0.9,
                                   schedule=LRScheduleConfig(
                                       learning_rate=LR)),
                   device="cpu", compute_dtype=torch.float32)
    init = to_sd(_f64(variables["params"]))
    pstate = port.create_state(torch.Generator().manual_seed(0), init)
    seen = {}

    def attack(x, y):
        seen["adv"] = pt_adv.make_attack(pstate.model, EPS)(x, y)
        return seen["adv"]

    pstate, clean, adv = pt_adv.adversarial_train_step_pair(
        port, pstate, torch.from_numpy(images), torch.from_numpy(labels),
        epsilon=EPS, attack_fn=attack)
    for got, want in ((clean, jclean), (adv, jadv)):
        assert abs(float(got["loss"]) - float(want["loss"])) <= \
            1e-6 * abs(float(want["loss"]))
        assert float(got["accuracy"]) == float(want["accuracy"])
    assert pstate.step == 2 and pstate.opt_state.count == 2
    for k, p in pstate.params.items():
        *path, leaf = k.split(".")
        flax_leaf = {"weight": "kernel", "bias": "bias"}[leaf]
        want = want_params
        for part in path:
            want = want[part]
        want = np.asarray(want[flax_leaf])
        got = p.detach().numpy()
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)
        elif got.ndim == 2:
            got = got.T
        assert close(got, want, 1e-6), k
    # the default attack is the white-box one on the updated model
    pstate2 = port.create_state(torch.Generator().manual_seed(0), init)
    pstate2, _, adv2 = pt_adv.adversarial_train_step_pair(
        port, pstate2, torch.from_numpy(images), torch.from_numpy(labels),
        epsilon=EPS)
    assert float(adv2["loss"]) == float(adv["loss"])


def test_random_sign_noise():
    gen = torch.Generator().manual_seed(3)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 8, 8, 3)).astype(np.float32))
    allowed = {e / 255 * 2 for e in pt_adv.EPSILONS}
    drawn = set()
    for _ in range(40):
        y = pt_adv.random_sign_noise(gen, x)
        assert y.min() >= -1.0 and y.max() <= 1.0
        inside = x.abs() < 1 - 2 * max(allowed)  # never clipped
        d = (y - x)[inside].abs()
        eps = float(d.max())
        assert any(abs(eps - a) < 1e-6 for a in allowed)
        assert torch.allclose(d, torch.full_like(d, eps), atol=1e-6)
        drawn.add(round(eps * 255 / 2))
    assert drawn == set(pt_adv.EPSILONS)
    again = pt_adv.random_sign_noise(torch.Generator().manual_seed(3), x)
    first = pt_adv.random_sign_noise(torch.Generator().manual_seed(3), x)
    assert torch.equal(again, first)
