"""The port's Darknet19 ImageNet classifier and its training pieces
against the JAX package on the CPU: the global ``avg_pool``, the
classifier forward (unfolded and BN-folded), ``softmax_task``, the
momentum optimizer and one whole float64 classifier train step.

Tolerances, each with its reason:

- ``avg_pool``: float32, rtol = atol = 1e-6 (a window sum over at most
  81 values, summed in another order).
- the classifier forward, 64² and 96×64, 10 classes, flax's init tree
  and seeded random weights: in eval mode, float32, relative norm 1e-5
  of the logits (19 float32 convs summed in other orders, as the
  detector's bound), folded or not; in train mode see
  ``test_classifier_train_mode_matches_jax`` (float32 train-mode
  BatchNorm over 2×2 maps is 1.5e-5 to 5e-5 from float64 by rounding
  alone, in either package).
- ``softmax_task``, float64: 1e-12 relative (the same formulas).
- momentum against optax, float64, three steps with and without
  clipping: rtol 1e-12 at a fixed rate; 1e-6 on an exponential schedule
  (optax's decayed rate is float32).
- one float64 train step (64², 10 classes, batch 4, momentum 0.9 at
  1e-3): the classifier returns float32 logits in both packages (its
  ``astype(float32)``), so the loss is float32 on both sides: relative
  1e-9 of the loss; each gradient and each updated parameter tensor
  1e-6 relative norm; the running statistics 1e-9 relative norm (flax
  keeps them in float32 in a float64 step only where the tree is
  float32; here every leaf is float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as jnn

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
from tensorflow_yolo2_torch.models.fold import fold_params as pt_fold
from tensorflow_yolo2_torch.models.layers import avg_pool
from tensorflow_yolo2_torch.train import optimizers as pt_opt
from tensorflow_yolo2_torch.train.checkpoint import load_into
from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.models import darknet as jx_darknet
from tensorflow_yolo2_tpu.models.fold import fold_params as jx_fold
from tensorflow_yolo2_tpu.parallel import MeshConfig, make_mesh
from tensorflow_yolo2_tpu.train import Trainer as JxTrainer
from tensorflow_yolo2_tpu.train import optimizers as jx_opt
from tensorflow_yolo2_tpu.train.trainer import TrainState as JxTrainState
from tensorflow_yolo2_tpu.train.trainer import softmax_task as jx_softmax
from tests.test_torch_port_models import random_variables, rel_err
from tests.test_torch_port_train import _pre_bn_bias, _scalars, rel_norm

NUM_CLASSES = 10
LR = 1e-3


# -- avg_pool -----------------------------------------------------------------


@pytest.mark.parametrize("hw,window", [((7, 7), 7), ((14, 14), 14),
                                       ((9, 7), 9), ((7, 9), 7),
                                       ((5, 2), 5), ((6, 6), 4)])
def test_avg_pool_matches_flax(hw, window):
    """SAME, window = stride: square maps give the mean; a map higher
    than wide (9×7) one output whose divisor counts the padded zeros
    (the sum over 63 values / 81); one wider than high (7×9) two outputs
    along W, each over its share of real columns / 49."""
    x = np.random.RandomState(0).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jnn.avg_pool(jnp.asarray(x), (window, window),
                                   strides=(window, window), padding="SAME"))
    got = avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window, window)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if hw == (9, 7):
        np.testing.assert_allclose(got[:, 0, 0], x.sum((1, 2)) / 81,
                                   rtol=1e-6, atol=1e-6)
    if hw == (7, 9):
        assert got.shape[1:3] == (1, 2)


# -- the classifier forward ---------------------------------------------------


def _jx_variables(kind, shape):
    model = jx_darknet.Darknet19Classifier(num_classes=NUM_CLASSES)
    if kind == "init":
        return jax.device_get(jax.jit(lambda rng, x: model.init(
            rng, x, train=False))(jax.random.PRNGKey(0),
                                  jnp.zeros(shape, jnp.float32)))
    return random_variables(model, shape, seed=7)


def _port_classifier(variables, fold_bn=False):
    model = Darknet19Classifier(NUM_CLASSES, fold_bn=fold_bn)
    if fold_bn:
        sd = convert.state_dict_from_flax(
            jax.device_get(jx_fold(variables["params"],
                                   variables["batch_stats"])))
        model.load_state_dict(sd)
    else:
        model.load_state_dict(convert.state_dict_from_flax(
            variables["params"], variables["batch_stats"]))
    return model


@pytest.fixture(scope="module")
def jx_variables():
    """The JAX classifier's variables at 64²: flax's init tree, and
    seeded random weights with BN away from the identity."""
    return {kind: _jx_variables(kind, (1, 64, 64, 3))
            for kind in ("init", "random")}


@pytest.fixture(scope="module", params=["init", "random"])
def classifier_case(request, jx_variables):
    """A 64² batch of 2 and one kind of the JAX classifier's variables."""
    shape = (2, 64, 64, 3)
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    return x, jx_variables[request.param]


def test_classifier_matches_jax(classifier_case):
    """Eval mode (running statistics), float32."""
    x, variables = classifier_case
    jmodel = jx_darknet.Darknet19Classifier(num_classes=NUM_CLASSES)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, x)
    with torch.no_grad():
        got = _port_classifier(variables).eval()(torch.from_numpy(x))
    assert got.shape == (2, NUM_CLASSES) and got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5


def test_classifier_train_mode_matches_jax(classifier_case):
    """Train mode (batch statistics; the running ones updated). Over
    the 2×2 maps of the last stages each BatchNorm normalises 8 values a
    channel, and float32 rounding alone moves either package's logits
    1.5e-5 to 5e-5 (relative norm) from the float64 forward (measured at
    batch 2 to 8, 64² and 96²), so the packages are held to each other
    in float64 (logits 1e-6: both are rounded to float32 at the end;
    running statistics 1e-9), and each float32 forward to float64 at
    1e-4."""
    x, variables = classifier_case
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 variables)
    with jax.enable_x64(True):
        jmodel = jx_darknet.Darknet19Classifier(
            num_classes=NUM_CLASSES, dtype=jnp.float64,
            param_dtype=jnp.float64)
        want, mutated = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            v64, x.astype(np.float64))
        want_stats = jax.device_get(mutated["batch_stats"])
    want32, _ = jax.jit(lambda v, x: jx_darknet.Darknet19Classifier(
        num_classes=NUM_CLASSES).apply(v, x, train=True,
                                       mutable=["batch_stats"]))(variables, x)
    model = _port_classifier(variables).double().train()
    model32 = _port_classifier(variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).double())
        got32 = model32(torch.from_numpy(x))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-6
    stats = convert.flatten(want_stats)
    sd = model.state_dict()
    assert len(stats) == sum("running" in k for k in sd)
    for path, leaf in stats.items():
        key = path.replace("/", ".").replace("bn.mean", "bn.running_mean") \
            .replace("bn.var", "bn.running_var")
        assert rel_err(sd[key].numpy(), leaf) <= 1e-9, key
    assert rel_err(got32.numpy(), got.numpy()) <= 1e-4
    assert rel_err(np.asarray(want32), got.numpy()) <= 1e-4


def test_folded_classifier_matches_jax(classifier_case):
    x, variables = classifier_case
    jfolded = jx_fold(variables["params"], variables["batch_stats"])
    want = jax.jit(lambda p, x: jx_darknet.Darknet19Classifier(
        num_classes=NUM_CLASSES, fold_bn=True).apply(
        {"params": p}, x, train=False))(jfolded, x)
    with torch.no_grad():
        folded = _port_classifier(variables, fold_bn=True).eval()(
            torch.from_numpy(x))
        unfolded = _port_classifier(variables).eval()(torch.from_numpy(x))
        own_fold = Darknet19Classifier(NUM_CLASSES, fold_bn=True)
        own_fold.load_state_dict(pt_fold(convert.state_dict_from_flax(
            variables["params"], variables["batch_stats"])))
        own = own_fold.eval()(torch.from_numpy(x))
    assert rel_err(folded.numpy(), np.asarray(want)) <= 1e-5
    assert rel_err(own.numpy(), np.asarray(want)) <= 1e-5
    assert rel_err(folded.numpy(), unfolded.numpy()) <= 1e-5


def test_classifier_on_non_square_maps(jx_variables):
    """96×64 (a 3×2 last map): the pool's 3×3 window over 6 values / 9,
    as flax's; 64×96 (2×3) leaves two outputs a class, which both
    packages' reshape refuses."""
    shape = (1, 96, 64, 3)
    variables = jx_variables["random"]
    x = np.random.RandomState(2).uniform(-1, 1, shape).astype(np.float32)
    jmodel = jx_darknet.Darknet19Classifier(num_classes=NUM_CLASSES)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    want = apply(variables, x)
    model = _port_classifier(variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5
    wide = np.swapaxes(x, 1, 2).copy()
    with pytest.raises(TypeError):
        apply(variables, wide)
    with pytest.raises(RuntimeError):
        with torch.no_grad():
            model(torch.from_numpy(wide))


def test_classifier_names_match_flax(jx_variables):
    """``backbone.*`` and ``conv19.*``: a JAX classifier tree maps onto
    the port's state dict unchanged, keys and shapes."""
    variables = jx_variables["init"]
    sd = convert.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    own = Darknet19Classifier(NUM_CLASSES).state_dict()
    assert own.keys() == sd.keys()
    assert all(own[k].shape == sd[k].shape for k in sd)
    assert {k.split(".")[0] for k in sd} == {"backbone", "conv19"}
    assert "conv19.bn.weight" in sd
    plain = Darknet19Classifier(NUM_CLASSES, bn_on_output=False)
    assert plain.conv19.bn is None and not plain.conv19.activate


# -- softmax_task -------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("aux", [False, True])
def test_softmax_task_matches_jax(smoothing, aux):
    """Loss, aux loss, accuracy and the gradient w.r.t. the logits, in
    float64."""
    rng = np.random.RandomState(3)
    logits = rng.normal(0, 2, (6, 7))
    aux_logits = rng.normal(0, 2, (6, 7))
    labels = rng.randint(0, 7, 6).astype(np.int32)
    jtask = jx_softmax(aux_weight=0.4, label_smoothing=smoothing)
    ptask = softmax_task(aux_weight=0.4, label_smoothing=smoothing)
    with jax.enable_x64(True):
        def jloss(lg, ax):
            out = (lg, ax) if aux else lg
            return jtask(out, jnp.asarray(labels))

        (want, wmetrics), wgrad = jax.value_and_grad(
            jloss, has_aux=True)(jnp.asarray(logits), jnp.asarray(aux_logits))
        wmetrics = {k: float(v) for k, v in wmetrics.items()}
        wgrad = np.asarray(wgrad)
    lg = torch.from_numpy(logits).requires_grad_()
    ax = torch.from_numpy(aux_logits)
    got, gmetrics = ptask((lg, ax) if aux else lg, torch.from_numpy(labels))
    ggrad, = torch.autograd.grad(got, lg)
    assert got.dtype == torch.float64
    assert set(gmetrics) == set(wmetrics)
    for k, v in wmetrics.items():
        np.testing.assert_allclose(gmetrics[k].item(), v, rtol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(ggrad.numpy(), wgrad, rtol=1e-12,
                               atol=1e-15)


# -- the momentum optimizer ---------------------------------------------------


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("kind", ["fixed", "exponential"])
def test_momentum_matches_optax(clip, kind):
    """Three float64 steps of momentum 0.9, with and without clipping
    (the first and third gradients above the norm): rtol 1e-12 on the
    fixed rate the classifier trains with; on an exponential schedule
    rtol 1e-6, as optax computes a decayed rate in float32 (the port in
    double: 7.7e-8 relative, measured)."""
    tol = dict(rtol=1e-12, atol=1e-15) if kind == "fixed" else \
        dict(rtol=1e-6, atol=1e-12)
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3, 2)}
    params = {k: rng.normal(0, 1, s) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s) * scale for k, s in shapes.items()}
             for scale in (3.0, 0.01, 2.0)]
    sched = dict(kind=kind, learning_rate=0.1, decay_steps=1,
                 decay_factor=0.5)
    with jax.enable_x64(True):
        jtx = jx_opt.make_optimizer(jx_config.OptimizerConfig(
            name="momentum", momentum=0.9, grad_clip_norm=clip,
            schedule=jx_config.LRScheduleConfig(**sched)))
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = jtx.init(jp)
        ptx = pt_opt.make_optimizer(OptimizerConfig(
            name="momentum", momentum=0.9, grad_clip_norm=clip,
            schedule=LRScheduleConfig(**sched)))
        assert isinstance(ptx, pt_opt.Momentum)
        pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        pstate = ptx.init(pp)
        for g in grads:
            updates, jstate = jtx.update(
                jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
            jp = optax.apply_updates(jp, updates)
            ptx.update_({k: torch.from_numpy(v) for k, v in g.items()},
                        pstate, pp)
            for k in shapes:
                np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                           **tol)
        trace = (jstate[-1] if clip else jstate)[0].trace
        assert pstate.count == 3
        for k in shapes:
            np.testing.assert_allclose(pstate.trace[k].numpy(),
                                       np.asarray(trace[k]), rtol=1e-12,
                                       atol=1e-15)


@pytest.mark.parametrize("name", ["sgd", "rmsprop", "adagrad"])
def test_other_optimizers_are_refused_naming_a6(name):
    """These optimizers are ported now (held to optax in
    ``tests/test_torch_port_slim_optim.py``), and so are the per-scope
    optimizer groups (held to optax in
    ``tests/test_torch_port_adversarial.py``): a group of this optimizer
    builds it, and takes every parameter of its scope."""
    assert isinstance(pt_opt.make_optimizer(OptimizerConfig(name=name)),
                      pt_opt.OPTIMIZERS[name])
    params = {"a.w": torch.zeros(2), "b.w": torch.zeros(3)}
    grouped = pt_opt.make_grouped_optimizer(
        [(("a",), OptimizerConfig(name=name))], params)
    (label, opt, keys), = grouped.groups
    assert isinstance(opt, pt_opt.OPTIMIZERS[name]) and keys == ["a.w"]
    assert grouped.init(params).names == ["a.w"]


# -- one float64 train step ---------------------------------------------------


def _to_sd(params, stats=None):
    """A flax tree → the port's state dict, float64 values (without the
    BatchNorm step counters)."""
    params, stats = jax.device_get((params, stats))
    sd = convert.state_dict_from_flax(params, stats)
    keys = [k for k in sd if not k.endswith("num_batches_tracked")]
    leaves = [*convert.flatten(params).values(),
              *convert.flatten(stats or {}).values()]
    assert len(keys) == len(leaves)
    out = {}
    for k, leaf in zip(keys, leaves):
        t = torch.from_numpy(np.array(leaf, np.float64))
        out[k] = t.permute(3, 2, 0, 1) if t.dim() == 4 else t
    return out


def pstate_counters(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def train_step():
    """One float64 train step of the classifier (64², 10 classes, batch
    4, seeded weights, momentum 0.9 at 1e-3) in both packages from the
    same state: the gradients, and metrics, parameters and statistics
    after the step."""
    rng = np.random.RandomState(5)
    images = rng.uniform(-1, 1, (4, 64, 64, 3))
    labels = rng.randint(0, NUM_CLASSES, 4).astype(np.int32)
    opt = dict(name="momentum", momentum=0.9)
    with jax.enable_x64(True):
        model = jx_darknet.Darknet19Classifier(
            num_classes=NUM_CLASSES, dtype=jnp.float64,
            param_dtype=jnp.float64)
        trainer = JxTrainer(
            model, jx_softmax(), jx_config.OptimizerConfig(
                **opt, schedule=jx_config.LRScheduleConfig(learning_rate=LR)),
            mesh=make_mesh(MeshConfig(data=1, model=1)))
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64),
            random_variables(jx_darknet.Darknet19Classifier(
                num_classes=NUM_CLASSES), (1, 64, 64, 3), seed=9))
        trainer.tx = jx_opt.make_optimizer(trainer.opt_cfg)
        state = trainer.shard_state(JxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=trainer.tx.init(variables["params"]),
            rng=jax.random.PRNGKey(1)))
        init = _to_sd(state.params, state.batch_stats)
        state, metrics = trainer.train_step(state, images, labels)
        want = (_scalars(metrics), _to_sd(state.params, state.batch_stats))
        # the first trace from zero is the gradient itself
        jgrads = _to_sd(state.opt_state[0].trace)

    port = Trainer(Darknet19Classifier(NUM_CLASSES).double(), softmax_task(),
                   OptimizerConfig(**opt, schedule=LRScheduleConfig(
                       learning_rate=LR)),
                   device="cpu", compute_dtype=torch.float32)
    pstate = port.create_state(torch.Generator().manual_seed(0),
                               {**pstate_counters(port.model), **init})
    _, pgrads = port.loss_and_grads(pstate, images, labels)
    load_into(pstate.model, init)  # the statistics before that forward
    pstate, metrics = port.train_step(pstate, images, labels)
    return {"jgrads": jgrads, "pgrads": {k: v.detach()
                                         for k, v in pgrads.items()},
            "want": want, "got": (_scalars(metrics),
                                  pstate.model.state_dict()),
            "init": init}


def test_train_step_loss_and_metrics_match_jax(train_step):
    (got, _), (want, _) = train_step["got"], train_step["want"]
    assert set(got) == set(want) == {"loss", "accuracy", "grad_norm"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-9)
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-6)


def test_train_step_gradients_match_jax(train_step):
    got, want = train_step["pgrads"], train_step["jgrads"]
    assert got.keys() == want.keys()
    for k in want:
        if _pre_bn_bias(k, want):  # a true gradient of 0: rounding noise
            continue
        assert rel_norm(got[k], want[k]) <= 1e-6, k


def test_train_step_params_and_stats_match_jax(train_step):
    (_, got), (_, want) = train_step["got"], train_step["want"]
    init = train_step["init"]
    assert want.keys() == {k for k in got
                           if not k.endswith("num_batches_tracked")}
    for k in want:
        if "running" in k:
            assert rel_norm(got[k], want[k]) <= 1e-9, k
        elif _pre_bn_bias(k, want):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-6 * LR, err_msg=k)
        else:
            assert rel_norm(got[k], want[k]) <= 1e-6, k
            assert not torch.equal(got[k], init[k]), k
