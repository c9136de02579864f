"""The port's inception family against the JAX package's on the CPU:
the layers it adds (BatchNorm without a scale, the SAME average pool
that leaves the pads out of its divisor, the separable conv), and each
net's float32 forward from converted weights, in eval mode and in train
mode (the output and every updated running statistic), at the sizes of
the JAX package's ``tests/test_zoo.py`` (v1 64², the rest 160²), full
width, batch 2, 10 classes, seeded random weights with the statistics
off the identity; the auxiliary heads of v1, v3 and v4 too.

In train mode dropout is replaced by the identity in both packages (their
generators differ); the port's dropout rule is held in
``tests/test_torch_port_resnet_model.py``, and here only that it draws
from the caller's generator.

Bounds, each with its reason:

- eval mode, float32: 1e-4 relative norm for every output (float32
  convs summed in other orders; measured ≤ 1e-6);
- train mode in float64 (both packages): 1e-9 relative norm for every
  output and every updated running statistic. In float32 the batch
  statistics of the last maps (batch 2 over 2×2 maps in v1 at 64², over
  1×1 maps in the auxiliary heads, 8 and 2 values a channel) turn the
  rounding of flax's one-pass variance, E[x²] − E[x]², into output
  differences up to 5.5e-3 (measured) that say nothing of the structure;
- the layers 1e-6 (float32).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.models import inception as pt_inception
from tensorflow_yolo2_torch.models import layers as pt_layers
from tensorflow_yolo2_torch.models import registry
from tensorflow_yolo2_tpu.models import inception as jx_inception
from tensorflow_yolo2_tpu.models import registry as jx_registry
from tests.test_torch_port_models import nchw, nhwc, random_variables, rel_err
from tests.test_torch_port_resnet_train import (  # noqa: F401
    _f64,
    few_torch_threads,  # autouse
)

NUM_CLASSES = 10
SIZES = {"inception_v1": 64, "inception_v2": 160, "inception_v3": 160,
         "inception_v4": 160, "inception_resnet_v2": 160}
AUX = ("inception_v1", "inception_v3", "inception_v4")
# the nets of this file; v4 and Inception-ResNet-v2, the deeper two, are
# held by tests/test_torch_port_inception_v4.py and
# tests/test_torch_port_inception_resnet.py, so that each file
# stays under a minute
SHALLOW = ("inception_v1", "inception_v2", "inception_v3")
REL = 1e-4
TRAIN_REL = 1e-9


def _kw(name):
    return {"num_classes": NUM_CLASSES,
            **({"aux_logits": True} if name in AUX else {})}


def _outputs(y):
    return [np.asarray(t) for t in (y if isinstance(y, tuple) else (y,))]


# -- layers -------------------------------------------------------------------


def test_no_scale_batchnorm_has_no_weight_and_matches_flax():
    """``use_scale=False``: only ``bias`` is a parameter (no weight for an
    optimizer, weight decay or the global norm to see); a train-mode call
    normalises with the batch statistics and leaves flax's running
    statistics; eval mode uses them."""
    bn = pt_layers.BatchNorm(6, momentum=pt_layers.SLIM_BN_MOMENTUM,
                             use_scale=False)
    assert [n for n, _ in bn.named_parameters()] == ["bias"]
    assert "weight" not in bn.state_dict() and bn.weight is None
    rng = np.random.RandomState(0)
    x = rng.normal(0.5, 2.0, (3, 5, 4, 6)).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    mean = rng.normal(0, 0.1, 6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9997,
                        epsilon=1e-3, use_scale=False)
    variables = {"params": {"bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = fbn.apply(variables, x, mutable=["batch_stats"])
    bn.load_state_dict({"bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn.train()(nchw(x))
    assert rel_err(nhwc(got.detach()), want) <= 1e-6
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        assert rel_err(getattr(bn, name).numpy(),
                       upd["batch_stats"][key]) <= 1e-6, name
    fbn_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-3,
                             use_scale=False)
    want = fbn_eval.apply({"params": {"bias": bias},
                           "batch_stats": upd["batch_stats"]}, x)
    with torch.no_grad():
        assert rel_err(nhwc(bn.eval()(nchw(x))), want) <= 1e-6
    bn.bias.data.fill_(1.0)
    bn.reset_parameters()
    assert not bn.bias.any()


@pytest.mark.parametrize("window, stride, side", [(3, 1, 7), (3, 1, 2),
                                                  (5, 3, 9)])
def test_exclusive_avg_pool_matches_flax(window, stride, side):
    """flax's SAME ``avg_pool(count_include_pad=False)``: a window's sum
    over the input values in it, where XLA's pads are symmetric (the
    inception nets' 3×3/1, a 5×5/3 on 9 and 10); pads that are not, as a
    3×3/2 on an even map, raise."""
    x = np.random.RandomState(side).normal(0, 1, (2, side, side + 1, 5)) \
        .astype(np.float32)
    with pytest.raises(ValueError, match="not symmetric"):
        pt_layers.avg_pool_exclusive(nchw(x), 3, 2)  # one side is even
    want = fnn.avg_pool(jnp.asarray(x), (window, window), (stride, stride),
                        "SAME", count_include_pad=False)
    got = pt_layers.avg_pool_exclusive(nchw(x), window, stride)
    assert got.shape[-2:] == want.shape[1:3]
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)
    # the corner of a 3×3/1 pool averages 4 values, not 9
    if (window, stride) == (3, 1):
        np.testing.assert_allclose(nhwc(got)[:, 0, 0],
                                   x[:, :2, :2].mean(axis=(1, 2)), rtol=1e-6)


@pytest.mark.parametrize("in_ch, mult, stride", [(3, 8, 2), (4, 3, 1),
                                                 (2, 1, 2)])
def test_separable_conv_matches_flax(in_ch, mult, stride):
    """The depthwise conv's output channel o reads input channel
    o // depth_multiplier in both (flax's grouped kernel (7, 7, 1,
    in·mult)), so the converted weights give the same map; train mode,
    the BatchNorm's statistics too."""
    jx = jx_inception.SeparableConvBNReLU(16, (7, 7), depth_multiplier=mult,
                                          strides=stride)
    x = np.random.RandomState(in_ch).uniform(-1, 1, (2, 20, 20, in_ch)) \
        .astype(np.float32)
    variables = random_variables(jx, x.shape, seed=mult)
    assert variables["params"]["depthwise"]["kernel"].shape == \
        (7, 7, 1, in_ch * mult)
    want, upd = jx.apply(variables, x, train=True, mutable=["batch_stats"])
    pt = pt_layers.SeparableConvBNReLU(in_ch, 16, 7, mult, stride)
    pt.load_state_dict(convert.state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    assert pt.depthwise.weight.shape == (in_ch * mult, 1, 7, 7)
    got = pt.train()(nchw(x))
    assert rel_err(nhwc(got.detach()), want) <= 1e-6
    assert rel_err(pt.bn.running_var.numpy(),
                   upd["batch_stats"]["bn"]["var"]) <= 1e-6
    # the channel order: a kernel that is one only at the centre of
    # output channel o copies input channel o // mult to it (SAME's low
    # pad shifts the centre by 3 − low)
    o = in_ch * mult - 1
    start = 3 - pt_layers._same_pads(20, 7, stride)[0]
    with torch.no_grad():
        pt.depthwise.weight.zero_()
        pt.depthwise.weight[o, 0, 3, 3] = 1.0
        picked = pt.depthwise(nchw(x))[:, o]
    np.testing.assert_array_equal(
        picked.numpy(),
        nchw(x)[:, o // mult, start::stride, start::stride].numpy())


# -- the nets -----------------------------------------------------------------


def net_results(name: str) -> dict:
    """One net of each package on the same converted weights, its input
    and the JAX package's eval and float64 train-mode results (dropout
    off)."""
    size = SIZES[name]
    jx_model = jx_registry.get_network(name, **_kw(name))
    variables = random_variables(jx_model, (1, size, size, 3), seed=len(name))
    x = np.random.RandomState(size).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    want_eval = _outputs(jax.jit(lambda v, x: jx_model.apply(
        v, x, train=False))(variables, x))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn, "Dropout",
                   lambda rate, deterministic: (lambda y: y))
        jx64 = jx_registry.get_network(name, dtype=jnp.float64, **_kw(name))
        y, upd = jax.jit(lambda v, x: jx64.apply(
            v, x, train=True, mutable=["batch_stats"]))(
                _f64(variables), x.astype(np.float64))
        want_train = _outputs(y)
        stats = {k: np.asarray(v) for k, v in convert.flatten(
            upd["batch_stats"]).items()}
    model = registry.get_network(name, image_size=size, **_kw(name))
    model.load_state_dict(convert.state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    return {"name": name, "x": x, "model": model, "eval": want_eval,
            "train": want_train, "stats": stats}


@pytest.fixture(scope="module", params=SHALLOW)
def net(request):
    return net_results(request.param)


def test_forward_eval_matches_jax(net):
    model = net["model"].eval()
    with torch.no_grad():
        got = _outputs(model(torch.from_numpy(net["x"])))
    assert len(got) == len(net["eval"]) == (2 if net["name"] in AUX else 1)
    for g, w in zip(got, net["eval"]):
        assert g.shape == w.shape == (2, NUM_CLASSES)
        assert g.dtype == np.float32
        assert rel_err(g, w) <= REL, (net["name"], rel_err(g, w))


def test_forward_train_and_statistics_match_jax(net, monkeypatch):
    """float64 in both packages (module docstring): the train-mode
    outputs and every running statistic after the call."""
    monkeypatch.setattr(pt_inception, "dropout", lambda x, rate, gen: x)
    model = copy.deepcopy(net["model"]).double().train()
    with torch.no_grad():
        got = _outputs(model(torch.from_numpy(net["x"]).double(),
                             generator=torch.Generator()))
    for g, w in zip(got, net["train"]):
        assert g.dtype == np.float32  # the nets' float32 logits
        assert rel_err(g, w) <= TRAIN_REL, (net["name"], rel_err(g, w))
    sd = model.state_dict()
    assert len(net["stats"]) > 50
    for path, want in net["stats"].items():
        *module, _, leaf = path.split("/")
        key = ".".join(module + ["bn", {"mean": "running_mean",
                                        "var": "running_var"}[leaf]])
        assert rel_err(sd[key].numpy(), want) <= TRAIN_REL, key
        assert not np.array_equal(sd[key].numpy(), net["model"].state_dict()[
            key].numpy()), key


@pytest.mark.parametrize("name", AUX)
def test_aux_head_shapes_follow_the_default_size(name):
    """The auxiliary heads' kernels and dense widths depend on the map
    size: at the registry size (224², 299², 299²) the state dict's names
    and shapes are those ``convert`` gives the flax tree's (the fixtures'
    strict loads hold the other nets and sizes), and no BatchNorm has a
    weight."""
    size = registry.default_image_size(name)
    assert size == jx_registry.default_image_size(name)
    shapes = jax.eval_shape(lambda: jx_registry.get_network(
        name, **_kw(name)).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, size, size, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = {k: tuple(v.shape) for k, v in convert.state_dict_from_flax(
        zeros["params"], zeros["batch_stats"]).items()}
    got = {k: tuple(v.shape) for k, v in
           registry.get_network(name, **_kw(name)).state_dict().items()}
    assert got == want
    assert any(k.startswith("aux") for k in got)
    assert not any(k.endswith("bn.weight") for k in got)


def test_dropout_draws_from_the_callers_generator():
    model = registry.get_network("inception_v1", image_size=64,
                                 **_kw("inception_v1")).train()
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="dropout generator"):
        model(x)
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
    for u, v, w in zip(a, b, c):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
        assert not torch.equal(u, w)


@pytest.mark.parametrize("name", ["inception_v2", "inception_resnet_v2"])
def test_aux_logits_only_where_the_net_has_heads(name):
    """The JAX nets without auxiliary heads take no ``aux_logits``: a
    ``TypeError`` in both registries (the trainer's ``--aux-loss``
    parser error)."""
    for reg in (registry, jx_registry):
        with pytest.raises(TypeError):
            reg.get_network(name, aux_logits=True)
