"""The port's model registry and slim zoo against the JAX package on the
CPU: the registry's names and default sizes, and each net's float32
forward from weights converted from the JAX net's (``convert``), in eval
mode.

Sizes: ``lenet`` 28, ``cifarnet`` 32 (a 7×7 / 8×8 map before the NHWC
flatten), ``resnet_v1_101`` and ``resnet_v2_50`` at 64, ``yolo1`` and
``yolo1_pretrain`` at 128 (a 2×2 map before the flatten, so its order
shows; the 7×7/2 ``conv1`` pads low 2, high 3), ``alexnet_v2`` and
``vgg_a`` at 224, ``overfeat`` at 231 (their VALID convs and pools need
the full size); batch 2, 10 classes, seeded random weights with
BatchNorm off the identity. The deeper variants (``vgg_16``, ``vgg_19``,
``resnet_v1_152`` / ``200``, ``resnet_v2_101`` / ``152`` / ``200``) are
held on their parameter names and shapes only.

Bound: 1e-5 relative norm for every output (float32 convs summed in
other orders; measured at most ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.models import registry
from tensorflow_yolo2_tpu.models import registry as jx_registry
from tests.test_torch_port_models import random_variables, rel_err
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

NUM_CLASSES = 10
FORWARD = {"lenet": 28, "cifarnet": 32, "resnet_v1_101": 64,
           "resnet_v2_50": 64, "yolo1": 128, "yolo1_pretrain": 128,
           "alexnet_v2": 224, "vgg_a": 224, "overfeat": 231}
SHAPES_ONLY = ("vgg_16", "vgg_19", "resnet_v1_152", "resnet_v1_200",
               "resnet_v2_101", "resnet_v2_152", "resnet_v2_200")
INCEPTION = ("inception_v1", "inception_v2", "inception_v3", "inception_v4",
             "inception_resnet_v2")
REL = 1e-5


def _kw(name):
    return {} if name == "yolo1" else {"num_classes": NUM_CLASSES}


def _flax_shapes(name, size):
    model = jx_registry.get_network(name, **_kw(name))
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))


def _port_key_and_shape(path, shape, collection):
    """Where ``convert`` puts a flax leaf, and the shape it gets there."""
    *module, layer, leaf = path.split("/")
    table = (convert._STAT_LEAVES if collection == "batch_stats" else
             {**convert._PARAM_LEAVES, **convert._BARE_LEAVES})
    name = table[(layer, leaf)]
    if leaf == "kernel":
        shape = ((shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4
                 else (shape[1], shape[0]))
    return ".".join(module + [name]), tuple(shape)


def test_registry_names_and_sizes_match_jax():
    assert registry.list_networks() == jx_registry.list_networks()
    for name in registry.list_networks():
        assert registry.default_image_size(name) == \
            jx_registry.default_image_size(name), name


@pytest.mark.parametrize("name", INCEPTION)
def test_inception_is_listed_and_refused(name):
    """Each inception net is listed and builds (``models.inception``,
    held to the JAX package in ``tests/test_torch_port_inception_*.py``);
    an override it does not take is refused: ``aux_logits`` on the nets
    without auxiliary heads, ``dtype`` on every net (the port takes bf16
    from autocast)."""
    assert name in registry.list_networks()
    model = registry.get_network(name, num_classes=NUM_CLASSES)
    assert model.logits.out_features == NUM_CLASSES
    with pytest.raises(TypeError):
        registry.get_network(name, dtype="bfloat16")
    if name in ("inception_v2", "inception_resnet_v2"):
        with pytest.raises(TypeError):
            registry.get_network(name, aux_logits=True)
    else:
        assert registry.get_network(name, aux_logits=True).aux


def test_unknown_names_and_overrides_raise():
    with pytest.raises(ValueError, match="Name of network unknown"):
        registry.get_network("vgg_17")
    with pytest.raises(TypeError):
        registry.get_network("lenet", aux_logits=True)


@pytest.mark.parametrize("name", sorted(FORWARD) + list(SHAPES_ONLY))
def test_names_and_shapes_match_flax(name):
    size = FORWARD.get(name, registry.default_image_size(name))
    shapes = _flax_shapes(name, size)
    want = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in convert.flatten(shapes.get(collection, {})).items():
            key, shape = _port_key_and_shape(path, leaf.shape, collection)
            want[key] = shape
    model = registry.get_network(name, image_size=size, **_kw(name))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_matches_jax(name):
    size = FORWARD[name]
    jx_model = jx_registry.get_network(name, **_kw(name))
    variables = random_variables(jx_model, (1, size, size, 3),
                                 seed=len(name))
    x = np.random.RandomState(size).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jx_model.apply(
        v, x, train=False))(variables, x))
    model = registry.get_network(name, image_size=size, **_kw(name))
    model.load_state_dict(convert.state_dict_from_flax(
        variables["params"], variables.get("batch_stats")))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).contiguous(
            memory_format=torch.contiguous_format)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel_err(got, want) <= REL, (name, rel_err(got, want))


def test_npz_carrier_round_trip(tmp_path):
    """A JAX zoo net's tree through ``save_npz`` / ``load_npz`` loads
    into the port's net as it is."""
    jx_model = jx_registry.get_network("cifarnet", num_classes=NUM_CLASSES)
    variables = random_variables(jx_model, (1, 32, 32, 3), seed=2)
    path = str(tmp_path / "cifarnet.npz")
    convert.save_npz(path, variables["params"])
    params, stats = convert.load_npz(path)
    model = registry.get_network("cifarnet", num_classes=NUM_CLASSES)
    model.load_state_dict(convert.state_dict_from_flax(params, stats))
    np.testing.assert_array_equal(
        model.fc3.weight.detach().numpy(),
        np.asarray(variables["params"]["fc3"]["kernel"]).T)


@pytest.mark.parametrize("name", ["lenet", "cifarnet", "yolo1"])
def test_dropout_needs_a_generator_in_training(name):
    size = FORWARD[name]
    model = registry.get_network(name, image_size=size, **_kw(name)).train()
    x = torch.zeros(1, size, size, 3)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    a = model(x, generator=torch.Generator().manual_seed(0))
    b = model(x, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
