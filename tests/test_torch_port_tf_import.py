"""The port's TF-checkpoint importers (``tensorflow_yolo2_torch/compat/
tf_import.py``) against the JAX package's on the CPU.

Both modules' ``load_tf_checkpoint`` are patched (``monkeypatch``) to
return the same name → array map, so no checkpoint file and no
TensorFlow is needed here (the reader is held to TensorFlow's in
``tests/test_torch_port_tf_bundle.py``):

- every importer of ``_IMPORTERS``, and ``import_darknet19_checkpoint``
  as detector and as classifier, on a map that holds every name asked
  for (a seeded array a name): the same tree, key for key, each leaf bit
  for bit;
- the Darknet19 detector (64²), the ResNet-50 detector (64²) and
  Inception v1 (64²): a map in the TF names of each importer with the
  JAX model's seeded weights; the port's ``state_dict_for`` of the port's
  import loads strictly into the port's model, whose float32 eval forward
  matches the JAX model's on the JAX import at the family's bound
  (Darknet19 and ResNet-50 1e-5, Inception 1e-4 relative norm: the
  bounds of ``tests/test_torch_port_models.py``,
  ``tests/test_torch_port_resnet_model.py`` and
  ``tests/test_torch_port_inception_model.py``).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.compat import tf_import as pt_imp
from tensorflow_yolo2_torch.models import registry
from tensorflow_yolo2_torch.models.darknet import Darknet19Detector
from tensorflow_yolo2_torch.models.resnet import ResNet50Detector
from tensorflow_yolo2_tpu.compat import tf_import as jx_imp
from tensorflow_yolo2_tpu.models import registry as jx_registry
from tensorflow_yolo2_tpu.models.darknet import (
    Darknet19Detector as JxDarknet19Detector,
)
from tensorflow_yolo2_tpu.models.resnet import (
    ResNet50Detector as JxResNet50Detector,
)
from tests.test_torch_port_models import random_variables, rel_err
from tests.test_torch_port_resnet_train import (  # noqa: F401
    few_torch_threads,  # autouse
)

SIZE = 32


class EveryName(dict):
    """Any name asked for, with a seeded (1, 1, 2, 3) float32 array of its
    own; ``in`` holds for every name, so every optional branch runs."""

    def __missing__(self, key):
        value = np.random.RandomState(zlib.crc32(key.encode())).normal(
            size=(1, 1, 2, 3)).astype(np.float32)
        self[key] = value
        return value

    def __contains__(self, key):
        return True


def patch_both(monkeypatch, var_map):
    for mod in (pt_imp, jx_imp):
        monkeypatch.setattr(mod, "load_tf_checkpoint", lambda path: var_map)


def assert_same_tree(got, want):
    got, want = convert.flatten(got), convert.flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_the_importer_tables_match():
    assert sorted(pt_imp._IMPORTERS) == sorted(jx_imp._IMPORTERS)
    with pytest.raises(ValueError, match="no TF importer for 'lenet'"):
        pt_imp.import_checkpoint_for("lenet", "x.ckpt")


@pytest.mark.parametrize("name", sorted(jx_imp._IMPORTERS))
def test_importer_matches_jax(monkeypatch, name):
    patch_both(monkeypatch, EveryName())
    for i, (got, want) in enumerate(zip(
            pt_imp.import_checkpoint_for(name, "x.ckpt"),
            jx_imp.import_checkpoint_for(name, "x.ckpt"))):
        assert_same_tree(got, want)
        if i == 0:
            assert convert.flatten(want), name


@pytest.mark.parametrize("detection", [True, False])
def test_darknet19_importer_matches_jax(monkeypatch, detection):
    patch_both(monkeypatch, EveryName())
    got = pt_imp.import_darknet19_checkpoint("x.ckpt", detection=detection)
    want = jx_imp.import_darknet19_checkpoint("x.ckpt", detection=detection)
    for g, w in zip(got, want):
        assert_same_tree(g, w)
    assert len(convert.flatten(got[0])) == 4 * (18 + (4 if detection else 1))


class _Recorded:
    """A leaf of a recording import: the TF name it was read from, and
    whether the importer reshaped it (a slim 1×1-conv kernel taken as a
    dense one)."""

    def __init__(self, name, reshaped=False):
        self.name, self.reshaped = name, reshaped

    def reshape(self, *shape):
        return _Recorded(self.name, reshaped=True)

    @property
    def shape(self):
        return (1, 1, 0, 0)


class _Recording(dict):
    def __missing__(self, key):
        return _Recorded(key)

    def __contains__(self, key):
        return True


def tf_var_map(monkeypatch, importer, variables) -> dict[str, np.ndarray]:
    """The TF names of ``importer`` → the arrays of ``variables`` (a JAX
    model's flax tree) that it maps them to: the inverse of the importer
    on this model. Names whose flax path the model lacks (an optional
    branch the net does not have) are left out."""
    monkeypatch.setattr(jx_imp, "load_tf_checkpoint",
                        lambda path: _Recording())
    recorded = importer()
    monkeypatch.undo()
    var_map = {}
    for tree, coll in zip(recorded, ("params", "batch_stats")):
        have = convert.flatten(variables.get(coll, {}))
        for path, leaf in convert.flatten(tree).items():
            if path in have:
                value = np.asarray(have[path])
                var_map[leaf.name] = (value.reshape(1, 1, *value.shape)
                                      if leaf.reshaped else value)
    return var_map


NETS = {
    "darknet19": (
        lambda: JxDarknet19Detector(output_channels=30),
        lambda: Darknet19Detector(output_channels=30),
        lambda: jx_imp.import_darknet19_checkpoint("x", detection=True),
        lambda: pt_imp.import_darknet19_checkpoint("x", detection=True),
        1e-5),
    "resnet50": (
        lambda: JxResNet50Detector(output_channels=30, S=7),
        lambda: ResNet50Detector(output_channels=30, S=7, image_size=SIZE),
        lambda: jx_imp.import_resnet_detector_checkpoint("x"),
        lambda: pt_imp.import_resnet_detector_checkpoint("x"), 1e-5),
    "inception_v1": (
        lambda: jx_registry.get_network("inception_v1", num_classes=10),
        lambda: registry.get_network("inception_v1", num_classes=10,
                                     image_size=SIZE),
        lambda: jx_imp.import_inception_v1_checkpoint("x"),
        lambda: pt_imp.import_inception_v1_checkpoint("x"), 1e-4),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_import_loads_strictly_and_matches_jax(monkeypatch, net):
    jx_model, pt_model, jx_importer, pt_importer, bound = NETS[net]
    x = np.random.RandomState(3).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    jmod = jx_model()
    variables = random_variables(jmod, x.shape, seed=11)
    var_map = tf_var_map(monkeypatch, jx_importer, variables)
    patch_both(monkeypatch, var_map)
    jx_params, jx_stats = jx_importer()
    # the import covers the model: every flax leaf comes from a TF name
    assert sorted(convert.flatten(jx_params)) == sorted(
        convert.flatten(variables["params"]))
    model = pt_model()
    model.load_state_dict(pt_imp.state_dict_for(pt_importer()), strict=True)
    model.eval()
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        {"params": jx_params, "batch_stats": jx_stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= bound


def test_state_dict_for_prefix():
    params = {"conv": {"kernel": np.ones((3, 3, 2, 4), np.float32),
                       "bias": np.zeros(4, np.float32)}}
    sd = pt_imp.state_dict_for(({"input_transform": params["conv"]}, {}))
    assert sd["input_transform.weight"].shape == (4, 2, 3, 3)
    sd = pt_imp.state_dict_for(({"a": params}, {}), prefix="backbone")
    assert sorted(sd) == ["backbone.a.conv.bias", "backbone.a.conv.weight"]
