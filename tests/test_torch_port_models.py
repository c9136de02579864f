"""The PyTorch port's layers, Darknet19 detector, BN fold and weight bridge
against the JAX package, on the same seeded weights and inputs (CPU,
float32).

Tolerances: single layers agree to rtol 1e-5 / atol 1e-5 (float32 convs
summed in another order); the 22-conv detector to a relative-norm error
of 1e-5, five times the ~2e-6 measured;
pools, leaky and space-to-depth select or move values and are exact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.models import darknet as pt_darknet
from tensorflow_yolo2_torch.models import layers as pt_layers
from tensorflow_yolo2_torch.models.fold import fold_params as pt_fold
from tensorflow_yolo2_tpu.models import darknet as jx_darknet
from tensorflow_yolo2_tpu.models import layers as jx_layers
from tensorflow_yolo2_tpu.models.fold import fold_params as jx_fold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL_DETECTOR = 1e-5


def random_variables(module, x_shape, seed):
    """Seeded numpy weights in the shape of ``module``'s flax variables:
    He-normal kernels, small conv biases, BN affine terms and statistics
    away from the identity."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        layer, name = path[-2].key, path[-1].key
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        elif layer == "conv":  # conv bias
            v = rng.normal(0, 0.05, shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:  # BN bias, mean
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(1).normal(0, 1, (4, 33)).astype(np.float32)
    np.testing.assert_array_equal(
        pt_layers.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(jx_layers.leaky_relu(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_leaky_relu_bits_match_jax(dtype):
    """Bit for bit on 2**16 seeded N(0, 4²) values. In bf16 alpha is
    rounded to 0.10009765625 before the product, as JAX rounds its
    weak-typed 0.1; a float32 0.1 put 6805 of these values one bf16 ulp
    off. float32 is unchanged."""
    x = np.random.RandomState(12).normal(0, 4, 2 ** 16).astype(np.float32)
    got = pt_layers.leaky_relu(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = np.asarray(jx_layers.leaky_relu(
        jnp.asarray(x).astype(getattr(jnp, dtype))))
    bits = (torch.int16, np.int16) if dtype == "bfloat16" else \
        (torch.int32, np.int32)
    np.testing.assert_array_equal(got.view(bits[0]).numpy(),
                                  want.view(bits[1]))


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(2).normal(0, 1, (2, 6, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pt_layers.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jx_layers.space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_max_pool_matches_jax(hw):
    x = np.random.RandomState(3).normal(0, 1, (2, *hw, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(pt_layers.max_pool(nchw(x))),
        np.asarray(jx_layers.max_pool(jnp.asarray(x))))


@pytest.mark.parametrize("kernel_size,use_bn,activate",
                         [(3, True, True), (1, True, True), (3, False, True),
                          (1, False, False)])
def test_conv_bn_matches_jax(kernel_size, use_bn, activate):
    x = np.random.RandomState(4).normal(0, 1, (2, 6, 6, 4)).astype(np.float32)
    jmod = jx_layers.ConvBN(7, kernel_size=kernel_size, use_bn=use_bn,
                            activate=activate)
    variables = random_variables(jmod, x.shape, seed=5)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))

    pmod = pt_layers.ConvBN(4, 7, kernel_size, use_bn=use_bn,
                            activate=activate).eval()
    pmod.load_state_dict(convert.state_dict_from_flax(
        variables["params"], variables.get("batch_stats")))
    with torch.no_grad():
        got = nhwc(pmod(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def detector():
    """Seeded unfolded detector weights, a 64² batch of 2, and the JAX
    model's output on it."""
    x = np.random.RandomState(6).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jmod = jx_darknet.Darknet19Detector(output_channels=30)
    variables = random_variables(jmod, x.shape, seed=7)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    return x, variables, want


def _port_forward(state_dict, x, fold_bn):
    model = pt_darknet.Darknet19Detector(output_channels=30, fold_bn=fold_bn)
    model.load_state_dict(state_dict)
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_detector_matches_jax(detector):
    x, variables, want = detector
    sd = convert.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    got = _port_forward(sd, x, fold_bn=False)
    assert got.shape == want.shape == (2, 2, 2, 30)
    assert got.dtype == np.float32
    assert rel_err(got, want) <= REL_TOL_DETECTOR


def test_folded_detector_matches_unfolded_and_jax(detector):
    x, variables, want = detector
    sd = convert.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    folded = _port_forward(pt_fold(sd), x, fold_bn=True)
    assert rel_err(folded, _port_forward(sd, x, fold_bn=False)) \
        <= REL_TOL_DETECTOR

    jfolded = jx_fold(variables["params"], variables["batch_stats"])
    jmod = jx_darknet.Darknet19Detector(output_channels=30, fold_bn=True)
    want_folded = np.asarray(jmod.apply({"params": jfolded},
                                        jnp.asarray(x), train=False))
    assert rel_err(folded, want_folded) <= REL_TOL_DETECTOR
    assert rel_err(folded, want) <= REL_TOL_DETECTOR


def test_folded_bf16_detector_matches_flax(detector):
    """The folded detector served in bf16 (``build_detector``'s cast) at
    64² against flax's bf16 forward of the same folded weights (float32
    parameters cast in each conv), relative norm. The two round their
    float32 conv sums, summed in another order, to bf16 at each of 22
    layers: measured 7.1e-3 (7.3e-3 with a float32 leaky slope), about
    what each is from the float32 forward (flax 7.4e-3, the port 6.4e-3);
    bound 1.5e-2."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        build_detector,
    )

    x, variables, _ = detector
    jfolded = jx_fold(variables["params"], variables["batch_stats"])
    want = np.asarray(jx_darknet.Darknet19Detector(
        output_channels=30, fold_bn=True, dtype=jnp.bfloat16).apply(
        {"params": jfolded}, jnp.asarray(x).astype(jnp.bfloat16),
        train=False))
    model = build_detector(YoloConfig(S=2, image_size=64),
                           convert.state_dict_from_flax(
                               variables["params"], variables["batch_stats"]),
                           dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16())
    assert got.shape == want.shape == (2, 2, 2, 30)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert rel_err(got.numpy(), want) <= 1.5e-2


def test_fold_params_matches_jax(detector):
    _, variables, _ = detector
    got = pt_fold(convert.state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]))
    want = convert.state_dict_from_flax(
        jax.device_get(jx_fold(variables["params"],
                               variables["batch_stats"])))
    assert got.keys() == want.keys()
    assert not any(".bn." in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_npz_round_trip(detector, tmp_path):
    _, variables, _ = detector
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, variables["params"], variables["batch_stats"])
    params, stats = convert.load_npz(path)
    for tree, ref in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        flat, flat_ref = convert.flatten(tree), convert.flatten(ref)
        assert flat.keys() == flat_ref.keys()
        for k in flat_ref:
            np.testing.assert_array_equal(flat[k], flat_ref[k])
    model = pt_darknet.Darknet19Detector(output_channels=30)
    model.load_state_dict(convert.state_dict_from_flax(params, stats))


def test_converter_rejects_unknown_leaves():
    with pytest.raises(ValueError, match="unknown params leaf"):
        convert.state_dict_from_flax({"dense": {"fc": {"kernel": np.ones(2)}}})


def test_stride_downsample_not_ported():
    """``downsample`` takes "pool" and "stride" (held to flax in
    test_torch_port_v2.py); any other value is not a trunk and raises."""
    pt_darknet.Darknet19Detector(downsample="stride")
    with pytest.raises(ValueError, match="downsample"):
        pt_darknet.Darknet19Detector(downsample="avg")


def test_randomize_is_seeded():
    def make(seed):
        m = pt_darknet.DetectionHead(output_channels=30, in_channels=8)
        return pt_darknet.randomize_(m, torch.Generator().manual_seed(seed))

    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.conv.weight"], c["conv1.conv.weight"])
    assert a["conv1.bn.running_var"].min() >= 0.5


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports without JAX
    and without TensorFlow (the port reads TF checkpoints in numpy)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tensorflow_yolo2_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'orbax', 'tensorflow_yolo2_tpu',\n"
        "        'tensorflow')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('tensorflow_yolo2_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14
