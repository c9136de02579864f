"""Int8 for the Darknet19 classifier (``ops/quant.py``, ``head=
"classifier"``) against the JAX package on the CPU at 64² (a 2×2 class
map, 10 classes), and the port's uint8 calibration (``quantize_detector``
on a uint8 batch) against its host-normalized one and against JAX's.

Each JAX function runs in the mode its entry point runs it in:
``calibrate`` jitted (it is ``jax.jit``-decorated), ``quantize_folded``
eager, ``forward_int8_classifier`` jitted (``imagenet_test_darknet``'s
``_int8_step``).

Tolerances:
- ``calibrate``: each scale within 1e-5 relative of JAX's (float32 convs
  summed in other orders; measured 1.2e-6).
- ``quantize_folded`` from the same folded weights and scales: equal, bit
  for bit.
- ``forward_int8_classifier``: each logit within one quantization level
  of ``conv19``'s output, ``127·scale[o]`` (the largest int8 weight times
  the channel's dequantize factor), of JAX's: JAX's jitted epilogue fuses
  acc·scale + bias into one rounding, so a requantized activation at a .5
  tie can land one level off. Layer by layer at 64² (each conv fed JAX's
  int8 input): int32 sums equal, requantized int8 within one level and
  ≥ 99.9% equal; the whole chain at 32² (see
  ``test_forward_int8_classifier_whole_chain`` for why not at 64²).
- uint8 calibration: the port's layers from a uint8 batch equal, bit for
  bit, its layers from the same batch normalized on the host; against
  JAX's ``quantize_detector`` on the normalized batch, kernels bit-equal,
  biases and scales within 1e-5 relative (each package folds BN itself:
  biases 1 ulp apart). (JAX calibrates a uint8 batch
  unnormalized: its input scale is then above 1, so every normalized
  input rounds to 0. The port normalizes first: README, "uint8
  calibration".)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_torch.ops import quant as pq
from tensorflow_yolo2_tpu.data.augment import normalize
from tensorflow_yolo2_tpu.entries import pascal_detect_darknet as jx_detect
from tensorflow_yolo2_tpu.models.darknet import (
    Darknet19Classifier,
    Darknet19Detector,
)
from tensorflow_yolo2_tpu.models.fold import fold_params
from tensorflow_yolo2_tpu.ops import quant as jq
from tests.test_torch_port_int8 import jax_trace, trace_steps
from tests.test_torch_port_models import random_variables

SIZE = 64
NUM_CLASSES = 10
SCALE_REL_TOL = 1e-5


def images(seed: int, n: int = 3) -> np.ndarray:
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def classifier():
    """Seeded classifier weights, folded (jitted) and as the port's state
    dict; JAX's scales on ``images(0)`` and JAX's layers."""
    v = random_variables(Darknet19Classifier(num_classes=NUM_CLASSES),
                         (1, SIZE, SIZE, 3), seed=6)
    folded = jax.tree_util.tree_map(
        np.asarray, jax.jit(fold_params)(v["params"], v["batch_stats"]))
    scales = np.asarray(jq.calibrate(folded, jnp.asarray(images(0)),
                                     head="classifier"))
    jlayers = jq.quantize_folded(folded, scales, head="classifier")
    return {"folded": folded, "state": convert.state_dict_from_flax(folded),
            "scales": scales, "jlayers": jlayers}


def _port_layers(classifier):
    return tuple({k: torch.from_numpy(np.array(layer[k])) for k in pq.KEYS}
                 for layer in classifier["jlayers"])


def _level(layers):
    """One quantization level of conv19's output, a channel: the largest
    int8 weight times its dequantize factor."""
    return 127 * layers[-1]["scale"].numpy()


def test_calibrate_classifier_matches_jax(classifier):
    got = pq.calibrate(classifier["state"], torch.from_numpy(images(0)),
                       head="classifier").numpy()
    want = classifier["scales"]
    assert got.shape == want.shape == (19,)
    np.testing.assert_allclose(got, want, rtol=SCALE_REL_TOL, atol=0)


def test_quantize_folded_classifier_matches_jax(classifier):
    got = pq.quantize_folded(classifier["state"],
                             torch.tensor(classifier["scales"]),
                             head="classifier")
    assert len(got) == len(classifier["jlayers"]) == 19
    assert got[-1]["kernel"].shape == (1, 1, 1024, NUM_CLASSES)
    for mine, theirs in zip(got, classifier["jlayers"]):
        for k in pq.KEYS:
            want = np.asarray(theirs[k])
            assert mine[k].numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(mine[k].numpy(), want, err_msg=k)


def test_forward_int8_classifier_layer_by_layer(classifier):
    """At 64², each conv fed JAX's int8 input (JAX's jitted forward, step
    by step): the int32 sums equal JAX's, the requantized int8 within one
    level, ≥ 99.9% equal; conv19's float32 map to 1e-6, and its mean, the
    logits, within one level of JAX's."""
    jl = classifier["jlayers"]
    layers = _port_layers(classifier)
    x = images(1)
    arrays = jax_trace(jl, x, False, "classifier")
    steps = trace_steps(False, "classifier")
    assert len(steps) == len(arrays) == 19
    equal = total = 0
    for (ci, activated, nxt), (x_in, acc, out) in zip(steps, arrays):
        got = pq.conv_int8(torch.from_numpy(np.array(x_in)), layers[ci])
        np.testing.assert_array_equal(got.numpy(), np.asarray(acc),
                                      err_msg=f"conv {ci}")
        y = pq.dequantize(got, layers[ci], activated)
        if nxt is None:
            assert y.shape == (3, 2, 2, NUM_CLASSES)
            np.testing.assert_allclose(y.numpy(), np.asarray(out),
                                       rtol=1e-6, atol=1e-6)
            logits = y.mean(dim=(1, 2)).numpy()
            want = np.asarray(jnp.mean(out, axis=(1, 2)))
            assert np.all(np.abs(logits - want) <= _level(layers))
            continue
        q = pq.quantize_act(y, layers[nxt]["inv_in"]).numpy().astype(int)
        want = np.asarray(out).astype(int)
        assert np.abs(q - want).max() <= 1, f"conv {ci}"
        equal += int((q == want).sum())
        total += q.size
    assert equal >= 0.999 * total


def test_forward_int8_classifier_whole_chain(classifier):
    """The whole chain against JAX's jitted ``forward_int8_classifier``:
    at 32² (one class-map cell) every logit within one level (measured
    ≤ 2e-5 of a level). At 64² a requantized value at a .5 tie that the
    two epilogues round apart moves the later layers' sums, and the flips
    spread: two of three seeded batches there differ by up to 4.4 levels
    (1.2% relative norm), so 64² is held layer by layer (above). The
    logits are the float32 mean of the class map; uint8 images are
    normalized on their device first."""
    layers = _port_layers(classifier)
    forward = jax.jit(jq.forward_int8_classifier)
    for seed in (1, 2, 3):
        x = np.random.RandomState(seed).uniform(
            -1, 1, (3, 32, 32, 3)).astype(np.float32)
        want = np.asarray(forward(classifier["jlayers"], jnp.asarray(x)))
        got = pq.forward_int8_classifier(layers, torch.from_numpy(x))
        assert got.shape == want.shape == (3, NUM_CLASSES)
        assert got.dtype == torch.float32
        assert np.all(np.abs(got.numpy() - want) <= _level(layers))
    x = torch.from_numpy(images(2))
    class_map = pq.forward_int8(layers, x, head="classifier")
    assert class_map.shape == (3, 2, 2, NUM_CLASSES)
    assert torch.equal(pq.forward_int8_classifier(layers, x),
                       class_map.mean(dim=(1, 2)))
    u8 = np.random.RandomState(3).randint(0, 256, (2, SIZE, SIZE, 3)
                                          ).astype(np.uint8)
    assert torch.equal(
        pq.forward_int8_classifier(layers, torch.from_numpy(u8)),
        pq.forward_int8_classifier(layers, torch.from_numpy(normalize(u8))))


# -- C3: calibration on a uint8 batch -----------------------------------------


@functools.cache
def _detector_variables():
    return random_variables(Darknet19Detector(output_channels=30),
                            (1, SIZE, SIZE, 3), seed=8)


def test_quantize_detector_uint8_calibration():
    """The port's ``quantize_detector`` on a uint8 batch = on the batch
    normalized on the host, bit for bit = JAX's ``quantize_detector`` on
    the normalized batch (kernels and biases bit for bit, scales to
    1e-6). JAX's on the uint8 batch itself calibrates the raw bytes: an
    input scale above 1."""
    v = _detector_variables()
    u8 = np.random.RandomState(9).randint(0, 256, (2, SIZE, SIZE, 3)
                                          ).astype(np.uint8)
    host = normalize(u8)
    from_u8 = pt_detect.quantize_detector(v["params"], v["batch_stats"], u8,
                                          device="cpu")
    from_host = pt_detect.quantize_detector(v["params"], v["batch_stats"],
                                            host, device="cpu")
    want = jx_detect.quantize_detector(v["params"], v["batch_stats"], host)
    assert len(from_u8) == len(from_host) == len(want) == 22
    for a, b, c in zip(from_u8, from_host, want):
        for k in pq.KEYS:
            assert torch.equal(a[k], b[k]), k
            c_k = np.asarray(c[k])
            if k == "kernel":
                np.testing.assert_array_equal(a[k].numpy(), c_k)
            else:  # BN folded in each package: biases 1 ulp apart
                np.testing.assert_allclose(a[k].numpy(), c_k,
                                           rtol=SCALE_REL_TOL, err_msg=k)
    raw = jx_detect.quantize_detector(v["params"], v["batch_stats"], u8)
    assert 1.0 / float(raw[0]["inv_in"]) > 1.0  # 255/127: inputs round to 0
    assert 1.0 / float(from_u8[0]["inv_in"]) <= 1.0 / 127
