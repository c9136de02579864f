"""The port's serving entry point (``make_detect_fn``) against the JAX
package's, end to end on the CPU in float32 at 64² (S=2): same seeded
weights (a flax tree of numpy arrays), same images, NMS on and off, float
and uint8 input.

Contract: kept-slot scores to rtol 1e-4 (the grids agree to ~2e-6 in
relative norm, see test_torch_port_models.py), boxes on kept slots to
atol 1e-4, classes exactly; the threshold is 0.05 so most slots are kept
and the NMS sweep fires.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.entries import pascal_detect_darknet as jx_detect
from tensorflow_yolo2_tpu.models.darknet import Darknet19Detector
from tests.test_torch_port_models import random_variables

THRESH = 0.05
PCFG = pt_config.YoloConfig(S=2, image_size=64)
JCFG = jx_config.YoloConfig(S=2, image_size=64)


@pytest.fixture(scope="module")
def weights():
    v = random_variables(Darknet19Detector(output_channels=30),
                         (1, 64, 64, 3), seed=11)
    # shift the output BN's offsets so that most slots are confident
    # (channels 20-21) and boxes are large (the w, h roots 24-25, 28-29)
    # and overlap: NMS then has boxes to suppress
    beta = v["params"]["detection"]["output"]["bn"]["bias"]
    beta[20:22] += 0.6
    beta[[24, 25, 28, 29]] += 1.5
    return v["params"], v["batch_stats"]


def images(uint8: bool) -> np.ndarray:
    rng = np.random.RandomState(12)
    if uint8:
        return rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    return rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("use_nms,uint8", [(True, True), (False, False)])
def test_detect_matches_jax(weights, use_nms, uint8):
    params, stats = weights
    x = images(uint8)
    got = pt_detect.make_detect_fn(PCFG, params, stats, THRESH, use_nms,
                                   dtype=torch.float32, device="cpu")(x)
    want = jx_detect.make_detect_fn(JCFG, params, stats, THRESH, use_nms,
                                    dtype=jnp.float32)(jnp.asarray(x))
    n = 32 if use_nms else 2 * 2 * 2
    assert got.boxes.shape == (2, n, 4) and got.scores.shape == (2, n)
    want_s = np.asarray(want.scores)
    kept = want_s > 0
    assert kept.sum() >= 4
    if use_nms:  # the sweep suppressed some of the 2·8 decoded slots
        assert kept.sum() < 2 * 8
    np.testing.assert_allclose(got.scores.numpy(), want_s, rtol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[kept],
                               np.asarray(want.boxes)[kept], atol=1e-4)
    np.testing.assert_array_equal(got.classes.numpy()[kept],
                                  np.asarray(want.classes)[kept])


def test_state_dict_and_unfolded_serving_agree(weights):
    """A port state dict serves like the flax tree it came from, and the
    unfolded model like the folded one."""
    params, stats = weights
    x = images(False)
    sd = convert.state_dict_from_flax(params, stats)
    outs = [pt_detect.make_detect_fn(PCFG, w, s, THRESH, use_nms=False,
                                     fold_bn=fold, dtype=torch.float32,
                                     device="cpu")(x)
            for w, s, fold in ((params, stats, True), (sd, None, True),
                               (params, stats, False))]
    for out in outs[1:]:
        np.testing.assert_allclose(out.scores.numpy(),
                                   outs[0].scores.numpy(), rtol=1e-4)


def test_default_device_is_cuda(weights):
    params, stats = weights
    if torch.cuda.is_available():
        detect = pt_detect.make_detect_fn(PCFG, params, stats, THRESH,
                                          dtype=torch.float32)
        assert detect(images(True)).scores.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt_detect.make_detect_fn(PCFG, params, stats)


@pytest.mark.parametrize("option", ["int8", "pallas_stem"])
def test_unported_options_raise(weights, option):
    """int8 serving without calibration images is refused, as the JAX
    package refuses it; with pallas_stem the pair is refused first, as a
    combination."""
    params, stats = weights
    error, match = ((ValueError, "calib_images")
                    if option == "int8" else (ValueError, "no int8"))
    with pytest.raises(error, match=match):
        pt_detect.make_detect_fn(PCFG, params, stats, device="cpu",
                                 **{"int8": True, option: True})


def test_cli_draws_detections(weights, tmp_path):
    cv2 = pytest.importorskip("cv2")
    params, stats = weights
    image = str(tmp_path / "in.png")
    cv2.imwrite(image, images(True)[0])
    npz = str(tmp_path / "w.npz")
    convert.save_npz(npz, params, stats)
    out = str(tmp_path / "out.png")
    assert pt_detect.main([image, "--weights", npz, "--image-size", "64",
                           "--threshold", str(THRESH), "--nms", "--out", out,
                           "--device", "cpu"]) == 0
    # drawn by matplotlib, as the JAX package draws (utils.visualize)
    with Image.open(out) as drawn:
        assert drawn.format == "PNG" and min(drawn.size) > 0
        assert "matplotlib" in drawn.info.get("Software", "")
