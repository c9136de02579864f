"""The port's YOLOv2 anchor serving paths (``--v2``, ``--v2 --passthrough``)
against the JAX package, on the CPU in float32: config and anchors, the
anchor decode, the anchor decode+NMS (B2's plain version against
``decode_nms_pallas`` in interpret mode), the two anchor detectors and
the stride-downsample trunks against flax, and ``make_detect_fn``.

Tolerances:

- ``yolo_v2_config``, ``at_scale``, ``load_anchors``: exact (the same
  double arithmetic).
- ``decode_grid_v2``: scores rtol 1e-5, boxes atol 1e-6, classes exact
  (exp, sigmoid and softmax of two libraries differ by a few ulp).
- ``decode_nms_v2_plain`` against ``decode_nms_pallas``: the contract of
  ``tests/test_pallas_nms.py::_assert_equivalent``, scores rtol 1e-5 /
  atol 1e-6, kept boxes 1e-5, kept classes exact; the survivor of a
  planted exact score tie across two anchors is the same box.
- Detectors, unfolded and BN-folded: relative norm 1e-5.
- ``make_detect_fn``: as ``test_torch_port_detect.py``, kept scores rtol
  1e-4, kept boxes atol 1e-4, kept classes exact. It runs at 224²
  (S=7): XLA takes minutes to compile the interpreted Pallas kernel at
  S=2, 20 s at S=7.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.data import anchors as pt_anchors
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_torch.models import darknet as pt_darknet
from tensorflow_yolo2_torch.models.fold import fold_params as pt_fold
from tensorflow_yolo2_torch.ops import boxes as pt_boxes
from tensorflow_yolo2_torch.ops import cuda_decode
from tensorflow_yolo2_torch.ops.boxes import Detections
from tensorflow_yolo2_torch.ops.nms import nms_fixed
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.data import anchors as jx_anchors
from tensorflow_yolo2_tpu.entries import pascal_detect_darknet as jx_detect
from tensorflow_yolo2_tpu.models import darknet as jx_darknet
from tensorflow_yolo2_tpu.models.fold import fold_params as jx_fold
from tensorflow_yolo2_tpu.ops import boxes as jx_boxes
from tensorflow_yolo2_tpu.ops.pallas_decode import decode_nms_pallas
from tests.test_pallas_nms import _assert_equivalent
from tests.test_torch_port_models import rel_err, random_variables

K = 32
REL_TOL_DETECTOR = 1e-5
THRESH = 0.05


# -- config and anchors ------------------------------------------------------


@pytest.mark.parametrize("image_size", [224, 320, 416, 608])
def test_yolo_v2_config_matches_jax(image_size):
    got = pt_config.yolo_v2_config(image_size)
    want = jx_config.yolo_v2_config(image_size)
    assert (got.S, got.B, got.image_size, got.per_slot_classes,
            got.cell_channels) == (want.S, want.B, want.image_size,
                                   want.per_slot_classes,
                                   want.cell_channels)
    assert got.anchors == want.anchors
    custom = ((1, 2.5), (3.25, 4))
    assert pt_config.yolo_v2_config(image_size, custom).anchors == \
        jx_config.yolo_v2_config(image_size, custom).anchors
    assert pt_config.CLASSIC_VOC_ANCHORS == jx_config.CLASSIC_VOC_ANCHORS


@pytest.mark.parametrize("S", [7, 10, 13, 14, 19])
def test_at_scale_matches_jax(S):
    for size in (224, 416):
        got = pt_config.yolo_v2_config(size).at_scale(S)
        want = jx_config.yolo_v2_config(size).at_scale(S)
        assert (got.S, got.image_size, got.anchors) == \
            (want.S, want.image_size, want.anchors)
    direct = pt_config.yolo_v2_config(32 * S).anchors
    # from the 13-grid the priors are yolo_v2_config's bit for bit; from
    # another grid equal after the float32 rounding the decode uses
    assert pt_config.yolo_v2_config(416).at_scale(S).anchors == direct
    np.testing.assert_array_equal(
        np.float32(pt_config.yolo_v2_config(224).at_scale(S).anchors),
        np.float32(direct))


def test_load_anchors_matches_jax(tmp_path):
    assert pt_anchors.load_anchors(str(tmp_path), 13) is None
    assert pt_anchors.v2_config_for_snapshot(str(tmp_path), 416) == \
        pt_config.yolo_v2_config(416)
    assert pt_anchors.ANCHORS_FILE == jx_anchors.ANCHORS_FILE
    jx_anchors.save_anchors(str(tmp_path), ((0.7, 1.1), (2.3, 3.9),
                                            (5.5, 4.25)), S=7)
    assert json.loads((tmp_path / "anchors.json").read_text())["S"] == 7
    for S in (7, 13, 19):
        got = pt_anchors.load_anchors(str(tmp_path), S)
        assert got == jx_anchors.load_anchors(str(tmp_path), S)
        cfg = pt_anchors.v2_config_for_snapshot(str(tmp_path), 32 * S)
        assert cfg.anchors == got and cfg.B == 3
        assert cfg == pt_config.yolo_v2_config(32 * S, got)
    assert pt_anchors.v2_config_for_snapshot(None, 416) == \
        pt_config.yolo_v2_config(416)


# -- decode and decode+NMS ---------------------------------------------------


def cfgs(S):
    return pt_config.yolo_v2_config(32 * S), jx_config.yolo_v2_config(32 * S)


@pytest.mark.parametrize("S", [5, 7])
def test_decode_grid_v2_matches_jax(S):
    pcfg, jcfg = cfgs(S)
    rng = np.random.RandomState(S)
    net = rng.normal(0, 2.0, (3, S, S, pcfg.cell_channels)).astype(np.float32)
    # w, h logits that keep boxes below ~4 image widths, where atol 1e-6
    # is about 2 ulp; one pair beyond the −8 clip
    slots = net.reshape(3, S, S, 5, 25)
    slots[..., 2:4] = rng.normal(0, 0.5, slots[..., 2:4].shape)
    slots[0, 1, 1, 0, 2:4] = -9.5
    got = pt_boxes.decode_grid_v2(torch.from_numpy(net), pcfg, 0.3)
    want = jax.vmap(lambda g: jx_boxes.decode_grid_v2(g, jcfg, 0.3))(net)
    assert got.boxes.shape == (3, S * S * 5, 4)
    assert got.classes.dtype == torch.int32
    assert (got.scores > 0).sum() > 10
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    dets = pt_boxes.decode_to_detections(torch.from_numpy(net), pcfg, 0.3,
                                         v2=True)
    assert all(torch.equal(a, b) for a, b in zip(dets, got))


def nms_batch(cfg):
    """S=7 anchor grids, one an image: the planted ties of
    chip_smoke.synthetic_grid_v2, an all-zero grid (every score is
    σ(0)/20 < 0.5: nothing kept), and the duplicate-anchor grid of
    tests/test_pallas_nms.py::test_fused_nms_v2_suppresses_duplicates."""
    C = cfg.num_class
    net = np.zeros((3, cfg.S, cfg.S, cfg.cell_channels), np.float32)
    net[0] = chip_smoke.synthetic_grid_v2(cfg, batch=1, seed=3)[0]
    for b in (0, 1):
        base = b * (5 + C)
        aw, ah = cfg.anchors[b]
        net[2, 3, 3, base + 2] = np.log(0.3 * cfg.S / aw)
        net[2, 3, 3, base + 3] = np.log(0.3 * cfg.S / ah)
        net[2, 3, 3, base + 4] = 4.0 - b
        net[2, 3, 3, base + 5] = 5.0
    return net


@pytest.mark.parametrize("class_aware,k", [(True, K), (False, 8)])
def test_decode_nms_v2_matches_pallas(class_aware, k):
    pcfg, jcfg = cfgs(7)
    net = nms_batch(pcfg)
    got = cuda_decode.decode_nms_v2_plain(torch.from_numpy(net), pcfg, 0.5,
                                          0.5, k, class_aware)
    want = decode_nms_pallas(net, jcfg, 0.5, 0.5, max_outputs=k,
                             class_aware=class_aware)
    assert got.boxes.shape == (3, k, 4) and got.classes.dtype == torch.int32
    kept = (got.scores > 0).sum(1).tolist()
    assert kept[0] >= 5 and kept[1] == 0 and kept[2] == 1
    _assert_equivalent(got, want)


def test_decode_nms_v2_tie_order():
    """Of the tied class-4 boxes (2,3) slot 0 survives, the lower key;
    decode_grid_v2 + nms_fixed's cell-major order keeps (2,2) slot 1. The
    tied class-9 box survives only class-aware NMS."""
    pcfg, _ = cfgs(7)
    net = torch.from_numpy(chip_smoke.synthetic_grid_v2(pcfg, batch=1,
                                                        seed=3))
    dense = pt_boxes.decode_grid_v2(net[0], pcfg, 0.5)

    def box(y, x, b):
        return dense.boxes[(y * 7 + x) * 5 + b].tolist()

    def kept(dets):
        return dets.boxes[dets.scores > 0].tolist()

    for class_aware in (True, False):
        got = cuda_decode.decode_nms_v2_plain(net, pcfg, 0.5, 0.5, K,
                                              class_aware)
        got = kept(Detections(*(t[0] for t in got)))
        assert box(2, 3, 0) in got and box(2, 2, 1) not in got
        assert (box(3, 3, 2) in got) == class_aware
        assert box(2, 3, 3) not in got  # the duplicate in the same cell
    got = kept(nms_fixed(dense, 0.5, K))
    assert box(2, 2, 1) in got and box(2, 3, 0) not in got


def test_v2_wrapper_on_cpu_takes_the_plain_path():
    pcfg, _ = cfgs(7)
    net = torch.from_numpy(nms_batch(pcfg))
    cuda_decode.reset_launch_counts()
    got = cuda_decode.decode_nms_fused(net, pcfg, 0.5, 0.5, K, False)
    want = cuda_decode.decode_nms_v2_plain(net, pcfg, 0.5, 0.5, K, False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_decode.DECODE_NMS_V2_LAUNCHES == 0
    assert cuda_decode.DECODE_NMS_LAUNCHES == 0
    # without priors the anchors are (1, 1), as in decode_nms_pallas
    bare = pt_config.YoloConfig(S=7, B=5, per_slot_classes=True)
    np.testing.assert_array_equal(pt_boxes.anchor_tensor(bare, "cpu"),
                                  np.ones((5, 2), np.float32))


# -- detectors ---------------------------------------------------------------


HEADS = {  # name → (port model, flax model), output channels 125
    "v2p": (lambda **kw: pt_darknet.Darknet19DetectorV2(125, **kw),
            lambda **kw: jx_darknet.Darknet19DetectorV2(
                output_channels=125, **kw)),
    "v2": (lambda **kw: pt_darknet.Darknet19Detector(
        125, bn_on_output=False, **kw),
           lambda **kw: jx_darknet.Darknet19Detector(
               output_channels=125, bn_on_output=False, **kw)),
    "v1": (lambda **kw: pt_darknet.Darknet19Detector(125, **kw),
           lambda **kw: jx_darknet.Darknet19Detector(
               output_channels=125, **kw)),
}


def port_forward(model, state_dict, x):
    model.load_state_dict(state_dict)  # strict: every key maps
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("head", ["v2p", "v2"])
def test_anchor_detector_matches_flax(head):
    make_pt, make_jx = HEADS[head]
    x = np.random.RandomState(21).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    variables = random_variables(make_jx(), x.shape, seed=22)
    want = np.asarray(make_jx().apply(variables, jnp.asarray(x),
                                      train=False))
    sd = convert.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    if head == "v2p":
        assert sd["detection.passthrough.conv.weight"].shape == (64, 512, 1,
                                                                 1)
        assert sd["detection.conv3.conv.weight"].shape[1] == 1280
    assert "detection.output.bn.weight" not in sd
    got = port_forward(make_pt(), sd, x)
    assert got.shape == want.shape == (2, 2, 2, 125)
    assert rel_err(got, want) <= REL_TOL_DETECTOR

    folded = port_forward(make_pt(fold_bn=True), pt_fold(sd), x)
    jfolded = jx_fold(variables["params"], variables["batch_stats"])
    want_folded = np.asarray(make_jx(fold_bn=True).apply(
        {"params": jfolded}, jnp.asarray(x), train=False))
    assert rel_err(folded, want_folded) <= REL_TOL_DETECTOR
    assert rel_err(folded, want) <= REL_TOL_DETECTOR


@pytest.mark.parametrize("head", ["v1", "v2", "v2p"])
def test_stride_downsample_matches_flax(head):
    make_pt, make_jx = HEADS[head]
    x = np.random.RandomState(23).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jmod = make_jx(downsample="stride")
    variables = random_variables(jmod, x.shape, seed=24)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    got = port_forward(make_pt(downsample="stride"),
                       convert.state_dict_from_flax(
                           variables["params"], variables["batch_stats"]),
                       x)
    assert got.shape == want.shape == (2, 2, 2, 125)
    assert rel_err(got, want) <= REL_TOL_DETECTOR


# -- the serving entry point ---------------------------------------------------


@pytest.fixture(scope="module")
def v2_weights():
    """Seeded flax weights of both anchor heads. The output conv's kernel
    is scaled by 0.1, so that its logits stay near the biases as a
    trained head's do (He-normal weights give w, h logits at the ±8 clip),
    and its biases moved so that only the slots of the two largest
    anchors are confident (conf logit +2 and class-0 logit +3 there, conf
    logit −3 elsewhere): these boxes, half the image wide and more,
    overlap and NMS suppresses most."""
    out = {}
    for head in ("v2p", "v2"):
        v = random_variables(HEADS[head][1](), (1, 64, 64, 3), seed=31)
        conv = v["params"]["detection"]["output"]["conv"]
        conv["kernel"] *= 0.1
        conv["bias"].reshape(5, 25)[:3, 4] -= 3.0
        conv["bias"].reshape(5, 25)[3:, 4] += 2.0
        conv["bias"].reshape(5, 25)[3:, 5] += 3.0
        out[head] = (v["params"], v["batch_stats"])
    return out


def images(uint8: bool, size: int = 224) -> np.ndarray:
    rng = np.random.RandomState(32)
    if uint8:
        return rng.randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    return rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("head,use_nms,uint8", [
    ("v2p", True, True), ("v2p", False, False),
    ("v2", True, False), ("v2", False, True)])
def test_detect_v2_matches_jax(v2_weights, head, use_nms, uint8):
    params, stats = v2_weights[head]
    pcfg, jcfg = cfgs(7)
    x = images(uint8)
    passthrough = head == "v2p"
    got = pt_detect.make_detect_fn(
        pcfg, params, stats, THRESH, use_nms, dtype=torch.float32,
        device="cpu", v2=True, passthrough=passthrough)(x)
    want = jx_detect.make_detect_fn(
        jcfg, params, stats, THRESH, use_nms, dtype=jnp.float32, v2=True,
        passthrough=passthrough)(jnp.asarray(x))
    n = K if use_nms else 7 * 7 * 5
    assert got.boxes.shape == (2, n, 4) and got.scores.shape == (2, n)
    want_s = np.asarray(want.scores)
    kept = want_s > 0
    assert kept.sum() >= 8
    if use_nms:  # fewer than K survive: the sweep suppressed boxes
        assert (kept.sum(1) < K).all()
    np.testing.assert_allclose(got.scores.numpy(), want_s, rtol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[kept],
                               np.asarray(want.boxes)[kept], atol=1e-4)
    np.testing.assert_array_equal(got.classes.numpy()[kept],
                                  np.asarray(want.classes)[kept])


def test_detect_rejects_inconsistent_heads(v2_weights):
    params, stats = v2_weights["v2p"]
    pcfg, _ = cfgs(2)
    with pytest.raises(ValueError, match="per_slot_classes"):
        pt_detect.make_detect_fn(pcfg, params, stats, device="cpu")
    with pytest.raises(ValueError, match="requires v2"):
        pt_detect.make_detect_fn(pt_config.YoloConfig(S=2, image_size=64),
                                 params, stats, device="cpu",
                                 passthrough=True)


def test_cli_serves_v2p_with_stored_anchors(v2_weights, tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    params, stats = v2_weights["v2p"]
    image = str(tmp_path / "in.png")
    cv2.imwrite(image, images(True, 64)[0])
    npz = str(tmp_path / "w.npz")
    convert.save_npz(npz, params, stats)
    args = [image, "--weights", npz, "--image-size", "64", "--threshold",
            str(THRESH), "--nms", "--v2", "--passthrough", "--device", "cpu",
            "--out", str(tmp_path / "out.png")]
    assert pt_detect.main(args) == 0
    assert "classic VOC priors" in capsys.readouterr().out
    jx_anchors.save_anchors(str(tmp_path), ((1.0, 1.5),) * 5, S=13)
    assert pt_detect.main(args) == 0
    assert str(tmp_path / "anchors.json") in capsys.readouterr().out
    # drawn by matplotlib, as the JAX package draws (utils.visualize)
    with Image.open(str(tmp_path / "out.png")) as drawn:
        assert drawn.format == "PNG" and min(drawn.size) > 0
        assert "matplotlib" in drawn.info.get("Software", "")
