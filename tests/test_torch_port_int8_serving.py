"""The port's int8 serving entry points against the JAX package's on the
CPU: ``make_detect_fn(int8=True)`` at 32² (S=1), its refusals, the detect
CLI's ``--int8`` / ``--int8-export`` / ``--int8-weights`` and
``pascal_eval_map --int8`` at 64². (``ops/quant.py`` itself:
tests/test_torch_port_int8.py.)

Tolerances: given JAX's scales, ``make_detect_fn(int8=True)``'s dense
scores and kept boxes within 1e-5 (the decodes' float32 arithmetic),
classes equal; each package calibrating on its own, within 1e-2 (scales
~1e-6 apart flip a few .5 ties in a requantize, which later layers carry:
measured 2.5e-3 on v2p's boxes). The CLI's ``--int8-weights`` serves the
boxes of the run that exported the artifact, exactly.

No test here needs a compiler: where the native library did not build,
the CLI reads through cv2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_torch.entries import pascal_eval_map as pt_eval
from tensorflow_yolo2_torch.ops import quant as pq
from tensorflow_yolo2_tpu import config as jx_config
from tensorflow_yolo2_tpu.entries import pascal_detect_darknet as jx_detect
from tensorflow_yolo2_tpu.models.fold import fold_params
from tensorflow_yolo2_tpu.ops import quant as jq
from tests import synthetic
from tests.test_torch_port_int8 import HEADS, IMG, images, variables

SELF_CALIB_TOL = 1e-2


@pytest.mark.parametrize("name", ["v1", "v2p"])
def test_make_detect_fn_int8_matches_jax(name, monkeypatch):
    """``make_detect_fn(int8=True)`` folds, calibrates, quantizes and serves
    as the JAX package's does (S=1, threshold 0, as tests/test_quant.py
    runs it): the dense detections, first with JAX's scales handed to the
    port's calibration, then with each package calibrating on its own.
    (With NMS the interpreted Pallas decode compiles for minutes on
    XLA:CPU for v2p; the NMS of a grid is the path's ``decode``,
    held to JAX's in tests/test_torch_port_decode.py and
    tests/test_torch_port_v2.py. The plain ``--v2`` head's chain is held
    to JAX's in tests/test_torch_port_int8.py.)"""
    _, v2, plan_head = HEADS[name]
    v = variables(name, 8)
    if not v2:  # confident slots: the v1 output BN's conf offsets
        v["params"]["detection"]["output"]["bn"]["bias"][20:22] += 1.0
    kw = {"object_thresh": 0.0, "use_nms": False, "v2": v2,
          "passthrough": name == "v2p", "int8": True}
    x = images(seed=9)
    jcfg = (jx_config.yolo_v2_config(IMG) if v2
            else jx_config.YoloConfig(S=1, image_size=IMG))
    pcfg = (pt_config.yolo_v2_config(IMG) if v2
            else pt_config.YoloConfig(S=1, image_size=IMG))
    want = jx_detect.make_detect_fn(jcfg, v["params"], v["batch_stats"],
                                    calib_images=jnp.asarray(x), **kw)(
        jnp.asarray(x))
    scores = np.asarray(want.scores)
    kept = scores > 0
    assert kept.any()
    jax_scales = jq.calibrate(fold_params(v["params"], v["batch_stats"]),
                              jnp.asarray(x), v2=v2, head=plan_head)
    for tol, own in ((1e-5, False), (SELF_CALIB_TOL, True)):
        with monkeypatch.context() as m:
            if not own:
                m.setattr(pq, "calibrate", lambda *a, **k: torch.from_numpy(
                    np.array(jax_scales)))
            got = pt_detect.make_detect_fn(pcfg, v["params"],
                                           v["batch_stats"], calib_images=x,
                                           device="cpu", **kw)(x)
        assert got.boxes.shape == tuple(want.boxes.shape)
        np.testing.assert_allclose(got.scores.numpy(), scores, atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(got.boxes.numpy()[kept],
                                   np.asarray(want.boxes)[kept], atol=tol,
                                   rtol=tol)
        if not own:
            np.testing.assert_array_equal(got.classes.numpy()[kept],
                                          np.asarray(want.classes)[kept])


@pytest.mark.parametrize("kw,error,match", [
    ({}, ValueError, "calib_images"),
    ({"calib_images": images(), "fold_bn": False}, ValueError,
     "fold_bn=True"),
    ({"calib_images": images(), "downsample": "stride"}, ValueError,
     "pool-based"),
    ({"calib_images": images(), "pallas_stem": True}, ValueError,
     "no int8"),
])
def test_make_detect_fn_int8_refusals(kw, error, match):
    v = variables("v1", 8)
    with pytest.raises(error, match=match):
        pt_detect.make_detect_fn(pt_config.YoloConfig(S=1, image_size=IMG),
                                 v["params"], v["batch_stats"], int8=True,
                                 device="cpu", **kw)


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A 64² v1 detector's weights (shifted so boxes are kept) as an
    ``.npz``, and a PNG to serve."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("int8_cli")
    v = variables("v1", 11, 64)
    beta = v["params"]["detection"]["output"]["bn"]["bias"]
    beta[20:22] += 0.6
    beta[[24, 25, 28, 29]] += 1.5
    npz = str(d / "w.npz")
    convert.save_npz(npz, v["params"], v["batch_stats"])
    image = str(d / "in.png")
    cv2.imwrite(image, np.random.RandomState(12).randint(
        0, 256, (80, 96, 3)).astype(np.uint8))
    return {"dir": d, "npz": npz, "image": image}


def run_cli(argv, monkeypatch) -> tuple[np.ndarray, ...]:
    """The detect CLI on the CPU; what it would draw."""
    drawn = []

    def draw(path, boxes, scores, classes, class_names, out_path):
        drawn.append((boxes, scores, classes))
        return out_path

    monkeypatch.setattr(pt_detect, "draw_detections", draw)
    assert pt_detect.main(argv + ["--device", "cpu"]) == 0
    return drawn[0]


def test_cli_int8_export_then_int8_weights(cli_files, monkeypatch, capsys):
    """``--int8 --int8-export`` then ``--int8-weights`` give the same boxes;
    the artifact carries the run's meta and JAX's format."""
    art = str(cli_files["dir"] / "int8.npz")
    base = [cli_files["image"], "--image-size", "64", "--threshold", "0.05",
            "--nms"]
    first = run_cli(base + ["--weights", cli_files["npz"], "--int8",
                            "--int8-export", art], monkeypatch)
    assert f"Exported int8 artifact to {art}" in capsys.readouterr().out
    again = run_cli(base + ["--int8-weights", art], monkeypatch)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert (first[1] > 0).sum() > 0
    layers, meta = jq.load_quantized(art)
    assert meta == {"v2": False, "passthrough": False, "image_size": 64}
    assert len(layers) == 22 and layers[0]["kernel"].dtype == jnp.int8
    with pytest.raises(SystemExit):
        run_cli(base[:2] + ["96", "--int8-weights", art], monkeypatch)
    assert "quantized with image_size=64, run requests 96" in \
        capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--weights", "w.npz", "--int8-export", "a.npz"], "requires --int8"),
    (["--int8-weights", "a.npz", "--int8"], "already serves"),
    (["--int8-weights", "a.npz", "--weights", "w.npz"], "would be ignored"),
    ([], "--weights NPZ is required"),
    (["--weights", "w.npz", "--int8", "--no-fold-bn"], "drop --no-fold-bn"),
    (["--weights", "w.npz", "--int8", "--downsample", "stride"],
     "stride variant"),
    (["--int8-weights", "a.npz", "--pallas-stem"], "not int8"),
    (["--weights", "w.npz", "--tf-checkpoint", "x"], "both name the weights"),
    (["--weights", "w.npz", "--spatial", "1"], "needs N >= 2"),
    (["--weights", "w.npz", "--spatial", "2", "--int8"],
     "--spatial serves the folded f32/bf16 chain"),
])
def test_cli_refuses(argv, match, capsys):
    with pytest.raises(SystemExit):
        pt_detect.main(["in.png"] + argv + ["--device", "cpu"])
    assert match in capsys.readouterr().err


def test_cli_int8_needs_batch_stats(cli_files, tmp_path, capsys):
    params, _ = convert.load_npz(cli_files["npz"])
    npz = str(tmp_path / "no_stats.npz")
    convert.save_npz(npz, params, {})
    with pytest.raises(SystemExit):
        pt_detect.main([cli_files["image"], "--weights", npz, "--int8",
                        "--image-size", "64", "--device", "cpu"])
    assert "needs BatchNorm statistics" in capsys.readouterr().err


def test_eval_cli_int8(tmp_root, capsys, monkeypatch):
    """``pascal_eval_map --int8`` on the synthetic VOC fixture at 64²: it
    calibrates on the first batch of ``--int8-calib-set`` and serves the
    int8 chain (every batch through ``forward_int8``)."""
    synthetic.make_voc(str(tmp_root / "data" / "VOCdevkit"), n_images=4)
    v = variables("v1", 11, 64)
    npz = str(tmp_root / "v1.npz")
    convert.save_npz(npz, v["params"], v["batch_stats"])
    monkeypatch.setattr(pt_eval, "IMAGE_SIZE", 64)
    calls = []
    forward = pq.forward_int8

    def counting(*args, **kw):
        calls.append(args[1].shape)
        return forward(*args, **kw)

    monkeypatch.setattr(pq, "forward_int8", counting)
    assert pt_eval.main(["--image-set", "trainval", "--batch-size", "2",
                         "--device", "cpu", "--weights", npz, "--int8",
                         "--int8-calib-set", "trainval"]) == 0
    assert "mAP@0.5 = " in capsys.readouterr().out
    assert calls and all(s == (2, 64, 64, 3) for s in calls)


def test_eval_cli_int8_refuses_passthrough(capsys):
    with pytest.raises(SystemExit):
        pt_eval.main(["--int8", "--v2", "--passthrough", "--device", "cpu"])
    assert "concat route" in capsys.readouterr().err

