"""The port's native host layer (``utils/native.py`` over
``native/tfy2_native.cc``), the reads built on it (``data/augment.py``,
``data/voc.py``) and the detect CLI's ``--host-nms``, on the CPU.

- The resize (float and uint8 output, channel swap, flip) and the
  normalize are bit-equal to a numpy copy of cv2's scalar INTER_LINEAR
  fixed-point arithmetic and to the numpy normalize, and within one level
  of ``cv2.resize`` (cv2 resizes through Intel IPP, which rounds
  otherwise on ~0.3% of pixels).
- ``label_grid`` is bit-equal to the port's and the JAX package's numpy
  grids; ``nms`` keeps what a numpy greedy NMS keeps.
- The libjpeg decode at full scale is within one level of the cv2 route
  (the JAX package's own bound); the DCT-scaled decode within its bounds
  (mean 0.02, worst 0.12 in [-1, 1] units).
- ``image_read`` / ``image_read_u8`` equal the JAX package's
  ``image_read`` bit for bit where JAX's native library built, else
  within one level (JAX then resizes with cv2).

These tests need the library: where ``g++`` cannot build it they fail
with the compiler's output (``native.require()``), they do not skip.
"""

import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest

from tensorflow_yolo2_torch import config as pt_config
from tensorflow_yolo2_torch import convert
from tensorflow_yolo2_torch.data import augment as pt_augment
from tensorflow_yolo2_torch.data import voc as pt_voc
from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pt_detect
from tensorflow_yolo2_torch.utils import native
from tensorflow_yolo2_tpu.data import augment as jx_augment
from tensorflow_yolo2_tpu.data import voc as jx_voc
from tensorflow_yolo2_tpu.models.darknet import Darknet19Detector
from tensorflow_yolo2_tpu.utils import native as jx_native
from tests import synthetic
from tests.reference_numpy import np_nms
from tests.test_torch_port_models import random_variables

DEMO = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                    "demo.jpg")
# one uint8 level in [-1, 1] units (+ float slack)
LEVEL = 2.0 / 255.0 + 1e-6


@pytest.fixture(scope="module", autouse=True)
def lib():
    """The library, built here if need be; without it every test fails
    with the compiler's output."""
    return native.require()


def normalize(x):
    return (x.astype(np.float32) / 255.0) * 2.0 - 1.0


def scalar_resize(src, dh, dw):
    """Numpy copy of OpenCV INTER_LINEAR's 8U scalar fixed-point resize
    (11-bit coefficients, int rows, (b·(row>>4))>>16 +2 >>2 rounding)."""

    def coefs(slen, dlen):
        scale = slen / dlen
        fx = ((np.arange(dlen) + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(fx).astype(int)
        f = fx - sx
        f[sx < 0] = 0
        sx[sx < 0] = 0
        f[sx >= slen - 1] = 1
        sx[sx >= slen - 1] = max(slen - 2, 0)
        return sx, np.rint((1 - f) * 2048).astype(np.int64), \
            np.rint(f * 2048).astype(np.int64)

    sh, sw = src.shape[:2]
    sx, ax0, ax1 = coefs(sw, dw)
    sy, ay0, ay1 = coefs(sh, dh)
    s = src.astype(np.int64)
    rows = (s[:, sx, :] * ax0[None, :, None]
            + s[:, np.minimum(sx + 1, sw - 1), :] * ax1[None, :, None])
    r0, r1 = rows[sy], rows[np.minimum(sy + 1, sh - 1)]
    out = ((((ay0[:, None, None] * (r0 >> 4)) >> 16)
            + ((ay1[:, None, None] * (r1 >> 4)) >> 16) + 2) >> 2)
    return np.clip(out, 0, 255).astype(np.uint8)


def cv2_route(img, size, rgb=False, flip=False):
    x = cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if rgb else img
    x = cv2.resize(x, (size, size))
    return x[:, ::-1, :] if flip else x


@pytest.mark.parametrize("shape,size", [
    ((37, 53), 224), ((480, 640), 224), ((224, 224), 224), ((300, 200), 64),
    ((5, 3), 17)])
def test_resize_matches_cv2_scalar_arithmetic(shape, size):
    img = np.random.RandomState(sum(shape)).randint(
        0, 256, (*shape, 3)).astype(np.uint8)
    want = scalar_resize(img, size, size)
    u8 = native.resize_u8(img, size, size)
    np.testing.assert_array_equal(u8, want)
    np.testing.assert_array_equal(native.resize_normalize(img, size, size),
                                  normalize(want))
    diff = np.abs(u8.astype(int) - cv2_route(img, size).astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("rgb,flip", [(False, True), (True, False),
                                      (True, True)])
def test_resize_swap_and_flip(rgb, flip):
    img = np.random.RandomState(0).randint(0, 256, (97, 123, 3)).astype(
        np.uint8)
    want = scalar_resize(img, 64, 48)
    want = want[:, :, ::-1] if rgb else want
    want = want[:, ::-1] if flip else want
    np.testing.assert_array_equal(
        native.resize_u8(img, 64, 48, swap_rb=rgb, hflip=flip), want)
    np.testing.assert_array_equal(
        native.resize_normalize(img, 64, 48, swap_rb=rgb, hflip=flip),
        normalize(want))
    assert native.resize_u8(img[..., 0], 8, 8) is None  # not HWC 3


def test_normalize_bit_exact():
    img = np.random.RandomState(1).randint(0, 256, (11, 7, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(native.normalize(img), normalize(img))
    full = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(native.normalize(full), normalize(full))
    np.testing.assert_array_equal(pt_augment.normalize(full),
                                  normalize(full))


def test_label_grid_matches_numpy(monkeypatch):
    """The native grid, the port's numpy grid and the JAX package's numpy
    grid: equal, bit for bit (first object of a cell wins)."""
    monkeypatch.setattr(jx_native, "label_grid", lambda *a: None)
    rng = np.random.RandomState(3)
    S, C, size = 7, 20, 224.0
    for _ in range(20):
        n = rng.randint(1, 12)
        x1, y1 = rng.uniform(0, size - 2, n), rng.uniform(0, size - 2, n)
        x2 = np.minimum(x1 + rng.uniform(1, 100, n), size - 1)
        y2 = np.minimum(y1 + rng.uniform(1, 100, n), size - 1)
        corners = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
        cls = rng.randint(0, C, n).astype(np.int32)
        got = native.label_grid(corners, cls, S, C, size)
        np.testing.assert_array_equal(
            got, pt_voc.label_grid_numpy(corners, cls, S, C, size))
        np.testing.assert_array_equal(
            got, jx_voc.build_label_grid(corners, cls, S, C, size))
        np.testing.assert_array_equal(
            got, pt_voc.build_label_grid(corners, cls, S, C, size))
    two = np.array([[10, 10, 50, 50], [12, 12, 48, 48]], np.float32)
    cell = native.label_grid(two, np.array([3, 5], np.int32), 7, 20,
                             224.0)[0, 0]
    assert cell[0] == 1 and cell[5 + 3] == 1 and cell[5 + 5] == 0
    empty = native.label_grid(np.zeros((0, 4), np.float32),
                              np.zeros((0,), np.int32), 7, 20, 224.0)
    assert empty.shape == (7, 7, 25) and not empty.any()


@pytest.mark.parametrize("class_aware", [True, False])
def test_nms_matches_numpy(class_aware):
    rng = np.random.RandomState(4)
    for _ in range(10):
        n = 40
        xy = rng.uniform(0, 1, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (n, 2))],
                               -1).astype(np.float32)
        scores = rng.uniform(0, 1, n).astype(np.float32)
        classes = rng.randint(0, 3, n).astype(np.int32)
        got = native.nms(boxes, scores, classes, 0.45,
                         class_aware=class_aware, score_thresh=0.1)
        dets = [(*boxes[i], scores[i], classes[i]) for i in range(n)
                if scores[i] > 0.1]
        want = np_nms(dets, 0.45, class_aware)
        np.testing.assert_array_equal(scores[got], [d[4] for d in want])


def smooth_image(h, w, seed=0):
    """Low-frequency content, so that a JPEG round trip loses little."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(xx / w * 4 + c) *
                     np.cos(yy / h * 3 - c) for c in range(3)], axis=-1)
    return np.clip(base + rng.uniform(-4, 4, (h, w, 3)), 0, 255).astype(
        np.uint8)


def test_jpeg_full_scale_within_one_level_of_cv2(tmp_path):
    assert native.jpeg_available(), native.build_log()
    path = str(tmp_path / "img.jpg")
    assert cv2.imwrite(path, smooth_image(60, 80, seed=7))
    data = open(path, "rb").read()
    for rgb in (False, True):
        for flip in (False, True):
            got = native.jpeg_resize_u8(data, 32, 32, swap_rb=rgb,
                                        hflip=flip, fast_scale=False)
            want = cv2_route(cv2.imread(path), 32, rgb, flip)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            np.testing.assert_array_equal(
                normalize(got), native.jpeg_resize_normalize(
                    data, 32, 32, swap_rb=rgb, hflip=flip,
                    fast_scale=False))


def test_jpeg_fast_scale_and_garbage(tmp_path):
    """The DCT-scaled decode on a 1024→64 shrink within the JAX package's
    bounds of the full decode; bytes that are no JPEG give None."""
    assert native.jpeg_available(), native.build_log()
    path = str(tmp_path / "big.jpg")
    assert cv2.imwrite(path, smooth_image(768, 1024, seed=8),
                       [cv2.IMWRITE_JPEG_QUALITY, 95])
    got = native.jpeg_resize_normalize(open(path, "rb").read(), 64, 64,
                                       fast_scale=True)
    want = normalize(cv2_route(cv2.imread(path), 64))
    assert np.mean(np.abs(got - want)) < 0.02
    assert np.max(np.abs(got - want)) < 0.12
    assert native.jpeg_resize_normalize(b"not a jpeg", 32, 32) is None
    assert native.jpeg_resize_u8(b"junk", 32, 32) is None


@pytest.fixture(scope="module")
def fixture_jpegs(tmp_path_factory):
    voc = synthetic.make_voc(str(tmp_path_factory.mktemp("voc")),
                             n_images=2)
    folder = os.path.join(voc, "JPEGImages")
    return [DEMO] + sorted(os.path.join(folder, f)
                           for f in os.listdir(folder))


@pytest.mark.parametrize("size,rgb,flipped", [(448, False, False),
                                              (64, True, True)])
def test_image_read_matches_jax(fixture_jpegs, size, rgb, flipped):
    """``assets/demo.jpg`` and VOC fixture JPEGs: the port's reads against
    the JAX package's ``image_read``: bit for bit where JAX's native
    library built (both resize natively), else within one level (JAX
    resizes with cv2)."""
    exact = jx_native.available()
    for path in fixture_jpegs:
        want = jx_augment.image_read(path, size, rgb=rgb, flipped=flipped,
                                     fast_jpeg=False)
        u8 = pt_augment.image_read_u8(path, size, rgb=rgb, flipped=flipped)
        got = pt_augment.image_read(path, size, rgb=rgb, flipped=flipped)
        assert u8.dtype == np.uint8 and u8.shape == (size, size, 3)
        np.testing.assert_array_equal(got, normalize(u8))
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, atol=LEVEL, rtol=0)
    with pytest.raises(FileNotFoundError):
        pt_augment.image_read_u8(str(fixture_jpegs[0]) + ".missing", 32)


def test_reads_without_cv2(fixture_jpegs, monkeypatch):
    """With cv2 absent the reads decode through libjpeg, within one level
    of the cv2 route; the VOC loader takes the image's shape from its
    frame header, equal to cv2's; with no JPEG decode either a read raises
    with the reason."""
    want = [pt_augment.image_read_u8(p, 96, rgb=True) for p in
            fixture_jpegs]
    shapes = [cv2.imread(p).shape[:2] for p in fixture_jpegs]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    for path, w, shape in zip(fixture_jpegs, want, shapes):
        got = pt_augment.image_read_u8(path, 96, rgb=True)
        assert np.abs(got.astype(int) - w.astype(int)).max() <= 1
        assert pt_voc.image_shape(path) == shape == \
            pt_augment.jpeg_size(path)
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    with pytest.raises(RuntimeError, match="no JPEG decode"):
        pt_augment.image_read(DEMO, 32)


def test_jpeg_size_matches_cv2(tmp_path):
    """The frame-header reader on baseline and progressive JPEGs with
    markers before the frame; a non-JPEG raises ``FileNotFoundError``."""
    img = smooth_image(37, 53)
    base, prog = str(tmp_path / "b.jpg"), str(tmp_path / "p.jpg")
    assert cv2.imwrite(base, img)
    assert cv2.imwrite(prog, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    for path in (base, prog, DEMO):
        assert pt_augment.jpeg_size(path) == cv2.imread(path).shape[:2]
    png = str(tmp_path / "x.png")
    assert cv2.imwrite(png, img)
    with pytest.raises(FileNotFoundError, match="not a JPEG"):
        pt_augment.jpeg_size(png)


def test_voc_labels_without_cv2(tmp_path, monkeypatch):
    """``PascalVOC``'s label grids without cv2 equal those with it."""
    voc = synthetic.make_voc(str(tmp_path / "VOCdevkit"), n_images=3)

    def labels(tag):
        imdb = pt_voc.PascalVOC(
            "trainval", batch_size=1, data_path=voc,
            paths=pt_config.Paths(root=str(tmp_path / tag)),
            rng=np.random.RandomState(0))
        return sorted((e["imname"], e["label"].tobytes())
                      for e in imdb.gt_labels)

    with_cv2 = labels("a")
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert labels("b") == with_cv2


def run_worker(build_dir: str, source: str, compiler: str = "g++"):
    code = textwrap.dedent(f"""
        from tensorflow_yolo2_torch.utils.native import NativeLibrary
        lib = NativeLibrary({source!r}, {build_dir!r}, {compiler!r})
        print(lib.require().tfy2_has_jpeg())
    """)
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            cwd=os.path.dirname(os.path.dirname(__file__)))


def test_loader_two_processes_build_at_once(tmp_path):
    build = str(tmp_path / "build")
    procs = [run_worker(build, native.SOURCE) for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        assert out.strip() == "1"
    libs = sorted(f for f in os.listdir(build) if f.endswith(".so"))
    assert len(libs) == 1 and libs[0].startswith("libtfy2_native-jpeg-")
    assert sorted(os.listdir(build)) == sorted(
        [libs[0], libs[0][:-3] + ".log", "lock"])


def test_loader_rebuilds_a_changed_source(tmp_path):
    src = tmp_path / "tfy2_native.cc"
    src.write_text(open(native.SOURCE).read())
    build = str(tmp_path / "build")
    native.NativeLibrary(str(src), build).require()
    before = native.NativeLibrary(str(src), build).path("jpeg")
    src.write_text(src.read_text() + "\n// changed\n")
    second = native.NativeLibrary(str(src), build)
    assert second.path("jpeg") != before
    second.require()
    assert os.path.exists(before) and os.path.exists(second.path("jpeg"))
    assert "-DTFY2_WITH_JPEG" in second.build_log()


def test_loader_failures_raise_with_the_compiler_output(tmp_path):
    """No compiler: ``require()`` raises with the error, and raises again;
    a source that does not compile: with g++'s messages; a compiler that
    cannot link libjpeg: the plain library, its failure kept beside it."""
    missing = native.NativeLibrary(native.SOURCE, str(tmp_path / "a"),
                                   compiler="no-such-compiler-g++")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="No such file"):
            missing.require()
    assert not missing.available()
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="error"):
        native.NativeLibrary(str(bad), str(tmp_path / "b")).require()
    wrapper = tmp_path / "cxx"
    wrapper.write_text("#!/bin/sh\ncase \"$*\" in *TFY2_WITH_JPEG*) echo "
                       "'jpeglib.h: No such file' >&2; exit 1;; esac\n"
                       "exec g++ \"$@\"\n")
    wrapper.chmod(0o755)
    build = str(tmp_path / "c")
    plain = native.NativeLibrary(native.SOURCE, build, str(wrapper))
    assert plain.require().tfy2_has_jpeg() == 0
    assert os.path.exists(plain.path("jpeg")[:-3] + ".failed.log")
    assert "jpeglib.h: No such file" in plain.build_log()
    p = run_worker(build, native.SOURCE, str(wrapper))  # not tried again
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0 and out.strip() == "0", err


def test_cli_host_nms_equals_numpy_nms(tmp_path, monkeypatch):
    """``--host-nms``: the dense decode, then the native NMS, keeps what a
    numpy greedy NMS of the CLI's dense detections keeps, and what
    ``--nms`` keeps."""
    v = random_variables(Darknet19Detector(output_channels=30),
                         (1, 64, 64, 3), seed=11)
    beta = v["params"]["detection"]["output"]["bn"]["bias"]
    beta[20:22] += 0.6
    beta[[24, 25, 28, 29]] += 1.5
    npz = str(tmp_path / "w.npz")
    convert.save_npz(npz, v["params"], v["batch_stats"])
    image = str(tmp_path / "in.jpg")
    cv2.imwrite(image, smooth_image(80, 96, seed=3))
    drawn = []
    monkeypatch.setattr(pt_detect, "draw_detections",
                        lambda path, *dets: drawn.append(dets[:3]))
    argv = [image, "--weights", npz, "--image-size", "64", "--threshold",
            "0.05", "--device", "cpu"]
    for flags in ([], ["--host-nms"], ["--nms"]):
        assert pt_detect.main(argv + flags) == 0
    dense, (boxes, scores, classes), on_device = drawn
    want = np_nms([(*dense[0][i], dense[1][i], dense[2][i])
                   for i in range(len(dense[1])) if dense[1][i] > 0])
    assert 1 < len(want) < len(dense[1])
    np.testing.assert_array_equal(scores, [d[4] for d in want])
    np.testing.assert_array_equal(boxes, [d[:4] for d in want])
    np.testing.assert_array_equal(classes, [d[5] for d in want])
    kept = on_device[1] > 0
    np.testing.assert_array_equal(np.sort(on_device[1][kept]),
                                  np.sort(scores))
