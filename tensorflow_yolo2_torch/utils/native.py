"""ctypes loader for the native host layer, ``native/tfy2_native.cc`` (port
of tensorflow_yolo2_tpu/utils/native.py).

The C++ source is shared with the JAX package and built as it is with
``g++`` into ``tensorflow_yolo2_torch/_build/native/``: first with libjpeg
(``-DTFY2_WITH_JPEG -ljpeg``: a fused JPEG decode), else without it. A
library's name carries a digest of the source, the flags and the host CPU
(``-march=native`` makes it specific to the machine), so an edited source
or another machine builds anew. Each build goes to a temporary name and is
renamed into place under a file lock, so processes that build at once
never load a half-written library; the compiler's output is kept beside
the library (``.log``), and a libjpeg build that failed leaves its output
as ``.failed.log``, so that later processes do not try it again.

Entry points (the JAX package's eight, the same arguments) return ``None``
where the library is unavailable, as the JAX package's do; ``require()``
raises with the compiler's output instead, for callers that cannot go on
without it. The resize replicates OpenCV INTER_LINEAR's 8U scalar
fixed-point arithmetic; cv2 wheels resize through Intel IPP, which differs
from that by one level on ~0.3% of pixels.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "tfy2_native.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
# (name, extra flags before the source, extra flags after it)
VARIANTS = (("jpeg", ("-DTFY2_WITH_JPEG",), ("-ljpeg",)), ("plain", (), ()))
BUILD_TIMEOUT_S = 300


def _host_cpu() -> str:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:  # the first processor's lines
                if not line.strip():
                    break
                if line.split(":", 1)[0].strip() in ("model name", "flags",
                                                     "Features"):
                    keep.append(line)
    except OSError:
        pass
    return platform.machine() + "".join(keep)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i, i64 = ctypes.c_int, ctypes.c_int64
    lib.tfy2_resize_normalize.argtypes = [u8p, i, i, f32p, i, i, i, i]
    lib.tfy2_resize_normalize.restype = None
    lib.tfy2_resize_u8.argtypes = [u8p, i, i, u8p, i, i, i, i]
    lib.tfy2_resize_u8.restype = None
    lib.tfy2_normalize.argtypes = [u8p, f32p, i64]
    lib.tfy2_normalize.restype = None
    lib.tfy2_label_grid.argtypes = [f32p, i32p, i, i, i, ctypes.c_float,
                                    f32p]
    lib.tfy2_label_grid.restype = None
    lib.tfy2_nms.argtypes = [f32p, f32p, i32p, i, ctypes.c_float, i,
                             ctypes.c_float, i, i32p]
    lib.tfy2_nms.restype = ctypes.c_int
    lib.tfy2_has_jpeg.argtypes = []
    lib.tfy2_has_jpeg.restype = ctypes.c_int
    lib.tfy2_jpeg_resize_normalize.argtypes = [u8p, i64, f32p, i, i, i, i, i]
    lib.tfy2_jpeg_resize_normalize.restype = ctypes.c_int
    lib.tfy2_jpeg_resize_u8.argtypes = [u8p, i64, u8p, i, i, i, i, i]
    lib.tfy2_jpeg_resize_u8.restype = ctypes.c_int
    return lib


class NativeLibrary:
    """The built and loaded library of ``source``, made at first use.

    ``require()`` returns the library or raises ``RuntimeError`` with the
    compiler's output; a failed build is remembered for the life of the
    object and raised again, not retried."""

    def __init__(self, source: str = SOURCE, build_dir: str = BUILD_DIR,
                 compiler: str = "g++"):
        self.source, self.build_dir, self.compiler = source, build_dir, \
            compiler
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._error: Optional[str] = None

    def path(self, variant: str) -> str:
        """Where the ``variant`` build ("jpeg" or "plain") goes."""
        flags = dict((v, pre + post) for v, pre, post in VARIANTS)[variant]
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read())
        digest.update(" ".join((self.compiler, *CXX_FLAGS, *flags)).encode())
        digest.update(_host_cpu().encode())
        stem = os.path.basename(self.source).rsplit(".", 1)[0]
        return os.path.join(self.build_dir, f"lib{stem}-{variant}-"
                                            f"{digest.hexdigest()[:12]}.so")

    def build_log(self) -> str:
        """The compiler's output of the loaded library's build, and of the
        libjpeg build where that failed."""
        out = []
        for variant, _, _ in VARIANTS:
            for suffix in (".log", ".failed.log"):
                log = self.path(variant)[:-3] + suffix
                if os.path.exists(log):
                    with open(log) as f:
                        out.append(f"[{variant} build{suffix[:-4]}]\n"
                                   f"{f.read()}")
        return "".join(out)

    def require(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None and self._error is None:
                try:
                    self._lib = _declare(ctypes.CDLL(self._build()))
                except (RuntimeError, OSError) as e:
                    self._error = str(e)
            if self._error is not None:
                raise RuntimeError(self._error)
            return self._lib

    def available(self) -> bool:
        try:
            self.require()
        except RuntimeError:
            return False
        return True

    def _build(self) -> str:
        """Path of the library: built already, or built now."""
        os.makedirs(self.build_dir, exist_ok=True)
        with open(os.path.join(self.build_dir, "lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when closed
            outputs = []
            for variant, pre, post in VARIANTS:
                so = self.path(variant)
                failed = so[:-3] + ".failed.log"
                if os.path.exists(so):
                    return so
                if os.path.exists(failed):  # tried before, and failed
                    with open(failed) as f:
                        outputs.append(f.read())
                    continue
                ok, out = self._compile(so, pre, post)
                if ok:
                    return so
                outputs.append(out)
                if variant != VARIANTS[-1][0]:
                    with open(failed, "w") as f:
                        f.write(out)
        raise RuntimeError(
            f"the native host layer ({self.source}) did not build with "
            f"{self.compiler}:\n" + "".join(outputs))

    def _compile(self, so: str, pre: tuple, post: tuple) -> tuple[bool, str]:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        cmd = [self.compiler, *CXX_FLAGS, *pre, self.source, "-o", tmp,
               *post]
        shown = " ".join(cmd).replace(tmp, so)
        # the compiler's own temporary files go beside the library, so a
        # TMPDIR that is not there cannot fail the build
        env = {**os.environ, "TMPDIR": self.build_dir}
        try:
            run = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 env=env, timeout=BUILD_TIMEOUT_S)
            out, ok = run.stdout, run.returncode == 0
        except (OSError, subprocess.TimeoutExpired) as e:
            out, ok = f"{type(e).__name__}: {e}\n", False
        out = f"$ {shown}\n{out}"
        if not ok:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(tmp)
            return False, out
        with open(tmp[:-3] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp[:-3] + ".log", so[:-3] + ".log")
        os.replace(tmp, so)
        return True, out


_DEFAULT = NativeLibrary()


def require() -> ctypes.CDLL:
    """The library, built at first use; raises ``RuntimeError`` with the
    compiler's output when it cannot be built."""
    return _DEFAULT.require()


def available() -> bool:
    """True when the library is (or can be) built and loaded."""
    return _DEFAULT.available()


def build_log() -> str:
    """The compiler's output behind the library (see ``NativeLibrary``)."""
    return _DEFAULT.build_log()


def _lib() -> Optional[ctypes.CDLL]:
    try:
        return _DEFAULT.require()
    except RuntimeError:
        return None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resize_normalize(image: np.ndarray, height: int, width: int,
                     swap_rb: bool = False,
                     hflip: bool = False) -> Optional[np.ndarray]:
    """Bilinear resize (cv2's scalar INTER_LINEAR arithmetic) + channel
    swap + horizontal flip + [-1, 1] normalize of a uint8 HWC 3-channel
    image: float32 (height, width, 3), or None without the library or for
    another kind of image."""
    lib = _lib()
    if lib is None or image.ndim != 3 or image.shape[2] != 3 \
            or image.dtype != np.uint8:
        return None
    image = np.ascontiguousarray(image)
    out = np.empty((height, width, 3), np.float32)
    lib.tfy2_resize_normalize(
        _ptr(image, ctypes.c_uint8), image.shape[0], image.shape[1],
        _ptr(out, ctypes.c_float), height, width, int(swap_rb), int(hflip))
    return out


def resize_u8(image: np.ndarray, height: int, width: int,
              swap_rb: bool = False,
              hflip: bool = False) -> Optional[np.ndarray]:
    """:func:`resize_normalize` without the normalize: uint8 (height,
    width, 3), the input of the on-device normalize."""
    lib = _lib()
    if lib is None or image.ndim != 3 or image.shape[2] != 3 \
            or image.dtype != np.uint8:
        return None
    image = np.ascontiguousarray(image)
    out = np.empty((height, width, 3), np.uint8)
    lib.tfy2_resize_u8(
        _ptr(image, ctypes.c_uint8), image.shape[0], image.shape[1],
        _ptr(out, ctypes.c_uint8), height, width, int(swap_rb), int(hflip))
    return out


def normalize(image: np.ndarray) -> Optional[np.ndarray]:
    """uint8 → float32 in [-1, 1] as (x/255)·2 − 1, in one pass."""
    lib = _lib()
    if lib is None or image.dtype != np.uint8:
        return None
    image = np.ascontiguousarray(image)
    out = np.empty(image.shape, np.float32)
    lib.tfy2_normalize(_ptr(image, ctypes.c_uint8),
                       _ptr(out, ctypes.c_float), image.size)
    return out


def jpeg_available() -> bool:
    """True when the library was built with libjpeg."""
    lib = _lib()
    return lib is not None and bool(lib.tfy2_has_jpeg())


def _jpeg_resize(fn: str, dtype, jpeg_bytes: bytes, height: int, width: int,
                 swap_rb: bool, hflip: bool,
                 fast_scale: bool) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None or not lib.tfy2_has_jpeg():
        return None
    buf = np.frombuffer(jpeg_bytes, np.uint8)
    out = np.empty((height, width, 3), dtype)
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_uint8
    rc = getattr(lib, fn)(_ptr(buf, ctypes.c_uint8), buf.size,
                          _ptr(out, ctype), height, width, int(swap_rb),
                          int(hflip), int(fast_scale))
    return out if rc == 0 else None


def jpeg_resize_normalize(jpeg_bytes: bytes, height: int, width: int,
                          swap_rb: bool = False, hflip: bool = False,
                          fast_scale: bool = True) -> Optional[np.ndarray]:
    """JPEG decode (libjpeg) + :func:`resize_normalize`, BGR unless
    ``swap_rb``. ``fast_scale`` decodes at the smallest M/8 DCT scale that
    still covers the target, which is not pixel-identical to a full
    decode; without it the decoder sees the bytes ``cv2.imread`` sees (no
    EXIF orientation is applied). None without libjpeg or for bytes that
    do not decode to 3 channels."""
    return _jpeg_resize("tfy2_jpeg_resize_normalize", np.float32,
                        jpeg_bytes, height, width, swap_rb, hflip,
                        fast_scale)


def jpeg_resize_u8(jpeg_bytes: bytes, height: int, width: int,
                   swap_rb: bool = False, hflip: bool = False,
                   fast_scale: bool = True) -> Optional[np.ndarray]:
    """:func:`jpeg_resize_normalize` with uint8 output."""
    return _jpeg_resize("tfy2_jpeg_resize_u8", np.uint8, jpeg_bytes, height,
                        width, swap_rb, hflip, fast_scale)


def label_grid(boxes_xyxy: np.ndarray, classes: np.ndarray, S: int,
               num_class: int, image_size: float) -> Optional[np.ndarray]:
    """Resized-pixel x1y1x2y2 boxes → (S, S, 5+C) v1 label grid, the first
    object of a cell wins (``data.voc.build_label_grid``)."""
    lib = _lib()
    if lib is None:
        return None
    boxes_xyxy = np.ascontiguousarray(boxes_xyxy, np.float32)
    classes = np.ascontiguousarray(classes, np.int32)
    grid = np.zeros((S, S, 5 + num_class), np.float32)
    lib.tfy2_label_grid(
        _ptr(boxes_xyxy, ctypes.c_float), _ptr(classes, ctypes.c_int32),
        int(boxes_xyxy.shape[0]), S, num_class, float(image_size),
        _ptr(grid, ctypes.c_float))
    return grid


def nms(boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray,
        iou_thresh: float = 0.5, class_aware: bool = True,
        score_thresh: float = 0.0,
        max_keep: int = 128) -> Optional[np.ndarray]:
    """Greedy NMS on the host: the kept indices, by descending score (ties
    to the lower index), at most ``max_keep``."""
    lib = _lib()
    if lib is None:
        return None
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    classes = np.ascontiguousarray(classes, np.int32)
    keep = np.empty(max_keep, np.int32)
    n = lib.tfy2_nms(
        _ptr(boxes, ctypes.c_float), _ptr(scores, ctypes.c_float),
        _ptr(classes, ctypes.c_int32), int(boxes.shape[0]),
        float(iou_thresh), int(class_aware), float(score_thresh),
        int(max_keep), _ptr(keep, ctypes.c_int32))
    return keep[:n].copy()
