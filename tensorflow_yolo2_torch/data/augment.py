"""Host-side image reads (port of the reading half of
tensorflow_yolo2_tpu/data/augment.py).

Images are read in BGR (``rgb=True`` swaps to RGB), warp-resized to
image_size² with bilinear interpolation, optionally flipped, and scaled to
[-1, 1] as ``(x/255)·2 − 1``, or kept as uint8 for the on-device normalize
(``utils.device.device_normalize``).

- Decode: ``cv2.imread`` where cv2 is installed (the JAX package's
  decode); without cv2, the native layer's libjpeg decode at full scale
  (``utils.native``), which sees the bytes ``cv2.imread`` sees and is
  within one level of it (EXIF orientation, which ``cv2.imread`` applies,
  is not; VOC's images carry none).
- Resize: the native layer's copy of cv2's scalar INTER_LINEAR
  arithmetic; cv2's own resize only where the native library did not
  build.
- ``fast_jpeg`` (default: ``TFY2_FAST_JPEG=1`` in the environment) decodes
  a ``.jpg`` at the smallest DCT scale that covers the target, as the JAX
  package does: not pixel-identical to a full decode.

With neither cv2 nor a native library that decodes, a read raises with
the compiler's output. The augmentation chain is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from tensorflow_yolo2_torch.utils import native


def normalize(image: np.ndarray) -> np.ndarray:
    """uint8 → float32 in [-1, 1]."""
    return (image.astype(np.float32) / 255.0) * 2.0 - 1.0


def _read_bytes(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        raise FileNotFoundError(path) from None


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def image_read_u8(path: str, image_size: int, rgb: bool = False,
                  flipped: bool = False,
                  fast_jpeg: bool | None = None) -> np.ndarray:
    """Read, resize to (image_size, image_size, 3) and flip: uint8."""
    if fast_jpeg is None:
        fast_jpeg = os.environ.get("TFY2_FAST_JPEG", "0") == "1"
    if fast_jpeg and _is_jpeg(path):
        fused = native.jpeg_resize_u8(_read_bytes(path), image_size,
                                      image_size, swap_rb=rgb,
                                      hflip=flipped, fast_scale=True)
        if fused is not None:
            return fused
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        data = _read_bytes(path)
        if not native.jpeg_available():
            raise RuntimeError(
                f"cannot decode {path}: cv2 is not installed and the "
                f"native library has no JPEG decode: {_why_no_jpeg()}")
        fused = native.jpeg_resize_u8(data, image_size, image_size,
                                      swap_rb=rgb, hflip=flipped,
                                      fast_scale=False)
        if fused is None:
            raise FileNotFoundError(f"{path}: not a 3-channel JPEG that "
                                    f"libjpeg decodes (no cv2 to try)")
        return fused
    image = cv2.imread(path)
    if image is None:
        raise FileNotFoundError(path)
    fused = native.resize_u8(image, image_size, image_size, swap_rb=rgb,
                             hflip=flipped)
    if fused is not None:
        return fused
    if rgb:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    image = cv2.resize(image, (image_size, image_size))
    if flipped:
        image = image[:, ::-1, :]
    return image


def _why_no_jpeg() -> str:
    try:
        native.require()
    except RuntimeError as e:  # the library did not build
        return str(e)
    return "it was built without libjpeg:\n" + native.build_log()


def image_read(path: str, image_size: int, rgb: bool = False,
               flipped: bool = False,
               fast_jpeg: bool | None = None) -> np.ndarray:
    """:func:`image_read_u8`, normalized: float32 in [-1, 1]. (The JAX
    package resizes and normalizes in one native pass: the same bits.)"""
    return normalize(image_read_u8(path, image_size, rgb, flipped,
                                   fast_jpeg))


def jpeg_size(path: str) -> tuple[int, int]:
    """(height, width) of a JPEG from its frame header (SOF), read without
    decoding; ``FileNotFoundError`` for a file that is missing or not a
    JPEG."""
    # markers with no length field: TEM, RST0-7, SOI
    standalone = {0x01, *range(0xD0, 0xD9)}
    with open(path, "rb") as f:  # FileNotFoundError as it is
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise FileNotFoundError(f"{path}: not a JPEG")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise FileNotFoundError(f"{path}: corrupt JPEG header")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in standalone:
            i += 2
            continue
        length = int.from_bytes(data[i + 2:i + 4], "big")
        # SOF0-15, but not DHT (C4), JPG (C8) and DAC (CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = int.from_bytes(data[i + 5:i + 7], "big")
            w = int.from_bytes(data[i + 7:i + 9], "big")
            return h, w
        if marker == 0xDA:  # scan data before any frame header
            break
        i += 2 + length
    raise FileNotFoundError(f"{path}: no frame header in the JPEG")
