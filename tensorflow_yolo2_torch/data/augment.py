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
the compiler's output.

The augmentation chain of classifier training (``augment_image``,
``augment_image_u8``, ``read_and_augment``): flip, 0–359° rotation, an
HSV hue and saturation shift, a gamma exposure shift and a random crop
from a short side in [image_size, upbound] (a 75% chance; a warp resize
otherwise), drawn from a ``random.Random`` in the JAX package's order and
computed with the same cv2 calls on arrays of the same types, so that a
seed gives the same bytes in both packages; ±ε sign noise as an option
of the float path.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, replace

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


@dataclass
class AugmentConfig:
    """The augmentation distribution (the JAX package's defaults; the
    reference's crop upbound 292 at 224²)."""

    image_size: int = 224
    rand_crop_upbound: int = 292
    flip: bool = True
    rotate: bool = True
    color_pert: bool = True
    exposure_shift: bool = True
    random_crop: bool = True
    # ±ε sign noise, ε drawn from {4, 8, 12, 16}/255·2: float path only
    random_noise: bool = False


def augment_image(image: np.ndarray, cfg: AugmentConfig,
                  rng: random.Random, rgb: bool = False) -> np.ndarray:
    """A uint8 image (BGR, or RGB with ``rgb``) through the augmentation
    chain → float32 (image_size, image_size, 3) in [-1, 1].

    The uint8 chain is ``augment_image_u8``'s; the sign noise (when
    ``cfg.random_noise``) is drawn after all of its draws, so the two
    paths see the same augmentations for a seed."""
    u8_cfg = replace(cfg, random_noise=False) if cfg.random_noise else cfg
    out = normalize(augment_image_u8(image, u8_cfg, rng, rgb=rgb))
    if cfg.random_noise:
        eps = rng.choice([4, 8, 12, 16]) / 255.0 * 2.0
        np_rng = np.random.RandomState(rng.randrange(2**32))
        sign = np.sign(np_rng.uniform(-1, 1, out.shape)).astype(np.float32)
        out = np.clip(out + eps * sign, -1.0, 1.0)
    return out


def augment_image_u8(image: np.ndarray, cfg: AugmentConfig,
                     rng: random.Random, rgb: bool = False) -> np.ndarray:
    """:func:`augment_image` without the normalize: the augmented uint8
    (image_size, image_size, 3) image, for the on-device normalize.
    Refuses ``random_noise`` (float arithmetic).

    Draws, in order: flip, rotation, crop chance, colour, exposure; then
    hue and saturation (with their signs), the gamma, the short side and
    the crop offsets as each step needs them."""
    import cv2

    if cfg.random_noise:
        raise ValueError("random_noise is float-valued; use augment_image "
                         "(float transfer)")
    size = cfg.image_size

    do_flip = cfg.flip and bool(rng.getrandbits(1))
    rotate_deg = rng.randint(0, 359) if cfg.rotate else 0
    # a 75% chance of a random crop; otherwise a plain warp resize
    crop_chance = rng.randint(0, 3) if cfg.random_crop else 0
    do_color = cfg.color_pert and bool(rng.getrandbits(1))
    do_exposure = cfg.exposure_shift and bool(rng.getrandbits(1))

    if do_flip:
        image = image[:, ::-1, :]

    if cfg.rotate:
        rows, cols, _ = image.shape
        m = cv2.getRotationMatrix2D((cols / 2, rows / 2), rotate_deg, 1)
        image = cv2.warpAffine(image, m, (cols, rows))

    if do_color:
        # uint8 HSV arithmetic, wrapping as numpy's uint8 does, ±[0, 10]
        to_hsv = cv2.COLOR_RGB2HSV if rgb else cv2.COLOR_BGR2HSV
        from_hsv = cv2.COLOR_HSV2RGB if rgb else cv2.COLOR_HSV2BGR
        hsv = cv2.cvtColor(image, to_hsv)
        hue = rng.randint(0, 10)
        sat = rng.randint(0, 10)
        if bool(rng.getrandbits(1)):
            hsv[:, :, 0] += np.uint8(hue)
        else:
            hsv[:, :, 0] -= np.uint8(hue)
        if bool(rng.getrandbits(1)):
            hsv[:, :, 1] += np.uint8(sat)
        else:
            hsv[:, :, 1] -= np.uint8(sat)
        image = cv2.cvtColor(hsv, from_hsv)

    if do_exposure:
        gamma = (rng.uniform(1, 2) if bool(rng.getrandbits(1))
                 else rng.uniform(0.5, 1))
        image = (((image / 255.0) ** (1.0 / gamma)) * 255).astype(np.uint8)

    too_small = False
    if crop_chance > 0:
        rows, cols, _ = image.shape
        # the reference's 292/224 headroom where the target size is above
        # the configured upbound (299², 448²), so the range is never empty
        upbound = max(cfg.rand_crop_upbound,
                      int(size * cfg.rand_crop_upbound / 224.0))
        short_len = rng.randint(size, upbound)
        if cols <= rows:
            scaled_cols = short_len
            scaled_rows = int(rows * short_len / float(cols))
        else:
            scaled_rows = short_len
            scaled_cols = int(cols * short_len / float(rows))
        if scaled_cols < size or scaled_rows < size:
            too_small = True
        else:
            image = cv2.resize(image, (scaled_cols, scaled_rows))
            co = rng.randint(0, scaled_cols - size)
            ro = rng.randint(0, scaled_rows - size)
            image = image[ro:ro + size, co:co + size]

    if crop_chance == 0 or too_small:
        image = cv2.resize(image, (size, size))
    return image


def read_and_augment(path: str, cfg: AugmentConfig, rng: random.Random,
                     rgb: bool = False) -> np.ndarray:
    """``cv2.imread`` (then BGR → RGB with ``rgb``) and
    :func:`augment_image`."""
    import cv2

    image = cv2.imread(path)
    if image is None:
        raise FileNotFoundError(path)
    if rgb:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    return augment_image(image, cfg, rng, rgb=rgb)
