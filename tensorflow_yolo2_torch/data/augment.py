"""Host-side image reads (port of the reading half of
tensorflow_yolo2_tpu/data/augment.py).

Images are read with cv2 in BGR (``rgb=True`` swaps to RGB), warp-resized
to image_size² with cv2's bilinear resize, optionally flipped, and scaled
to [-1, 1] as ``(x/255)·2 − 1``, or kept as uint8 for the on-device
normalize (``utils.device.device_normalize``). cv2 is imported inside
the functions: the card machine has none. The JAX package's native C++
resize and the augmentation chain are not ported yet.
"""

from __future__ import annotations

import numpy as np


def normalize(image: np.ndarray) -> np.ndarray:
    """uint8 → float32 in [-1, 1]."""
    return (image.astype(np.float32) / 255.0) * 2.0 - 1.0


def image_read_u8(path: str, image_size: int, rgb: bool = False,
                  flipped: bool = False) -> np.ndarray:
    """Read, resize to (image_size, image_size, 3) and flip: uint8."""
    import cv2

    image = cv2.imread(path)
    if image is None:
        raise FileNotFoundError(path)
    if rgb:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    image = cv2.resize(image, (image_size, image_size))
    if flipped:
        image = image[:, ::-1, :]
    return image


def image_read(path: str, image_size: int, rgb: bool = False,
               flipped: bool = False) -> np.ndarray:
    """:func:`image_read_u8`, normalized: float32 in [-1, 1]."""
    return normalize(image_read_u8(path, image_size, rgb, flipped))
