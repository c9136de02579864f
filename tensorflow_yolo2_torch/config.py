"""Detection-grid configuration (port of tensorflow_yolo2_tpu/config.py).

Only the pieces the serving paths read: ``YoloConfig`` with its channel
layout, grid offset and ``at_scale``, ``yolo_grid_offset``, the anchor
head's ``yolo_v2_config`` with ``CLASSIC_VOC_ANCHORS``, and
``VOC_CLASSES``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np


def yolo_grid_offset(S: int, B: int) -> np.ndarray:
    """The [S, S, B] column-index offset grid.

    ``offset[y, x, b] == x``; its (1, 0, 2) transpose gives the row index.
    """
    off = np.tile(np.arange(S, dtype=np.float32), S * B).reshape(B, S, S)
    return np.transpose(off, (1, 2, 0))


@dataclass(frozen=True)
class YoloConfig:
    """YOLO grid-detection head hyperparameters.

    The v1 head emits ``S*S`` cells with channel layout
    ``[num_class | B confidences | B*(x, y, w, h)]`` (5B + C channels).
    ``per_slot_classes`` selects the YOLOv2 anchor layout, ``B*(5 + C)``
    channels: each slot carries ``(x, y, w, h, conf, C class logits)``.
    """

    S: int = 7
    B: int = 2
    num_class: int = 20
    image_size: int = 224
    per_slot_classes: bool = False
    # Anchor priors (w, h) in grid-cell units; v2 decode only.
    anchors: tuple[tuple[float, float], ...] = ()

    @property
    def cell_channels(self) -> int:
        if self.per_slot_classes:
            return self.B * (5 + self.num_class)
        return self.num_class + 5 * self.B

    @property
    def offset(self) -> np.ndarray:
        return yolo_grid_offset(self.S, self.B)

    def at_scale(self, S: int) -> "YoloConfig":
        """This config re-gridded to an ``S``-cell grid (input = 32·S px).

        Anchor priors are in grid-cell units, so they rescale by the
        grid-size ratio: constant as image fractions. The product is not
        rounded, as in the JAX package: from a 13-grid config the anchors
        equal ``yolo_v2_config(32*S)``'s bit for bit, from another grid
        to within 2 ulp in double, and equal after the float32 rounding
        the decode uses."""
        if S == self.S:
            return self
        factor = S / self.S
        return dataclasses.replace(
            self, S=S, image_size=self.image_size * S // self.S,
            anchors=tuple((w * factor, h * factor)
                          for w, h in self.anchors))


# Classic YOLOv2 VOC anchor priors in 13-grid cell units (the YOLO9000
# k-means priors, yolo-voc.cfg); the --v2 heads serve with them unless an
# anchors.json gives others.
CLASSIC_VOC_ANCHORS = (
    (1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
    (8.98282, 9.77052), (11.2364, 10.0071))


def yolo_v2_config(image_size: int = 224,
                   anchors: tuple[tuple[float, float], ...] | None = None
                   ) -> YoloConfig:
    """Anchor-head ``YoloConfig`` at ``image_size`` (multiple of 32).

    Default priors are ``CLASSIC_VOC_ANCHORS`` rescaled from the 13-grid
    to S = image_size/32; ``anchors`` ((w, h) pairs already in this
    grid's cell units) override them, and B follows their count."""
    S = image_size // 32
    if anchors is None:
        scale = S / 13.0
        anchors = tuple((w * scale, h * scale)
                        for w, h in CLASSIC_VOC_ANCHORS)
    else:
        anchors = tuple((float(w), float(h)) for w, h in anchors)
    return YoloConfig(S=S, image_size=image_size, B=len(anchors),
                      per_slot_classes=True, anchors=anchors)


# VOC2007 class list.
VOC_CLASSES: Sequence[str] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
