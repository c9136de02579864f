"""Detection-grid configuration (port of tensorflow_yolo2_tpu/config.py).

Only the pieces the serving path reads: ``YoloConfig`` with its channel
layout and grid offset, ``yolo_grid_offset`` and ``VOC_CLASSES``.
"""

from __future__ import annotations

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
    ``per_slot_classes`` selects the anchor layout (``B*(5 + C)``
    channels), which this port does not serve yet.
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


# VOC2007 class list.
VOC_CLASSES: Sequence[str] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
