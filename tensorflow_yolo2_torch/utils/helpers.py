"""Small helpers (port of tensorflow_yolo2_tpu/utils/helpers.py).

- :func:`compare_label_values`: the count and share of predictions equal
  to their labels;
- :func:`add_contrast_channels`: the adversarial defence's input
  transform, a torch op on NHWC images: for each RGB channel four more
  holding the absolute difference to the pixel above, below, left and
  right, zero on the border where that neighbour is missing → 15
  channels.
"""

from __future__ import annotations

import numpy as np
import torch


def compare_label_values(preds, labels) -> tuple[int, float]:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    assert preds.ndim == labels.ndim == 1 and preds.shape == labels.shape
    count = int((preds == labels).sum())
    return count, count / len(preds)


def add_contrast_channels(images: torch.Tensor) -> torch.Tensor:
    """(batch, H, W, 3) → (batch, H, W, 15): [rgb | |Δup| | |Δdown| |
    |Δleft| | |Δright|], each difference zero where the neighbour is
    outside the image (the first row for up, the last for down, the first
    column for left, the last for right)."""
    x = images
    z_row = torch.zeros_like(x[:, :1])
    z_col = torch.zeros_like(x[:, :, :1])
    dy = torch.abs(x[:, 1:] - x[:, :-1])
    dx = torch.abs(x[:, :, 1:] - x[:, :, :-1])
    up = torch.cat([z_row, dy], dim=1)
    down = torch.cat([dy, z_row], dim=1)
    left = torch.cat([z_col, dx], dim=2)
    right = torch.cat([dx, z_col], dim=2)
    return torch.cat([x, up, down, left, right], dim=-1)
