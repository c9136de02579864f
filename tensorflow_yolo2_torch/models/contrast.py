"""The contrast-channel input wrapper of the adversarial defence (port of
tensorflow_yolo2_tpu/models/contrast.py).

NHWC images (N, H, W, 3) → ``utils.helpers.add_contrast_channels``
(N, H, W, 15) → ``input_transform``, a 3×3 SAME conv 15 → 3 with a bias
(the reference's ``Conv2d_tr_3x3``) → the wrapped backbone, any
registered net, under ``backbone``. The names are flax's, so a converted
tree (``input_transform/kernel``, ``backbone/...``) loads strictly.
"""

from __future__ import annotations

import torch
from torch import nn

from tensorflow_yolo2_torch.models.layers import SameConv2d
from tensorflow_yolo2_torch.utils.helpers import add_contrast_channels

CONTRAST_CHANNELS = 15  # RGB and its four neighbour differences
TRANSFORM_FEATURES = 3


class ContrastInputModel(nn.Module):
    """x (N, H, W, 3) → contrast features (N, H, W, 15) → 3×3 transform
    conv → the wrapped backbone's output."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.input_transform = SameConv2d(CONTRAST_CHANNELS,
                                          TRANSFORM_FEATURES, 3)
        self.backbone = backbone

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None):
        x = add_contrast_channels(images).permute(0, 3, 1, 2)
        x = self.input_transform(x).permute(0, 2, 3, 1)
        return self.backbone(x, generator=generator)
