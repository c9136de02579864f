"""The ResNet v2 (pre-activation) family, resnet_v2_50 / 101 / 152 / 200
(port of tensorflow_yolo2_tpu/models/resnet_v2.py).

Names are the flax ones (``conv1``, ``block1_unit1.preact_bn.bn``,
``...shortcut_conv``, ``...conv3``, ``postnorm.bn``, ``logits``). Images
come in as NHWC, logits go out as float32; inside, NCHW views in
``channels_last`` memory. BatchNorm has the ResNet constants
(``models.resnet._BN``: momentum 0.997, epsilon 1e-5).

The unit is slim's pre-activation bottleneck: ``preact = relu(preact_bn
(x))``; the shortcut is the input (subsampled at the stride by a 1×1
pool, a slice) when the depth is unchanged, else ``shortcut_conv``, a
1×1 conv at the stride **with a bias**, on the pre-activated input; the
residual is 1×1 ``conv1`` → ``bn1`` → ReLU → 3×3 ``conv2`` (at the
stride, slim's ``conv2d_same``) → ``bn2`` → ReLU → 1×1 ``conv3`` **with
a bias** and no BatchNorm after it. The root is a 7×7/2 conv with a bias
and no BatchNorm, then the SAME 3×3/2 pool (``layers.max_pool_same``);
after the last block ``postnorm`` and a ReLU, the global mean, a dense
``logits``. (The JAX module's ``global_pool=False`` and
``num_classes=None`` forms have no caller and are not ported.)
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_yolo2_torch.models.layers import max_pool_same
from tensorflow_yolo2_torch.models.resnet import _BN, _conv
from tensorflow_yolo2_torch.models.zoo import (
    RESNET_BOTTLENECKS,
    RESNET_DEPTHS,
    _entry,
)


class BottleneckV2(nn.Module):
    """The pre-activation bottleneck (module docstring)."""

    def __init__(self, in_channels: int, depth: int, depth_bottleneck: int,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        self.preact_bn = _BN(in_channels)
        self.shortcut_conv = (
            nn.Conv2d(in_channels, depth, 1, stride=stride)
            if depth != in_channels else None)
        self.conv1 = _conv(in_channels, depth_bottleneck, 1)
        self.bn1 = _BN(depth_bottleneck)
        self.conv2 = _conv(depth_bottleneck, depth_bottleneck, 3, stride)
        self.bn2 = _BN(depth_bottleneck)
        self.conv3 = nn.Conv2d(depth_bottleneck, depth, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        preact = F.relu(self.preact_bn(x))
        if self.shortcut_conv is not None:
            shortcut = self.shortcut_conv(preact)
        else:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        r = F.relu(self.bn1(self.conv1(preact)))
        r = F.relu(self.bn2(self.conv2(r)))
        return shortcut + self.conv3(r)


RESNET_V2_UNITS = {
    "resnet_v2_50": (3, 4, 6, 3),
    "resnet_v2_101": (3, 4, 23, 3),
    "resnet_v2_152": (3, 8, 36, 3),
    "resnet_v2_200": (3, 24, 36, 3),
}


class ResNetV2(nn.Module):
    """NHWC images → (N, num_classes) float32 logits. ``image_size`` is
    the registry's common argument; the global mean makes the net take
    any size."""

    def __init__(self, units: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, image_size: int = 224):
        super().__init__()
        self.units = tuple(units)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        in_ch = 64
        for bi, n in enumerate(self.units, start=1):
            for ui in range(1, n + 1):
                stride = 2 if (ui == n and bi < len(self.units)) else 1
                self.add_module(f"block{bi}_unit{ui}", BottleneckV2(
                    in_ch, RESNET_DEPTHS[bi - 1], RESNET_BOTTLENECKS[bi - 1],
                    stride))
                in_ch = RESNET_DEPTHS[bi - 1]
        self.postnorm = _BN(in_ch)
        self.logits = nn.Linear(in_ch, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout; the trainer passes one to every model
        x = max_pool_same(self.conv1(images.permute(0, 3, 1, 2)), 3, 2)
        for bi, n in enumerate(self.units, start=1):
            for ui in range(1, n + 1):
                x = getattr(self, f"block{bi}_unit{ui}")(x)
        x = F.relu(self.postnorm(x))
        return self.logits(x.mean(dim=(2, 3))).float()


RESNET_V2_ZOO = {name: _entry(ResNetV2, 224, units=units)
                 for name, units in RESNET_V2_UNITS.items()}
