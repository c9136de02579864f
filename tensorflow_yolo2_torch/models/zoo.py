"""The classification zoo (port of tensorflow_yolo2_tpu/models/zoo.py):
``LeNet``, ``CifarNet``, ``AlexNet`` (alexnet_v2), ``OverFeat``, ``VGG``
(vgg_a / vgg_16 / vgg_19) and ``ResNetV1`` (resnet_v1_101 / 152 / 200).

Submodule names are the flax parameter names (``conv1``, ``fc3``,
``conv3_2``, ``fc8``, ``conv1_bn``, ``block2_unit4``, ``logits``), so
``convert`` maps a flax tree by renaming leaves only. Images come in as
NHWC (N, H, W, 3), logits go out as (N, num_classes) float32; inside,
the convs run on NCHW views in ``channels_last`` memory.

Where PyTorch's defaults differ from flax's:

- flax's ``nn.max_pool`` pads VALID by default: the zoo's pools are
  ``F.max_pool2d`` without padding (floor), whose backward is PyTorch's,
  as the JAX package's is XLA's (AlexNet's 3×3/2 pools overlap);
- ``nn.Conv`` is SAME with a bias: the stride-1 convs here have odd
  kernels, so ``padding=k // 2``; the VALID convs (AlexNet's and
  OverFeat's 11×11/4 ``conv1``, OverFeat's ``conv2``, the ``fc6`` convs)
  have none;
- the flatten before ``LeNet``'s and ``CifarNet``'s ``fc3`` is in NHWC
  order, a view of the channels_last map, so a dense kernel maps by a
  transpose alone; the models need ``image_size`` for that layer's
  width, and ``in_channels`` (3, or MNIST's 1) for ``conv1``'s, which
  flax infers from the first input;
- dropout 0.5 is flax's rule on a generator the caller passes
  (``layers.dropout``), active only in training.

``ResNetV1`` is the JAX zoo's, not ``ResNet50V1``: its BatchNorm after
the root conv is ``conv1_bn`` and it ends in a global mean and a dense
``logits``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_yolo2_torch.models.layers import dropout, max_pool_same
from tensorflow_yolo2_torch.models.resnet import _BN, BottleneckV1, _conv

DROPOUT = 0.5


def _conv_same(in_ch: int, features: int, k: int) -> nn.Conv2d:
    """flax's stride-1 SAME ``nn.Conv`` with a bias (odd k)."""
    return nn.Conv2d(in_ch, features, k, padding=k // 2)


def _conv_valid(in_ch: int, features: int, k: int,
                stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, features, k, stride=stride)


def _drop(x: torch.Tensor, training: bool,
          generator: torch.Generator | None) -> torch.Tensor:
    if not training:
        return x
    if generator is None:
        raise ValueError("a zoo net with dropout needs a dropout generator "
                         "in training mode")
    return dropout(x, DROPOUT, generator)


def _nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class LeNet(nn.Module):
    """slim lenet: two 5×5 SAME conv + ReLU + 2×2 pool, ``fc3`` 1024
    (ReLU, dropout), ``fc4`` to the classes."""

    def __init__(self, num_classes: int = 10, image_size: int = 28,
                 in_channels: int = 3):
        super().__init__()
        side = image_size // 4
        self.conv1 = _conv_same(in_channels, 32, 5)
        self.conv2 = _conv_same(32, 64, 5)
        self.fc3 = nn.Linear(side * side * 64, 1024)
        self.fc4 = nn.Linear(1024, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = F.relu(self.fc3(_nhwc_flatten(x)))
        x = _drop(x, self.training, generator)
        return self.fc4(x).float()


class CifarNet(nn.Module):
    """slim cifarnet (the JAX zoo's, without LRN): two 5×5 conv + ReLU +
    2×2 pool, ``fc3`` 384 (dropout), ``fc4`` 192, ``logits``."""

    def __init__(self, num_classes: int = 10, image_size: int = 32,
                 in_channels: int = 3):
        super().__init__()
        side = image_size // 4
        self.conv1 = _conv_same(in_channels, 64, 5)
        self.conv2 = _conv_same(64, 64, 5)
        self.fc3 = nn.Linear(side * side * 64, 384)
        self.fc4 = nn.Linear(384, 192)
        self.logits = nn.Linear(192, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = F.relu(self.fc3(_nhwc_flatten(x)))
        x = _drop(x, self.training, generator)
        x = F.relu(self.fc4(x))
        return self.logits(x).float()


class _ConvHead(nn.Module):
    """The fc-as-conv head of AlexNet, OverFeat and VGG: ``fc6`` (VALID,
    ReLU, dropout), ``fc7`` 1×1 (ReLU, dropout), ``fc8`` 1×1, then the
    mean over the map."""

    def _head(self, x: torch.Tensor,
              generator: torch.Generator | None) -> torch.Tensor:
        x = _drop(F.relu(self.fc6(x)), self.training, generator)
        x = _drop(F.relu(self.fc7(x)), self.training, generator)
        return self.fc8(x).mean(dim=(2, 3)).float()


class AlexNet(_ConvHead):
    """slim alexnet_v2: 11×11/4 VALID conv1, 3×3/2 VALID pools after
    conv1, conv2 and conv5, then the conv head (``fc6`` 5×5 VALID)."""

    def __init__(self, num_classes: int = 1000, image_size: int = 224):
        super().__init__()
        self.conv1 = _conv_valid(3, 64, 11, 4)
        self.conv2 = _conv_same(64, 192, 5)
        self.conv3 = _conv_same(192, 384, 3)
        self.conv4 = _conv_same(384, 384, 3)
        self.conv5 = _conv_same(384, 256, 3)
        self.fc6 = _conv_valid(256, 4096, 5)
        self.fc7 = nn.Conv2d(4096, 4096, 1)
        self.fc8 = nn.Conv2d(4096, num_classes, 1)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 3, 2)
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = F.max_pool2d(F.relu(self.conv5(x)), 3, 2)
        return self._head(x, generator)


class OverFeat(_ConvHead):
    """slim overfeat: 11×11/4 VALID conv1, 5×5 VALID conv2, 2×2 VALID
    pools, then the conv head (``fc6`` 6×6 VALID to 3072)."""

    def __init__(self, num_classes: int = 1000, image_size: int = 231):
        super().__init__()
        self.conv1 = _conv_valid(3, 64, 11, 4)
        self.conv2 = _conv_valid(64, 256, 5)
        self.conv3 = _conv_same(256, 512, 3)
        self.conv4 = _conv_same(512, 1024, 3)
        self.conv5 = _conv_same(1024, 1024, 3)
        self.fc6 = _conv_valid(1024, 3072, 6)
        self.fc7 = nn.Conv2d(3072, 4096, 1)
        self.fc8 = nn.Conv2d(4096, num_classes, 1)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = F.max_pool2d(F.relu(self.conv5(x)), 2, 2)
        return self._head(x, generator)


VGG_WIDTHS = (64, 128, 256, 512, 512)


class VGG(_ConvHead):
    """slim vgg: ``stages`` 3×3 SAME convs (ReLU) per stage, a 2×2 VALID
    pool after each, then the conv head (``fc6`` 7×7 VALID)."""

    def __init__(self, stages: Sequence[int] = (2, 2, 3, 3, 3),
                 num_classes: int = 1000, image_size: int = 224):
        super().__init__()
        self.stages = tuple(stages)
        in_ch = 3
        for si, (n, w) in enumerate(zip(self.stages, VGG_WIDTHS), start=1):
            for ci in range(1, n + 1):
                self.add_module(f"conv{si}_{ci}", _conv_same(in_ch, w, 3))
                in_ch = w
        self.fc6 = _conv_valid(512, 4096, 7)
        self.fc7 = nn.Conv2d(4096, 4096, 1)
        self.fc8 = nn.Conv2d(4096, num_classes, 1)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        for si, n in enumerate(self.stages, start=1):
            for ci in range(1, n + 1):
                x = F.relu(getattr(self, f"conv{si}_{ci}")(x))
            x = F.max_pool2d(x, 2, 2)
        return self._head(x, generator)


RESNET_DEPTHS = (256, 512, 1024, 2048)
RESNET_BOTTLENECKS = (64, 128, 256, 512)


class ResNetV1(nn.Module):
    """The JAX zoo's resnet_v1 depth family on ``BottleneckV1``: the
    7×7/2 root conv (symmetric pad 3, no bias), ``conv1_bn``, ReLU, the
    SAME 3×3/2 pool, ``units`` bottlenecks a block (stride 2 on the last
    unit of every block but the last), the global mean, a dense
    ``logits``."""

    def __init__(self, units: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, image_size: int = 224):
        super().__init__()
        self.units = tuple(units)
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv1_bn = _BN(64)
        in_ch = 64
        for bi, n in enumerate(self.units, start=1):
            for ui in range(1, n + 1):
                stride = 2 if (ui == n and bi < len(self.units)) else 1
                self.add_module(f"block{bi}_unit{ui}", BottleneckV1(
                    in_ch, RESNET_DEPTHS[bi - 1], RESNET_BOTTLENECKS[bi - 1],
                    stride))
                in_ch = RESNET_DEPTHS[bi - 1]
        self.logits = nn.Linear(in_ch, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout; the trainer passes one to every model
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.conv1_bn(self.conv1(x)))
        x = max_pool_same(x, 3, 2)
        for bi, n in enumerate(self.units, start=1):
            for ui in range(1, n + 1):
                x = getattr(self, f"block{bi}_unit{ui}")(x)
        return self.logits(x.mean(dim=(2, 3))).float()


RESNET_V1_UNITS = {
    "resnet_v1_101": (3, 4, 23, 3),
    "resnet_v1_152": (3, 8, 36, 3),
    "resnet_v1_200": (3, 24, 36, 3),
}


def _entry(cls, size: int, **fixed):
    """(constructor, default size): the constructor takes
    ``num_classes`` and ``image_size`` (default ``size``)."""
    def build(num_classes: int = 1000, image_size: int = size) -> nn.Module:
        return cls(num_classes=num_classes, image_size=image_size, **fixed)
    return build, size


def _small_entry(cls, size: int):
    """``_entry`` for the nets of MNIST and CIFAR-10, whose constructor
    also takes ``in_channels``."""
    def build(num_classes: int = 1000, image_size: int = size,
              in_channels: int = 3) -> nn.Module:
        return cls(num_classes=num_classes, image_size=image_size,
                   in_channels=in_channels)
    return build, size


# name → (constructor, default_image_size); consumed by models.registry.
ZOO = {
    "lenet": _small_entry(LeNet, 28),
    "cifarnet": _small_entry(CifarNet, 32),
    "alexnet_v2": _entry(AlexNet, 224),
    "overfeat": _entry(OverFeat, 231),
    "vgg_a": _entry(VGG, 224, stages=(1, 1, 2, 2, 2)),
    "vgg_16": _entry(VGG, 224, stages=(2, 2, 3, 3, 3)),
    "vgg_19": _entry(VGG, 224, stages=(2, 2, 4, 4, 4)),
}
for _name, _units in RESNET_V1_UNITS.items():
    ZOO[_name] = _entry(ResNetV1, 224, units=_units)
