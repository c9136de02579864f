"""ResNet50-v1 trunk, its ImageNet classifier form and the YOLO-head
detector (port of tensorflow_yolo2_tpu/models/resnet.py).

Module attribute names follow the flax parameter names
(``backbone.block1_unit1.conv1``, ``backbone.block1_unit1.bn1.bn``,
``yolo_fc1``, ``logits``), so that ``convert`` maps a flax tree by
renaming leaves only. Images come in as NHWC (N, H, W, 3); inside, the
convs run on NCHW views in ``channels_last`` memory, as the Darknet
trunk's do.

Where PyTorch's defaults differ from flax's, each difference is spelled
out:

- the stride-2 convs pad explicitly (3 for the 7×7 root conv, 1 for a
  unit's 3×3 ``conv2``), symmetric, as slim's ``conv2d_same``; the
  stride-1 convs are flax's SAME, symmetric for odd kernels;
- the root max pool is flax's 3×3/2 SAME pool (``layers.max_pool_same``,
  low 0 and high 1 with −inf on an even map), not ``nn.MaxPool2d(3, 2,
  1)``;
- BatchNorm keeps slim's ResNet constants, momentum 0.997 and epsilon
  1e-5, and flax's running-statistic update (``layers.BatchNorm``);
- the detector flattens the (N, 2048, h, w) map in NHWC order, as the
  JAX package's ``reshape`` of its NHWC map does, so ``yolo_fc1``'s
  weight is the flax kernel transposed with no permutation of its rows;
- dropout between the FCs is flax's rule on a generator the caller
  passes (``layers.dropout``), active only in training.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_yolo2_torch.models.layers import (
    BatchNorm,
    dropout,
    max_pool_same,
)

BN_EPSILON = 1e-5
BN_MOMENTUM = 0.997

# (depth, depth_bottleneck, num_units) for ResNet50.
_R50_BLOCKS: Sequence[tuple[int, int, int]] = (
    (256, 64, 3), (512, 128, 4), (1024, 256, 6), (2048, 512, 3),
)


def _conv(in_channels: int, features: int, kernel: int,
          stride: int = 1) -> nn.Conv2d:
    """slim's ``conv2d_same``: stride 1 is SAME; stride 2 pads
    (kernel − 1) // 2 low and the rest high, which for the odd kernels
    here is symmetric. A 1×1 conv needs no padding at any stride."""
    return nn.Conv2d(in_channels, features, kernel, stride=stride,
                     padding=(kernel - 1) // 2, bias=False)


class _BN(nn.Module):
    """slim's batch_norm with the ResNet constants; the flax module of
    the same name nests its BatchNorm as ``bn``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features, eps=BN_EPSILON,
                            momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class BottleneckV1(nn.Module):
    """ResNet v1 bottleneck: 1×1 → 3×3 (stride) → 1×1, BatchNorm after
    every conv, ReLU after the add. The shortcut is a projection (1×1
    conv at the stride + BatchNorm) when the depth changes, else the
    input subsampled at the stride."""

    def __init__(self, in_channels: int, depth: int, depth_bottleneck: int,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        if depth != in_channels:
            self.shortcut_conv = _conv(in_channels, depth, 1, stride)
            self.shortcut_bn = _BN(depth)
        else:
            self.shortcut_conv = None
        self.conv1 = _conv(in_channels, depth_bottleneck, 1)
        self.bn1 = _BN(depth_bottleneck)
        self.conv2 = _conv(depth_bottleneck, depth_bottleneck, 3, stride)
        self.bn2 = _BN(depth_bottleneck)
        self.conv3 = _conv(depth_bottleneck, depth, 1)
        self.bn3 = _BN(depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_conv is not None:
            shortcut = self.shortcut_bn(self.shortcut_conv(x))
        else:
            # flax's 1×1 max pool at the stride
            shortcut = x[:, :, ::self.stride, ::self.stride]
        r = F.relu(self.bn1(self.conv1(x)))
        r = F.relu(self.bn2(self.conv2(r)))
        r = self.bn3(self.conv3(r))
        return F.relu(shortcut + r)


class ResNet50V1(nn.Module):
    """slim-compatible ResNet50-v1: NHWC images → the float32 NHWC
    (N, H/32, W/32, 2048) map for ``num_classes=None``, else a 1×1
    ``logits`` conv with bias on it: after a global mean with
    ``global_pool``, (N, num_classes) float32 logits. Stride 2 sits on
    the last unit of blocks 1–3."""

    def __init__(self, num_classes: int | None = None,
                 global_pool: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.global_pool = global_pool
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv1_bn = _BN(64)
        in_ch = 64
        for bi, (depth, depth_bn, units) in enumerate(_R50_BLOCKS, start=1):
            last_block = bi == len(_R50_BLOCKS)
            for ui in range(1, units + 1):
                stride = 2 if (ui == units and not last_block) else 1
                self.add_module(f"block{bi}_unit{ui}",
                                BottleneckV1(in_ch, depth, depth_bn, stride))
                in_ch = depth
        self.logits = (nn.Conv2d(in_ch, num_classes, 1)
                       if num_classes is not None else None)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW input → the block4 map."""
        x = F.relu(self.conv1_bn(self.conv1(x)))
        x = max_pool_same(x, 3, 2)
        for bi, (_, _, units) in enumerate(_R50_BLOCKS, start=1):
            for ui in range(1, units + 1):
                x = getattr(self, f"block{bi}_unit{ui}")(x)
        return x

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout; the trainer passes one to every model
        x = self.trunk(images.permute(0, 3, 1, 2))
        if self.global_pool:
            x = x.mean(dim=(2, 3), keepdim=True)
        if self.logits is not None:
            x = self.logits(x)
        if self.global_pool and self.logits is not None:
            return x.reshape(x.shape[0], self.num_classes).float()
        return x.permute(0, 2, 3, 1).float()


class ResNet50Detector(nn.Module):
    """ResNet50 trunk + the FC YOLO head: NHWC images → (N, S, S,
    output_channels) float32 grid.

    flatten (NHWC order) → ``yolo_fc1`` 4096, ReLU → dropout
    (``dropout_rate``, training only) → ``yolo_fc2`` S·S·output_channels
    → ReLU (the slim ``fully_connected`` default that the reference keeps
    on its output layer, ``tensorflow_yolo2_tpu/models/resnet.py:192``) →
    the grid. ``image_size`` fixes ``yolo_fc1``'s input, 2048·⌈size/32⌉²
    (flax infers it from the first input).

    In training with ``dropout_rate`` > 0 the forward needs
    ``generator``, a ``torch.Generator`` on the input's device, as a flax
    apply needs a dropout rng.
    """

    def __init__(self, output_channels: int = 30, S: int = 7,
                 image_size: int = 224, dropout_rate: float = 0.5):
        super().__init__()
        self.S = S
        self.output_channels = output_channels
        self.dropout_rate = dropout_rate
        self.backbone = ResNet50V1(global_pool=False)
        side = -(-image_size // 32)
        self.yolo_fc1 = nn.Linear(2048 * side * side, 4096)
        self.yolo_fc2 = nn.Linear(4096, S * S * output_channels)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.backbone.trunk(images.permute(0, 3, 1, 2))
        # NHWC order: a view of the channels_last map
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.yolo_fc1(x))
        if self.training and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("ResNet50Detector in training mode needs a "
                                 "dropout generator")
            x = dropout(x, self.dropout_rate, generator)
        x = F.relu(self.yolo_fc2(x))
        return x.reshape(x.shape[0], self.S, self.S,
                         self.output_channels).float()
