"""Layer primitives (port of tensorflow_yolo2_tpu/models/layers.py).

Modules take NCHW tensors (the trunk keeps them in ``channels_last``
memory, which is NHWC in storage); the free functions keep the JAX
package's NHWC layout where they work on images.

The conv keeps its bias in front of BatchNorm, as the reference does, so
imported checkpoints map 1:1; BatchNorm uses TF1's epsilon 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_ALPHA = 0.1
BN_EPSILON = 1e-3


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_ALPHA) -> torch.Tensor:
    """max(alpha·x, x) — the reference's hand-rolled leaky ReLU."""
    return torch.maximum(alpha * x, x)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H/2, W/2, 4C); channel = (2·r_row + r_col)·C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 SAME max pool of an NCHW tensor.

    ``ceil_mode`` keeps the last partial window of an odd size, which is
    what SAME's -inf padding gives; on even sizes it is a VALID pool.
    """
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class ConvBN(nn.Module):
    """k×k SAME conv (with bias) + BatchNorm + leaky-ReLU.

    ``use_bn=False`` is a plain conv+bias(+leaky) — the shape BN folding
    produces for inference; ``activate=False`` drops the leaky.

    ``stride=2`` pads as XLA's SAME does on an even input: the total
    padding k−2 goes low ⌊·/2⌋, high the rest (low 0, high 1 for a 3×3),
    where torch's symmetric ``padding`` would shift the sampling grid.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 use_bn: bool = True, activate: bool = True,
                 stride: int = 1):
        super().__init__()
        if stride == 1:
            self.pad, padding = None, kernel_size // 2
        else:
            total = max(kernel_size - stride, 0)
            low = total // 2
            self.pad, padding = (low, total - low, low, total - low), 0
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              stride=stride, padding=padding, bias=True)
        self.bn = (nn.BatchNorm2d(features, eps=BN_EPSILON, momentum=0.01)
                   if use_bn else None)
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad is not None:
            x = F.pad(x, self.pad)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activate:
            x = leaky_relu(x)
        return x
