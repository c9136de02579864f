"""Darknet19 trunk + v1 detection head (port of
tensorflow_yolo2_tpu/models/darknet.py).

Module attribute names follow the flax parameter names
(``backbone.conv1.conv``, ``detection.output.bn``, …), so the weight
converter (``convert``) only renames paths.

Public layout is the JAX package's: images in as NHWC (N, H, W, 3), the
grid out as (N, S, S, output_channels) float32. Inside, the convs run on
NCHW views in ``channels_last`` memory.
"""

from __future__ import annotations

import torch
from torch import nn

from tensorflow_yolo2_torch.models.layers import ConvBN, max_pool

# (kernel_size, features) per conv, with "M" = 2×2/2 maxpool between stages.
# Like the reference, conv4 is a 3×3, not the YOLO9000 paper's 1×1.
_DARKNET19_SCHEDULE = (
    (3, 32), "M",
    (3, 64), "M",
    (3, 128), (3, 64), (3, 128), "M",
    (3, 256), (1, 128), (3, 256), "M",
    (3, 512), (1, 256), (3, 512), (1, 256), (3, 512), "M",
    (3, 1024), (1, 512), (3, 1024), (1, 512), (3, 1024),
)


class Darknet19Backbone(nn.Module):
    """18-conv Darknet19 trunk: NCHW (N, 3, H, W) → (N, 1024, H/32, W/32)."""

    def __init__(self, fold_bn: bool = False):
        super().__init__()
        in_ch, conv_i = 3, 0
        for item in _DARKNET19_SCHEDULE:
            if item == "M":
                continue
            k, f = item
            conv_i += 1
            self.add_module(f"conv{conv_i}",
                            ConvBN(in_ch, f, k, use_bn=not fold_bn))
            in_ch = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_i = 0
        for item in _DARKNET19_SCHEDULE:
            if item == "M":
                x = max_pool(x)
            else:
                conv_i += 1
                x = getattr(self, f"conv{conv_i}")(x)
        return x


class DetectionHead(nn.Module):
    """3×(3×3×1024) ConvBN + 1×1 output conv, output cast to float32.

    ``bn_on_output`` keeps the reference's BN + leaky on the output conv.
    """

    def __init__(self, output_channels: int = 30, bn_on_output: bool = True,
                 fold_bn: bool = False, in_channels: int = 1024):
        super().__init__()
        self.conv1 = ConvBN(in_channels, 1024, 3, use_bn=not fold_bn)
        self.conv2 = ConvBN(1024, 1024, 3, use_bn=not fold_bn)
        self.conv3 = ConvBN(1024, 1024, 3, use_bn=not fold_bn)
        self.output = ConvBN(1024, output_channels, 1,
                             use_bn=bn_on_output and not fold_bn,
                             activate=bn_on_output)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3(self.conv2(self.conv1(x)))
        return self.output(x).float()


class Darknet19Detector(nn.Module):
    """Backbone + detection head: NHWC images → (N, S, S, C) float32 grid.

    ``fold_bn=True`` builds the BN-free inference graph that takes the
    state dict of ``models.fold.fold_params``. Only ``downsample="pool"``
    (the reference architecture) is ported.
    """

    def __init__(self, output_channels: int = 30, bn_on_output: bool = True,
                 fold_bn: bool = False, downsample: str = "pool"):
        super().__init__()
        if downsample != "pool":
            raise NotImplementedError(
                "downsample='stride' is not ported yet (ROADMAP: deferred "
                "'--downsample stride', which needs an explicit "
                "F.pad(0, 1, 0, 1) for XLA's SAME stride-2 padding)")
        self.backbone = Darknet19Backbone(fold_bn=fold_bn)
        self.detection = DetectionHead(output_channels, bn_on_output, fold_bn)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)  # NHWC storage = NCHW channels_last
        x = self.detection(self.backbone(x))
        return x.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, in place: He-normal conv kernels, small conv
    biases, and BatchNorm affine terms and running statistics away from
    the identity, so a folded forward exercises every term of the fold."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            m.bias.normal_(0.0, 0.05, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.uniform_(0.5, 1.5, generator=generator)
            m.bias.normal_(0.0, 0.1, generator=generator)
            m.running_mean.normal_(0.0, 0.1, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
    return model
