"""Darknet19 trunk, the v1 detection head, the YOLOv2 passthrough head and
the ImageNet classifier (port of tensorflow_yolo2_tpu/models/darknet.py).

Module attribute names follow the flax parameter names
(``backbone.conv1.conv``, ``detection.output.bn``, ``conv19.bn``, …), so
the weight converter (``convert``) only renames paths, and a detector
takes its trunk from a classifier snapshot by name.

Public layout is the JAX package's: images in as NHWC (N, H, W, 3), the
grid out as (N, S, S, output_channels) float32 (the classifier's logits
as (N, num_classes) float32). Inside, the convs run on NCHW views in
``channels_last`` memory.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tensorflow_yolo2_torch.models.layers import (
    BN_MOMENTUM,
    ConvBN,
    avg_pool,
    max_pool,
    space_to_depth,
)

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
_STEM_ITEMS = 4  # conv1, pool, conv2, pool: what the fast stems compute


class Darknet19Backbone(nn.Module):
    """18-conv Darknet19 trunk: NCHW (N, 3, H, W) → (N, 1024, H/32, W/32).

    ``downsample="pool"`` is the reference's 2×2/2 max pool between
    stages; ``"stride"`` instead gives the 3×3 conv after each "M" stride
    2 (the JAX package's pool-free training variant; same parameters).
    ``bn_momentum`` is the BatchNorm running-statistic momentum (flax's
    convention; the reference's 0.99).
    """

    def __init__(self, fold_bn: bool = False, downsample: str = "pool",
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        if downsample not in ("pool", "stride"):
            raise ValueError(f"downsample must be 'pool' or 'stride', got "
                             f"{downsample!r}")
        self.downsample = downsample
        in_ch, conv_i, stride = 3, 0, 1
        for item in _DARKNET19_SCHEDULE:
            if item == "M":
                stride = 2 if downsample == "stride" else 1
                continue
            k, f = item
            conv_i += 1
            self.add_module(f"conv{conv_i}",
                            ConvBN(in_ch, f, k, use_bn=not fold_bn,
                                   stride=stride, bn_momentum=bn_momentum))
            in_ch, stride = f, 1

    def forward(self, x: torch.Tensor, return_mid: bool = False,
                after_stem: bool = False):
        """``return_mid=True`` also returns ``mid``, the (N, 512, H/16,
        W/16) map that feeds the last downsample: the YOLOv2
        passthrough source. ``after_stem=True`` takes the (N, 64, H/4,
        W/4) map after the second pool, as a fast stem computes it, and
        runs conv3 on."""
        schedule, conv_i, mid = _DARKNET19_SCHEDULE, 0, None
        if after_stem:
            if self.downsample != "pool":
                raise ValueError("after_stem follows the pool-based stem; "
                                 "the stride variant has no pools")
            schedule, conv_i = schedule[_STEM_ITEMS:], 2
        for item in schedule:
            if item == "M":
                mid = x
                if self.downsample == "pool":
                    x = max_pool(x)
            else:
                conv_i += 1
                x = getattr(self, f"conv{conv_i}")(x)
        return (x, mid) if return_mid else x


class Darknet19Classifier(nn.Module):
    """Darknet19 ImageNet classifier: NHWC images → (N, num_classes)
    float32 logits.

    The trunk, a 1×1 ``conv19`` to ``num_classes`` channels (with the
    reference's BN + leaky when ``bn_on_output``; linear without), then
    the SAME average pool over an H×H window (``layers.avg_pool``), so
    that 448² inputs work too. A map wider than it is high leaves more
    than one output a class, which the reshape refuses, as in the JAX
    package.
    """

    def __init__(self, num_classes: int = 1000, bn_on_output: bool = True,
                 fold_bn: bool = False, downsample: str = "pool",
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = Darknet19Backbone(fold_bn=fold_bn,
                                          downsample=downsample,
                                          bn_momentum=bn_momentum)
        self.conv19 = ConvBN(1024, num_classes, 1,
                             use_bn=bn_on_output and not fold_bn,
                             activate=bn_on_output, bn_momentum=bn_momentum)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout; the trainer passes one to every model
        x = self.conv19(self.backbone(images.permute(0, 3, 1, 2)))
        h = x.shape[2]
        x = avg_pool(x, h, h)
        return x.reshape(x.shape[0], self.num_classes).float()


class DetectionHead(nn.Module):
    """3×(3×3×1024) ConvBN + 1×1 output conv, output cast to float32.

    ``bn_on_output`` keeps the reference's BN + leaky on the output conv;
    without it the output conv is linear (the ``--v2`` head).
    """

    def __init__(self, output_channels: int = 30, bn_on_output: bool = True,
                 fold_bn: bool = False, in_channels: int = 1024,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        kw = {"use_bn": not fold_bn, "bn_momentum": bn_momentum}
        self.conv1 = ConvBN(in_channels, 1024, 3, **kw)
        self.conv2 = ConvBN(1024, 1024, 3, **kw)
        self.conv3 = ConvBN(1024, 1024, 3, **kw)
        self.output = ConvBN(1024, output_channels, 1,
                             use_bn=bn_on_output and not fold_bn,
                             activate=bn_on_output, bn_momentum=bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3(self.conv2(self.conv1(x)))
        return self.output(x).float()


class DetectionHeadV2(nn.Module):
    """The YOLOv2 head with the passthrough (reorg) route.

    Two 3×3×1024 ConvBN on the trunk output; the trunk's H/16 map through
    a 1×1×64 ConvBN and a 2×2 space-to-depth to (256, H/32, W/32),
    concatenated after the main path's 1024 channels; a 3×3×1024 ConvBN
    on the 1280 channels; a linear 1×1 output conv, cast to float32.
    """

    def __init__(self, output_channels: int = 125, fold_bn: bool = False,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        kw = {"use_bn": not fold_bn, "bn_momentum": bn_momentum}
        self.conv1 = ConvBN(1024, 1024, 3, **kw)
        self.conv2 = ConvBN(1024, 1024, 3, **kw)
        self.passthrough = ConvBN(512, 64, 1, **kw)
        self.conv3 = ConvBN(1024 + 4 * 64, 1024, 3, **kw)
        self.output = ConvBN(1024, output_channels, 1, use_bn=False,
                             activate=False)

    def forward(self, x: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        p = self.passthrough(mid)
        # the reorg on the NHWC view, so that channel (2·r_row + r_col)·64
        # + c is the JAX package's order whatever p's memory layout
        p = space_to_depth(p.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = self.conv3(torch.cat([x, p], dim=1))
        return self.output(x).float()


class Darknet19Detector(nn.Module):
    """Backbone + detection head: NHWC images → (N, S, S, C) float32 grid.

    ``fold_bn=True`` builds the BN-free inference graph that takes the
    state dict of ``models.fold.fold_params``.
    """

    def __init__(self, output_channels: int = 30, bn_on_output: bool = True,
                 fold_bn: bool = False, downsample: str = "pool",
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.backbone = Darknet19Backbone(fold_bn=fold_bn,
                                          downsample=downsample,
                                          bn_momentum=bn_momentum)
        self.detection = DetectionHead(output_channels, bn_on_output, fold_bn,
                                       bn_momentum=bn_momentum)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout; the trainer passes one to every model
        x = images.permute(0, 3, 1, 2)  # NHWC storage = NCHW channels_last
        x = self.detection(self.backbone(x))
        return x.permute(0, 2, 3, 1).contiguous()


class Darknet19DetectorV2(nn.Module):
    """Backbone + passthrough head → (N, S, S, B·(5+C)) anchor grid: the
    YOLOv2 architecture. Backbone names match ``Darknet19Detector``."""

    def __init__(self, output_channels: int = 125, fold_bn: bool = False,
                 downsample: str = "pool", bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.backbone = Darknet19Backbone(fold_bn=fold_bn,
                                          downsample=downsample,
                                          bn_momentum=bn_momentum)
        self.detection = DetectionHeadV2(output_channels, fold_bn,
                                         bn_momentum)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout; the trainer passes one to every model
        x, mid = self.backbone(images.permute(0, 3, 1, 2), return_mid=True)
        return self.detection(x, mid).permute(0, 2, 3, 1).contiguous()


# flax's truncated normal keeps [-2σ, 2σ] and rescales σ by this, so
# that the truncated distribution has the requested variance
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded fresh weights with flax's defaults, in place: lecun-normal
    conv and dense kernels (variance 1/fan_in, truncated at two standard
    deviations), zero biases, BatchNorm scale 1, bias 0, running mean 0
    and variance 1."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


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
