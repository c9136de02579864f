"""The inception family (port of tensorflow_yolo2_tpu/models/inception.py):
``InceptionV1`` (GoogLeNet with BatchNorm; the two paper auxiliary heads
behind ``aux_logits``, averaged), ``InceptionV2`` (the separable 7×7
stem), ``InceptionV3`` (slim's auxiliary tower off the last 17×17 block
behind ``aux_logits``), ``InceptionV4`` (its auxiliary tower likewise)
and ``InceptionResnetV2`` (the residual block35 / 17 / 8 towers).

Submodule names are the flax ones (``conv1``, ``mixed_3b.b1a``,
``mixed6_2.b2e``, ``a0_b1b``, ``block17_11.up``, ``aux_4a.fc``,
``aux_logits``, ``logits``; each ``ConvBNReLU`` holds ``conv`` and
``bn``), so ``convert`` maps a flax tree by renaming leaves only. Images
come in as NHWC (N, H, W, 3), logits go out as (N, num_classes) float32,
and with ``aux_logits`` the model returns ``(logits, aux_logits)``, both
float32; inside, the convs run on NCHW views in ``channels_last`` memory.

Where PyTorch's defaults differ from flax's, each difference is spelled
out:

- ``ConvBNReLU`` is slim's conv with batch_norm: no conv bias, BatchNorm
  with momentum 0.9997, epsilon 1e-3 and **no scale**
  (``layers.BatchNorm(use_scale=False)``: no ``weight`` parameter);
- the convs follow each call's padding: SAME ones pad as XLA does
  (``layers.SameConv2d``: symmetric at stride 1, low ⌊·/2⌋ and high the
  rest at stride 2), VALID ones not at all;
- the max pools follow each call's padding too: v1's and v2's SAME pools
  (3×3/2, 3×3/1 and v1's 2×2/2) pad −inf as XLA does
  (``layers.max_pool_same``; low 0 and high 1 on an even map at stride
  2), v3's, v4's and Inception-ResNet-v2's are flax's default VALID
  pools (``F.max_pool2d`` without padding). None is the Darknet pool, so
  none runs backward through B5;
- the branch average pools are 3×3/1 SAME with the pads out of the
  divisor (``layers.avg_pool_exclusive``); the auxiliary heads' pools are
  VALID;
- the auxiliary heads' kernels and dense widths depend on the map size,
  which flax reads from the first input: here they come from
  ``image_size`` at construction (slim's reduced kernel for small
  inputs). v1's ``fc`` flattens its map in NHWC order, a view of the
  channels_last map, so its kernel maps by a transpose alone;
- the residual blocks add ``scale · up`` (0.17, 0.10, 0.20; the final
  ``block8_post`` 1.0 without the ReLU), ``up`` a 1×1 conv with a bias;
- dropout (0.2 before ``logits``, 0.7 in v1's auxiliary heads) is flax's
  rule on a generator the caller passes (``layers.dropout``), drawn in
  the order of the forward, active only in training.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_yolo2_torch.models.layers import (
    SLIM_BN_MOMENTUM,
    BatchNorm,
    SameConv2d,
    SeparableConvBNReLU,
    avg_pool_exclusive,
    dropout,
    max_pool_same,
)
from tensorflow_yolo2_torch.models.zoo import _entry

HEAD_DROPOUT = 0.2
AUX_V1_DROPOUT = 0.7


def _valid(n: int, k: int, s: int = 1) -> int:
    """A VALID conv or pool's output side."""
    return (n - k) // s + 1


def _same(n: int, s: int) -> int:
    """A SAME conv or pool's output side."""
    return -(-n // s)


def _drop(x: torch.Tensor, rate: float, training: bool,
          generator: torch.Generator | None) -> torch.Tensor:
    if not training:
        return x
    if generator is None:
        raise ValueError("an inception net needs a dropout generator in "
                         "training mode")
    return dropout(x, rate, generator)


def _nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _branch_pool(x: torch.Tensor) -> torch.Tensor:
    return avg_pool_exclusive(x, 3, 1)


class ConvBNReLU(nn.Module):
    """slim's conv2d with batch_norm: a conv without bias (SAME or VALID,
    k or (kh, kw)), BatchNorm without a scale, ReLU."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3),
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.conv = (SameConv2d(in_channels, features, kernel, stride,
                                bias=False) if padding == "SAME" else
                     nn.Conv2d(in_channels, features, kernel, stride=stride,
                               bias=False))
        self.bn = BatchNorm(features, momentum=SLIM_BN_MOMENTUM,
                            use_scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


# -- Inception v1 ------------------------------------------------------------


class _MixedV1(nn.Module):
    """GoogLeNet block: 1×1 | 1×1→3×3 | 1×1→3×3 | 3×3/1 max pool→1×1."""

    def __init__(self, in_ch: int, b0: int, b1: tuple[int, int],
                 b2: tuple[int, int], b3: int):
        super().__init__()
        self.b0 = ConvBNReLU(in_ch, b0, 1)
        self.b1a = ConvBNReLU(in_ch, b1[0], 1)
        self.b1b = ConvBNReLU(b1[0], b1[1], 3)
        self.b2a = ConvBNReLU(in_ch, b2[0], 1)
        self.b2b = ConvBNReLU(b2[0], b2[1], 3)
        self.b3 = ConvBNReLU(in_ch, b3, 1)
        self.out_channels = b0 + b1[1] + b2[1] + b3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)),
                          self.b3(max_pool_same(x, 3, 1))], dim=1)


class _AuxHeadV1(nn.Module):
    """The GoogLeNet paper's auxiliary classifier on a ``side``² map:
    avg pool (min(5, side))²/3 VALID → ``proj`` 1×1 128 → NHWC flatten →
    ``fc`` 1024, ReLU → dropout 0.7 → ``logits``."""

    def __init__(self, in_ch: int, side: int, num_classes: int):
        super().__init__()
        self.window = min(5, side)
        pooled = _valid(side, self.window, 3)
        self.proj = ConvBNReLU(in_ch, 128, 1)
        self.fc = nn.Linear(pooled * pooled * 128, 1024)
        self.logits = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        x = F.avg_pool2d(x, self.window, 3)
        x = F.relu(self.fc(_nhwc_flatten(self.proj(x))))
        x = _drop(x, AUX_V1_DROPOUT, self.training, generator)
        return self.logits(x).float()


_V1_SPECS = (
    ("3a", 64, (96, 128), (16, 32), 32),
    ("3b", 128, (128, 192), (32, 96), 64), ("pool", 3),
    ("4a", 192, (96, 208), (16, 48), 64),
    ("4b", 160, (112, 224), (24, 64), 64),
    ("4c", 128, (128, 256), (24, 64), 64),
    ("4d", 112, (144, 288), (32, 64), 64),
    ("4e", 256, (160, 320), (32, 128), 128), ("pool", 2),
    ("5a", 256, (160, 320), (32, 128), 128),
    ("5b", 384, (192, 384), (48, 128), 128),
)


class InceptionV1(nn.Module):
    """GoogLeNet (slim inception_v1's structure). Its inter-stage pools
    are SAME 3×3/2, the last one 2×2/2. ``aux_logits`` adds the paper's
    heads after ``mixed_4a`` and ``mixed_4d`` and returns ``(logits,
    mean of the two heads)``."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 image_size: int = 224):
        super().__init__()
        self.aux = aux_logits
        self.conv1 = ConvBNReLU(3, 64, 7, 2)
        self.conv2 = ConvBNReLU(64, 64, 1)
        self.conv3 = ConvBNReLU(64, 192, 3)
        side = _same(_same(_same(_same(image_size, 2), 2), 2), 2)
        in_ch = 192
        self.stages: list = []
        for spec in _V1_SPECS:
            if spec[0] == "pool":
                self.stages.append(spec)
                continue
            name, b0, b1, b2, b3 = spec
            block = _MixedV1(in_ch, b0, b1, b2, b3)
            self.add_module(f"mixed_{name}", block)
            self.stages.append(("mixed", name))
            in_ch = block.out_channels
            if aux_logits and name in ("4a", "4d"):
                self.add_module(f"aux_{name}",
                                _AuxHeadV1(in_ch, side, num_classes))
        self.logits = nn.Linear(in_ch, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None):
        x = images.permute(0, 3, 1, 2)
        x = max_pool_same(self.conv1(x), 3, 2)
        x = max_pool_same(self.conv3(self.conv2(x)), 3, 2)
        aux = []
        for kind, arg in self.stages:
            if kind == "pool":
                x = max_pool_same(x, arg, 2)
                continue
            x = getattr(self, f"mixed_{arg}")(x)
            if self.aux and arg in ("4a", "4d"):
                aux.append(getattr(self, f"aux_{arg}")(x, generator))
        x = _drop(x.mean(dim=(2, 3)), HEAD_DROPOUT, self.training, generator)
        logits = self.logits(x).float()
        if self.aux:
            return logits, (aux[0] + aux[1]) / 2.0
        return logits


# -- Inception v2 ------------------------------------------------------------


class _MixedV2(nn.Module):
    """Inception-v2 block: 1×1 | 1×1→3×3 | 1×1→3×3→3×3 | pool→1×1, the
    pool a 3×3/1 exclusive average (a SAME max in ``mixed_5c``)."""

    def __init__(self, in_ch: int, b0: int, b1: tuple[int, int],
                 b2: tuple[int, int, int], b3: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.b0 = ConvBNReLU(in_ch, b0, 1)
        self.b1a = ConvBNReLU(in_ch, b1[0], 1)
        self.b1b = ConvBNReLU(b1[0], b1[1], 3)
        self.b2a = ConvBNReLU(in_ch, b2[0], 1)
        self.b2b = ConvBNReLU(b2[0], b2[1], 3)
        self.b2c = ConvBNReLU(b2[1], b2[2], 3)
        self.b3 = ConvBNReLU(in_ch, b3, 1)
        self.out_channels = b0 + b1[1] + b2[2] + b3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = (_branch_pool(x) if self.pool == "avg"
                  else max_pool_same(x, 3, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2c(self.b2b(self.b2a(x))),
                          self.b3(pooled)], dim=1)


class _ReductionV2(nn.Module):
    """Inception-v2 grid reduction: 1×1→3×3/2 | 1×1→3×3→3×3/2 | SAME
    3×3/2 max pool."""

    def __init__(self, in_ch: int, b0: tuple[int, int],
                 b1: tuple[int, int, int]):
        super().__init__()
        self.b0a = ConvBNReLU(in_ch, b0[0], 1)
        self.b0b = ConvBNReLU(b0[0], b0[1], 3, 2)
        self.b1a = ConvBNReLU(in_ch, b1[0], 1)
        self.b1b = ConvBNReLU(b1[0], b1[1], 3)
        self.b1c = ConvBNReLU(b1[1], b1[2], 3, 2)
        self.out_channels = b0[1] + b1[2] + in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0b(self.b0a(x)),
                          self.b1c(self.b1b(self.b1a(x))),
                          max_pool_same(x, 3, 2)], dim=1)


_V2_BLOCKS = (
    ("mixed_3b", (64, (64, 64), (64, 96, 96), 32)),
    ("mixed_3c", (64, (64, 96), (64, 96, 96), 64)),
    ("mixed_4a", ((128, 160), (64, 96, 96))),
    ("mixed_4b", (224, (64, 96), (96, 128, 128), 128)),
    ("mixed_4c", (192, (96, 128), (96, 128, 128), 128)),
    ("mixed_4d", (160, (128, 160), (128, 160, 160), 96)),
    ("mixed_4e", (96, (128, 192), (160, 192, 192), 96)),
    ("mixed_5a", ((128, 192), (192, 256, 256))),
    ("mixed_5b", (352, (192, 320), (160, 224, 224), 128)),
    ("mixed_5c", (352, (192, 320), (192, 224, 224), 128)),
)


class InceptionV2(nn.Module):
    """The BatchNorm paper's Inception (slim inception_v2): a separable
    7×7/2 stem with depth multiplier 8, SAME 3×3/2 max pools, double-3×3
    towers, slim's branch widths."""

    def __init__(self, num_classes: int = 1000, image_size: int = 224):
        super().__init__()
        self.conv1 = SeparableConvBNReLU(3, 64, 7, depth_multiplier=8,
                                         stride=2)
        self.conv2b = ConvBNReLU(64, 64, 1)
        self.conv2c = ConvBNReLU(64, 192, 3)
        in_ch = 192
        self.blocks: list[str] = []
        for name, spec in _V2_BLOCKS:
            block = (_ReductionV2(in_ch, *spec) if len(spec) == 2 else
                     _MixedV2(in_ch, *spec,
                              pool="max" if name == "mixed_5c" else "avg"))
            self.add_module(name, block)
            self.blocks.append(name)
            in_ch = block.out_channels
        self.logits = nn.Linear(in_ch, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = max_pool_same(self.conv1(images.permute(0, 3, 1, 2)), 3, 2)
        x = max_pool_same(self.conv2c(self.conv2b(x)), 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = _drop(x.mean(dim=(2, 3)), HEAD_DROPOUT, self.training, generator)
        return self.logits(x).float()


# -- Inception v3 ------------------------------------------------------------


def _conv(module: nn.Module, name: str, in_ch: int, features: int, kernel,
          stride: int = 1, padding: str = "SAME") -> int:
    """Add a ``ConvBNReLU`` child ``name``; its output channels."""
    module.add_module(name, ConvBNReLU(in_ch, features, kernel, stride,
                                       padding))
    return features


def _apply(module: nn.Module, names: Sequence[str],
           x: torch.Tensor) -> torch.Tensor:
    for name in names:
        x = getattr(module, name)(x)
    return x


def _add_chains(module: nn.Module, in_ch: int, chains, prefix: str = ""
                ) -> tuple[list[tuple[str, ...]], int]:
    """Add the ``ConvBNReLU`` chains of a tower's branches, each
    ``(name, features, kernel)`` a conv named ``prefix + name``: (the
    names of each chain, the branches' total output channels)."""
    names, width = [], 0
    for chain in chains:
        c = in_ch
        for name, features, kernel in chain:
            c = _conv(module, prefix + name, c, features, kernel)
        names.append(tuple(prefix + name for name, _, _ in chain))
        width += c
    return names, width


class _MixedV3A(nn.Module):
    """35×35 tower: 1×1 | 1×1→5×5 | 1×1→3×3→3×3 | avg→1×1."""

    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        _conv(self, "b0", in_ch, 64, 1)
        _conv(self, "b1a", in_ch, 48, 1)
        _conv(self, "b1b", 48, 64, 5)
        _conv(self, "b2a", in_ch, 64, 1)
        _conv(self, "b2b", 64, 96, 3)
        _conv(self, "b2c", 96, 96, 3)
        _conv(self, "b3", in_ch, pool_features, 1)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), _apply(self, ("b1a", "b1b"), x),
                          _apply(self, ("b2a", "b2b", "b2c"), x),
                          self.b3(_branch_pool(x))], dim=1)


class _MixedV3B(nn.Module):
    """17×17 tower with the 1×7 / 7×1 factorization."""

    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        _conv(self, "b0", in_ch, 192, 1)
        _conv(self, "b1a", in_ch, c7, 1)
        _conv(self, "b1b", c7, c7, (1, 7))
        _conv(self, "b1c", c7, 192, (7, 1))
        _conv(self, "b2a", in_ch, c7, 1)
        _conv(self, "b2b", c7, c7, (7, 1))
        _conv(self, "b2c", c7, c7, (1, 7))
        _conv(self, "b2d", c7, c7, (7, 1))
        _conv(self, "b2e", c7, 192, (1, 7))
        _conv(self, "b3", in_ch, 192, 1)
        self.out_channels = 768

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), _apply(self, ("b1a", "b1b", "b1c"), x),
                          _apply(self, ("b2a", "b2b", "b2c", "b2d", "b2e"),
                                 x),
                          self.b3(_branch_pool(x))], dim=1)


class _MixedV3C(nn.Module):
    """8×8 tower with the split 1×3 | 3×1 ends."""

    def __init__(self, in_ch: int):
        super().__init__()
        _conv(self, "b0", in_ch, 320, 1)
        _conv(self, "b1a", in_ch, 384, 1)
        _conv(self, "b1b", 384, 384, (1, 3))
        _conv(self, "b1c", 384, 384, (3, 1))
        _conv(self, "b2a", in_ch, 448, 1)
        _conv(self, "b2b", 448, 384, 3)
        _conv(self, "b2c", 384, 384, (1, 3))
        _conv(self, "b2d", 384, 384, (3, 1))
        _conv(self, "b3", in_ch, 192, 1)
        self.out_channels = 2048

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t1 = self.b1a(x)
        t2 = self.b2b(self.b2a(x))
        return torch.cat([self.b0(x), self.b1b(t1), self.b1c(t1),
                          self.b2c(t2), self.b2d(t2),
                          self.b3(_branch_pool(x))], dim=1)


def _stem_v3_side(image_size: int) -> int:
    """The side after v3's and Inception-ResNet-v2's stem (3×3/2 VALID,
    3×3 VALID, 3×3 SAME, pool, 1×1, 3×3 VALID, pool)."""
    n = _valid(_valid(image_size, 3, 2), 3)
    n = _valid(_valid(n, 3, 2), 3)
    return _valid(n, 3, 2)


_STEM_V3 = (("conv1a", 3, 32, 3, 2, "VALID"), ("conv2a", 32, 32, 3, 1,
                                                "VALID"),
            ("conv2b", 32, 64, 3, 1, "SAME"), ("pool",),
            ("conv3b", 64, 80, 1, 1, "VALID"),
            ("conv4a", 80, 192, 3, 1, "VALID"), ("pool",))


def _add_stem(module: nn.Module) -> None:
    for spec in _STEM_V3:
        if spec[0] != "pool":
            _conv(module, *spec)


def _run_stem(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    for spec in _STEM_V3:
        x = (F.max_pool2d(x, 3, 2) if spec[0] == "pool"
             else getattr(module, spec[0])(x))
    return x


class InceptionV3(nn.Module):
    """slim inception_v3's structure (299² default). ``aux_logits`` adds
    slim's tower off the last 17×17 block (avg 5×5/3 VALID → ``aux_proj``
    1×1 128 → ``aux_conv`` (min(5, side))² VALID 768 → ``aux_logits`` 1×1
    conv → mean over the map) and returns ``(logits, aux)``."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 image_size: int = 299):
        super().__init__()
        self.aux = aux_logits
        _add_stem(self)
        in_ch = 192
        for i, pf in enumerate((32, 64, 64)):
            block = _MixedV3A(in_ch, pf)
            self.add_module(f"mixed5_{i}", block)
            in_ch = block.out_channels
        _conv(self, "red1_b0", in_ch, 384, 3, 2, "VALID")
        _conv(self, "red1_b1a", in_ch, 64, 1)
        _conv(self, "red1_b1b", 64, 96, 3)
        _conv(self, "red1_b1c", 96, 96, 3, 2, "VALID")
        in_ch = 384 + 96 + in_ch
        for i, c7 in enumerate((128, 160, 160, 192)):
            self.add_module(f"mixed6_{i}", _MixedV3B(in_ch, c7))
            in_ch = 768
        if aux_logits:
            side = _valid(_valid(_stem_v3_side(image_size), 3, 2), 5, 3)
            _conv(self, "aux_proj", in_ch, 128, 1)
            _conv(self, "aux_conv", 128, 768, min(5, side), 1, "VALID")
            self.aux_logits = nn.Conv2d(768, num_classes, 1)
        _conv(self, "red2_b0a", in_ch, 192, 1)
        _conv(self, "red2_b0b", 192, 320, 3, 2, "VALID")
        _conv(self, "red2_b1a", in_ch, 192, 1)
        _conv(self, "red2_b1b", 192, 192, (1, 7))
        _conv(self, "red2_b1c", 192, 192, (7, 1))
        _conv(self, "red2_b1d", 192, 192, 3, 2, "VALID")
        in_ch = 320 + 192 + in_ch
        for i in range(2):
            block = _MixedV3C(in_ch)
            self.add_module(f"mixed7_{i}", block)
            in_ch = block.out_channels
        self.logits = nn.Linear(in_ch, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None):
        x = _run_stem(self, images.permute(0, 3, 1, 2))
        for i in range(3):
            x = getattr(self, f"mixed5_{i}")(x)
        x = torch.cat([self.red1_b0(x),
                       _apply(self, ("red1_b1a", "red1_b1b", "red1_b1c"), x),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for i in range(4):
            x = getattr(self, f"mixed6_{i}")(x)
        aux = None
        if self.aux:
            a = self.aux_conv(self.aux_proj(F.avg_pool2d(x, 5, 3)))
            aux = self.aux_logits(a).mean(dim=(2, 3)).float()
        x = torch.cat([_apply(self, ("red2_b0a", "red2_b0b"), x),
                       _apply(self, ("red2_b1a", "red2_b1b", "red2_b1c",
                                     "red2_b1d"), x),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for i in range(2):
            x = getattr(self, f"mixed7_{i}")(x)
        x = _drop(x.mean(dim=(2, 3)), HEAD_DROPOUT, self.training, generator)
        logits = self.logits(x).float()
        return (logits, aux) if self.aux else logits


# -- Inception-ResNet-v2 -----------------------------------------------------


_IR_BRANCHES = {
    # kind → ((name, features, kernel) chains, one a branch)
    "35": ((("b0", 32, 1),), (("b1a", 32, 1), ("b1b", 32, 3)),
           (("b2a", 32, 1), ("b2b", 48, 3), ("b2c", 64, 3))),
    "17": ((("b0", 192, 1),),
           (("b1a", 128, 1), ("b1b", 160, (1, 7)), ("b1c", 192, (7, 1)))),
    "8": ((("b0", 192, 1),),
          (("b1a", 192, 1), ("b1b", 224, (1, 3)), ("b1c", 256, (3, 1)))),
}


class _IRBlock(nn.Module):
    """Inception-ResNet residual block: ``x + scale · up(concat of the
    branches)``, ``up`` a 1×1 conv with a bias back to the trunk width,
    then ReLU unless ``use_relu`` is off (the final ``block8_post``)."""

    def __init__(self, in_ch: int, kind: str, scale: float,
                 use_relu: bool = True):
        super().__init__()
        self.scale = scale
        self.use_relu = use_relu
        self.chains, width = _add_chains(self, in_ch, _IR_BRANCHES[kind])
        self.up = nn.Conv2d(width, in_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mixed = torch.cat([_apply(self, chain, x) for chain in self.chains],
                          dim=1)
        out = x + self.scale * self.up(mixed)
        return F.relu(out) if self.use_relu else out


class InceptionResnetV2(nn.Module):
    """slim inception_resnet_v2's structure (299² default): the v3 stem,
    ``Mixed_5b``, 10 block35 (0.17), reduction A, 20 block17 (0.10),
    reduction B, 9 block8 (0.20), ``block8_post``, ``conv7b`` 1×1 1536."""

    def __init__(self, num_classes: int = 1000, image_size: int = 299):
        super().__init__()
        _add_stem(self)
        _conv(self, "m5_b0", 192, 96, 1)
        _conv(self, "m5_b1a", 192, 48, 1)
        _conv(self, "m5_b1b", 48, 64, 5)
        _conv(self, "m5_b2a", 192, 64, 1)
        _conv(self, "m5_b2b", 64, 96, 3)
        _conv(self, "m5_b2c", 96, 96, 3)
        _conv(self, "m5_b3", 192, 64, 1)
        in_ch = 320
        for i in range(10):
            self.add_module(f"block35_{i}", _IRBlock(in_ch, "35", 0.17))
        _conv(self, "redA_b0", in_ch, 384, 3, 2, "VALID")
        _conv(self, "redA_b1a", in_ch, 256, 1)
        _conv(self, "redA_b1b", 256, 256, 3)
        _conv(self, "redA_b1c", 256, 384, 3, 2, "VALID")
        in_ch = 384 + 384 + in_ch
        for i in range(20):
            self.add_module(f"block17_{i}", _IRBlock(in_ch, "17", 0.10))
        _conv(self, "redB_b0a", in_ch, 256, 1)
        _conv(self, "redB_b0b", 256, 384, 3, 2, "VALID")
        _conv(self, "redB_b1a", in_ch, 256, 1)
        _conv(self, "redB_b1b", 256, 288, 3, 2, "VALID")
        _conv(self, "redB_b2a", in_ch, 256, 1)
        _conv(self, "redB_b2b", 256, 288, 3)
        _conv(self, "redB_b2c", 288, 320, 3, 2, "VALID")
        in_ch = 384 + 288 + 320 + in_ch
        for i in range(9):
            self.add_module(f"block8_{i}", _IRBlock(in_ch, "8", 0.20))
        self.block8_post = _IRBlock(in_ch, "8", 1.0, use_relu=False)
        _conv(self, "conv7b", in_ch, 1536, 1)
        self.logits = nn.Linear(1536, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = _run_stem(self, images.permute(0, 3, 1, 2))
        x = torch.cat([self.m5_b0(x), _apply(self, ("m5_b1a", "m5_b1b"), x),
                       _apply(self, ("m5_b2a", "m5_b2b", "m5_b2c"), x),
                       self.m5_b3(_branch_pool(x))], dim=1)
        for i in range(10):
            x = getattr(self, f"block35_{i}")(x)
        x = torch.cat([self.redA_b0(x),
                       _apply(self, ("redA_b1a", "redA_b1b", "redA_b1c"), x),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for i in range(20):
            x = getattr(self, f"block17_{i}")(x)
        x = torch.cat([_apply(self, ("redB_b0a", "redB_b0b"), x),
                       _apply(self, ("redB_b1a", "redB_b1b"), x),
                       _apply(self, ("redB_b2a", "redB_b2b", "redB_b2c"), x),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for i in range(9):
            x = getattr(self, f"block8_{i}")(x)
        x = self.conv7b(self.block8_post(x))
        x = _drop(x.mean(dim=(2, 3)), HEAD_DROPOUT, self.training, generator)
        return self.logits(x).float()


# -- Inception v4 ------------------------------------------------------------


_V4_A = ((("b0", 96, 1),), (("b1a", 64, 1), ("b1b", 96, 3)),
         (("b2a", 64, 1), ("b2b", 96, 3), ("b2c", 96, 3)))
_V4_B = ((("b0", 384, 1),),
         (("b1a", 192, 1), ("b1b", 224, (1, 7)), ("b1c", 256, (7, 1))),
         (("b2a", 192, 1), ("b2b", 192, (7, 1)), ("b2c", 224, (1, 7)),
          ("b2d", 224, (7, 1)), ("b2e", 256, (1, 7))))
_V4_POOL = {"a": 96, "b": 128, "c": 256}  # the avg-pool branch's width


class InceptionV4(nn.Module):
    """slim inception_v4's structure (299² default): the stem, 4 × A,
    reduction A, 7 × B, reduction B, 3 × C; the towers' convs are children
    of the net itself (``a0_b1b``, ``b6_b2e``, ``c2_b3``), as the JAX
    package's. ``aux_logits`` adds slim's tower off the last B block (avg
    5×5/3 VALID → ``aux_proj`` 1×1 128 → ``aux_conv`` VALID over the whole
    map, 768 → flatten → dense ``aux_logits``) and returns ``(logits,
    aux)``."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 image_size: int = 299):
        super().__init__()
        self.aux = aux_logits
        _conv(self, "s1", 3, 32, 3, 2, "VALID")
        _conv(self, "s2", 32, 32, 3, 1, "VALID")
        _conv(self, "s3", 32, 64, 3)
        _conv(self, "s4", 64, 96, 3, 2, "VALID")
        _conv(self, "s5a", 160, 64, 1)
        _conv(self, "s5b", 64, 96, 3, 1, "VALID")
        _conv(self, "s6a", 160, 64, 1)
        _conv(self, "s6b", 64, 64, (1, 7))
        _conv(self, "s6c", 64, 64, (7, 1))
        _conv(self, "s6d", 64, 96, 3, 1, "VALID")
        _conv(self, "s7", 192, 192, 3, 2, "VALID")
        in_ch = 384
        self.towers = {}  # prefix → the names of its branch chains
        for i in range(4):
            in_ch = self._tower(f"a{i}_", in_ch, _V4_A, "a")
        _conv(self, "redA_b0", in_ch, 384, 3, 2, "VALID")
        _conv(self, "redA_b1a", in_ch, 192, 1)
        _conv(self, "redA_b1b", 192, 224, 3)
        _conv(self, "redA_b1c", 224, 256, 3, 2, "VALID")
        in_ch = 384 + 256 + in_ch
        for i in range(7):
            in_ch = self._tower(f"b{i}_", in_ch, _V4_B, "b")
        if aux_logits:
            side = _valid(_valid(self._stem_side(image_size), 3, 2), 5, 3)
            _conv(self, "aux_proj", in_ch, 128, 1)
            _conv(self, "aux_conv", 128, 768, side, 1, "VALID")
            self.aux_logits = nn.Linear(768, num_classes)
        _conv(self, "redB_b0a", in_ch, 192, 1)
        _conv(self, "redB_b0b", 192, 192, 3, 2, "VALID")
        _conv(self, "redB_b1a", in_ch, 256, 1)
        _conv(self, "redB_b1b", 256, 256, (1, 7))
        _conv(self, "redB_b1c", 256, 320, (7, 1))
        _conv(self, "redB_b1d", 320, 320, 3, 2, "VALID")
        in_ch = 192 + 320 + in_ch
        for i in range(3):
            p = f"c{i}_"
            _conv(self, p + "b0", in_ch, 256, 1)
            _conv(self, p + "b1a", in_ch, 384, 1)
            _conv(self, p + "b1b", 384, 256, (1, 3))
            _conv(self, p + "b1c", 384, 256, (3, 1))
            _conv(self, p + "b2a", in_ch, 384, 1)
            _conv(self, p + "b2b", 384, 448, (3, 1))
            _conv(self, p + "b2c", 448, 512, (1, 3))
            _conv(self, p + "b2d", 512, 256, (1, 3))
            _conv(self, p + "b2e", 512, 256, (3, 1))
            _conv(self, p + "b3", in_ch, _V4_POOL["c"], 1)
            in_ch = 6 * 256
        self.logits = nn.Linear(in_ch, num_classes)

    @staticmethod
    def _stem_side(image_size: int) -> int:
        n = _valid(_valid(image_size, 3, 2), 3)  # s1, s2 (s3 SAME)
        n = _valid(n, 3, 2)                      # the pool | s4
        n = _valid(n, 3)                         # s5b | s6d
        return _valid(n, 3, 2)                   # s7 | the pool

    def _tower(self, prefix: str, in_ch: int, chains, kind: str) -> int:
        """Add an A or B tower's convs, ``<prefix><name>``, and its pool
        branch's ``<prefix>b3``; its output channels."""
        self.towers[prefix], width = _add_chains(self, in_ch, chains, prefix)
        return width + _conv(self, prefix + "b3", in_ch, _V4_POOL[kind], 1)

    def _run_tower(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        outs = [_apply(self, chain, x) for chain in self.towers[prefix]]
        outs.append(getattr(self, prefix + "b3")(_branch_pool(x)))
        return torch.cat(outs, dim=1)

    def _run_c(self, i: int, x: torch.Tensor) -> torch.Tensor:
        c = lambda name, t: getattr(self, f"c{i}_{name}")(t)  # noqa: E731
        t1 = c("b1a", x)
        t2 = c("b2c", c("b2b", c("b2a", x)))
        return torch.cat([c("b0", x), c("b1b", t1), c("b1c", t1),
                          c("b2d", t2), c("b2e", t2),
                          c("b3", _branch_pool(x))], dim=1)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None):
        x = self.s3(self.s2(self.s1(images.permute(0, 3, 1, 2))))
        x = torch.cat([F.max_pool2d(x, 3, 2), self.s4(x)], dim=1)
        x = torch.cat([self.s5b(self.s5a(x)),
                       _apply(self, ("s6a", "s6b", "s6c", "s6d"), x)], dim=1)
        x = torch.cat([self.s7(x), F.max_pool2d(x, 3, 2)], dim=1)
        for i in range(4):
            x = self._run_tower(f"a{i}_", x)
        x = torch.cat([self.redA_b0(x),
                       _apply(self, ("redA_b1a", "redA_b1b", "redA_b1c"), x),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for i in range(7):
            x = self._run_tower(f"b{i}_", x)
        aux = None
        if self.aux:
            a = self.aux_conv(self.aux_proj(F.avg_pool2d(x, 5, 3)))
            aux = self.aux_logits(a.flatten(1)).float()
        x = torch.cat([_apply(self, ("redB_b0a", "redB_b0b"), x),
                       _apply(self, ("redB_b1a", "redB_b1b", "redB_b1c",
                                     "redB_b1d"), x),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for i in range(3):
            x = self._run_c(i, x)
        x = _drop(x.mean(dim=(2, 3)), HEAD_DROPOUT, self.training, generator)
        logits = self.logits(x).float()
        return (logits, aux) if self.aux else logits


def _aux_entry(cls, size: int):
    """``zoo._entry`` for a net with auxiliary heads: the constructor
    also takes ``aux_logits``."""
    def build(num_classes: int = 1000, image_size: int = size,
              aux_logits: bool = False) -> nn.Module:
        return cls(num_classes=num_classes, aux_logits=aux_logits,
                   image_size=image_size)
    return build, size


# name → (constructor, default_image_size); consumed by models.registry.
INCEPTION_ZOO = {
    "inception_v1": _aux_entry(InceptionV1, 224),
    "inception_v2": _entry(InceptionV2, 224),
    "inception_v3": _aux_entry(InceptionV3, 299),
    "inception_v4": _aux_entry(InceptionV4, 299),
    "inception_resnet_v2": _entry(InceptionResnetV2, 299),
}
