"""The original YOLOv1 network and its classification pretrain net (port
of tensorflow_yolo2_tpu/models/yolo1.py).

24 convs with a bias and a leaky ReLU (no BatchNorm) on the reference's
schedule, four 2×2/2 max pools among them; ``Yolo1Net`` ends in the
dense ``fc25`` 4096 (leaky, dropout 0.5) and ``fc26`` to the S·S·out
grid, ``Yolo1PretrainNet`` after the first 20 convs in a 2×2/2 average
pool and the dense ``fc21`` to the class logits. Names are flax's
(``conv1`` … ``conv24``, ``fc21``, ``fc25``, ``fc26``); images come in as
NHWC, outputs go out as float32; inside, NCHW views in
``channels_last`` memory.

Where the JAX modules' routing and flax's defaults decide:

- the pools are ``layers.max_pool``, as the JAX package's are its
  ``layers.max_pool``: in a training step on an even map their backward
  is the CUDA kernel B5, 4 launches a step;
- every conv is flax's SAME (``layers.SameConv2d``): the 7×7/2
  ``conv1`` on an even input pads low 2, high 3, the 3×3/2 conv low 0,
  high 1;
- the average pool is flax's ``nn.avg_pool``, VALID (``F.avg_pool2d``),
  not ``layers.avg_pool``, which is SAME;
- the flatten before ``fc21`` / ``fc25`` is in NHWC order (a view of the
  channels_last map); ``image_size`` fixes that layer's width, which
  flax infers from the first input;
- dropout is flax's rule on the caller's generator (``layers.dropout``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_yolo2_torch.models.layers import (
    SameConv2d,
    dropout,
    leaky_relu,
    max_pool,
)

# (kernel, features, stride) with "M" = 2×2/2 max pool: the reference's
# layer schedule.
YOLO1_SCHEDULE: Sequence = (
    (7, 64, 2), "M",
    (3, 192, 1), "M",
    (1, 128, 1), (3, 256, 1), (1, 256, 1), (3, 512, 1), "M",
    (1, 256, 1), (3, 512, 1), (1, 256, 1), (3, 512, 1),
    (1, 256, 1), (3, 512, 1), (1, 256, 1), (3, 512, 1),
    (1, 512, 1), (3, 1024, 1), "M",
    (1, 512, 1), (3, 1024, 1), (1, 512, 1), (3, 1024, 1),
    (3, 1024, 1), (3, 1024, 2), (3, 1024, 1), (3, 1024, 1),
)


class _Yolo1Trunk(nn.Module):
    """The first ``n_convs`` convs of the schedule with their pools;
    ``self.side`` is the map's side after them at ``image_size``."""

    def __init__(self, n_convs: int, image_size: int):
        super().__init__()
        self.n_convs = n_convs
        in_ch, conv_i, side = 3, 0, image_size
        for item in YOLO1_SCHEDULE:
            if conv_i == n_convs:
                break
            if item == "M":
                side = -(-side // 2)
                continue
            k, f, s = item
            conv_i += 1
            self.add_module(f"conv{conv_i}", SameConv2d(in_ch, f, k, s))
            in_ch, side = f, -(-side // s)
        self.side = side

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        conv_i = 0
        for item in YOLO1_SCHEDULE:
            if conv_i == self.n_convs:
                break
            if item == "M":
                x = max_pool(x)
                continue
            conv_i += 1
            x = leaky_relu(getattr(self, f"conv{conv_i}")(x))
        return x


class Yolo1PretrainNet(_Yolo1Trunk):
    """The first 20 convs, a VALID 2×2/2 average pool, the NHWC flatten
    and ``fc21`` to the logits (no dropout, no BatchNorm)."""

    def __init__(self, num_classes: int = 1000, image_size: int = 448):
        super().__init__(20, image_size)
        side = self.side // 2
        self.fc21 = nn.Linear(side * side * 1024, num_classes)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout; the trainer passes one to every model
        x = F.avg_pool2d(self.trunk(images.permute(0, 3, 1, 2)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc21(x).float()


class Yolo1Net(_Yolo1Trunk):
    """The 24 convs, the NHWC flatten, ``fc25`` 4096 (leaky, dropout
    ``dropout_rate`` in training), ``fc26`` → (N, S, S, output_channels)
    float32."""

    def __init__(self, S: int = 7, output_channels: int = 30,
                 dropout_rate: float = 0.5, image_size: int = 448):
        super().__init__(len([i for i in YOLO1_SCHEDULE if i != "M"]),
                         image_size)
        self.S, self.output_channels = S, output_channels
        self.dropout_rate = dropout_rate
        self.fc25 = nn.Linear(self.side * self.side * 1024, 4096)
        self.fc26 = nn.Linear(4096, S * S * output_channels)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.trunk(images.permute(0, 3, 1, 2))
        x = leaky_relu(self.fc25(x.permute(0, 2, 3, 1).reshape(
            x.shape[0], -1)))
        if self.training and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("Yolo1Net in training mode needs a dropout "
                                 "generator")
            x = dropout(x, self.dropout_rate, generator)
        x = self.fc26(x)
        return x.reshape(x.shape[0], self.S, self.S,
                         self.output_channels).float()
