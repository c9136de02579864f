"""Layer primitives (port of tensorflow_yolo2_tpu/models/layers.py).

Modules take NCHW tensors (the trunk keeps them in ``channels_last``
memory, which is NHWC in storage); the free functions keep the JAX
package's NHWC layout where they work on images.

The conv keeps its bias in front of BatchNorm, as the reference does, so
imported checkpoints map 1:1; BatchNorm uses TF1's epsilon 1e-3 and
flax's running-statistic update (``BatchNorm``).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_yolo2_torch.ops import cuda_pool
from tensorflow_yolo2_torch.parallel.mesh import all_reduce_sum

LEAKY_ALPHA = 0.1
BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99

_FROZEN_STATS = 0  # > 0: BatchNorm in training mode leaves its statistics


@contextlib.contextmanager
def frozen_running_stats():
    """Within it, ``BatchNorm`` in training mode normalises with the batch
    statistics as always but leaves its running statistics as they are:
    the recompute of a rematerialized forward must not update them a
    second time."""
    global _FROZEN_STATS
    _FROZEN_STATS += 1
    try:
        yield
    finally:
        _FROZEN_STATS -= 1


@functools.cache
def _rounded(alpha: float, dtype: torch.dtype) -> float:
    return torch.tensor(alpha, dtype=dtype).item()


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_ALPHA) -> torch.Tensor:
    """max(alpha·x, x) — the reference's hand-rolled leaky ReLU. alpha is
    rounded to x's type first, as JAX rounds its weak-typed scalar (in
    bf16, 0.1 is 0.10009765625)."""
    return torch.maximum(_rounded(alpha, x.dtype) * x, x)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H/2, W/2, 4C); channel = (2·r_row + r_col)·C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 SAME max pool of an NCHW tensor.

    When a gradient is recorded and H and W are even, the pool is
    ``ops.cuda_pool.MaxPool2``, whose backward on the card is the CUDA
    kernel B5. Otherwise ``ceil_mode`` keeps the last partial window of
    an odd size, which is what SAME's -inf padding gives; on even sizes
    it is a VALID pool. Both have the same values and gradient.
    """
    if torch.is_grad_enabled() and x.requires_grad and \
            cuda_pool.supported(x):
        return cuda_pool.MaxPool2.apply(x)
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one dimension: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """window×window SAME max pool of an NCHW tensor, flax's ``max_pool``
    with ``padding="SAME"``: XLA's padding, −inf, then a VALID pool. On
    an even map a 3×3/2 pads low 0 and high 1; ``nn.MaxPool2d(3, 2, 1)``
    pads 1 on both sides, which gives the same shape with every window
    one row and one column further up and left."""
    (top, bottom), (left, right) = (_same_pads(s, window, stride)
                                    for s in x.shape[-2:])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax's ``Dropout`` in training: ``where(keep, x / keep_prob, 0)``
    with ``keep`` drawn with probability ``keep_prob = 1 − rate`` from
    ``generator`` (on x's device), not from the global generator. The
    divisor is a tensor of x's type on x's device, as JAX rounds its
    weak-typed ``keep_prob`` to x's type (CUDA turns a division by a
    Python number into a multiplication by its reciprocal)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < \
        keep_prob
    divisor = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / divisor, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """window×window SAME average pool of an NCHW tensor, flax's
    ``avg_pool``: the padded zeros count in the divisor, so every output
    is the window's sum over window².

    For the classifier's global pool (window = stride = H): on an H×H
    map the mean; on an H×W map with W < H, the sum over H·W values
    divided by H² (one output); with W > H, ⌈W/H⌉ outputs along W."""
    (top, bottom), (left, right) = (_same_pads(s, window, stride)
                                    for s in x.shape[-2:])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.avg_pool2d(x, window, stride)


def avg_pool_exclusive(x: torch.Tensor, window: int,
                       stride: int) -> torch.Tensor:
    """window×window SAME average pool of an NCHW tensor that leaves the
    padded zeros out of the divisor, flax's ``avg_pool`` with
    ``count_include_pad=False``: each output is its window's sum over the
    number of input values in it. That is ``F.avg_pool2d``'s
    ``count_include_pad=False`` where XLA's SAME pads are the same on
    both sides, as for the inception nets' 3×3/1 pools; other pads raise
    ``ValueError``."""
    (top, bottom), (left, right) = (_same_pads(s, window, stride)
                                    for s in x.shape[-2:])
    if top != bottom or left != right:
        raise ValueError(f"avg_pool_exclusive: SAME pads ({top}, {bottom}) "
                         f"× ({left}, {right}) of a {window}×{window}/"
                         f"{stride} pool are not symmetric")
    return F.avg_pool2d(x, window, stride, padding=(top, left),
                        count_include_pad=False)


def synced_batch_stats(x: torch.Tensor, group, count: float | None = None,
                       mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-channel batch mean and biased variance of an NCHW tensor
    over every rank of ``group``, in float32 (float64 for float64 x), as
    ``nn.BatchNorm2d`` would take them over the ranks' joined batch: the
    sum and then the squared deviations from the global mean are each
    all-reduced (differentiably) with the element count. ``mask``
    (broadcastable to x, 0 / 1) leaves elements out; ``count``, the valid
    elements a channel over all ranks, then replaces the reduced count."""
    xf = x if x.dtype == torch.float64 else x.float()
    if mask is not None:
        xf = xf * mask
    c = x.shape[1]
    local = torch.cat([xf.sum((0, 2, 3)),
                       xf.new_full((1,), xf.numel() // c)])
    total = all_reduce_sum(local, group)
    n = total[c] if count is None else count
    mean = total[:c] / n
    dev = xf - mean.view(1, c, 1, 1)
    if mask is not None:
        dev = dev * mask
    var = all_reduce_sum((dev * dev).sum((0, 2, 3)), group) / n
    return mean, var


def sync_batch_norm_(model: nn.Module, group) -> nn.Module:
    """Every ``BatchNorm`` of ``model`` takes its training statistics over
    ``group`` (None: this process's batch alone), in place."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return model


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's running statistics.

    In training mode it normalises with the batch mean and the biased
    batch variance, as ``nn.BatchNorm2d`` does, and then updates
    ``running ← momentum·running + (1 − momentum)·batch_stat`` with the
    biased variance (flax's ``BatchNorm``; ``nn.BatchNorm2d`` would use
    the unbiased one, and its momentum is the complement). Statistics are
    float32 whatever the input type. In eval mode it normalises with the
    running statistics. The state dict is ``nn.BatchNorm2d``'s.

    ``use_scale=False`` is flax's BatchNorm without a scale (slim's
    ``batch_norm`` default, the inception nets'): the module has no
    ``weight`` at all, only the ``bias``, so no optimizer, weight decay
    or norm sees a scale. The kernel is given a constant unit scale
    instead, a buffer outside the state dict: CUDA's BatchNorm backward
    returns no bias gradient when it has no weight.

    With a ``process_group`` (``sync_batch_norm_``; data parallelism) the
    training statistics are the group's joined batch's
    (``synced_batch_stats``), normalisation and update as above; the
    output keeps x's type.
    """

    process_group = None

    def __init__(self, num_features: int, eps: float = BN_EPSILON,
                 momentum: float = BN_MOMENTUM, use_scale: bool = True):
        super().__init__(num_features, eps=eps, affine=use_scale)
        if not use_scale:
            self.bias = nn.Parameter(torch.zeros(num_features))
            self.register_buffer("unit_scale", torch.ones(num_features),
                                 persistent=False)
        self.flax_momentum = momentum

    def reset_parameters(self) -> None:
        super().reset_parameters()
        if not self.affine and getattr(self, "bias", None) is not None:
            nn.init.zeros_(self.bias)

    def _scale(self) -> torch.Tensor:
        return self.unit_scale if self.weight is None else self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self._scale(), self.bias, False, 0.0,
                                self.eps)
        if self.process_group is not None:
            return self._synced_forward(x)
        # the batch statistics come out of the fused kernel: with
        # momentum 1 it writes the batch mean and unbiased variance into
        # zeroed buffers (it refuses a single value per channel)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self._scale(), self.bias, True, 1.0,
                         self.eps)
        if _FROZEN_STATS:
            return y
        n = x.numel() // x.shape[1]
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            # var itself is saved for the backward: not in place
            self.running_var.mul_(m).add_(var * ((n - 1) / n),
                                          alpha=1.0 - m)
        return y

    def _synced_forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = synced_batch_stats(x, self.process_group)
        scale = self._scale() * torch.rsqrt(var + self.eps)
        xf = x if x.dtype == torch.float64 else x.float()
        y = ((xf - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) +
             self.bias.view(1, -1, 1, 1)).to(x.dtype)
        if not _FROZEN_STATS:
            m = self.flax_momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return y


class SameConv2d(nn.Conv2d):
    """A conv with flax's ``padding="SAME"``: XLA's padding of each
    dimension for its size and the stride (``_same_pads``), zeros, then
    the unpadded conv. At stride 1 with odd kernel sides that is the
    symmetric ``k // 2``; at stride 2 on an even map the total k − 2 goes
    low ⌊·/2⌋ and high the rest (low 2, high 3 for a 7×7; low 0, high 1
    for a 3×3), where torch's symmetric ``padding`` would shift the
    sampling grid. ``kernel_size`` is k or (kh, kw); ``groups`` is
    flax's ``feature_group_count``. Parameters are ``nn.Conv2d``'s."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int | tuple[int, int], stride: int = 1,
                 bias: bool = True, groups: int = 1):
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
        symmetric = stride == 1 and kh % 2 == 1 and kw % 2 == 1
        super().__init__(in_channels, features, (kh, kw), stride=stride,
                         padding=(kh // 2, kw // 2) if symmetric else 0,
                         bias=bias, groups=groups)
        self.symmetric = symmetric

    def pad_input(self, x: torch.Tensor) -> torch.Tensor:
        """x with XLA's SAME padding where torch's ``padding`` cannot give
        it (the unpadded conv follows)."""
        if not self.symmetric:
            (top, bottom), (left, right) = (
                _same_pads(n, k, s) for n, k, s in
                zip(x.shape[-2:], self.kernel_size, self.stride))
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.pad_input(x))


SLIM_BN_MOMENTUM = 0.9997  # slim's inception arg scope (epsilon 1e-3)


class SeparableConvBNReLU(nn.Module):
    """slim's ``separable_conv2d`` with ``batch_norm``: ``depthwise``, a
    SAME k×k conv of ``groups = in_channels`` with ``in_channels ·
    depth_multiplier`` outputs and no bias (output channel o reads input
    channel o // depth_multiplier, as flax's grouped kernel (kh, kw, 1,
    in·mult) does), ``pointwise``, a 1×1 conv to ``features`` with no
    bias, then BatchNorm without a scale and ReLU."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int | tuple[int, int], depth_multiplier: int,
                 stride: int = 1):
        super().__init__()
        mid = in_channels * depth_multiplier
        self.depthwise = SameConv2d(in_channels, mid, kernel_size, stride,
                                    bias=False, groups=in_channels)
        self.pointwise = nn.Conv2d(mid, features, 1, bias=False)
        self.bn = BatchNorm(features, momentum=SLIM_BN_MOMENTUM,
                            use_scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.pointwise(self.depthwise(x))))


class ConvBN(nn.Module):
    """k×k SAME conv (with bias) + BatchNorm + leaky-ReLU.

    ``use_bn=False`` is a plain conv+bias(+leaky) — the shape BN folding
    produces for inference; ``activate=False`` drops the leaky.

    The conv is a ``SameConv2d``: at ``stride=2`` it pads as XLA's SAME
    does (low 0, high 1 for a 3×3 on an even input).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 use_bn: bool = True, activate: bool = True,
                 stride: int = 1, bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.conv = SameConv2d(in_channels, features, kernel_size, stride)
        self.bn = (BatchNorm(features, momentum=bn_momentum)
                   if use_bn else None)
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activate:
            x = leaky_relu(x)
        return x
