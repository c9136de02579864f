"""The space-to-depth stem and the trunk after the stem (port of
tensorflow_yolo2_tpu/models/fast_stem.py).

For a stride-1 3×3 conv (+ bias, leaky) followed by a 2×2/2 max pool,

    pool(leaky(conv3x3(x) + b)) == leaky(max_{4 phases} conv2x2(s2d(x)) + b)

where ``s2d`` is the 2×2 space-to-depth transform and each phase conv
computes the pre-pool outputs at one position of the pool window; bias
and leaky are monotone, so they commute with the max. ``phase_kernel``
rearranges a (3, 3, C, O) HWIO kernel into the (2, 2, 4C, O) phase
kernel (taps that would fall outside the 3×3 window are zero).

``detect_tail`` runs a folded ``Darknet19Detector`` from the stage-2 map
on (conv3 … conv18, pools 3–5, the head) with the detector's own modules,
so a fast stem shares the weights of the model it serves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensorflow_yolo2_torch.models.layers import leaky_relu, space_to_depth


def phase_kernel(w: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Rearrange a (3, 3, C, O) kernel into the (2, 2, 4C, O) phase kernel
    computing the pre-pool outputs at pool-window position (di, dj)."""
    kh, kw, c, o = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"phase_kernel takes a 3×3 kernel, got {kh}×{kw}")
    zeros = w.new_zeros((c, o))
    dr = -1 if di == 0 else 0
    dc = -1 if dj == 0 else 0
    rows = []
    for a in range(2):
        cols = []
        for bcol in range(2):
            blocks = []
            for r_row in range(2):
                u = 2 * (a + dr) + r_row - di + 1  # original kernel row
                for r_col in range(2):
                    v = 2 * (bcol + dc) + r_col - dj + 1
                    blocks.append(w[u, v] if 0 <= u <= 2 and 0 <= v <= 2
                                  else zeros)
            cols.append(torch.cat(blocks, dim=0))  # (4C, O)
        rows.append(torch.stack(cols))  # (2, 4C, O)
    return torch.stack(rows)  # (2, 2, 4C, O)


def conv_pool_s2d(x_s2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """leaky(max-pool(conv3x3(x) + b)) computed on the s2d input.

    x_s2d: (B, H/2, W/2, 4C) NHWC; w: the original (3, 3, C, O) kernel.
    Returns the post-pool (B, H/2, W/2, O) map, NHWC, in ``dtype``.
    """
    x = x_s2d.to(dtype).permute(0, 3, 1, 2)
    acc = None
    for di in (0, 1):
        for dj in (0, 1):
            k = phase_kernel(w, di, dj).to(dtype).permute(3, 2, 0, 1)
            pad_r = (1, 0) if di == 0 else (0, 1)
            pad_c = (1, 0) if dj == 0 else (0, 1)
            y = F.conv2d(F.pad(x, pad_c + pad_r), k)
            acc = y if acc is None else torch.maximum(acc, y)
    y = leaky_relu(acc + b.to(dtype)[:, None, None])
    return y.permute(0, 2, 3, 1)


def stem_params(detector: torch.nn.Module) -> tuple[torch.Tensor, ...]:
    """The folded conv1 and conv2 of a detector as HWIO kernels and
    biases: (w1, b1, w2, b2)."""
    bk = detector.backbone
    out = []
    for conv in (bk.conv1, bk.conv2):
        if conv.bn is not None:
            raise ValueError("the fast stems take a BN-folded detector")
        out += [conv.conv.weight.permute(2, 3, 1, 0), conv.conv.bias]
    return tuple(out)


def detect_tail(detector: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A folded ``Darknet19Detector`` after its first two conv + pool
    stages: ``x`` is the (B, H/4, W/4, 64) NHWC stage-2 map (from either
    stem); runs conv3 … conv18 and the head, whose output conv is linear
    for the ``--v2`` detector (``bn_on_output=False``). Returns the
    (B, S, S, C) float32 grid."""
    y = detector.backbone(x.permute(0, 3, 1, 2), after_stem=True)
    return detector.detection(y).permute(0, 2, 3, 1).contiguous()


def fast_detect_forward(detector: torch.nn.Module, images: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The folded detector's forward with the s2d stem on the first two
    conv + pool stages; layers 3+ run the detector's own modules."""
    w1, b1, w2, b2 = stem_params(detector)
    x = conv_pool_s2d(space_to_depth(images), w1, b1, dtype)
    x = conv_pool_s2d(space_to_depth(x), w2, b2, dtype)
    return detect_tail(detector, x)
