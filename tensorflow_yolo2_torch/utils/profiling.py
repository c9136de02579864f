"""Profiling (port of tensorflow_yolo2_tpu/utils/profiling.py).

``maybe_trace`` records a ``torch.profiler`` trace of a region (the train
loop's ``--profile-dir``) and writes it as Chrome trace JSON, which
TensorBoard's profiler plugin and ``chrome://tracing`` read. The analytic
conv FLOPs of the detector and the classifier and the H100's peaks turn a
throughput into a share of the card's compute.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def maybe_trace(logdir: str | None,
                device: str | torch.device | None = None
                ) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block into ``logdir``
    (a ``<host>_<pid>.<ns>.pt.trace.json``) when it is set; the card's
    kernels too when ``device`` is a CUDA device."""
    if not logdir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


# Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): HBM bytes/s, float32 operations/s outside the tensor cores, and
# bf16, TF32 and int8 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 494.7e12
INT8_OPS_PER_S = 1979e12


def _schedule_flops(image_size: int, schedule, in_channels: int = 3
                    ) -> float:
    """Forward conv FLOPs (2 × MACs) of one image through a (kernel,
    channels) / "M" schedule at ``image_size``²."""
    hw = image_size
    cin = in_channels
    flops = 0.0
    for item in schedule:
        if item == "M":
            hw = (hw + 1) // 2
            continue
        k, cout = item
        flops += 2.0 * hw * hw * k * k * cin * cout
        cin = cout
    return flops


def conv_flops_per_image(image_size: int, cell_channels: int,
                         passthrough: bool = False) -> float:
    """Forward conv FLOPs (2 × MACs) of the detector on one image: the
    Darknet19 trunk (``models.darknet``), then the v1 / ``--v2`` head (3
    × 3×3×1024 and the 1×1 output) or, with ``passthrough``, the YOLOv2
    head (2 × 3×3×1024, the 1×1×64 passthrough at H/16, a 3×3 1280→1024
    and the output). BatchNorm, leaky and pools are not counted."""
    from tensorflow_yolo2_torch.models.darknet import _DARKNET19_SCHEDULE

    if not passthrough:
        return _schedule_flops(image_size, _DARKNET19_SCHEDULE +
                               ((3, 1024),) * 3 + ((1, cell_channels),))
    hw = image_size // 32
    trunk = _schedule_flops(image_size,
                            _DARKNET19_SCHEDULE + ((3, 1024),) * 2)
    return trunk + 2.0 * ((2 * hw) ** 2 * 512 * 64 +
                          hw * hw * (9 * 1280 * 1024 + 1024 * cell_channels))


def classifier_flops_per_image(image_size: int, num_classes: int) -> float:
    """Forward conv FLOPs (2 × MACs) of the Darknet19 classifier on one
    image: the trunk and the 1×1 ``conv19`` to ``num_classes``."""
    from tensorflow_yolo2_torch.models.darknet import _DARKNET19_SCHEDULE

    return _schedule_flops(image_size,
                           _DARKNET19_SCHEDULE + ((1, num_classes),))


def resnet50_flops_per_image(image_size: int, num_classes: int | None = None,
                             grid_outputs: int | None = None) -> float:
    """Forward conv and dense FLOPs (2 × MACs) of ResNet50 on one image
    (``models.resnet``): the root 7×7/2 conv and the 16 bottleneck units
    with their projection shortcuts; then the classifier's 1×1
    ``logits`` on the pooled 2048 features (``num_classes``), or the
    detector's ``yolo_fc1`` (2048·⌈size/32⌉² → 4096) and ``yolo_fc2``
    (4096 → ``grid_outputs``, S·S·(5B+C)). BatchNorm, ReLU, the adds and
    the pools are not counted."""
    from tensorflow_yolo2_torch.models.resnet import _R50_BLOCKS

    hw = -(-image_size // 2)
    flops = 2.0 * hw * hw * 7 * 7 * 3 * 64
    hw, cin = -(-hw // 2), 64
    for bi, (depth, depth_bn, units) in enumerate(_R50_BLOCKS, start=1):
        for ui in range(1, units + 1):
            stride = 2 if ui == units and bi < len(_R50_BLOCKS) else 1
            out = -(-hw // stride)
            flops += 2.0 * (hw * hw * cin * depth_bn +
                            out * out * (9 * depth_bn * depth_bn +
                                         depth_bn * depth))
            if cin != depth:
                flops += 2.0 * out * out * cin * depth
            hw, cin = out, depth
    if num_classes is not None:
        flops += 2.0 * cin * num_classes
    if grid_outputs is not None:
        flops += 2.0 * (hw * hw * cin * 4096 + 4096 * grid_outputs)
    return flops


def module_flops_per_image(model: torch.nn.Module, image_size: int,
                           device: str | torch.device = "cpu") -> float:
    """Forward conv and dense FLOPs (2 × MACs) of ``model`` on one NHWC
    ``image_size``² image, counted from the shapes that one forward in
    eval mode gives each ``nn.Conv2d`` and ``nn.Linear`` (any registered
    net, the zoo's too); the model is left in eval mode on ``device``."""
    flops = [0.0]

    def count(module, args, out):
        if isinstance(module, torch.nn.Conv2d):
            k = module.weight[0].numel()  # in/groups · kh · kw
            flops[0] += 2.0 * out.numel() * k
        else:
            flops[0] += 2.0 * out.numel() * module.in_features

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model.eval().to(device)(torch.zeros(1, image_size, image_size, 3,
                                                device=device))
    finally:
        for h in hooks:
            h.remove()
    return flops[0]
