"""tensorflow_yolo2_torch — the PyTorch + CUDA port of tensorflow_yolo2_tpu.

The JAX package beside it is the reference; every module here mirrors the
module of the same name there and is tested against it on the same
weights and inputs. This package imports ``torch`` and ``numpy`` and
nothing of JAX.

- ``config``   — ``YoloConfig``, the grid offset, ``yolo_v2_config`` and
                 the classic VOC anchors, the VOC class list.
- ``data``     — ``anchors``: the priors stored beside a snapshot.
- ``models``   — Darknet19 trunk (pool or stride downsample), the v1 head,
                 the YOLOv2 passthrough head, BN folding.
- ``ops``      — IoU, the v1 and anchor grid decodes, fixed-shape NMS, and
                 the hand-written CUDA decode / decode+NMS kernels
                 (``ops.cuda_decode``, sources in ``csrc/``).
- ``convert``  — flax parameter trees (as numpy) → torch state dicts, and
                 the ``.npz`` format that carries them between machines.
- ``entries``  — ``pascal_detect_darknet``: the serving entry point (v1,
                 ``--v2``, ``--v2 --passthrough``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
