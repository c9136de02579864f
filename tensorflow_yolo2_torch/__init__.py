"""tensorflow_yolo2_torch — the PyTorch + CUDA port of tensorflow_yolo2_tpu.

The JAX package beside it is the reference; every module here mirrors the
module of the same name there and is tested against it on the same
weights and inputs. This package imports ``torch`` and ``numpy`` and
nothing of JAX.

- ``config``   — ``YoloConfig`` (+ loss weights and the YOLOv2 loss's
                 stabilizers), the grid offset, ``yolo_v2_config`` and the
                 classic VOC anchors, the optimizer and schedule configs,
                 the run-dir layout (``Paths``), the VOC class list.
- ``data``     — ``anchors``: k-means dimension clusters and the priors
                 stored beside a snapshot; ``voc``: VOC2007 with v1 and
                 per-slot label grids; ``ilsvrc``: ILSVRC CLS-LOC;
                 ``synsets``: synset maps; ``augment``: image reads and
                 the classifier's augmentation chain; ``prefetch``:
                 threads, worker processes, pinned copies to the card;
                 ``flowers``: TF_flowers; ``memory``: in-memory data;
                 the slim data tier: ``preprocessing`` (the factory),
                 ``mnist``, ``cifar10``, ``prepared`` (npz shards),
                 ``fetch`` (URL download, archive unpacking).
- ``models``   — Darknet19 trunk (pool or stride downsample), the v1 head,
                 the YOLOv2 passthrough head, the ImageNet classifier,
                 BatchNorm with flax's running statistics, flax's
                 initializers, BN folding (and the identity fold);
                 ResNet-50 v1; the registry, the slim zoo, ResNet v2,
                 YOLOv1 and the inception family (v1–v4,
                 Inception-ResNet-v2); the contrast-channel input wrapper.
- ``ops``      — IoU, the v1 and anchor grid decodes, fixed-shape NMS, and
                 the hand-written CUDA kernels (sources in ``csrc/``):
                 decode / decode+NMS (``ops.cuda_decode``), the 2×2
                 max-pool backward (``ops.cuda_pool``) and the fused stem
                 (``ops.cuda_stem``).
- ``losses``   — ``yolo``: the YOLOv1 grid loss; ``yolo_v2``: the YOLOv2
                 anchor loss.
- ``eval``     — the VOC mAP evaluator.
- ``train``    — schedules, the optimizer family (and per-scope
                 groups), gradient accumulation, EMA, the train step
                 (YOLO and softmax tasks; remat, activation summaries),
                 FGSM adversarial training, snapshots, metrics.
- ``convert``  — flax parameter trees (as numpy) → torch state dicts, and
                 the ``.npz`` format that carries them between machines.
- ``compat``   — TF checkpoints: ``tf_bundle`` reads V1 and V2 files in
                 numpy alone (no TensorFlow), ``tf_import`` maps the
                 reference's and slim's names onto the models.
- ``entries``  — ``pascal_detect_darknet``: the serving entry point (v1,
                 ``--v2``, ``--v2 --passthrough``); ``pascal_train_darknet``:
                 detector training (the same three heads);
                 ``pascal_eval_map``: VOC mAP of a snapshot;
                 ``imagenet_train_darknet``, ``imagenet_test_darknet``,
                 ``imagenet_predict_darknet``: the classifier's
                 pretraining, accuracy (bf16, int8) and top-5; the
                 ResNet-50 entries; ``train_classifier``,
                 ``eval_classifier``, ``flowers_train``: the slim tier;
                 ``download_and_convert``: raw datasets to prepared
                 shards; ``imagenet_train_adversarial``: clean + FGSM
                 training of a contrast-channel classifier;
                 ``verify_released_ckpts``: the released TF bundles
                 through the serving path, with golden boxes.
- ``utils``    — the kernels' build, the device default, the native host
                 layer, timers, the profiler trace, the detection
                 drawing and ``helpers`` (label counts, the contrast
                 channels).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
