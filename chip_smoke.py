#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tensorflow_yolo2_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, the torch and CUDA versions,
   whether TensorFlow is importable there, and builds the CUDA kernels
   from tensorflow_yolo2_torch/csrc with nvcc (failing if ptxas
   serializes B4's wgmma pipeline).
2. Holds each kernel against its plain PyTorch version on the card, on
   seeded synthetic grids with exact score ties and overlapping same- and
   cross-class boxes, batch 256, class-aware NMS on and off: the v1
   kernels at S=7 and 14, the anchor kernel at S=7, 10, 13, 14 and 19
   (224² to 608²). The max-pool backward kernel (B5) is held bit for bit
   to its plain version and to torch's autograd of ``F.max_pool2d`` at
   the five pool sites of a 224² train step at batch 24, in bf16 and
   float32, on integer-valued inputs that tie in every window, and on odd
   C and small maps.
3. Drives the v1 serving path, ``make_detect_fn`` on the full
   Darknet19-448 detector (BN folded, bf16, seeded random weights), on a
   seeded uint8 batch with NMS on and off; checks shapes, finiteness, that
   both v1 kernels were launched, one image's grid against the float32 CPU
   forward, and the kernels against their plain versions on the real grid.
4. Drives the two anchor serving paths the same way at YOLOv2's VOC size,
   416² (S=13, B=5, C=20, classic anchors): ``--v2 --passthrough``
   (``Darknet19DetectorV2``) and ``--v2`` (linear-output
   ``Darknet19Detector``), checking that the anchor kernel was launched,
   the grid, and the kernel on the real grid.
5. Holds the fused stem kernel B4 against its plain version (the same
   rounding points) on the card at (2, 32, 32), (1, 64, 32), (1, 56, 64),
   (4, 416, 416), (4, 448, 448) and (256, 448, 448), with random weights
   and with the folded conv1 / conv2 of the v1 detector, and on all-zero
   images with b1 > 0 (the SAME zeros of the stage-1 map make every edge
   output differ from the interior). Holds the float32 stem kernel B4-f32
   to its plain version (TF32 off) at rtol = atol = 1e-5 on the same
   shapes and cases, and one float32
   card grid (TF32 off) to the float32 CPU forward. Then drives the
   ``--pallas-stem`` serving paths, ``make_detect_fn(pallas_stem=True)``,
   in bf16 and in float32, on the v1 448² and ``--v2`` 416² detectors
   above, NMS on and off: the stem kernel of the type (B4, B4-f32) once a
   call and the decode kernel once a call; the bf16 grid against the
   float32 CPU forward and against the stock path's bf16 grid, the
   float32 grid against the stock float32 grid (2e-4); the decode kernels
   on each grid against their plain versions.
6. Drives the v1 training path at full width, ``Trainer.train_step`` on
   the Darknet19 v1 detector at the reference's 224² (S=7, B=2, C=20),
   fresh seeded weights (flax's initializers), bf16 compute, Adam at
   1e-3, on seeded uint8 batches whose labels come from
   ``build_label_grid`` on seeded boxes: 30 steps on one batch of 24,
   checking that B5 ran 5 times a step and that the loss fell; then, from
   the weights those steps reached, one float32 step on the card against
   the same step in float64 on the CPU (loss and every gradient), and the
   bf16 loss against the float32 one.
7. Drives the v2p training path at full width, ``Trainer.train_step``
   with ``yolo_v2_task`` on YOLOv2's VOC detector at 416² (S=13, B=5,
   C=20, classic anchors, ``--v2 --passthrough``), fresh seeded weights,
   bf16, Adam at 1e-3, on a seeded uint8 batch of 24 whose per-slot labels
   come from ``build_label_grid_v2``: 30 steps, checking that B5 ran 5
   times a step, that the loss fell and that the burn-in term was on;
   then one float32 step on the card against float64 on the CPU, on 4
   images of the batch.
7b. Drives the plain v2 training path (``--v2``, ``Darknet19Detector``
   with a linear output) the same way at the quality recipe's 224² (S=7,
   B=5, C=20, k-means priors of seeded box shapes), with the recipe's
   trainer (Adam at 1e-3, grad clip 5, BatchNorm momentum 0.9): 30 bf16
   steps on a batch of 24 (B5 5 times a step, the loss falls, the burn-in
   is on) and one float32 card step against float64 on the CPU on 4
   images, at 7's bounds. Then 10 float32 steps on the card (TF32 off) of
   the plain v2 head and of v2p, 64², batch 4, grad clip 1.5e4, the
   burn-in ending after step 1, against the same chain in float64 on the
   CPU, beside the CPU's own float32 chains (its default threads and 1):
   the card's distance from float64 (each step's metrics, each parameter
   tensor and BatchNorm statistic after the chain) within
   ``V2_CHAIN_RATIO`` times the CPU's float32 chains' (Adam's steps flip
   where a gradient is as small as float32's rounding, so float32 chains
   part from float64 and from each other), the first step within
   ``V2_CHAIN_FIRST_STEP``.
8. Runs the evaluation, ``pascal_eval_map.run_eval`` through
   ``make_detect_fn`` at the eval CLI's threshold 0.005, NMS IoU 0.5 and
   K=32, on 256 seeded uint8 images at batch 32 (an in-memory image set:
   no VOC data on the card machine): v2p at 416² with the serving
   weights of 4 and per-slot labels, v1 at 448² with the weights of 3
   and v1 grids; checks that the decode kernel (B2, B1) ran once a
   batch, that the APs and mAP (all-points and VOC07) equal those of the
   plain decode on the same grids, and the kernel against its plain
   version on each grid; times the eval loop and the kernel at batch 32.
9. Builds the native host layer (``utils.native``: native/tfy2_native.cc
   with g++, libjpeg where the machine has it) and holds its resize
   (uint8 and normalized, channel swap and flip, three shapes) bit for
   bit to a numpy copy of cv2's scalar INTER_LINEAR arithmetic, its
   normalize, ``label_grid`` and ``nms`` to numpy; reads
   ``assets/demo.jpg`` at 448² through ``data.augment.image_read_u8``
   (cv2's or libjpeg's decode, then the native resize) and times it.
10. Serves int8 (``ops.quant``) at full width: v1 448², ``--v2`` and
   v2p 416² on the seeded weights above: calibration on the card (TF32
   off) held to the CPU's; the chain quantized once; each conv's int32
   sums on the card equal to the CPU's exact conv of the same int8 input,
   and the grid to the CPU's int8 grid; ``make_detect_fn_int8`` with and
   without NMS launching its decode kernel (B1 and B3 for v1, B2 for the
   anchor heads) once a call; a saved and loaded artifact serving the
   same detections; the decode kernels on the int8 grid against their
   plain versions; no float conv in a profiled forward. Then the detect
   CLI on ``assets/demo.jpg`` with ``--int8-weights`` (the v1 chain) and
   ``--host-nms``, held to a numpy greedy NMS of the dense detections, and
   ``run_eval`` through the int8 v1 path as in 8.
11. Drives the classifier at full width (``Darknet19Classifier``, 1000
   classes, 224², flax's initializers, bf16, momentum 0.9 at 1e-3): B5
   at the five pool sites of a batch-48 step bit for bit against its
   plain version; 30 steps of ``Trainer.train_step`` on one seeded uint8
   batch of 48 with seeded labels (B5 5 times a step, the loss falling);
   a float32 step on the card against float64 on the CPU (the detector
   steps' bounds) on 16 images of it; images/s at batch 48 and 64 with the
   idle share and a profile; int8 from the trained weights (calibration
   card vs CPU, every conv's int32 sums, ``conv19``'s among them, equal
   to the CPU's, the logits; images/s at batch 256 beside the operation
   bound); then on a small ILSVRC tree written with cv2 the CLIs with
   ``--device cuda``: ``imagenet_train_darknet`` plain, with
   ``--uint8-transfer`` and with ``--process-workers 2`` (an epoch each,
   resumed, B5 5 times a step), ``imagenet_test_darknet`` in bf16 and
   with ``--int8``, ``imagenet_predict_darknet``; each exits 0.
12. Drives the ResNet50 family at full width (``models.resnet``;
   224², S=7, B=2, C=20; flax's initializers drawn on the card, the
   detector's BatchNorms moved off the identity and its box outputs held
   near wide boxes so that NMS has work): serving through
   ``make_resnet_detect_fn`` in bf16 with BN unfolded at the CLI's
   threshold 0.2, B1 once a call with NMS and B3 once without, the grid
   of 2 images against the float32 CPU forward, B1 and B3 against their
   plain versions on the card grid of 256 images at 0.2 and 0.05; the
   detector's training (Adam 5e-4, dropout 0.5 from the train state's
   generator): 30 steps on one seeded batch of 4 (the loss falling, no
   B5), a float32 step on the card against float64 on the CPU at 64²
   on 4 images with dropout off, from 3 float64 steps on the CPU
   (gradient bounds 1e-1 worst and 3e-2 all: ``RESNET_GRAD_BOUNDS``),
   images/s at batch 4 and 32 with the idle share; the
   frozen-trunk ImageNet fine-tune (1000 classes, momentum 0.9 at 1e-3,
   ``trainable_scopes=("logits",)``) at batch 32: after 10 steps every
   trunk parameter bit-equal, every running statistic moved, the logits
   moved, then images/s; and the three CLIs with ``--device cuda`` under
   a temporary run root: ``pascal_train_resnet`` (2 iterations at batch
   4 on a synthetic VOC tree), ``pascal_detect_resnet --nms`` on its
   snapshot (its boxes equal ``make_resnet_detect_fn``'s, B1 once),
   ``imagenet_train_resnet`` (an epoch on the synthetic ILSVRC tree).
13. Drives the slim tier (``train_classifier``, ``eval_classifier``,
   ``flowers_train``, ``models.registry``, ``train.optimizers``): on a
   ``make_flowers`` tree at 224² the three CLIs with ``--device cuda``,
   ``train_classifier`` on its defaults (darknet19, rmsprop, weight decay
   4e-5) with EMA, ``--grad-accum-steps 2``, ``--save-interval-secs`` and
   ``--activation-summaries`` (B5 5 times a micro-step), then
   ``eval_classifier --use-ema`` on its snapshot and ``flowers_train``;
   the data tier's CLIs under a temporary run root: a ``file://`` mirror
   of a seeded CIFAR-10 python archive and MNIST's gzipped IDX files,
   ``download_and_convert`` of cifar10 (from the URL), mnist and a
   flowers tree, ``train_classifier`` with ``--preprocessing-name`` on
   the prepared cifar10 shards (cifarnet), on mnist (lenet), on the
   prepared flowers shards (darknet19, B5 5 times a step) and
   ``inception_v3 --aux-loss`` on the flowers tree at 299², then
   ``eval_classifier --preprocessing-name inception`` on its snapshot;
   every registered net at its default size (the inception nets with
   their auxiliary heads where they have them), batch 2: the float32
   card forward (TF32 off) within 1e-4 and the bf16 forward within 5e-2
   of the CPU's float32 forward (relative norm); the identity fold of
   inception_v3 at 299² (folded logits within 1e-5 of the unfolded); each
   of the nine optimizers, MultiSteps and the EMA, one update on the card
   against the CPU's from the same state (1e-6); ``yolo1_pretrain`` at
   224² with k=2 on two batches of 16 against one step on 32 (1e-5; B5 4
   times a micro-step); a ``remat`` step of ``resnet_v1_152`` at batch 8
   bit-equal to the plain one, with the peak memory of each; and the
   train steps of darknet19 (224², batch 32, rmsprop, weight decay,
   EMA), vgg_16 and resnet_v1_152 (224², batch 32), yolo1 (448², batch
   16; B5 4 times a step), inception_v3 with its auxiliary loss and
   inception_resnet_v2 (299², batch 32), bf16, images/s with the idle
   share.
14. Imports TF checkpoints and trains adversarially at full width. The
   448² v1 detector's seeded weights written as a TF V2 bundle in the
   reference's names (``write_tf_bundle``, a writer of the format that
   TensorFlow's reader reads bit for bit; CPU test), imported by the
   port's numpy reader bit for bit; the detect CLI with
   ``--tf-checkpoint --nms --device cuda`` on ``assets/demo.jpg``, B1
   once, its boxes equal to those of the same weights as a state dict;
   ``pascal_train_resnet --tf-checkpoint`` (2 iterations at batch 4) from
   a seeded ResNet-50 trunk written in slim's names, every trunk tensor
   warm-started. Then ``imagenet_train_adversarial`` with ``--device
   cuda``: Inception-ResNet-v2 at 299², batch 18, ``--attack-model
   inception_v3 --grouped-opt``, 3 iterations on the ILSVRC tree of 11
   (exit 0, both streams with ``clean/`` and ``adv/`` metrics); a timed
   pair of that configuration and of the white-box Darknet19 classifier
   at 224², batch 18 (images/s and the idle share beside the card's name
   and power limit), B5 15 times a Darknet19 pair
   (``launches_adversarial_pair``); and one Darknet19 pair in float32 on
   the card (TF32 off) against float64 on the CPU from the weights those
   pairs reached: the clean loss to 1e-4, the attack's input gradient to
   1e-1 (relative norm; the CPU's own float32 pair printed beside it),
   the FGSM images where the float64 input gradient exceeds 0.25 of its
   largest value (``ADV_SIGN_THRESH``), the adversarial step's loss on
   the same images to 1e-4.
15. Drives the parallel paths (``parallel/``) through a world-1 NCCL
   group opened in this process from torchrun's variables and destroyed
   after (one card: the halos are SAME's zeros from both ends, the
   all-reduces identities, but the group, the synced BatchNorm, the
   autograd collectives and the launcher run at full width): the
   data-parallel ``Trainer`` step on a (1, 1) mesh, v1 224² bf16 batch
   24 from section 6's weights, B5 5 times a step, and its float32 step
   (TF32 off) held to the plain float64 step on the CPU with the float32
   step bounds of 6 (float32 rounding alone puts this trunk's gradients
   ~1e-2 from float64, whichever float32 arithmetic computes them; the
   distance from the plain float32 step is printed);
   ``make_spatial_detect_fn`` at v1 448² bf16 with NMS on and off (B1 and
   B3 once a call) and v2p 416² with NMS (B2 once), its grid against the
   stock ``make_detect_fn`` grid (5e-2), the decode kernels against their
   plain versions on it; the live-BatchNorm spatial steps
   (``spatial_yolo_train_fn`` v1 224², ``spatial_yolo_v2_train_fn`` v2p
   416², batch 8, float32, from the weights of 6 and 7) against the
   plain float64 step on the CPU (loss 1e-4, the float32 gradient
   bounds, running statistics 1e-2; B5 5 times a step); ``python -m
   torch.distributed.run --nproc-per-node 1 -m ...train_classifier
   --num-clones 1`` on a ``make_flowers`` tree (exit 0) and the same
   ``train_classifier`` in this process under the group (B5 5 times a
   step); images/s of the DP step against the plain one at batch 24 and
   64 and of spatial serving against ``make_detect_fn`` at 32 and 256,
   with the idle share.
16. Runs the quality program small (``entries.quality_curve``,
   ``entries.int8_quality``; ``--device cuda``, a run root of its own):
   the hard synthetic VOC at 128 train / 32 val images, a 100-step
   classifier pretrain, the v1 head with ``--stages 150`` and then
   ``--stages 150,300`` (the second call trains only the 150-step delta
   to a step-300 snapshot), ``--v2 --anchors kmeans --stages 300`` and
   ``--v2 --passthrough --anchors kmeans --stages 300`` (their k-means
   priors in ``anchors.json``, decoded with), and ``int8_quality`` on
   the v1 snapshot: every call exits 0 with its mAPs finite in [0, 1];
   B5 5 times a train step, B1 once a v1 evaluation batch (bf16 and
   int8), B2 once an anchor head's one; each head's trained train-split
   mAP above that of the same detector with fresh seeded weights (both
   printed).
17. Times the v1, v1 ``--pallas-stem`` and v2p serving paths in bf16 and
   the v1 and v1 ``--pallas-stem`` paths in float32 with TF32 off
   (images/s at batch 32 and 256, with a profile), the v1 224² and v2p
   416² train steps (steps/s and images/s at batch 24 and 64, with a
   profile), each decode kernel and its plain version at batch 256, B5
   at each pool site of a batch-24 step beside torch's
   ``max_pool2d_with_indices_backward``, B4
   at batch 256, 448², beside the stock stem (the detector's own conv1,
   bias, leaky, pool, conv2, bias, leaky, pool), and B4-f32 there beside
   the stock float32 stem with cuDNN's TF32 off and on, and prints them,
   with each kernel's bound, as one JSON line ``{"kernels": [...]}``;
   and the int8 paths (images/s at batch 32 and 256 beside the int8
   operation bound, with a profile split into im2col, ``_int_mm``, the
   float32 epilogue and the pools); B5 is also timed at the classifier's
   batch-48 sites; the ResNet serving path (images/s at batch 32 and 256
   with a profile), and B1 and B3 on the ResNet grid at batch 256,
   threshold 0.2, as the entries ``decode_nms_resnet`` and
   ``decode_grid_resnet``.
18. Ends with ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --stem-ab [OTHER_STEM_CU ...]

runs no smoke: it builds csrc/stem.cu (B4) and the other stem sources
given, each whole, with each phase of a tile (the input load, conv1,
conv2) left out and with each phase alone, holds each whole source to
B4's plain version, and times them all in turns at batch 256, 448²
(``stem_ab``). No profiler sees inside a kernel on the card, so this is
how the phases are timed; an older B4 to compare with is written out with
``git show <commit>:tensorflow_yolo2_torch/csrc/stem.cu``.

    python3 chip_smoke.py --decode-ab [OTHER_DECODE_CU ...]

runs no smoke either: it builds csrc/decode.cu and the other decode
sources given, holds each one's B1 and B2 to their plain versions on the
real v1 448² and v2p 416² grids and its B3 on a synthetic S=7 grid and
the real v1 448² grid, and times them in turns at thresholds 0.5 and
0.05, batches 1, 32 and 256, B1 and B2 at K=32 and K=1 (``decode_ab``);
an older source is written out with ``git show
<commit>:tensorflow_yolo2_torch/csrc/decode.cu``.

    python3 chip_smoke.py --quality-draws ROOT

runs no smoke: it writes the quality program's fixture (the hard
synthetic VOC, 1024 train / 128 val images) and its 1500-step classifier
pretrain under the run root ROOT, then trains and scores the draws of
``DRAW_PLAN`` (head, compute dtype, seed) to the cumulative stages
``DRAW_STAGES``, each in a clean root holding copies of them: a bf16
draw through ``quality_curve``, a float32 one through the same stage's
``pascal_train_darknet`` arguments with ``--compute-dtype float32`` and
``quality_curve.score`` (``quality_draws``); one ``DRAW`` JSON line a
stage.

Each path is driven with the launch counts set to 0 just before it and
read just after; the ``launches`` of a kernel are those of its path.
Exits non-zero, printing no result, without a CUDA device or if any phase
fails. Float32 checks on the card run with TF32 off.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import importlib.util
import io
import itertools
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W) and the detector's
# conv FLOPs
# the int8 forward's phases: profiler ranges in ops/quant.py
from tensorflow_yolo2_torch.ops.quant import PHASES as INT8_PHASES
from tensorflow_yolo2_torch.utils.profiling import (
    BF16_FLOPS_PER_S,
    F32_OPS_PER_S,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
    TF32_FLOPS_PER_S,
    conv_flops_per_image,
    resnet50_flops_per_image,
)


K = 32
BATCH = 256
PATH_BATCHES = (32, 256)
GRID_REL_TOL = 5e-2  # bf16 card forward vs float32 CPU forward, rel. norm
BOX_TOL = 1e-6
SOURCE = "tensorflow_yolo2_torch/csrc/decode.cu"
POOL_SOURCE = "tensorflow_yolo2_torch/csrc/pool.cu"
STEM_SOURCE = "tensorflow_yolo2_torch/csrc/stem.cu"
STEM_F32_SOURCE = "tensorflow_yolo2_torch/csrc/stem_f32.cu"
TPU_KERNELS = {
    "decode_nms": "tensorflow_yolo2_tpu/ops/pallas_decode.py:204",
    "decode_nms_v2": "tensorflow_yolo2_tpu/ops/pallas_decode.py:255",
    "decode_grid": "tensorflow_yolo2_tpu/ops/pallas_decode.py:42",
    "max_pool2_bwd": "tensorflow_yolo2_tpu/ops/pallas_pool.py:44",
    "stem": "tensorflow_yolo2_tpu/ops/pallas_stem.py:118",
    "stem_f32": "tensorflow_yolo2_tpu/ops/pallas_stem.py:118",
}

# B4 against its plain version (same rounding points, float32 sums in
# another order). A sum that lands on the other side of a bf16 rounding
# boundary in stage 1 moves the stage-2 sums that read it by ~1 bf16 ulp
# of the stage-1 value, which near an output of 0 is many ulps of that
# output: cuDNN's float32 plain version itself is 1236 ulps from a
# float64 reference at worst on (4, 448, 448). So each difference is held
# to one bf16 ulp of the plain value or of the plain output's RMS,
# whichever is larger; the share of bit-equal elements is taken over all
# shapes of a weight set (one such flip moves ~20 outputs, a large share
# of a 32² image's); and the relative norm.
STEM_BIT_SHARE = 0.999
STEM_MAX_ULPS = 1.0
STEM_REL_TOL = 1e-4
STEM_SHAPES = ((2, 32, 32), (1, 64, 32), (1, 56, 64), (4, 416, 416),
               (4, 448, 448), (256, 448, 448))
# the --pallas-stem grid against the stock path's bf16 grid, rel. norm
STEM_PATH_REL_TOL = 5e-2
# B4-f32 against its plain version (float32 sums in another order):
# rtol = atol, the JAX package's own bound for its float32 stem
STEM_F32_TOL = 1e-5
# the float32 --pallas-stem grid against the stock float32 grid (TF32
# off), and a float32 card grid against the float32 CPU forward, rel.
# norm: 22 float32 convs summed in other orders
STEM_F32_PATH_REL_TOL = 2e-4

# names of the kernels of csrc/, which the profile lists by kernel
PORT_KERNEL_NAMES = ("decode_grid_kernel", "decode_nms_kernel",
                     "pool2_bwd_kernel", "stem_kernel", "stem_f32_kernel")

# the training path: the reference's batch 24, and 64
TRAIN_BATCHES = (24, 64)
FALL_STEPS = 30       # steps on one batch, over which the loss must fall
TIMED_STEPS = 20
# a float32 train step on the card against float64 on the CPU (see
# check_train_step_against_cpu for why float64): the loss, relative; each
# gradient and all of them as one vector, relative norm
LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 5e-2
ALL_GRADS_REL_TOL = 1e-2
BF16_LOSS_REL_TOL = 5e-2  # bf16 loss vs float32 loss, same weights
L2_BYTES = 50e6
# the v2p training path: YOLOv2's VOC size, the reference's batch and 64;
# the float32-vs-float64 step on a few images of the batch (CPU float64
# at 416² is the slow part)
V2P_TRAIN_SIZE = 416
V2P_CHECK_IMAGES = 4
# evaluation: pascal_eval_map's threshold and batch, 8 batches
EVAL_THRESH = 0.005
EVAL_BATCH = 32
EVAL_IMAGES = 256
# the native host layer: (source shape, target size) of the resize checks
NATIVE_SHAPES = (((240, 320), 448), ((480, 640), 416), ((37, 53), 64))
DEMO = "assets/demo.jpg"  # 320×240, baseline JPEG
DEMO_CANDIDATES = 120  # slots above the threshold the CLI serves DEMO at
# int8 serving: calibration images (card and CPU), and images whose int8
# forward is held to the CPU's conv by conv (a float64 conv chain takes
# seconds an image at 448² on the host)
INT8_CALIB_IMAGES = 2
INT8_CPU_IMAGES = 1
# card vs CPU calibration, each scale, relative: float32 convs (TF32 off)
# summed in other orders
INT8_CALIB_REL_TOL = 1e-4
# card vs CPU int8 grid from the same layers, relative norm: the same int32
# sums and the same eager float32 epilogue; bounded, not 0, for a rounding
# of the card's float32 multiply or add that differed from the host's
INT8_GRID_REL_TOL = 1e-6
# names of a float conv's operators and kernels (cuDNN's implicit-GEMM
# kernels are named fprop / dgrad / wgrad)
FLOAT_CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "cudnn")
# the classifier: ImageNet's 1000 classes at 224², the reference's
# pretrain batch 48, and 64; the float32-vs-float64 step on a few images
# of the batch (the CPU's float64 step is the slow part); int8 at 256
CLS_CLASSES = 1000
CLS_SIZE = 224
CLS_BATCHES = (48, 64)
CLS_CHECK_IMAGES = 16
# the synthetic ILSVRC tree of the classifier's CLIs: synsets, train
# images a synset, val images; 8 a batch, 5 train iterations an epoch
CLS_TREE = (10, 4, 16)
CLS_CLI_BATCH = 8
# the ResNet50 family: the detector at the reference's 224² (S=7, B=2,
# C=20) served at the CLI's threshold 0.2, trained at the reference's
# batch 4 and at 32; its float32-vs-float64 step at 64² on 4 images
# (full width; the CPU's float64 step at 224² is too slow); the
# 1000-class fine-tune at the reference's batch 32, 10 steps checked
RESNET_THRESH = 0.2
RESNET_TRAIN_BATCHES = (4, 32)
RESNET_CHECK_SIZE = 64
RESNET_CHECK_IMAGES = 4
# the check's weights: fresh ones after 3 float64 Adam steps on the CPU
# (resnet_check_weights). Float32 rounding alone puts ResNet50's
# gradients at 64², batch 4, there 1.35e-2 from float64 on the card and
# 8.1e-3 on the CPU (all, relative norm; the worst tensor 2.8e-2 and
# 1.3e-2; the same every run under torch 2.11), over the detector steps'
# 1e-2; from other weights up to 1.9e-2 all. So the card is held to 1e-1
# worst and 3e-2 all; TF32 convs are 0.35–0.47 / 0.25–0.30 off, bf16
# 0.95–1.2 / 0.78–0.95, both rejected
RESNET_WARM_STEPS = 3
RESNET_GRAD_BOUNDS = (1e-1, 3e-2)
FINE_TUNE_BATCH = 32
FINE_TUNE_STEPS = 10
# the synthetic VOC tree of the ResNet detector's CLIs: images, batch
VOC_TREE_IMAGES = 8
RESNET_CLI_BATCH = 4
# the slim tier (train_classifier, eval_classifier, flowers_train, the
# zoo, the optimizer family): the CLIs on a make_flowers tree at 224²
# (3 classes, 8 images each), 4 iterations at batch 8 with accumulation
# over 2; the zoo at each net's default size, batch 2
SLIM_FLOWERS_PER_CLASS = 8
SLIM_CLI_BATCH = 8
SLIM_CLI_ITERS = 4
ZOO_BATCH = 2
# the zoo's float32 card forward (TF32 off) against the CPU's float32
# forward from the same weights: both round every conv and dense sum in
# float32, in other orders, ~1e-7 relative a layer; 1e-4 leaves room for
# the deepest (resnet_v1_200, 200 layers) and rejects a wrong padding,
# pool or flatten (relative errors of order 1)
ZOO_F32_REL_TOL = 1e-4
# the bf16 autocast forward against the same CPU float32 forward: the
# serving paths' bound (GRID_REL_TOL)
ZOO_BF16_REL_TOL = 5e-2
# one update of each optimizer (EMA, MultiSteps) on the card against the
# CPU's from the same float32 parameters, gradients and slots: the same
# formulas, the card's in float32 (rsqrt within 2 ulp there), ~1e-7. The
# CPU's update is taken in float64: its float32 norm of a 1M-value tensor
# is 1e-5 off (measured), and the clip divides every gradient by it
OPT_REL_TOL = 1e-6
OPT_WARM_STEPS = 3
# a k=2 step on two batches of 16 against one step on the batch of 32
# (yolo1_pretrain at 224², float32, TF32 off; no BatchNorm, no dropout):
# the parameters after, and the accumulated gradient against the mean of
# the two batch-16 gradients, the same float32 values summed in another
# order, ~1e-7. (Against the batch-32 gradient the card measured 4.8e-4
# all, 7.2e-3 on conv4's bias: cuDNN computes 16 and 32 images
# differently; printed, not held)
ACCUM_REL_TOL = 1e-5
ACCUM_SIZE = 224
REMAT_NET, REMAT_BATCH = "resnet_v1_152", 8
# timed train steps: (net, size, batch, classes, EMA), bf16, the CLI's
# rmsprop with weight decay 4e-5 (darknet19 on flowers' 5 classes)
SLIM_TIMES = (("darknet19", 224, 32, 5, True),
              ("vgg_16", 224, 32, 1000, False),
              ("resnet_v1_152", 224, 32, 1000, False),
              ("yolo1", 448, 16, None, False),
              ("inception_v3", 299, 32, 1000, False),
              ("inception_resnet_v2", 299, 32, 1000, False))
# the nets with auxiliary heads: the zoo's forwards and the timed steps
# build them with the heads (the timed inception_v3 step trains them)
AUX_NETS = ("inception_v1", "inception_v3", "inception_v4")
# the identity fold (models.fold.fold_params_identity) of inception_v3 at
# 299², float32 (TF32 off): the folded logits against the unfolded ones,
# relative norm; the CPU test's bound (float32 convs of rescaled kernels)
FOLD_BATCH = 8
FOLD_REL_TOL = 1e-5
# the data tier's CLIs: a seeded CIFAR-10 python archive behind a file://
# URL (images a batch file) and MNIST's four gzipped IDX files (train,
# test images) in a mirror under the run root
DATA_CIFAR_PER_BATCH = 16
DATA_MNIST = (64, 32)
DATA_INCEPTION_SIZE = 299  # inception_v3's default size


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + what)


def synthetic_grid(cfg, batch: int = 3, seed: int = 0) -> np.ndarray:
    """Seeded grid with confident same-cell pairs, exact score ties among
    large overlapping boxes of one class, and a tied box of another."""
    rng = np.random.RandomState(seed)
    C, B = cfg.num_class, cfg.B
    net = rng.normal(0, 0.6, (batch, cfg.S, cfg.S, cfg.cell_channels)
                     ).astype(np.float32)
    net[:, 1, 2, C] = 0.95
    net[:, 1, 2, C + 1] = 0.9
    net[:, 1, 3, C] = 0.8
    for y, x, b, cls in ((2, 2, 1, 4), (2, 3, 0, 4), (3, 2, 0, 4),
                         (3, 3, 1, 4), (3, 4, 0, 9)):
        net[:, y, x, :C] = 0.0
        net[:, y, x, cls] = 3.0
        net[:, y, x, C:C + B] = 0.3
        net[:, y, x, C + b] = 0.85
        net[:, y, x, C + B + 4 * b:C + B + 4 * b + 4] = (0.5, 0.5, 0.8, 0.8)
    return net


def synthetic_grid_v2(cfg, batch: int = 3, seed: int = 0) -> np.ndarray:
    """Seeded per-slot anchor grid (S >= 7): random logits with 3·S
    confident slots, and large (0.6 × 0.6) boxes with exactly tied
    scores: class 4 at (2, 3) slot 0 and (2, 2) slot 1 (IoU ≈ 0.61; the
    key order b·S·S + cell keeps the first, cell-major order the
    second), class 9 at (3, 3) slot 2 (IoU ≈ 0.61 with the first, so
    only class-aware NMS keeps it), and a lower-scored duplicate of the
    first in the last slot of its cell (B >= 3)."""
    rng = np.random.RandomState(seed)
    S, B, C = cfg.S, cfg.B, cfg.num_class
    net = rng.normal(0, 0.6, (batch, S, S, cfg.cell_channels)
                     ).astype(np.float32)
    slots = net.reshape(batch, S, S, B, 5 + C)  # a view of net
    ys, xs, bs = (rng.randint(0, m, 3 * S) for m in (S, S, B))
    slots[:, ys, xs, bs, 4] = 4.0
    slots[:, ys, xs, bs, 5 + rng.randint(0, C, 3 * S)] = 5.0
    anchors = np.asarray(cfg.anchors or ((1.0, 1.0),) * B)
    for y, x, b, cls, conf in ((2, 3, 0, 4, 3.0), (2, 2, 1, 4, 3.0),
                               (3, 3, 2, 9, 3.0), (2, 3, B - 1, 4, 2.0)):
        slots[:, y, x, b] = 0.0
        slots[:, y, x, b, 2:4] = np.log(0.6 * S / anchors[b])
        slots[:, y, x, b, 4] = conf
        slots[:, y, x, b, 5 + cls] = 6.0
    return net


def compare_dense(got, want) -> float:
    """B3 against its plain version: scores and classes exact, boxes to
    BOX_TOL. Returns the largest absolute difference."""
    check(torch.equal(got.scores, want.scores), "decode_grid scores")
    check(torch.equal(got.classes, want.classes), "decode_grid classes")
    err = (got.boxes - want.boxes).abs().max().item()
    check(err <= BOX_TOL, f"decode_grid boxes differ by {err}")
    return err


def compare_kept(got, want, name: str = "decode_nms") -> float:
    """B1 or B2 against its plain version: scores exact, kept boxes to
    BOX_TOL, kept classes exact. Returns the largest absolute difference."""
    check(torch.equal(got.scores, want.scores), f"{name} scores")
    kept = want.scores > 0
    check(torch.equal(got.classes[kept], want.classes[kept]),
          f"{name} kept classes")
    err = (got.boxes[kept] - want.boxes[kept]).abs().max().item() \
        if kept.any() else 0.0
    check(err <= BOX_TOL, f"{name} kept boxes differ by {err}")
    return err


def pool_sites(batch: int, size: int = 224) -> list[tuple[int, ...]]:
    """NCHW shapes of the inputs of Darknet19's five 2×2/2 pools."""
    return [(batch, c, size >> i, size >> i)
            for i, c in enumerate((32, 64, 128, 256, 512))]


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits in NCHW order, for bit-exact comparisons."""
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_pool(x: torch.Tensor, dout: torch.Tensor, what: str) -> float:
    """B5 on (x, dout) against its plain version and against torch's
    autograd of ``F.max_pool2d``: all three bit-equal. Returns the largest
    absolute difference to the plain version (0.0)."""
    from tensorflow_yolo2_torch.ops import cuda_pool

    y = F.max_pool2d(x, 2, 2)
    fused = cuda_pool.max_pool2_bwd_fused(x, y, dout)
    plain = cuda_pool.max_pool2_bwd_plain(x, y, dout)
    leaf = x.detach().requires_grad_()
    auto, = torch.autograd.grad(F.max_pool2d(leaf, 2, 2), leaf, dout)
    check(fused.shape == x.shape and fused.dtype == x.dtype,
          f"max_pool2_bwd output, {what}")
    check(torch.equal(bits(fused), bits(plain)),
          f"max_pool2_bwd equals its plain version, {what}")
    check(torch.equal(bits(fused), bits(auto)),
          f"max_pool2_bwd equals autograd of F.max_pool2d, {what}")
    return (fused.float() - plain.float()).abs().max().item()


def check_pool_kernel(dev: torch.device) -> float:
    """B5 at the five pool sites of a 224² step at batch 24 in bf16 and
    float32; on integer values in {0, 1, 2}, which tie in almost every
    window; on odd C and small maps; and on an input in NCHW memory."""
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(s, dt, False) for s in pool_sites(TRAIN_BATCHES[0])
             for dt in (bf16, f32)]
    cases += [(s, dt, True) for s in pool_sites(4)[::2] for dt in (bf16, f32)]
    cases += [((2, 3, 4, 6), f32, False), ((1, 5, 2, 2), bf16, True),
              ((3, 5, 8, 10), bf16, False), ((2, 3, 6, 4), f32, True)]
    err = 0.0
    for shape, dtype, ties in cases:
        if ties:
            x = torch.randint(0, 3, shape, generator=gen, device=dev)
        else:
            x = torch.randn(shape, generator=gen, device=dev)
        n, c, h, w = shape
        dout = torch.randn((n, c, h // 2, w // 2), generator=gen, device=dev)
        x, dout = (t.to(dtype).contiguous(memory_format=torch.channels_last)
                   for t in (x, dout))
        kind = "ties" if ties else "random"
        err = max(err, check_pool(x, dout, f"{kind} {dtype} {shape}"))
    err = max(err, check_pool(x.contiguous(), dout.contiguous(),
                              "NCHW memory"))
    torch.cuda.synchronize()
    return err


def pool_bound(x: torch.Tensor) -> tuple[float, float]:
    """Least time of B5 on x, in ms, by bytes (x and dx once, y and dout
    once: 2.5·|x|) and by operations (a compare and a select an input
    element, float32 rate)."""
    nbytes = 2.5 * x.numel() * x.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * x.numel() / F32_OPS_PER_S * 1e3


def cold_copies(make, nbytes: float) -> list:
    """Enough ``make()`` input sets that cycling through them outruns the
    50 MB L2, as a train step finds the pool's inputs: the forward saved
    them long before the backward reads them."""
    return [make() for _ in range(min(32, max(1, math.ceil(
        2.5 * L2_BYTES / nbytes))))]


def time_pool_sites(dev: torch.device, batch: int) -> list[dict]:
    """B5, its plain version and torch's own pool backward
    (``max_pool2d_with_indices_backward`` given the forward's indices) at
    each pool site of a bf16 train step, on inputs L2 does not hold."""
    from tensorflow_yolo2_torch.ops import cuda_pool

    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for shape in pool_sites(batch):
        def make():
            x = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            y, idx = torch.ops.aten.max_pool2d_with_indices(x, [2, 2],
                                                             [2, 2])
            return x, y, torch.randn(y.shape, generator=gen, device=dev,
                                     dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last), idx

        t_bytes, t_ops = pool_bound(make()[0])
        sets = cold_copies(make, 2.5 * math.prod(shape) * 2)
        cycle = itertools.cycle(sets)

        def fused():
            x, y, dout, _ = next(cycle)
            return cuda_pool.max_pool2_bwd_fused(x, y, dout)

        def library():
            x, _, dout, idx = next(cycle)
            return torch.ops.aten.max_pool2d_with_indices_backward(
                dout, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)

        def plain():
            x, y, dout, _ = next(cycle)
            return cuda_pool.max_pool2_bwd_plain(x, y, dout)

        rows.append({"shape": list(shape), "ms": graph_ms(fused, 40),
                     "library_ms": graph_ms(library, 40),
                     "plain_ms": cuda_ms(plain, 5),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "copies": len(sets)})
        del sets, cycle
    return rows


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing above |v|, as float32."""
    a = v.abs().to(torch.bfloat16)
    return (a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float()


def compare_stem(got: torch.Tensor, want: torch.Tensor,
                 what: str) -> tuple[float, int]:
    """B4's output against its plain version's: no difference above
    STEM_MAX_ULPS bf16 ulps of the plain value or of the plain output's
    RMS, relative norm at most STEM_REL_TOL. Returns the largest absolute
    difference and the count of elements that are not bit-equal, for the
    caller's share."""
    check(got.shape == want.shape and got.dtype == want.dtype ==
          torch.bfloat16, f"stem output {tuple(got.shape)} {got.dtype}, "
          f"{what}")
    unequal = int((bits(got) != bits(want)).sum().item())
    w = want.float()
    diff = (got.float() - w).abs()
    rms = w.double().square().mean().sqrt().float()
    ulps = (diff / torch.maximum(bf16_ulp(want), bf16_ulp(rms))).max().item()
    rel = (diff.double().norm() / w.double().norm().clamp(min=1e-30)).item()
    print(f"stem {what}: {100 - unequal / want.numel() * 100:.4f}% "
          f"bit-equal, worst {ulps:.2f} ulp (of the value or the RMS "
          f"{rms.item():.3f}), relative norm {rel:.2e}")
    check(ulps <= STEM_MAX_ULPS and rel <= STEM_REL_TOL,
          f"stem matches its plain version, {what}")
    return diff.max().item(), unequal


def random_stem_weights(gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    """Seeded (w1, b1, w2, b2) at the spreads of the JAX package's stem
    tests."""
    return tuple(torch.randn(shape, generator=gen) * std for shape, std in (
        ((3, 3, 3, 32), 0.3), ((32,), 0.2), ((3, 3, 32, 64), 0.1),
        ((64,), 0.2)))


def check_stem_kernel(dev: torch.device, state: dict | None,
                      dtype: torch.dtype = torch.bfloat16) -> float:
    """The stem kernel of ``dtype`` (B4, B4-f32) against
    ``fused_stem_plain`` on the card at STEM_SHAPES, with random weights
    and, given ``state``, the folded conv1 / conv2 of its detector; then
    all-zero images with b1 > 0, where SAME padding of the stage-1 map
    with zeros (not leaky(b1)) makes every edge output differ from the
    interior. B4 is held by ``compare_stem`` and its bit-equal share over
    all shapes of a weight set, B4-f32 by ``compare_stem_f32`` (TF32
    off). Returns the largest absolute difference."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        stem_weights,
    )
    from tensorflow_yolo2_torch.ops import cuda_stem as cs

    f32 = dtype == torch.float32
    compare = compare_stem_f32 if f32 else compare_stem
    check(not (f32 and torch.backends.cudnn.allow_tf32),
          "the float32 plain stem runs with TF32 off")
    gen = torch.Generator().manual_seed(7)
    xgen = torch.Generator(device=dev).manual_seed(8)
    sets = {"random": cs.pack_stem_weights(*random_stem_weights(gen),
                                           device=dev)}
    if state is not None:
        sets["detector"] = stem_weights(state, dev)
    err = 0.0
    for name, weights in sets.items():
        unequal = total = 0
        for n, h, w in STEM_SHAPES:
            x = (torch.rand((n, h, w, 3), generator=xgen, device=dev) * 2 - 1
                 ).to(dtype)
            got = cs.fused_stem_packed(x, weights)
            want = cs.fused_stem_plain(x, *weights[:4])
            e, u = compare(got, want, f"{name} weights, {(n, h, w)}")
            err, unequal, total = max(err, e), unequal + u, total + got.numel()
            del x, got, want
        share = 1 - unequal / total
        bound = "" if f32 else f" (bound {STEM_BIT_SHARE * 100}%)"
        print(f"{'stem_f32' if f32 else 'stem'}, {name} weights, all "
              f"shapes: {share * 100:.4f}% bit-equal{bound}")
        check(f32 or share >= STEM_BIT_SHARE, f"stem bit-equal share, {name}")
        torch.cuda.synchronize()
    w1, b1, w2, b2 = random_stem_weights(gen)
    weights = cs.pack_stem_weights(w1, b1.abs() + 0.1, w2, b2, device=dev)
    x = torch.zeros((2, 64, 96, 3), dtype=dtype, device=dev)
    got = cs.fused_stem_packed(x, weights)
    err = max(err, compare(got, cs.fused_stem_plain(x, *weights[:4]),
                           "all-zero images, b1 > 0")[0])
    inner = got[:, 1:-1, 1:-1]
    check(bool((inner == got[:1, 1:2, 1:2]).all()),
          "zero images: the interior is constant")
    for edge in (got[:, 0, 1:-1], got[:, -1, 1:-1], got[:, 1:-1, 0],
                 got[:, 1:-1, -1]):
        check(bool((edge != inner[:, :1, 0]).any(-1).all()),
              "zero images: every edge output differs from the interior")
    torch.cuda.synchronize()
    return err


def stem_bound(n: int, h: int, w: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Least time of the stem kernel of ``dtype`` (B4, B4-f32) on (n, h,
    w, 3) images, in ms: by bytes (the images read once, the (n, h/4,
    w/4, 64) output written once, the weights) and by operations (the two
    convs' multiply-adds, 2 FLOPs each, at the bf16 tensor-core rate for
    B4 and the float32 FMA rate for B4-f32; the float32 bias, leaky and
    pool run on other units beside them). For float32 also the least time
    at float32 accuracy on the tensor cores: three TF32 passes
    (3xTF32)."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n * h * w * 3 + n * (h // 4) * (w // 4) * 64 +
              27 * 32 + 288 * 64) * size + (32 + 64) * 4
    flops = n * 2 * (h * w * 27 * 32 + (h // 2) * (w // 2) * 288 * 64)
    rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    out = {"bound_ms": max(t_bytes, t_ops), "bytes_bound_ms": t_bytes,
           "ops_bound_ms": t_ops,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if dtype == torch.float32:
        out["ops_bound_3xtf32_ms"] = 3 * flops / TF32_FLOPS_PER_S * 1e3
    return out


def compare_stem_f32(got: torch.Tensor, want: torch.Tensor,
                     what: str) -> tuple[float, int]:
    """B4-f32's output against its plain version's at rtol = atol =
    STEM_F32_TOL. Returns the largest absolute difference and the count
    of elements that are not bit-equal, as ``compare_stem``."""
    check(got.shape == want.shape and got.dtype == want.dtype ==
          torch.float32, f"float32 stem output {tuple(got.shape)} "
          f"{got.dtype}, {what}")
    diff = (got - want).abs()
    share = (diff / (STEM_F32_TOL * (1 + want.abs()))).max().item()
    print(f"stem_f32 {what}: max abs err {diff.max().item():.3e}, worst "
          f"{share:.3f} of the tolerance (rtol = atol {STEM_F32_TOL})")
    check(share <= 1.0, f"float32 stem matches its plain version, {what}")
    return diff.max().item(), int((bits(got) != bits(want)).sum().item())


def time_stem(dev: torch.device, yolo, state: dict, images,
              dtype: torch.dtype = torch.bfloat16) -> dict:
    """The stem kernel of ``dtype`` (B4, B4-f32), its plain version and the
    stock stem (the detector's own conv1, bias, leaky, pool, conv2, bias,
    leaky, pool) in ``dtype`` on one uint8 batch of 448² images
    normalized on the card; the kernel and the stock stem replayed from
    CUDA graphs. In float32 the stock stem runs with cuDNN's TF32 off (the
    same accuracy) and on (PyTorch's default, not held to 1e-5)."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        build_detector,
        stem_weights,
    )
    from tensorflow_yolo2_torch.models.layers import max_pool
    from tensorflow_yolo2_torch.ops import cuda_stem as cs
    from tensorflow_yolo2_torch.utils.device import device_normalize

    x = device_normalize(images.to(dev)).to(dtype)
    weights = stem_weights(state, dev)
    bk = build_detector(yolo, state, dtype=dtype, device=dev).backbone
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory, as the model
    n, h, w, _ = x.shape
    reps = 5 if dtype == torch.float32 else 20
    out = {}
    with torch.inference_mode():
        out["ms"] = graph_ms(lambda: cs.fused_stem_packed(x, weights), reps)
        for tf32 in ((False, True) if dtype == torch.float32 else (False,)):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                out["stock_stem_tf32_ms" if tf32 else "stock_stem_ms"] = \
                    graph_ms(lambda: max_pool(bk.conv2(max_pool(bk.conv1(
                        xc)))), reps)
            finally:
                torch.backends.cudnn.allow_tf32 = False
        out["plain_ms"] = cuda_ms(lambda: cs.fused_stem_plain(
            x, *weights[:4]), 3)
    return out | stem_bound(n, h, w, dtype) | {"shape": [n, h, w, 3]}


# ``--stem-ab``: B4's sources built and timed side by side. A phase of a
# tile's work in a stem source is the block that starts at its comment and
# ends at the first line "    }" after it; a copy without it computes a
# wrong output and is only timed.
STEM_PHASES = {"load": "    // input patch:", "conv1": "    // stage 1:",
               "conv2": "    // stage 2:"}
AB_ROUNDS = 4  # rounds of timing, in turns (A B ... B A A B ...)
# what ptxas prints where a wgmma pipeline cannot stand as written: B4
# would run, slower, and still pass
PIPELINE_LOST = ("serialized", "is injected")


def without_phases(text: str, phases) -> str:
    """The stem source ``text`` with the named phases left out."""
    lines = text.split("\n")
    for phase in phases:
        first = next(i for i, line in enumerate(lines)
                     if line.startswith(STEM_PHASES[phase]))
        del lines[first:lines.index("    }", first) + 1]
    return "\n".join(lines)


def stem_variants(sources: list[str], where: str) -> list[dict]:
    """Each stem source whole, with each phase left out and with each
    phase alone; the copies are written to ``where``."""
    os.makedirs(where, exist_ok=True)
    variants = []
    for src in sources:
        with open(src) as f:
            text = f.read()
        base = os.path.basename(src)[:-3]
        for left_out in [(), *((p,) for p in STEM_PHASES),
                         *(tuple(q for q in STEM_PHASES if q != p)
                           for p in STEM_PHASES)]:
            if len(left_out) == 2:
                alone = next(p for p in STEM_PHASES if p not in left_out)
                name = f"{base}, {alone} alone"
            else:
                name = base + "".join(f" -{p}" for p in left_out)
            copy = src
            if left_out:
                copy = os.path.join(where, f"{base}-no-{'-'.join(left_out)}.cu")
                with open(copy, "w") as f:
                    f.write(without_phases(text, left_out))
            # a source without wgmma (B4 before it) reads conv2's weights
            # as mma.sync fragments
            variants.append({"name": name, "source": src, "build": copy,
                             "left_out": list(left_out),
                             "wgmma": "wgmma.mma_async" in text})
    return variants


@contextlib.contextmanager
def stem_build(v: dict):
    """``cuda_stem``'s wrapper, on the card, launching the variant's
    library, with conv2's weights packed in the layout it reads."""
    from tensorflow_yolo2_torch.ops import cuda_stem as cs
    from tensorflow_yolo2_torch.utils import cuda_build

    lib = cs.bind(ctypes.CDLL(cuda_build.library_path(v["build"])))
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(cs, "_lib", lambda: lib))
        if not v["wgmma"]:
            stack.enter_context(mock.patch.object(
                cs, "wgmma_tiles", lambda w: cs.mma_fragments(w).view(
                    18, cs.C2 // 8, 2, 8, 8)))
        yield


def stem_ab(sources: list[str], card: str) -> int:
    """Builds every variant of ``stem_variants`` at once and prints what
    ptxas says; holds each whole source to the plain version as
    ``check_stem_kernel`` does (random weights); times every variant at
    batch 256, 448², bf16 (CUDA-graph replays) in AB_ROUNDS rounds, in
    turns, on the same seeded images and weights. Prints a line for each
    variant, then one JSON object. Returns 1 if a whole source fails its
    check or loses its wgmma pipeline, else 0."""
    from tensorflow_yolo2_torch.ops import cuda_stem as cs
    from tensorflow_yolo2_torch.utils import cuda_build

    dev = torch.device("cuda")
    variants = stem_variants(sources, os.path.join(cuda_build.BUILD_DIR,
                                                   "ab"))
    t0 = time.perf_counter()
    logs = cuda_build.build([v["build"] for v in variants])
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(variants)} "
          f"variants")
    ok = True
    for v in variants:
        print(f"[{v['name']}: {v['build']}]\n{logs[v['build']]}", end="")
        v["pipeline_lost"] = any(w in logs[v["build"]]
                                 for w in PIPELINE_LOST)
        v["check"] = None
        if not v["left_out"]:
            with stem_build(v):
                try:
                    check_stem_kernel(dev, None)
                    v["check"] = True
                except RuntimeError as e:
                    print(f"{v['name']}: {e}")
                    v["check"] = False
            ok &= v["check"] and not v["pipeline_lost"]

    n, h, w = BATCH, 448, 448
    raw = random_stem_weights(torch.Generator().manual_seed(0))
    x = (torch.rand((n, h, w, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
         * 2 - 1).to(torch.bfloat16)
    for v in variants:
        with stem_build(v):
            v["weights"] = cs.pack_stem_weights(*raw, device=dev)
        v["runs_ms"] = []
    for r in range(AB_ROUNDS):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            with stem_build(v), torch.inference_mode():
                v["runs_ms"].append(graph_ms(
                    lambda: cs.fused_stem_packed(x, v["weights"]), 20))
    bound = stem_bound(n, h, w)["bound_ms"]
    rows = []
    for v in variants:
        ms = sum(v["runs_ms"]) / len(v["runs_ms"])
        print(f"{v['name']}: {ms:.4f} ms ("
              + ", ".join(f"{t:.4f}" for t in v["runs_ms"])
              + f"; bound {bound:.3f} ms, {ms / bound:.2f}x)"
              + ("" if v["check"] is None else
                 ", check " + ("ok" if v["check"] else "FAILED"))
              + (", wgmma pipeline LOST" if v["pipeline_lost"] else ""))
        rows.append({k: v[k] for k in ("name", "source", "left_out",
                                       "runs_ms", "check", "pipeline_lost")}
                    | {"ms": ms})
    print(json.dumps({"card": card, "shape": [n, h, w, 3], "bound_ms": bound,
                      "variants": rows}))
    return 0 if ok else 1


def train_batch(rng: np.random.RandomState, batch: int, yolo):
    """Seeded uint8 images (batch, size, size, 3) and their label grids on
    1–6 seeded boxes an image: ``build_label_grid`` for the v1 head,
    ``build_label_grid_v2`` (per-slot) for an anchor config."""
    from tensorflow_yolo2_torch.data.voc import (
        build_label_grid,
        build_label_grid_v2,
    )

    size = yolo.image_size
    images = rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8)
    slots = (yolo.B,) if yolo.per_slot_classes else ()
    labels = np.zeros((batch, yolo.S, yolo.S) + slots +
                      (5 + yolo.num_class,), np.float32)
    for i in range(batch):
        n = rng.randint(1, 7)
        xy = rng.uniform(0, size - 40, (n, 2))
        wh = rng.uniform(16, 160, (n, 2))
        corners = np.concatenate([xy, np.minimum(xy + wh, size - 1)],
                                 1).astype(np.float32)
        cls = rng.randint(0, yolo.num_class, n)
        if yolo.per_slot_classes:
            labels[i] = build_label_grid_v2(corners, cls, yolo.S, yolo.B,
                                            yolo.anchors, yolo.num_class,
                                            float(size))
        else:
            labels[i] = build_label_grid(corners, cls, yolo.S,
                                         yolo.num_class, float(size))
    return images, labels


def make_trainer(yolo, dtype: torch.dtype, device, state_dict=None):
    """The trainer as the CLI builds it (Adam at 1e-3) and its state on
    ``device``, fresh weights from seed 0 or ``state_dict``'s: the v1
    detector and the YOLOv1 loss, or for an anchor config the YOLOv2
    passthrough detector (``--v2 --passthrough``) and the YOLOv2 loss,
    whose burn-in the step count drives."""
    from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_task
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
    )
    from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

    if yolo.per_slot_classes:
        model, task = (Darknet19DetectorV2(yolo.cell_channels),
                       yolo_v2_task(yolo))
    else:
        model, task = Darknet19Detector(yolo.cell_channels), yolo_task(yolo)
    trainer = Trainer(model, task, device=device, compute_dtype=dtype)
    return trainer, trainer.create_state(torch.Generator().manual_seed(0),
                                         state_dict)


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()


def step_grads(build, dtype: torch.dtype, where, state_dict, images,
               labels) -> tuple[float, dict]:
    """(loss, gradients by name, float64 on the CPU) of one step of the
    network of ``build(compute_dtype, device, state_dict) → (trainer,
    state)`` (``make_trainer`` of a detector, ``make_cls_trainer``) from
    ``state_dict``'s weights, in train mode, with the trunk in ``dtype``:
    bf16 (autocast), float32, or float64 (the model converted, the images
    normalized in float64; the head output and the loss stay float32, as
    on every path)."""
    compute = torch.float32 if dtype == torch.float64 else dtype
    trainer, state = build(compute, where, state_dict)
    if dtype == torch.float64:
        state.model.double()
        images = images.double() / 255.0 * 2.0 - 1.0
    metrics, grads = trainer.loss_and_grads(state, images.to(where),
                                            labels.to(where))
    return (metrics["loss"].item(),
            {k: g.detach().double().cpu() for k, g in grads.items()})


def grad_errors(grads: dict, want: dict) -> tuple[float, str, float]:
    """(worst relative-norm error of one gradient, its name, error of all
    gradients as one vector). The conv biases in front of a BatchNorm
    have a true gradient of 0 and hold rounding noise: they count only in
    the error of all."""
    pre_bn = {k for k in want if k.endswith("conv.bias") and
              k[:-len("conv.bias")] + "bn.weight" in want}
    worst, key = max((rel_norm(grads[k], want[k]), k)
                     for k in want if k not in pre_bn)
    total = rel_norm(torch.cat([grads[k].ravel() for k in want]),
                     torch.cat([want[k].ravel() for k in want]))
    return worst, key, total


def check_train_step_against_cpu(build, images, labels, dev,
                                 state_dict,
                                 bounds: tuple[float, float] = (
                                     GRAD_REL_TOL, ALL_GRADS_REL_TOL)
                                 ) -> dict:
    """One step (forward in train mode and gradients) from the weights of
    ``state_dict`` on one batch: float32 on the card, TF32 off, held to
    the float64 step on the CPU, with the CPU's own float32 step printed
    beside it; and the bf16 step's loss on the card held to the float32
    one. The gradients of the same step with TF32 convs and of the bf16
    step are printed as controls, with whether the bounds reject them.

    The float32 gradients of this network are ill-conditioned: the
    BatchNorm backward of each of 22 layers subtracts batch means, and
    float32 rounding alone puts the CPU's gradients of the early BN
    parameters up to 3e-2 (relative norm) from the float64 ones at fresh
    weights, batch 24, and 7e-3 after 30 steps at batch 8. So each side
    is held to float64, not to the other. The weights are those of a few
    steps on this batch: from fresh ones the predicted boxes are random
    and the responsible box of a cell (the larger of two small IoUs)
    flips under bf16's rounding, which moves the coordinate loss ~10%.

    ``bounds`` = (worst, all) are the gradient bounds: GRAD_REL_TOL and
    ALL_GRADS_REL_TOL, or wider ones for a network whose float32
    rounding alone reaches those (ResNet50's 53 BatchNorms at 64²:
    ``RESNET_GRAD_BOUNDS``). The TF32 control must be rejected by
    them."""
    cpu = torch.device("cpu")
    loss, grads = step_grads(build, torch.float32, dev, state_dict, images,
                             labels)
    loss64, grads64 = step_grads(build, torch.float64, cpu, state_dict,
                                 images, labels)
    loss32, grads32 = step_grads(build, torch.float32, cpu, state_dict,
                                 images, labels)
    bf16_loss, bf16_grads = step_grads(build, torch.bfloat16, dev,
                                       state_dict, images, labels)
    # the control: the same float32 step with TF32 convs, which the bounds
    # must reject for the check to tell reduced precision from float32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, tf32_grads = step_grads(build, torch.float32, dev, state_dict,
                                   images, labels)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check(any(bool(g.any()) for g in grads64.values()),
          "the float64 step has gradients (the output is not all cut off)")
    worst, key, total = grad_errors(grads, grads64)
    cpu_worst, cpu_key, cpu_total = grad_errors(grads32, grads64)
    grad_tol, all_tol = bounds
    controls = {}
    for name, g in (("tf32", tf32_grads), ("bf16", bf16_grads)):
        c_worst, c_key, c_total = grad_errors(g, grads64)
        rejected = c_worst > grad_tol or c_total > all_tol
        controls[name] = {"grad_rel_err": c_worst, "all_grads_rel_err":
                          c_total, "rejected": rejected}
        print(f"control, {name} card gradients against float64: worst "
              f"{c_worst:.2e} ({c_key}), all {c_total:.2e}: "
              f"{'rejected' if rejected else 'NOT rejected'} by the bounds")
    loss_err = abs(loss - loss64) / abs(loss64)
    bf16_err = abs(bf16_loss - loss) / abs(loss)
    print(f"train step, batch {len(images)}, against float64 on the CPU: "
          f"float32 card loss {loss:.6f} vs {loss64:.6f} (rel. err "
          f"{loss_err:.2e}, bound {LOSS_REL_TOL}); float32 card gradients: "
          f"worst {worst:.2e} ({key}), all {total:.2e} (bounds "
          f"{grad_tol:.2e}, {all_tol:.2e}, relative norm); float32 "
          f"CPU gradients: worst {cpu_worst:.2e} ({cpu_key}), all "
          f"{cpu_total:.2e}; bf16 card loss {bf16_loss:.6f} (rel. err to "
          f"float32 {bf16_err:.2e}, bound {BF16_LOSS_REL_TOL})")
    check(loss_err <= LOSS_REL_TOL, "float32 card loss vs float64")
    check(worst <= grad_tol and total <= all_tol,
          "float32 card gradients vs float64")
    check(controls["tf32"]["rejected"], "the gradient bounds reject TF32")
    check(bf16_err <= BF16_LOSS_REL_TOL, "bf16 loss vs float32 loss")
    return {"loss_rel_err": loss_err, "grad_rel_err": worst,
            "all_grads_rel_err": total, "grad_bounds": [grad_tol, all_tol],
            "cpu_f32_grad_rel_err": cpu_worst,
            "cpu_f32_all_grads_rel_err": cpu_total,
            "bf16_loss_rel_err": bf16_err, "controls": controls}


# -- the plain v2 head's training (section 7b) ----------------------------

V2_TRAIN_SIZE = 224  # the quality recipe's: S=7, B=5, C=20
RECIPE_CLIP = 5.0  # --grad-clip 5
RECIPE_BN_MOMENTUM = 0.9  # --bn-momentum 0.9
# the float32 card chain against the float64 CPU chain, at the size, batch
# and priors of tests/test_torch_port_v2_chain.py (64², S=2, batch 4),
# the burn-in on in the first 2 steps and the clip binding on them
V2_CHAIN_STEPS = 10
V2_CHAIN_SIZE = 64
V2_CHAIN_BATCH = 4
V2_CHAIN_CLIP = 1.5e4
V2_CHAIN_BURNIN = 8
V2_CHAIN_ANCHORS = ((0.31, 0.45), (0.62, 0.98), (1.05, 0.66), (1.21, 1.43),
                    (1.78, 1.83))
# Float32 and float64 chains of Adam steps part: where a gradient is as
# small as float32's rounding, Adam's step flips sign, and the flips move
# every later step, so that after 10 steps from these weights two float32
# chains of the CPU (other thread counts) are as far from each other as
# from float64. The card's float32 chain is held to the CPU's: within
# V2_CHAIN_RATIO times the farther of the CPU's two float32 chains (its
# default threads and 1 thread) from float64, in each measure, and
# within V2_CHAIN_FIRST_STEP on the first step, before any flip.
V2_CHAIN_RATIO = 3.0
V2_CHAIN_FIRST_STEP = 1e-3

def make_v2_trainer(yolo, dtype: torch.dtype, device, state_dict=None,
                    passthrough: bool = False, clip: float = RECIPE_CLIP):
    """The trainer of the quality recipe's anchor heads
    (``pascal_train_darknet --v2 [--passthrough] --bn-momentum 0.9
    --grad-clip 5``: Adam at 1e-3 behind the global-norm clip, BatchNorm
    momentum 0.9 in every layer) and its state on ``device``, fresh
    weights from seed 0 or ``state_dict``'s; the plain v2 head
    (``Darknet19Detector``, linear output) unless ``passthrough``."""
    from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
    from tensorflow_yolo2_torch.losses.yolo_v2 import yolo_v2_task
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
    )
    from tensorflow_yolo2_torch.train.trainer import Trainer

    if passthrough:
        model = Darknet19DetectorV2(yolo.cell_channels,
                                    bn_momentum=RECIPE_BN_MOMENTUM)
    else:
        model = Darknet19Detector(yolo.cell_channels, bn_on_output=False,
                                  bn_momentum=RECIPE_BN_MOMENTUM)
    if dtype == torch.float64:  # parameters and slots in float64
        model.double()
    trainer = Trainer(model, yolo_v2_task(yolo), OptimizerConfig(
        name="adam", schedule=LRScheduleConfig(learning_rate=1e-3),
        grad_clip_norm=clip), device=device,
        compute_dtype=torch.float32 if dtype == torch.float64 else dtype)
    return trainer, trainer.create_state(torch.Generator().manual_seed(0),
                                         state_dict)


def v2_chain_batches(yolo, n: int, seed: int = 5) -> list:
    """``n`` batches of the chain: images in [-1, 1] (float64) and
    per-slot labels of 1-4 seeded boxes an image."""
    from tensorflow_yolo2_torch.data.voc import build_label_grid_v2

    rng = np.random.RandomState(seed)
    size = yolo.image_size
    out = []
    for _ in range(n):
        images = rng.uniform(-1, 1, (V2_CHAIN_BATCH, size, size, 3))
        labels = []
        for _ in range(V2_CHAIN_BATCH):
            k = rng.randint(1, 5)
            xy = rng.uniform(0, size * 0.75, (k, 2))
            wh = rng.uniform(size * 0.1, size * 0.6, (k, 2))
            corners = np.concatenate([xy, np.minimum(xy + wh, size - 1)],
                                     1).astype(np.float32)
            labels.append(build_label_grid_v2(
                corners, rng.randint(0, yolo.num_class, k), yolo.S, yolo.B,
                yolo.anchors, yolo.num_class, float(size)))
        out.append((images, np.stack(labels).astype(np.float32)))
    return out


def v2_chain(yolo, passthrough: bool, dtype: torch.dtype, where,
             state_dict: dict, batches: list) -> dict:
    """The chain's train steps in ``dtype`` on ``where`` (the float32
    loss on every side; float64 parameters and Adam slots in float64):
    each step's 0-d metrics, the state dict after the last step (float64
    on the CPU) and the seconds it took."""
    trainer, state = make_v2_trainer(yolo, dtype, where, state_dict,
                                     passthrough, V2_CHAIN_CLIP)
    metrics = []
    t0 = time.perf_counter()
    for images, labels in batches:
        state, m = trainer.train_step(
            state, torch.as_tensor(images, dtype=dtype), labels)
        metrics.append({k: v for k, v in m.items() if v.dim() == 0})
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return {"metrics": metrics, "seconds": time.perf_counter() - t0,
            "model": {k: v.detach().double().cpu() for k, v in
                      state.model.state_dict().items()
                      if not k.endswith("num_batches_tracked")}}


def v2_chain_gaps(got: dict, want: dict) -> dict:
    """The chain's measures of ``got`` against ``want``: the largest
    relative difference of a step's metric, and the largest relative norm
    of a parameter tensor (the conv biases in front of BatchNorm, whose
    true gradient is 0, left out) and of a BatchNorm statistic."""
    sd = want["model"]
    pre_bn = {k for k in sd if k.endswith("conv.bias") and
              k[:-len("conv.bias")] + "bn.weight" in sd}
    return {
        "metrics": max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                       for g, w in zip(got["metrics"], want["metrics"])
                       for k in w),
        "params": max(rel_norm(got["model"][k], v) for k, v in sd.items()
                      if "running" not in k and k not in pre_bn),
        "stats": max(rel_norm(got["model"][k], v) for k, v in sd.items()
                     if "running" in k)}


def check_v2_chains(dev) -> dict:
    """``V2_CHAIN_STEPS`` train steps of the plain v2 head, and of the
    passthrough head as its yardstick, in float32 on the card (TF32 off)
    against float64 on the CPU, from one seeded state (He-normal kernels,
    BatchNorm terms and statistics away from the identity:
    ``models.darknet.randomize_``), beside the CPU's own float32 chains
    with its default threads and with 1. Both heads are held to the same
    bounds (``V2_CHAIN_RATIO``, ``V2_CHAIN_FIRST_STEP``); the burn-in ends
    and the clip binds inside the chain."""
    import dataclasses

    from tensorflow_yolo2_torch.config import yolo_v2_config
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
        randomize_,
    )

    yolo = dataclasses.replace(
        yolo_v2_config(V2_CHAIN_SIZE, anchors=V2_CHAIN_ANCHORS),
        v2_burnin_samples=V2_CHAIN_BURNIN)
    batches = v2_chain_batches(yolo, V2_CHAIN_STEPS)
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    out = {}
    for head in ("v2", "v2p"):
        passthrough = head == "v2p"
        model = (Darknet19DetectorV2(yolo.cell_channels) if passthrough
                 else Darknet19Detector(yolo.cell_channels,
                                        bn_on_output=False))
        weights = randomize_(model, torch.Generator().manual_seed(3))
        state_dict = weights.state_dict()
        runs = {}
        for name, dtype, where, n in (
                ("card_f32", torch.float32, dev, threads),
                ("cpu_f64", torch.float64, cpu, threads),
                ("cpu_f32", torch.float32, cpu, threads),
                ("cpu_f32_1thread", torch.float32, cpu, 1)):
            torch.set_num_threads(n)
            try:
                runs[name] = v2_chain(yolo, passthrough, dtype, where,
                                      state_dict, batches)
            finally:
                torch.set_num_threads(threads)
        want = runs.pop("cpu_f64")
        burn = [m["burnin_loss"] > 0 for m in want["metrics"]]
        clipped = [m["grad_norm"] > V2_CHAIN_CLIP for m in want["metrics"]]
        gaps = {name: {**v2_chain_gaps(r, want), "first_step": max(
            abs(r["metrics"][0][k] - w) / max(abs(w), 1e-30)
            for k, w in want["metrics"][0].items())}
            for name, r in runs.items()}
        card = gaps["card_f32"]
        cpu_worst = {k: max(gaps[n][k] for n in gaps if n != "card_f32")
                     for k in card}
        ratios = {k: card[k] / max(cpu_worst[k], 1e-30)
                  for k in ("metrics", "params", "stats")}
        out[head] = {"gaps": gaps, "ratios": ratios, "burn_in": burn,
                     "clipped": clipped, "losses": [
                         m["loss"] for m in want["metrics"]],
                     "seconds": {k: r["seconds"] for k, r in runs.items()}}
        print(f"{head} chain, {V2_CHAIN_STEPS} steps at {V2_CHAIN_SIZE}², "
              f"batch {V2_CHAIN_BATCH}, against float64 on the CPU: " +
              "; ".join(f"{name} " + ", ".join(
                  f"{k} {v:.2e}" for k, v in g.items())
                  for name, g in gaps.items()) +
              "; card / the CPU's farther float32: " +
              ", ".join(f"{k} {v:.2f}" for k, v in ratios.items()) +
              f" (bounds {V2_CHAIN_RATIO}, first step "
              f"{V2_CHAIN_FIRST_STEP}); burn-in on {burn}, clip binds "
              f"{clipped}; float64 loss " + ", ".join(
                  f"{v:.3f}" for v in out[head]["losses"]))
        check(any(burn) and not all(burn) and any(clipped)
              and not all(clipped),
              f"the {head} chain crosses the end of the burn-in and the "
              "clip binds on some of its steps and not on others")
        check(card["first_step"] <= V2_CHAIN_FIRST_STEP and all(
            r <= V2_CHAIN_RATIO for r in ratios.values()),
            f"the float32 {head} chain on the card is as close to float64 "
            "as the CPU's float32 chains")
    return out


def check_v2_plain_training(dev) -> dict:
    """Section 7b: the plain v2 training path (``--v2``, linear output) at
    the quality recipe's 224² (S=7, B=5, C=20, k-means priors of seeded
    box shapes), fresh seeded weights, bf16, Adam at 1e-3, grad clip 5,
    BatchNorm momentum 0.9: 30 steps on one seeded uint8 batch of 24
    (B5 5 times a step, the loss falls, the burn-in is on); one float32
    card step from the weights they reached against float64 on the CPU
    on 4 images (section 7's bounds); and ``check_v2_chains``."""
    from tensorflow_yolo2_torch.config import yolo_v2_config
    from tensorflow_yolo2_torch.data.anchors import iou_kmeans
    from tensorflow_yolo2_torch.ops import cuda_pool

    rng = np.random.RandomState(6)
    # the shapes train_batch draws, in cells of the 7×7 grid
    priors, _ = iou_kmeans(rng.uniform(16, 160, (200, 2)) / 32.0, 5)
    yolo = yolo_v2_config(V2_TRAIN_SIZE, anchors=priors)
    images, labels = (torch.from_numpy(a).to(dev) for a in
                      train_batch(rng, TRAIN_BATCHES[0], yolo))
    trainer, state = make_v2_trainer(yolo, torch.bfloat16, dev)
    metrics = []
    cuda_pool.reset_launch_counts()
    for _ in range(FALL_STEPS):
        state, m = trainer.train_step(state, images, labels)
        metrics.append(torch.stack([m["loss"], m["burnin_loss"],
                                    m["grad_norm"]]))
    torch.cuda.synchronize()
    pool_launches = cuda_pool.MAX_POOL2_BWD_LAUNCHES
    losses, burnin, norms = torch.stack(metrics).T.tolist()
    print(f"train path v2 {V2_TRAIN_SIZE}² (priors "
          f"{[tuple(round(float(x), 2) for x in p) for p in priors]}): "
          f"max_pool2_bwd {pool_launches} in {FALL_STEPS} steps; loss on "
          f"one batch of {TRAIN_BATCHES[0]}: " +
          ", ".join(f"{v:.3f}" for v in losses) + "; burnin_loss: " +
          ", ".join(f"{v:.4f}" for v in burnin) + "; grad_norm: " +
          ", ".join(f"{v:.1f}" for v in norms))
    check(pool_launches == 5 * FALL_STEPS, "B5 ran 5 times a v2 train step")
    check(all(math.isfinite(v) for v in losses + burnin),
          "finite v2 train losses")
    check(sum(losses[-5:]) / 5 < 0.5 * losses[0],
          "the v2 loss fell on a fixed batch (mean of the last 5 steps "
          "under half the first)")
    check(all(v > 0 for v in burnin), "the v2 burn-in term is on")
    check(state.step == FALL_STEPS and all(
        bool(torch.isfinite(p).all()) for p in state.params.values()),
        "finite v2 parameters after the steps")
    trained = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    step_check = check_train_step_against_cpu(
        functools.partial(make_v2_trainer, yolo), images[:V2P_CHECK_IMAGES],
        labels[:V2P_CHECK_IMAGES], dev, trained)
    return {"losses": losses, "burnin_losses": burnin, "grad_norms": norms,
            "max_pool2_bwd_launches": pool_launches, "checks": step_check,
            "chains": check_v2_chains(dev)}


def graph_ms(fn, reps: int = 100) -> float:
    """Device time per call of ``fn()``, replayed from a CUDA graph of
    ``reps`` calls: the host's launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` on the card's stream over ``reps`` calls,
    after a warm-up; gaps while the host launches are included."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_call(fn, label: str, top: int = 12) -> dict:
    """Device time of one call of ``fn()`` by kernel (torch.profiler):
    returns the kernels' time and the call's wall time in ms, and the
    share of that wall time in which the card ran no kernel (the
    profiler's own cost is in the wall time: a call that launches
    hundreds of kernels runs slower under it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a warm-up step first, and a pause at each end of the recorded call:
    # a profile of one call alone has lost the call's first few ms of
    # kernels, as if they lay outside the window it records
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(0.05)
        prof.step()
    busy_us, n_kernels, ops = 0.0, 0, []
    for e in events:
        us = e.self_device_time_total
        if us <= 0:
            continue
        if e.key.startswith("ProfilerStep") or e.key in INT8_PHASES:
            # the step's own range and the int8 forward's phase ranges,
            # mirrored on the card's timeline over the kernels they hold:
            # not kernels
            continue
        if e.device_type == DeviceType.CUDA:  # a kernel
            busy_us += us
            n_kernels += e.count
            if any(k in e.key for k in PORT_KERNEL_NAMES):
                # launched through ctypes, under no operator: by kernel
                ops.append((us, e.count, "kernel " + e.key))
        else:  # the operator that launched kernels: the same time, by op
            ops.append((us, e.count, e.key))
    idle = 1 - busy_us / wall_us
    print(f"profile, {label}: wall {wall_us:.0f} us, {n_kernels} kernels "
          f"{busy_us:.0f} us, device idle share {idle:.3f}; device time by "
          f"operator, and by kernel for the port's own:")
    for us, count, key in sorted(ops, reverse=True)[:top]:
        print(f"  {us:10.1f} us {count:4d}x  {key[:80]}")
    return {"idle_share": idle, "kernels_ms": busy_us / 1e3,
            "wall_ms": wall_us / 1e3}


def decode_bound(cfg, batch: int, kept_per_image=None) -> tuple[float, str]:
    """Least time for the decode (+NMS) on this card: bytes (grid read
    once, outputs written once) over HBM rate against float32 operations
    over the non-tensor-core rate, an exp counting as one operation; the
    NMS counts the steps this run's data took (one per kept box)."""
    S, B, C = cfg.S, cfg.B, cfg.num_class
    cells, n = S * S, S * S * B
    in_bytes = batch * cells * cfg.cell_channels * 4
    if cfg.per_slot_classes:
        # per slot: argmax C-1; Σ exp(l - l_max) 3C; 3 sigmoids 9; clip 4;
        # w, h (2 exp, 2 mul, 2 div) 6; x, y 4; corners + area 7; score and
        # threshold 2
        ops = batch * n * (4 * C + 31)
    else:
        ops = batch * (cells * (C - 1) + n * 14)  # argmax, decode, threshold
    if kept_per_image is None:
        out_bytes = batch * n * 6 * 4
    else:
        out_bytes = batch * K * 6 * 4
        ops += int(kept_per_image.sum()) * n * 18  # IoU, kill, step max
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_path(detect, images, dev, label: str, flops: float,
              flops_per_s: float = BF16_FLOPS_PER_S) -> dict:
    """images/s of ``detect`` on uint8 batches already on the card, host
    clock around calls that end in a synchronize; the bound is the convs'
    ``flops`` an image at ``flops_per_s``."""
    out = {}
    for b in PATH_BATCHES:
        xb = images[:b].to(dev)
        detect(xb)
        torch.cuda.synchronize()
        reps = 20 if b <= 32 else 8
        t0 = time.perf_counter()
        for _ in range(reps):
            detect(xb)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        out[b] = {"images_per_s": b / dt, "ms_per_batch": dt * 1e3,
                  "bound_images_per_s": flops_per_s / flops}
        print(f"path {label}, NMS on, uint8 batch {b} on the card: "
              f"{b / dt:.1f} images/s ({dt * 1e3:.3f} ms per batch; "
              f"conv bound {flops_per_s / flops:.0f} images/s at "
              f"{flops / 1e9:.2f} GFLOP per image, "
              f"{flops_per_s / 1e12:.0f} TFLOP/s)")
    for b in PATH_BATCHES:
        xb = images[:b].to(dev)
        out[b]["idle_share"] = profile_call(
            lambda: detect(xb), f"{label} path batch {b}")["idle_share"]
    return out


def time_train(trainer, state, make_batch, flops: float, label: str,
               batches=TRAIN_BATCHES, pools: int = 5) -> dict:
    """Steps/s and images/s of ``Trainer.train_step`` at each of
    ``batches`` on seeded batches (``make_batch(b)``: numpy images and
    labels) already on the card (as the train loop's device prefetch
    hands them over), host clock around steps that end in a synchronize;
    B5's launches checked at ``pools`` a step (the Darknet trunk's 5, 0
    for ResNet's); then one profiled step a batch. ``flops`` are the
    FLOPs of a step an image, forward and backward, for the bound."""
    from tensorflow_yolo2_torch.ops import cuda_pool

    dev = trainer.device
    out, on_card = {}, {}
    for b in batches:
        images, labels = (torch.from_numpy(a).to(dev) for a in make_batch(b))
        on_card[b] = (images, labels)
        for _ in range(3):
            trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_pool.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, metrics = trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TIMED_STEPS
        n = cuda_pool.MAX_POOL2_BWD_LAUNCHES
        check(n == pools * TIMED_STEPS, f"B5 ran {pools} times a step at "
                                        f"batch {b} ({n} in {TIMED_STEPS} "
                                        f"steps)")
        check(math.isfinite(metrics["loss"].item()), f"finite loss at {b}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[b] = {"steps_per_s": 1 / dt, "images_per_s": b / dt,
                  "ms_per_step": dt * 1e3, "peak_gib": peak,
                  "max_pool2_bwd_launches": n,
                  "bound_images_per_s": BF16_FLOPS_PER_S / flops}
        print(f"train step {label}, bf16, batch {b}: "
              f"{1 / dt:.2f} steps/s, {b / dt:.1f} images/s ({dt * 1e3:.2f} "
              f"ms a step; matmul bound {BF16_FLOPS_PER_S / flops:.0f} "
              f"images/s at {flops / 1e9:.2f} GFLOP an image a step); peak "
              f"memory {peak:.2f} GiB")
    for b, (images, labels) in on_card.items():
        prof = profile_call(lambda: trainer.train_step(state, images, labels),
                            f"train step {label} batch {b}", top=16)
        # the step's kernels against its unprofiled host-clock time
        idle = 1 - prof["kernels_ms"] / out[b]["ms_per_step"]
        out[b].update(idle_share=prof["idle_share"],
                      kernels_ms=prof["kernels_ms"],
                      idle_share_unprofiled=idle)
        print(f"train step {label} batch {b}: {prof['kernels_ms']:.2f} ms of "
              f"kernels in a {out[b]['ms_per_step']:.2f} ms step: idle share "
              f"{idle:.3f} unprofiled ({prof['idle_share']:.3f} in the "
              f"profiled {prof['wall_ms']:.2f} ms step)")
    return out


def detector_train_times(trainer, state, rng, yolo) -> dict:
    """``time_train`` of a detector trainer on ``train_batch`` batches."""
    return time_train(
        trainer, state, lambda b: train_batch(rng, b, yolo),
        3 * conv_flops_per_image(yolo.image_size, yolo.cell_channels,
                                 passthrough=yolo.per_slot_classes),
        f"{'v2p' if yolo.per_slot_classes else 'v1'} {yolo.image_size}²")


class MemoryImdb:
    """A seeded in-memory image set with the interface ``run_eval`` reads
    (``get``, ``gt_labels``, ``batch_size``, ``num_class``, ``classes``):
    uint8 images and their label grids, handed out in order, batch after
    batch, from the start again after the last."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int):
        from tensorflow_yolo2_torch.config import VOC_CLASSES

        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.gt_labels = list(range(len(images)))
        self.classes = VOC_CLASSES
        self.num_class = len(VOC_CLASSES)
        self.cursor = 0

    def get(self) -> tuple[np.ndarray, np.ndarray]:
        s = slice(self.cursor, self.cursor + self.batch_size)
        self.cursor = (self.cursor + self.batch_size) % len(self.images)
        return self.images[s], self.labels[s]


def check_eval(head: str, yolo, state: dict, images: np.ndarray,
               labels: np.ndarray, dev, calib: np.ndarray | None = None
               ) -> dict:
    """``pascal_eval_map.run_eval`` on the card over a seeded in-memory
    set at the eval CLI's settings (threshold EVAL_THRESH, NMS IoU 0.5,
    K=32, batch EVAL_BATCH), through ``make_detect_fn`` (the bf16 BN-folded
    detector, or with ``calib`` the int8 chain calibrated on it, then B1
    or B2): the decode kernel launched once a batch;
    the APs and the mAP, all-points and VOC07, equal to those of the plain
    decode on the same grids; the kernel equal to its plain version on
    every grid; then the eval loop's images/s (host included) and the
    kernel alone at batch EVAL_BATCH (graph replays) beside its bound."""
    from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pdd
    from tensorflow_yolo2_torch.entries.pascal_eval_map import run_eval
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.ops.boxes import decode_grid_v2

    v2 = yolo.per_slot_classes
    name = "decode_nms_v2" if v2 else "decode_nms"
    plain = cd.decode_nms_v2_plain if v2 else cd.decode_nms_plain
    dense = decode_grid_v2 if v2 else cd.decode_grid_plain
    detect = pdd.make_detect_fn(yolo, state, object_thresh=EVAL_THRESH,
                                use_nms=True, nms_iou=0.5, v2=v2,
                                passthrough=v2, int8=calib is not None,
                                calib_images=calib)
    imdb = MemoryImdb(images, labels, EVAL_BATCH)
    grids = []

    def recording(grid, *args, **kw):  # the path's own decode call
        grids.append(grid.clone())
        return cd.decode_nms_fused(grid, *args, **kw)

    cd.reset_launch_counts()
    with mock.patch.object(pdd, "decode_nms_fused", recording):
        got = {m: run_eval(detect, imdb, yolo, use_07_metric=m)
               for m in (False, True)}
    torch.cuda.synchronize()
    n_batches = len(images) // EVAL_BATCH
    counts = {"decode_nms": cd.DECODE_NMS_LAUNCHES,
              "decode_nms_v2": cd.DECODE_NMS_V2_LAUNCHES,
              "decode_grid": cd.DECODE_GRID_LAUNCHES}
    print(f"eval {head} {yolo.image_size}²: launches over two passes of "
          f"{len(images)} images at batch {EVAL_BATCH}: {counts}")
    check(counts[name] == 2 * n_batches and sum(counts.values()) ==
          2 * n_batches, f"eval {head}: {name} once a batch, no other")

    def replay():  # the plain decode of the same grids, batch by batch
        it = iter(grids)
        return lambda _: plain(next(it), yolo, EVAL_THRESH, 0.5, K)

    want = {m: run_eval(replay(), MemoryImdb(images, labels, EVAL_BATCH),
                        yolo, use_07_metric=m) for m in (False, True)}
    for m in (False, True):
        check(got[m] == want[m], f"eval {head}: the kernel path's APs equal "
                                 f"the plain decode's (VOC07 {m})")
    err, kept, valid = 0.0, [], []
    for grid in grids[:n_batches]:
        ref = plain(grid, yolo, EVAL_THRESH, 0.5, K)
        err = max(err, compare_kept(
            cd.decode_nms_fused(grid, yolo, EVAL_THRESH, 0.5, K), ref, name))
        kept.append((ref.scores > 0).sum(1))
        valid.append((dense(grid, yolo, EVAL_THRESH).scores > 0).sum(1))
    kept, valid = torch.cat(kept), torch.cat(valid).float()
    print(f"eval {head}: mAP {got[False][0]:.6f} all-points, "
          f"{got[True][0]:.6f} VOC07 ({len(got[False][1])} classes with "
          f"objects), equal to the plain decode's; {valid.mean():.1f} "
          f"candidates (at most {valid.max():.0f}) and "
          f"{kept.float().mean():.1f} kept slots an image at threshold "
          f"{EVAL_THRESH}; {name} against its plain version on the "
          f"{n_batches} grids: max abs err {err}")

    run_eval(detect, MemoryImdb(images, labels, EVAL_BATCH), yolo)  # warm
    t0 = time.perf_counter()
    run_eval(detect, MemoryImdb(images, labels, EVAL_BATCH), yolo)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    grid = grids[0]
    ms = graph_ms(lambda: cd.decode_nms_fused(grid, yolo, EVAL_THRESH, 0.5,
                                              K))
    plain_ms = cuda_ms(lambda: plain(grid, yolo, EVAL_THRESH, 0.5, K), 5)
    bound, by = decode_bound(yolo, EVAL_BATCH, kept[:EVAL_BATCH])
    print(f"eval {head}: {len(images) / dt:.1f} images/s over the eval loop "
          f"(uint8 host batches, detect, host evaluator); {name} at "
          f"threshold {EVAL_THRESH}, batch {EVAL_BATCH}: kernel "
          f"{ms * 1e3:.2f} us (graph replay), plain {plain_ms * 1e3:.1f} us, "
          f"bound {bound * 1e3:.2f} us ({by})")
    return {"kernel": name, "launches": counts[name] // 2,
            "n_images": len(images), "batch": EVAL_BATCH,
            "threshold": EVAL_THRESH, "map": got[False][0],
            "map_voc07": got[True][0], "images_per_s": len(images) / dt,
            "candidates_per_image": valid.mean().item(),
            "max_candidates_per_image": valid.max().item(),
            "kept_per_image": kept.float().mean().item(),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}


def scalar_resize(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Numpy copy of OpenCV INTER_LINEAR's 8U scalar fixed-point resize
    (11-bit coefficients, int rows, (b·(row>>4))>>16 +2 >>2 rounding),
    which the native resize reproduces."""

    def coefs(slen, dlen):
        fx = ((np.arange(dlen) + 0.5) * (slen / dlen) - 0.5).astype(
            np.float32)
        sx = np.floor(fx).astype(int)
        f = fx - sx
        f[sx < 0] = 0
        sx[sx < 0] = 0
        f[sx >= slen - 1] = 1
        sx[sx >= slen - 1] = max(slen - 2, 0)
        return sx, np.rint((1 - f) * 2048).astype(np.int64), \
            np.rint(f * 2048).astype(np.int64)

    sh, sw = src.shape[:2]
    sx, ax0, ax1 = coefs(sw, dw)
    sy, ay0, ay1 = coefs(sh, dh)
    s = src.astype(np.int64)
    rows = (s[:, sx, :] * ax0[None, :, None]
            + s[:, np.minimum(sx + 1, sw - 1), :] * ax1[None, :, None])
    r0, r1 = rows[sy], rows[np.minimum(sy + 1, sh - 1)]
    out = ((((ay0[:, None, None] * (r0 >> 4)) >> 16)
            + ((ay1[:, None, None] * (r1 >> 4)) >> 16) + 2) >> 2)
    return np.clip(out, 0, 255).astype(np.uint8)


def numpy_nms(boxes, scores, classes, iou_thresh: float,
              class_aware: bool, score_thresh: float) -> list[int]:
    """Greedy NMS in numpy: indices by descending score (ties to the lower
    index), each killing the later ones of its class above the IoU."""
    order = sorted(range(len(scores)), key=lambda i: -scores[i])
    alive, keep = [True] * len(order), []
    for oi, i in enumerate(order):
        if not alive[oi] or scores[i] <= score_thresh:
            continue
        keep.append(i)
        for oj in range(oi + 1, len(order)):
            j = order[oj]
            if not alive[oj] or (class_aware and classes[i] != classes[j]):
                continue
            a, b = boxes[i], boxes[j]
            inter = (max(min(a[2], b[2]) - max(a[0], b[0]), 0) *
                     max(min(a[3], b[3]) - max(a[1], b[1]), 0))
            union = (max((a[2] - a[0]) * (a[3] - a[1]), 0) +
                     max((b[2] - b[0]) * (b[3] - b[1]), 0) - inter)
            if union > 0 and inter / union > iou_thresh:
                alive[oj] = False
    return keep


def probe_drawing() -> bool:
    """Whether the detect CLI can draw here: its drawing
    (``utils.visualize``) needs matplotlib and PIL. Prints what it
    found."""
    import importlib

    found = {}
    for name in ("matplotlib", "PIL"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = None
    print("drawing (utils.visualize): " + ", ".join(
        f"{k} {v or 'not installed'}" for k, v in found.items()))
    return all(found.values())


def check_native() -> tuple[np.ndarray, dict]:
    """The native host layer (``utils.native``), built with g++ here: the
    resize (uint8 and normalized, channel swap and flip) at NATIVE_SHAPES
    bit-equal to ``scalar_resize``, the normalize at all 256 levels,
    ``label_grid`` against the numpy grid and ``nms`` against
    ``numpy_nms``; then DEMO read at 448² through ``image_read_u8`` (cv2's
    decode where cv2 is installed, else libjpeg's, then the native
    resize), timed. Without either decoder, a seeded image resized by
    ``resize_u8`` stands in for DEMO. Returns the 448² uint8 image and
    what was found."""
    from tensorflow_yolo2_torch.data import augment, voc
    from tensorflow_yolo2_torch.utils import native

    t0 = time.perf_counter()
    native.require()
    jpeg = native.jpeg_available()
    print(f"native host layer: built and loaded in "
          f"{time.perf_counter() - t0:.1f} s; libjpeg decode: "
          f"{'yes' if jpeg else 'no'}")
    if not jpeg:
        why = [ln for ln in native.build_log().splitlines() if "rror" in ln]
        print("native host layer: no libjpeg on this machine (a host-side "
              "limit, not a fallback of the device path): "
              + (why[0][:200] if why else "the libjpeg build failed"))
    rng = np.random.RandomState(6)
    for (h, w), size in NATIVE_SHAPES:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = scalar_resize(img, size, size)
        for rgb, flip in itertools.product((False, True), repeat=2):
            w_ = want[:, :, ::-1] if rgb else want
            w_ = w_[:, ::-1] if flip else w_
            what = f"native resize {(h, w)} → {size}², swap {rgb}, flip {flip}"
            check(np.array_equal(native.resize_u8(img, size, size, rgb, flip),
                                 w_), what + " (uint8)")
            check(np.array_equal(
                native.resize_normalize(img, size, size, rgb, flip),
                augment.normalize(w_)), what + " (normalized)")
    levels = np.arange(256, dtype=np.uint8)
    check(np.array_equal(native.normalize(levels), augment.normalize(levels)),
          "native normalize at all 256 levels")
    for _ in range(20):
        n = rng.randint(1, 12)
        xy = rng.uniform(0, 446, (n, 2))
        corners = np.concatenate([xy, np.minimum(
            xy + rng.uniform(1, 200, (n, 2)), 447)], 1).astype(np.float32)
        cls = rng.randint(0, 20, n).astype(np.int32)
        check(np.array_equal(native.label_grid(corners, cls, 14, 20, 448.0),
                             voc.label_grid_numpy(corners, cls, 14, 20,
                                                  448.0)),
              "native label_grid equals the numpy grid")
    for class_aware, _ in itertools.product((True, False), range(5)):
        xy = rng.uniform(0, 1, (40, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (40, 2))],
                               1).astype(np.float32)
        scores = rng.uniform(0, 1, 40).astype(np.float32)
        classes = rng.randint(0, 3, 40).astype(np.int32)
        check(list(native.nms(boxes, scores, classes, 0.45, class_aware,
                              0.1)) ==
              numpy_nms(boxes, scores, classes, 0.45, class_aware, 0.1),
              "native nms equals the numpy greedy NMS")
    print(f"native host layer: resize_u8 and resize_normalize at "
          f"{len(NATIVE_SHAPES)} shapes × swap × flip bit-equal to cv2's "
          f"scalar arithmetic (numpy), normalize, label_grid and nms equal "
          f"to numpy")
    try:
        import cv2  # noqa: F401
        decode = "cv2"
    except ImportError:
        decode = "libjpeg" if jpeg else None
    info = {"libjpeg": jpeg, "decode": decode, "draws": probe_drawing()}
    if decode is None:
        print("native host layer: neither cv2 nor libjpeg here: a seeded "
              "uint8 image resized by the native resize_u8 stands in for "
              f"{DEMO}")
        return native.resize_u8(rng.randint(0, 256, (240, 320, 3)).astype(
            np.uint8), 448, 448), info
    image = augment.image_read_u8(DEMO, 448)
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        augment.image_read_u8(DEMO, 448)
    info["read_ms"] = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        native.resize_u8(np.ascontiguousarray(image[:240, :320]), 448, 448)
    info["resize_ms"] = (time.perf_counter() - t0) / reps * 1e3
    print(f"native read of {DEMO} (320×240) at 448²: {decode} decode + "
          f"native resize, {info['read_ms']:.3f} ms an image ({reps} reads; "
          f"the resize alone {info['resize_ms']:.3f} ms); shape "
          f"{image.shape}, {image.dtype}")
    return image, info


def int8_phase_profile(fn, label: str) -> dict:
    """One profiled call of an int8 serving ``fn``: the device time inside
    each of the forward's phase ranges (INT8_PHASES), the kernels and
    operators seen, and the busy and wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    phases = dict.fromkeys(INT8_PHASES, 0.0)
    names, busy_us = set(), 0.0
    for e in prof.key_averages():
        names.add(e.key)
        if e.key in INT8_PHASES and e.device_type != DeviceType.CUDA:
            phases[e.key] += e.device_time_total
        elif e.device_type == DeviceType.CUDA and e.key not in INT8_PHASES:
            busy_us += e.self_device_time_total
    out = {"wall_ms": wall_us / 1e3, "kernels_ms": busy_us / 1e3,
           "phases_ms": {k: v / 1e3 for k, v in phases.items()},
           "float_conv_names": sorted(
               n for n in names if any(m in n.lower()
                                       for m in FLOAT_CONV_MARKS))}
    rest = busy_us - sum(phases.values())
    print(f"int8 profile, {label}: wall {wall_us / 1e3:.3f} ms, kernels "
          f"{busy_us / 1e3:.3f} ms: " + ", ".join(
              f"{k[5:]} {v / 1e3:.3f} ms ({v / max(busy_us, 1e-9):.0%})"
              for k, v in phases.items()) +
          f", other {rest / 1e3:.3f} ms (normalize, reorg, decode)")
    return out


def check_int8_sums(what: str, on_card, on_cpu, x: torch.Tensor, forward,
                    output: str) -> tuple[float, int]:
    """``forward(layers, x)`` of an int8 chain on the card and on the CPU,
    recording each conv's int8 input and int32 sums: every conv runs once,
    in order, and its sums on the card equal the CPU's exact float64 conv
    of the card's int8 input (fed to the CPU where the two inputs
    differ). Returns the outputs' relative norm error (checked against
    INT8_GRID_REL_TOL) and how many inputs were fed."""
    from tensorflow_yolo2_torch.ops import quant

    seen = {"card": [], "cpu": []}
    conv = quant.conv_int8

    def recording(where, chain):
        index = {id(layer): i for i, layer in enumerate(chain)}

        def run(x, layer):
            acc = conv(x, layer)
            seen[where].append((index[id(layer)], x, acc))
            return acc
        return run

    dev = on_card[0]["kernel"].device
    with mock.patch.object(quant, "conv_int8", recording("card", on_card)):
        out = forward(on_card, x.to(dev))
    with mock.patch.object(quant, "conv_int8", recording("cpu", on_cpu)):
        cpu_out = forward(on_cpu, x)
    check([i for i, _, _ in seen["card"]] == list(range(len(on_card))),
          f"{what}: every conv ran once, in order")
    fed = 0
    for (i, x_card, acc_card), (_, x_cpu, acc_cpu) in zip(seen["card"],
                                                           seen["cpu"]):
        if not torch.equal(x_card.cpu(), x_cpu):  # feed the card's input
            fed += 1
            acc_cpu = quant.conv_int8(x_card.cpu(), on_cpu[i])
        check(torch.equal(acc_card.cpu(), acc_cpu),
              f"{what}: conv {i}'s int32 sums on the card equal the CPU's "
              f"from the same int8 input")
    rel = ((out.cpu().double() - cpu_out.double()).norm() /
           cpu_out.double().norm()).item()
    print(f"{what}: {len(on_card)} convs, int32 sums on the card equal the "
          f"CPU's float64 conv of the same int8 input at every layer ({fed} "
          f"inputs differed and were fed from the card); {output} vs the "
          f"CPU's int8 forward: relative norm {rel:.3e} (bound "
          f"{INT8_GRID_REL_TOL})")
    check(rel <= INT8_GRID_REL_TOL,
          f"{what}: the card's {output} agrees with the CPU's")
    return rel, fed


def check_int8(head: str, yolo, state: dict, images: torch.Tensor,
               dev) -> dict:
    """Int8 serving of one head at full width: calibration on the card
    (TF32 off) and on the CPU, held to each other; the chain quantized
    once, from the card's scales; the card's int8 forward held to the
    CPU's conv by conv (each conv's int32 sums from the card's int8 input
    equal to the CPU's exact float64 conv of it) and as a grid; the detect
    path (``make_detect_fn_int8``) with and without NMS launching its
    decode kernel once a call (B1 and B3 for v1, B2 for the anchor
    heads); the artifact saved and loaded back serving the same
    detections; the decode kernels on the int8 grid against their plain
    versions; no float conv in the profiled forward. Returns the detect
    functions, the layers and what was measured."""
    import tempfile

    from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pdd
    from tensorflow_yolo2_torch.models.fold import fold_params
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.ops import quant
    from tensorflow_yolo2_torch.utils import cuda_build
    from tensorflow_yolo2_torch.utils.device import device_normalize

    v2, passthrough = yolo.per_slot_classes, head == "v2p"
    plan_head = "detector_v2p" if passthrough else "detector"
    kw = {"v2": v2, "head": plan_head}
    folded = fold_params(state)
    calib = images[:INT8_CALIB_IMAGES]
    t0 = time.perf_counter()
    card_scales = quant.calibrate({k: v.to(dev) for k, v in folded.items()},
                                  device_normalize(calib.to(dev)), **kw)
    calib_s = time.perf_counter() - t0
    cpu_scales = quant.calibrate(folded, device_normalize(calib), **kw)
    calib_rel = ((card_scales - cpu_scales).abs() / cpu_scales).max().item()
    print(f"int8 {head}: calibration on {INT8_CALIB_IMAGES} images, card "
          f"(TF32 off, {calib_s:.2f} s) vs CPU: {len(card_scales)} scales "
          f"within {calib_rel:.3e} relative (bound {INT8_CALIB_REL_TOL})")
    check(calib_rel <= INT8_CALIB_REL_TOL,
          f"int8 {head}: card and CPU calibration agree")
    layers = quant.quantize_folded(folded, card_scales, **kw)
    on_card, on_cpu = quant.prepare(layers, dev), quant.prepare(layers, "cpu")
    grid_rel, fed = check_int8_sums(
        f"int8 {head}", on_card, on_cpu, images[:INT8_CPU_IMAGES],
        functools.partial(quant.forward_int8, **kw), "grid")

    detect = pdd.make_detect_fn_int8(yolo, layers, 0.5, use_nms=True, v2=v2,
                                     passthrough=passthrough, device=dev)
    dense_fn = pdd.make_detect_fn_int8(yolo, layers, 0.5, use_nms=False,
                                       v2=v2, passthrough=passthrough,
                                       device=dev)
    batch = images[:16]
    cd.reset_launch_counts()
    kept = detect(batch)
    dense = dense_fn(batch)
    torch.cuda.synchronize()
    counts = {"decode_nms": cd.DECODE_NMS_LAUNCHES,
              "decode_nms_v2": cd.DECODE_NMS_V2_LAUNCHES,
              "decode_grid": cd.DECODE_GRID_LAUNCHES}
    want = ({"decode_nms_v2": 1, "decode_nms": 0, "decode_grid": 0} if v2
            else {"decode_nms_v2": 0, "decode_nms": 1, "decode_grid": 1})
    print(f"int8 {head} path launches, one call with NMS and one without: "
          f"{counts}")
    check(counts == want, f"int8 {head}: each decode kernel of the head "
                          f"once a call, no other")
    n = yolo.S * yolo.S * yolo.B
    check(kept.boxes.shape == (16, K, 4) and dense.boxes.shape == (16, n, 4),
          f"int8 {head} output shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (*kept[:2], *dense[:2])),
          f"int8 {head} finite outputs")
    check(bool((kept.scores > 0).any()), f"the int8 {head} path kept "
                                         f"detections")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as d:
        path = os.path.join(d, f"{head}_int8.npz")
        quant.save_quantized(path, layers, {"v2": v2, "passthrough":
                                            passthrough,
                                            "image_size": yolo.image_size})
        loaded, meta = quant.load_quantized(path)
        again = pdd.make_detect_fn_int8(yolo, loaded, 0.5, use_nms=True,
                                        v2=v2, passthrough=passthrough,
                                        device=dev)(batch)
    check(all(torch.equal(a, b) for a, b in zip(kept, again)),
          f"int8 {head}: the saved and loaded artifact serves the same "
          f"detections")
    print(f"int8 {head}: artifact ({meta}) saved, loaded, same detections")

    errs = {}
    grid = quant.forward_int8(on_card, images[:BATCH].to(dev), **kw)
    name = "decode_nms_v2" if v2 else "decode_nms"
    plain = cd.decode_nms_v2_plain if v2 else cd.decode_nms_plain
    errs[name] = 0.0
    for thresh in (0.05, 0.5):
        for class_aware in (True, False):
            errs[name] = max(errs[name], compare_kept(
                cd.decode_nms_fused(grid, yolo, thresh, 0.5, K, class_aware),
                plain(grid, yolo, thresh, 0.5, K, class_aware), name))
        if not v2:
            errs["decode_grid"] = max(errs.get("decode_grid", 0.0),
                                      compare_dense(
                cd.decode_grid_fused(grid, yolo, thresh),
                cd.decode_grid_plain(grid, yolo, thresh)))
    del grid
    torch.cuda.synchronize()
    print(f"int8 {head} grid at batch {BATCH}: the decode kernels match "
          f"their plain versions (max abs err {errs})")
    prof = int8_phase_profile(lambda: detect(images[:32].to(dev)),
                              f"{head} batch 32")
    check(not prof["float_conv_names"],
          f"int8 {head}: no float conv in the profiled forward "
          f"({prof['float_conv_names']})")
    return {"detect": detect, "layers": layers, "launches": counts,
            "errs": errs, "calib_rel_err": calib_rel,
            "grid_rel_err": grid_rel, "fed_inputs": fed}


def serve_demo_cli(image: np.ndarray, layers, yolo, native_info: dict,
                   dev) -> dict:
    """The detect CLI (``pascal_detect_darknet.main``) on DEMO with
    ``--int8-weights`` (the v1 448² chain, saved as an artifact) and
    ``--host-nms`` at the threshold that leaves DEMO_CANDIDATES slots
    (the seeded v1 weights put ~180 of 392 above the CLI's 0.5, and more
    than the CLI's cap of 128 survive NMS there): B3 once, then the
    native NMS on the host; its kept boxes equal ``numpy_nms`` of the
    dense detections of the same image, and fewer than the candidates. Without a decoder for DEMO the same path runs on
    ``image`` through ``make_detect_fn_int8`` and ``native.nms``."""
    import tempfile

    from tensorflow_yolo2_torch.entries import pascal_detect_darknet as pdd
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.ops import quant
    from tensorflow_yolo2_torch.utils import cuda_build, native

    scores = pdd.make_detect_fn_int8(yolo, layers, 0.0, device=dev)(
        image[None]).scores[0].cpu().numpy()
    thresh = float(np.sort(scores)[-DEMO_CANDIDATES - 1])
    dense = [t[0].cpu().numpy() for t in pdd.make_detect_fn_int8(
        yolo, layers, thresh, device=dev)(image[None])]
    want = numpy_nms(*dense, 0.5, True, 0.0)[:128]  # the CLI keeps 128
    cd.reset_launch_counts()
    if native_info["decode"] is None:
        keep = native.nms(*dense, iou_thresh=0.5, class_aware=True,
                          score_thresh=0.0)
        got = [a[keep] for a in dense]
        route = "make_detect_fn_int8 + native.nms on a seeded image"
    else:
        drawn = []
        with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as d:
            art = os.path.join(d, "v1_int8.npz")
            quant.save_quantized(art, layers, {
                "v2": False, "passthrough": False,
                "image_size": yolo.image_size})
            draw = pdd.draw_detections

            def recording(path, boxes, scores, classes, class_names,
                          out_path):
                drawn.append((boxes, scores, classes))
                return draw(path, boxes, scores, classes, class_names,
                            out_path) if native_info["draws"] else out_path

            out = io.StringIO()  # the CLI prints every box it draws
            with mock.patch.object(pdd, "draw_detections", recording), \
                    contextlib.redirect_stdout(out):
                check(pdd.main([DEMO, "--int8-weights", art, "--image-size",
                                str(yolo.image_size), "--threshold",
                                str(thresh),
                                "--host-nms", "--device", str(dev), "--out",
                                os.path.join(d, "demo.png")]) == 0,
                      "the detect CLI exits 0")
        got = drawn[0]
        route = (f"pascal_detect_darknet.main --int8-weights --host-nms "
                 f"({native_info['decode']} read)")
    torch.cuda.synchronize()
    launches = {"decode_grid": cd.DECODE_GRID_LAUNCHES,
                "decode_nms": cd.DECODE_NMS_LAUNCHES}
    check(launches == {"decode_grid": 1, "decode_nms": 0},
          f"--host-nms: B3 once, no decode+NMS kernel ({launches})")
    n_cand = int((dense[1] > 0).sum())
    check(1 < len(want) < min(128, n_cand), f"--host-nms: the NMS kept "
          f"boxes and suppressed some ({len(want)} of {n_cand} kept)")
    check(all(np.array_equal(g, d[want]) for g, d in zip(got, dense)),
          "--host-nms keeps what numpy's greedy NMS keeps")
    print(f"int8 v1 {yolo.image_size}², {route}: {len(dense[1])} slots, "
          f"{n_cand} above {thresh:.6f}, {len(want)} kept by "
          f"the native NMS, equal to numpy's greedy NMS; B3 launches "
          f"{launches['decode_grid']}")
    return {"route": route, "kept": len(want), "launches": launches}


def cls_batch(rng: np.random.RandomState, batch: int,
              num_classes: int = CLS_CLASSES, size: int = CLS_SIZE):
    """Seeded uint8 images (batch, size, size, 3) and int32 labels."""
    return (rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
            rng.randint(0, num_classes, batch).astype(np.int32))


def make_cls_trainer(dtype: torch.dtype, device, state_dict=None):
    """The classifier's trainer as ``imagenet_train_darknet`` builds it
    (``Darknet19Classifier`` with 1000 classes, ``softmax_task``,
    momentum 0.9 at 1e-3) and its state on ``device``: fresh weights
    from seed 0 (flax's initializers) or ``state_dict``'s."""
    from tensorflow_yolo2_torch.entries.imagenet_train_darknet import (
        momentum_config,
    )
    from tensorflow_yolo2_torch.models.darknet import Darknet19Classifier
    from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task

    trainer = Trainer(Darknet19Classifier(CLS_CLASSES), softmax_task(),
                      momentum_config(1e-3), device=device,
                      compute_dtype=dtype)
    return trainer, trainer.create_state(torch.Generator().manual_seed(0),
                                         state_dict)


def check_cls_pool_sites(dev) -> float:
    """B5 at the classifier's five pool sites at batch 48 (224², 112²,
    56², 28², 14² with 32 to 512 channels), bf16 and float32: bit for
    bit its plain version and torch's autograd of ``F.max_pool2d``."""
    gen = torch.Generator(device=dev).manual_seed(7)
    err = 0.0
    for shape in pool_sites(CLS_BATCHES[0], CLS_SIZE):
        n, c, h, w = shape
        for dtype in (torch.bfloat16, torch.float32):
            x, dout = (torch.randn(t, generator=gen, device=dev).to(dtype)
                       .contiguous(memory_format=torch.channels_last)
                       for t in (shape, (n, c, h // 2, w // 2)))
            err = max(err, check_pool(x, dout, f"classifier {dtype} {shape}"))
    torch.cuda.synchronize()
    return err


def check_classifier_training(dev) -> dict:
    """The classifier's training path at full width (1000 classes, 224²,
    bf16, momentum 0.9 at 1e-3, fresh seeded weights): B5 at the five
    pool sites of a batch-48 step against its plain version; 30 steps of
    ``Trainer.train_step`` on one seeded uint8 batch of 48 (B5 5 times a
    step, the loss falling); from the weights they reached, a float32
    step on the card against float64 on the CPU (the detector steps'
    bounds) on CLS_CHECK_IMAGES of the batch; then images/s at batch 48
    and 64 with the device's idle share and a profile."""
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.utils.profiling import (
        classifier_flops_per_image,
    )

    pool_err = check_cls_pool_sites(dev)
    print(f"max_pool2_bwd at the classifier's pool sites, batch "
          f"{CLS_BATCHES[0]}, {CLS_SIZE}², bf16 and float32: bit-equal to "
          f"its plain version and to autograd (max abs err {pool_err})")
    rng = np.random.RandomState(8)
    images, labels = (torch.from_numpy(a).to(dev)
                      for a in cls_batch(rng, CLS_BATCHES[0]))
    trainer, state = make_cls_trainer(torch.bfloat16, dev)
    metrics_seen = []
    cuda_pool.reset_launch_counts()
    for _ in range(FALL_STEPS):
        state, metrics = trainer.train_step(state, images, labels)
        metrics_seen.append(torch.stack([metrics["loss"],
                                         metrics["accuracy"]]))
    torch.cuda.synchronize()
    launches = cuda_pool.MAX_POOL2_BWD_LAUNCHES
    losses, accuracy = torch.stack(metrics_seen).T.tolist()
    print(f"train path classifier {CLS_SIZE}², {CLS_CLASSES} classes, "
          f"launches: max_pool2_bwd {launches} in {FALL_STEPS} steps; loss "
          f"on one batch of {CLS_BATCHES[0]}: " +
          ", ".join(f"{v:.4f}" for v in losses) + "; accuracy: " +
          ", ".join(f"{v:.3f}" for v in accuracy))
    check(launches == 5 * FALL_STEPS, "B5 ran 5 times a classifier step")
    check(all(math.isfinite(v) for v in losses), "finite classifier losses")
    check(sum(losses[-5:]) / 5 < losses[0],
          "the classifier's loss fell on a fixed batch (mean of the last 5 "
          "steps under the first)")
    check(state.step == FALL_STEPS and all(
        bool(torch.isfinite(p).all()) for p in state.params.values()),
        "finite classifier parameters after the steps")
    trained = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    step_check = check_train_step_against_cpu(
        make_cls_trainer, images[:CLS_CHECK_IMAGES],
        labels[:CLS_CHECK_IMAGES], dev, trained)
    del images, labels
    times = time_train(trainer, state, lambda b: cls_batch(rng, b),
                       3 * classifier_flops_per_image(CLS_SIZE, CLS_CLASSES),
                       f"classifier {CLS_SIZE}²", CLS_BATCHES)
    return {"losses": losses, "accuracy": accuracy, "launches": launches,
            "pool_err": pool_err, "checks": step_check, **times,
            "trained": trained}


def check_int8_classifier(state_dict: dict, dev) -> dict:
    """Int8 of the classifier at full width (1000 classes, 224²), from
    the weights of ``state_dict`` with BN folded: calibration on the card
    (TF32 off) held to the CPU's; each conv's int32 sums on the card, the
    1×1 ``conv19`` among them, equal to the CPU's from the same int8
    input, and the logits to the CPU's; images/s of
    ``forward_int8_classifier`` at batch 256 beside the operation bound,
    and its profile by phase (no float conv)."""
    from tensorflow_yolo2_torch.models.fold import fold_params
    from tensorflow_yolo2_torch.ops import quant
    from tensorflow_yolo2_torch.utils.device import device_normalize
    from tensorflow_yolo2_torch.utils.profiling import (
        classifier_flops_per_image,
    )

    folded = fold_params(state_dict)
    images = torch.from_numpy(cls_batch(np.random.RandomState(9), BATCH)[0])
    calib = images[:INT8_CALIB_IMAGES]
    card_scales = quant.calibrate({k: v.to(dev) for k, v in folded.items()},
                                  device_normalize(calib.to(dev)),
                                  head="classifier")
    cpu_scales = quant.calibrate(folded, device_normalize(calib),
                                 head="classifier")
    calib_rel = ((card_scales - cpu_scales).abs() / cpu_scales).max().item()
    print(f"int8 classifier: calibration on {INT8_CALIB_IMAGES} images, card "
          f"(TF32 off) vs CPU: {len(card_scales)} scales within "
          f"{calib_rel:.3e} relative (bound {INT8_CALIB_REL_TOL})")
    check(calib_rel <= INT8_CALIB_REL_TOL,
          "int8 classifier: card and CPU calibration agree")
    layers = quant.quantize_folded(folded, card_scales, head="classifier")
    on_card, on_cpu = quant.prepare(layers, dev), quant.prepare(layers, "cpu")
    logits_rel, fed = check_int8_sums(
        "int8 classifier", on_card, on_cpu, images[:INT8_CPU_IMAGES],
        quant.forward_int8_classifier, "logits")
    flops = classifier_flops_per_image(CLS_SIZE, CLS_CLASSES)
    xb = images.to(dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: quant.forward_int8_classifier(on_card, xb), 5)
        out = quant.forward_int8_classifier(on_card, xb)
        check(out.shape == (BATCH, CLS_CLASSES) and
              bool(torch.isfinite(out).all()),
              "int8 classifier logits: shape and finite")
        prof = int8_phase_profile(
            lambda: quant.forward_int8_classifier(on_card, xb),
            f"classifier {CLS_SIZE}² batch {BATCH}")
    check(not prof["float_conv_names"],
          f"int8 classifier: no float conv in the profiled forward "
          f"({prof['float_conv_names']})")
    bound_ms = BATCH * flops / INT8_OPS_PER_S * 1e3
    print(f"int8 classifier {CLS_SIZE}², uint8 batch {BATCH} on the card: "
          f"{BATCH / ms * 1e3:.1f} images/s ({ms:.3f} ms a batch); "
          f"operation bound {bound_ms:.3f} ms ({flops / 1e9:.2f} GOP an "
          f"image at {INT8_OPS_PER_S / 1e12:.0f} int8 TOPS)")
    return {"calib_rel_err": calib_rel, "logits_rel_err": logits_rel,
            "fed_inputs": fed, "ms_per_batch": ms,
            "images_per_s": BATCH / ms * 1e3, "bound_ms": bound_ms,
            "profile": prof}


def write_ilsvrc_tree(root: str, rng: np.random.RandomState) -> str:
    """A small ILSVRC CLS-LOC tree, laid out as the tests'
    ``ilsvrc_dir`` fixture lays it out (per-synset train dirs and
    ``train_cls.txt``, val images labelled by XML), of seeded uint8
    images of random sizes written with cv2: CLS_TREE synsets, train
    images a synset and val images."""
    import cv2

    n_syn, n_train, n_val = CLS_TREE
    synsets = [f"n0{1000001 + i}" for i in range(n_syn)]
    lines = []

    def image(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        h, w = rng.randint(120, 320, 2)
        check(cv2.imwrite(path, rng.randint(0, 256, (h, w, 3)).astype(
            np.uint8)), f"cv2 wrote {path}")

    for syn in synsets:
        for i in range(n_train):
            rel = f"{syn}/{syn}_{i}"
            image(os.path.join(root, "Data", "CLS-LOC", "train",
                               rel + ".JPEG"))
            lines.append(f"{rel} {len(lines) + 1}")
    os.makedirs(os.path.join(root, "ImageSets", "CLS-LOC"))
    with open(os.path.join(root, "ImageSets", "CLS-LOC", "train_cls.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    ann = os.path.join(root, "Annotations", "CLS-LOC", "val")
    os.makedirs(ann)
    for i in range(n_val):
        name = f"ILSVRC2012_val_{i:08d}"
        image(os.path.join(root, "Data", "CLS-LOC", "val", name + ".JPEG"))
        with open(os.path.join(ann, name + ".xml"), "w") as f:
            f.write(f"<annotation><object><name>{synsets[i % n_syn]}"
                    "</name></object></annotation>")
    return root


@functools.cache
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_cli(main, argv: list[str], what: str) -> str:
    """An entry point's ``main(argv)`` in this process: it must return 0.
    Prints and returns what it printed."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    print(f"{what} ({time.perf_counter() - t0:.1f} s), exit {rc}:\n  " +
          "\n  ".join(text.strip().splitlines()[-6:]))
    check(rc == 0, f"{what} exits 0")
    return text


def run_classifier_clis(dev) -> dict:
    """The classifier's three CLIs with ``--device cuda`` on a synthetic
    ILSVRC tree (``write_ilsvrc_tree``) under a run root of their own:
    ``imagenet_train_darknet`` three times, each an epoch of 5 iterations
    at batch 8 resuming the last (plain, ``--uint8-transfer``,
    ``--process-workers 2``), with a validation batch every 2 iterations
    and a snapshot an epoch (B5 5 times a train step); then
    ``imagenet_test_darknet`` in bf16 and with ``--int8``, and
    ``imagenet_predict_darknet`` on a val image. Each must exit 0."""
    import tempfile

    from tensorflow_yolo2_torch.entries import (
        imagenet_predict_darknet,
        imagenet_test_darknet,
        imagenet_train_darknet,
    )
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
    from tensorflow_yolo2_torch.utils import cuda_build

    out = {}
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
        data = write_ilsvrc_tree(os.path.join(root, "data", "ILSVRC"),
                                 np.random.RandomState(10))
        epoch = CLS_TREE[0] * CLS_TREE[1] // CLS_CLI_BATCH
        train = ["--batch-size", str(CLS_CLI_BATCH), "--iters", str(epoch),
                 "--save-every", str(epoch), "--eval-every", "2",
                 "--log-every", str(epoch), "--num-workers", "2",
                 "--device", str(dev)]
        cuda_pool.reset_launch_counts()
        runs = {"plain": [], "uint8_transfer": ["--uint8-transfer"],
                "process_workers": ["--process-workers", "2"]}
        for name, extra in runs.items():
            run_cli(imagenet_train_darknet.main, train + extra,
                    f"imagenet_train_darknet {' '.join(extra)}")
        torch.cuda.synchronize()
        out["train_launches"] = cuda_pool.MAX_POOL2_BWD_LAUNCHES
        steps = CheckpointManager("darknet19", "ilsvrc_2017_cls",
                                  save_by_epoch=True).all_steps()
        print(f"classifier CLIs: snapshots at epochs {steps}; B5 launched "
              f"{out['train_launches']} times in {3 * epoch} train steps")
        check(steps == [1, 2, 3], "an epoch-named snapshot a run, resumed")
        check(out["train_launches"] == 5 * 3 * epoch,
              "B5 ran 5 times a CLI train step")
        test = ["--batch-size", str(CLS_CLI_BATCH), "--max-batches", "2",
                "--num-workers", "2", "--device", str(dev)]
        for name, extra in (("test_bf16", []), ("test_int8", ["--int8"])):
            text = run_cli(imagenet_test_darknet.main, test + extra,
                           f"imagenet_test_darknet {' '.join(extra)}")
            check("top-1 accuracy" in text, f"{name} reports top-1")
            out[name] = text.strip().splitlines()[-2:]
        val = os.path.join(data, "Data", "CLS-LOC", "val",
                           "ILSVRC2012_val_00000000.JPEG")
        text = run_cli(imagenet_predict_darknet.main,
                       [val, "--device", str(dev)], "imagenet_predict_darknet")
        rows = text.strip().splitlines()
        check(len(rows) == 5 and rows[0].startswith("1. n0"),
              "the predict CLI prints 5 ranked synsets")
        out["predict"] = rows
    return out


def resnet_detector(dev):
    """The ResNet50 detector at 224² (S=7, B=2, C=20), flax's fresh
    weights from seed 0 drawn on the card, with its BatchNorms moved off
    the identity (scale U(0.5, 1.5), bias N(0, 0.1), running mean
    N(0, 0.1), variance U(0.5, 2)) so that the ReLU'd grid is not all
    zeros; the box outputs (channels 22-29 of every cell) near their
    biases (weights ×0.1, x, y 0.5, w, h roots 0.6: boxes ~2.5 cells
    wide) and the confidences raised (+0.3) so that both boxes of a cell
    often pass the threshold and overlap, and NMS has work: its config and
    state dict (on the CPU)."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.models.darknet import init_params_
    from tensorflow_yolo2_torch.models.resnet import ResNet50Detector

    yolo = YoloConfig()
    with torch.device(dev):
        model = ResNet50Detector(yolo.cell_channels, yolo.S, yolo.image_size)
    gen = torch.Generator(dev).manual_seed(0)
    init_params_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        C, B = yolo.num_class, yolo.B
        weight = model.yolo_fc2.weight.view(-1, yolo.cell_channels, 4096)
        bias = model.yolo_fc2.bias.view(-1, yolo.cell_channels)
        weight[:, C + B:] *= 0.1
        bias[:, C + B:] = torch.tensor([0.5, 0.5, 0.6, 0.6] * B)
        bias[:, C:C + B] += 0.3
    return yolo, {k: v.cpu() for k, v in model.state_dict().items()}


def check_resnet_serving(dev, images: torch.Tensor) -> dict:
    """The ResNet detector's serving path, ``make_resnet_detect_fn`` at
    224², bf16, BN unfolded, threshold 0.2: one call with NMS and one
    without on a uint8 batch of 16 (B1 once, B3 once); the bf16 card grid
    of 2 images against the float32 CPU forward; B1 (K=32 and K=n,
    class-aware on and off) and B3 against their plain versions on the
    card grid of 256 images at 0.2 and 0.05. Returns the detect function
    with NMS, the grid, the config, the launches and the errors."""
    from tensorflow_yolo2_torch.entries.pascal_detect_resnet import (
        build_resnet_detector,
        make_resnet_detect_fn,
    )
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.utils.device import device_normalize

    yolo, state = resnet_detector(dev)
    detect_nms = make_resnet_detect_fn(yolo, state, RESNET_THRESH,
                                       use_nms=True)
    detect_dense = make_resnet_detect_fn(yolo, state, RESNET_THRESH)
    batch = images[:16]
    cd.reset_launch_counts()
    kept = detect_nms(batch)
    dense = detect_dense(batch)
    torch.cuda.synchronize()
    launches = {"decode_nms": cd.DECODE_NMS_LAUNCHES,
                "decode_grid": cd.DECODE_GRID_LAUNCHES,
                "decode_nms_v2": cd.DECODE_NMS_V2_LAUNCHES}
    print(f"resnet50 224² path launches, one call with NMS and one without: "
          f"{launches}")
    check(launches == {"decode_nms": 1, "decode_grid": 1, "decode_nms_v2": 0},
          "the ResNet path launched B1 once with NMS and B3 once without")
    n = yolo.S * yolo.S * yolo.B
    check(kept.boxes.shape == (16, K, 4) and dense.boxes.shape == (16, n, 4),
          "ResNet output shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (*kept[:2], *dense[:2])),
          "ResNet finite outputs")
    check(bool((kept.scores > 0).any()), "the ResNet path kept detections")
    del detect_dense

    model = build_resnet_detector(yolo, state, device=dev)
    x = images[:BATCH].to(dev)
    with torch.inference_mode():
        grid = model(device_normalize(x).to(torch.bfloat16))
        on_card = grid[:2].double().cpu()
    cpu = build_resnet_detector(yolo, state, torch.float32, "cpu")
    with torch.inference_mode():
        on_cpu = cpu(images[:2].float() / 255.0 * 2.0 - 1.0).double()
    del cpu, model
    rel = ((on_card - on_cpu).norm() / on_cpu.norm()).item()
    print(f"resnet50 grid, bf16 card vs float32 CPU forward: relative norm "
          f"error {rel:.3e} (bound {GRID_REL_TOL})")
    check(rel <= GRID_REL_TOL, "ResNet card grid agrees with the CPU forward")
    errs = {"decode_nms": 0.0, "decode_grid": 0.0}
    for thresh in (RESNET_THRESH, 0.05):
        errs["decode_grid"] = max(errs["decode_grid"], compare_dense(
            cd.decode_grid_fused(grid, yolo, thresh),
            cd.decode_grid_plain(grid, yolo, thresh)))
        for class_aware in (True, False):
            errs["decode_nms"] = max(errs["decode_nms"], compare_kept(
                cd.decode_nms_fused(grid, yolo, thresh, 0.5, K, class_aware),
                cd.decode_nms_plain(grid, yolo, thresh, 0.5, K,
                                    class_aware)))
        want = cd.decode_nms_plain(grid, yolo, thresh, 0.5, n)
        errs["decode_nms"] = max(errs["decode_nms"], compare_kept(
            cd.decode_nms_fused(grid, yolo, thresh, 0.5, n), want))
        valid = (cd.decode_grid_plain(grid, yolo, thresh).scores > 0).sum(1)
        n_kept = (want.scores > 0).sum(1)
        print(f"resnet50 real grid, threshold {thresh}: "
              f"{valid.float().mean():.1f} valid and "
              f"{n_kept.float().mean():.1f} surviving slots per image")
        check(bool((n_kept > 0).any()), "the ResNet grid keeps boxes")
        check(bool((n_kept <= valid).all()) and bool((n_kept < valid).any()),
              "ResNet NMS suppressed boxes")
    torch.cuda.synchronize()
    print(f"resnet50 real grid: B1 and B3 match their plain versions (max "
          f"abs err {errs})")
    return {"detect": detect_nms, "grid": grid, "yolo": yolo,
            "launches": launches, "errs": errs, "grid_rel_err": rel}


def fresh_state_dict(model: torch.nn.Module, device) -> dict:
    """flax's fresh weights for ``model`` (``init_params_``), drawn on
    ``device`` from seed 0: the host draws the 224² ResNet detector's 435M
    weights in ~30 s (its truncated normal resamples the whole tensor
    until no value lies out of range)."""
    from tensorflow_yolo2_torch.models.darknet import init_params_

    model = init_params_(model.to(device),
                         torch.Generator(device).manual_seed(0))
    return {k: v.cpu() for k, v in model.state_dict().items()}


def make_resnet_trainer(dtype: torch.dtype, device, state_dict=None,
                        size: int = 224, dropout_rate: float = 0.5):
    """The detector's trainer as ``pascal_train_resnet`` builds it
    (``ResNet50Detector`` at ``size``², the YOLO loss, Adam at 5e-4) and
    its state on ``device``: fresh weights from seed 0 drawn there
    (``fresh_state_dict``) or ``state_dict``'s."""
    from tensorflow_yolo2_torch.config import (
        LRScheduleConfig,
        OptimizerConfig,
        YoloConfig,
    )
    from tensorflow_yolo2_torch.models.resnet import ResNet50Detector
    from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

    yolo = YoloConfig(image_size=size)
    with torch.device(device):
        model = ResNet50Detector(yolo.cell_channels, yolo.S, size,
                                 dropout_rate=dropout_rate)
    if state_dict is None:
        state_dict = fresh_state_dict(model, device)
    trainer = Trainer(model, yolo_task(yolo), OptimizerConfig(
        name="adam", schedule=LRScheduleConfig(learning_rate=5e-4)),
        device=device, compute_dtype=dtype)
    return trainer, trainer.create_state(torch.Generator().manual_seed(0),
                                         state_dict)


def resnet_check_weights(images: torch.Tensor, labels: torch.Tensor
                         ) -> dict:
    """The float32 weights the ResNet step check starts from: fresh ones
    from seed 0 drawn on the CPU at ``RESNET_CHECK_SIZE``², then
    ``RESNET_WARM_STEPS`` Adam steps in float64 on the CPU on ``images``
    and ``labels``, dropout off. Float32 steps on the card would make
    them a function of the card's rounding: Adam's first steps move each
    weight by ~lr whatever its gradient's size, and the point they reach,
    and the float32 gradients' distance from float64 there, changed from
    run to run (all 1.8e-5 to 1.2e-2, and once over 3e-2)."""
    cpu = torch.device("cpu")
    trainer, state = make_resnet_trainer(torch.float32, cpu,
                                         size=RESNET_CHECK_SIZE,
                                         dropout_rate=0.0)
    state.model.double()
    trainer.resume_optimizer(state)
    images = images.cpu().double() / 255.0 * 2.0 - 1.0
    for _ in range(RESNET_WARM_STEPS):
        trainer.train_step(state, images, labels.cpu())
    return {k: v.detach().float() if v.is_floating_point() else v
            for k, v in state.model.state_dict().items()}


def check_resnet_training(dev) -> dict:
    """The detector's training path at full width, bf16, Adam at 5e-4,
    dropout on: 30 steps on one seeded batch of 4 at 224² (no B5, the
    loss falling); a float32 step on the card against float64 on the CPU
    with dropout off at 64² on 4 images, from the weights of 3 float64
    steps on the CPU (``resnet_check_weights``; ``RESNET_GRAD_BOUNDS``);
    images/s at batch 4 and 32 with the idle share."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.utils.profiling import (
        resnet50_flops_per_image,
    )

    yolo = YoloConfig()
    rng = np.random.RandomState(11)
    images, labels = (torch.from_numpy(a).to(dev) for a in
                      train_batch(rng, RESNET_TRAIN_BATCHES[0], yolo))
    trainer, state = make_resnet_trainer(torch.bfloat16, dev)
    losses = []
    cuda_pool.reset_launch_counts()
    for _ in range(FALL_STEPS):
        state, metrics = trainer.train_step(state, images, labels)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    losses = torch.stack(losses).tolist()
    print(f"train path resnet50 224², dropout 0.5: loss on one batch of "
          f"{RESNET_TRAIN_BATCHES[0]}: " + ", ".join(f"{v:.3f}"
                                                     for v in losses))
    check(cuda_pool.MAX_POOL2_BWD_LAUNCHES == 0, "no B5 in a ResNet step")
    check(all(math.isfinite(v) for v in losses), "finite ResNet losses")
    # Adam's first steps move every weight by ~lr, and the ReLU'd grid
    # with them: the loss jumps by orders of magnitude before it falls (a
    # float32 CPU rehearsal: 385 → 70391 at step 2 → 80 at step 29), so
    # the last steps are held to the first five
    check(sum(losses[-5:]) < 0.1 * sum(losses[:5]),
          "the ResNet loss fell on a fixed batch (mean of the last 5 steps "
          "under a tenth of the first 5's)")
    check(state.step == FALL_STEPS and all(
        bool(torch.isfinite(p).all()) for p in state.params.values()),
        "finite ResNet parameters after the steps")

    small = YoloConfig(image_size=RESNET_CHECK_SIZE)
    build = functools.partial(make_resnet_trainer, size=RESNET_CHECK_SIZE,
                              dropout_rate=0.0)
    cimages, clabels = (torch.from_numpy(a).to(dev) for a in train_batch(
        np.random.RandomState(15), RESNET_CHECK_IMAGES, small))
    cuda_pool.reset_launch_counts()
    step_check = check_train_step_against_cpu(
        build, cimages, clabels, dev, resnet_check_weights(cimages, clabels),
        bounds=RESNET_GRAD_BOUNDS)
    check(cuda_pool.MAX_POOL2_BWD_LAUNCHES == 0,
          "no B5 in the ResNet step check")
    flops = 3 * resnet50_flops_per_image(224, grid_outputs=yolo.S ** 2 *
                                         yolo.cell_channels)
    times = time_train(trainer, state, lambda b: train_batch(rng, b, yolo),
                       flops, "resnet50 224²", RESNET_TRAIN_BATCHES, pools=0)
    return {"losses": losses, "checks": step_check, **times}


def check_fine_tune(dev) -> dict:
    """The frozen-trunk ImageNet fine-tune as ``imagenet_train_resnet``
    builds it (``ResNet50V1``, 1000 classes, 224², momentum 0.9 at 1e-3,
    ``trainable_scopes=("logits",)``), bf16, at batch 32: after 10 steps
    every trunk parameter bit-equal to its start, every running statistic
    of the trunk moved, the logits moved; then images/s."""
    from tensorflow_yolo2_torch.entries.imagenet_train_resnet import (
        fine_tune_config,
    )
    from tensorflow_yolo2_torch.models.resnet import ResNet50V1
    from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task
    from tensorflow_yolo2_torch.utils.profiling import (
        resnet50_flops_per_image,
    )

    with torch.device(dev):
        model = ResNet50V1(CLS_CLASSES, global_pool=True)
    fresh = fresh_state_dict(model, dev)
    trainer = Trainer(model, softmax_task(), fine_tune_config(1e-3),
                      device=dev)
    state = trainer.create_state(torch.Generator().manual_seed(0), fresh)
    start = {k: v.detach().clone()
             for k, v in state.model.state_dict().items()}
    rng = np.random.RandomState(12)
    images, labels = (torch.from_numpy(a).to(dev)
                      for a in cls_batch(rng, FINE_TUNE_BATCH))
    for _ in range(FINE_TUNE_STEPS):
        state, metrics = trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    after = state.model.state_dict()
    params = dict(state.model.named_parameters())
    trunk = [k for k in params if not k.startswith("logits.")]
    stats = [k for k in after if "running" in k]
    frozen_equal = all(torch.equal(after[k], start[k]) for k in trunk)
    stats_moved = all(not torch.equal(after[k], start[k]) for k in stats)
    logits_moved = all(not torch.equal(after[k], start[k])
                       for k in ("logits.weight", "logits.bias"))
    print(f"fine-tune resnet50 224², {CLS_CLASSES} classes, batch "
          f"{FINE_TUNE_BATCH}, {FINE_TUNE_STEPS} steps: {len(trunk)} trunk "
          f"parameters bit-equal to their start: {frozen_equal}; "
          f"{len(stats)} running statistics moved: {stats_moved}; logits "
          f"moved: {logits_moved}; slots: {sorted(state.opt_state.trace)}; "
          f"loss {metrics['loss'].item():.4f}")
    check(frozen_equal, "the frozen trunk's parameters are bit-equal")
    check(stats_moved, "the frozen trunk's BatchNorm statistics moved")
    check(logits_moved, "the logits trained")
    check(sorted(state.opt_state.trace) == ["logits.bias", "logits.weight"],
          "optimizer slots for the logits alone")
    # the frozen trunk runs forward only; the logits' backward is ~0
    flops = resnet50_flops_per_image(224, num_classes=CLS_CLASSES)
    times = time_train(trainer, state, lambda b: cls_batch(rng, b), flops,
                       f"fine-tune resnet50 {CLS_SIZE}²", (FINE_TUNE_BATCH,),
                       pools=0)
    return {"frozen_equal": frozen_equal, "stats_moved": stats_moved,
            "logits_moved": logits_moved, **times}


def run_resnet_clis(dev) -> dict:
    """The ResNet family's three CLIs with ``--device cuda`` under a run
    root of their own (a temporary dir, deleted after: a 224² detector
    snapshot with Adam's slots is ~5 GB): ``pascal_train_resnet`` for 2
    iterations at batch 4 on a synthetic VOC tree written with cv2;
    ``pascal_detect_resnet --nms`` on its snapshot, drawing recorded
    through a patched ``draw_detections`` (the card machine has no
    matplotlib), its boxes equal to ``make_resnet_detect_fn``'s (B1 once
    a call); ``imagenet_train_resnet`` for an epoch on the
    ``write_ilsvrc_tree`` tree. Each must exit 0."""
    import tempfile

    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.data.augment import image_read
    from tensorflow_yolo2_torch.entries import (
        imagenet_train_resnet,
        pascal_detect_resnet,
        pascal_train_resnet,
    )
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.train.checkpoint import (
        CheckpointManager,
        read_snapshot,
    )
    from tensorflow_yolo2_torch.utils import cuda_build
    from tests import synthetic

    out = {}
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
        voc = synthetic.make_voc(os.path.join(root, "data", "VOCdevkit"),
                                 n_images=VOC_TREE_IMAGES)
        run_cli(pascal_train_resnet.main,
                ["--iters", "2", "--batch-size", str(RESNET_CLI_BATCH),
                 "--save-every", "2", "--log-every", "1", "--num-workers",
                 "2", "--device", str(dev)], "pascal_train_resnet")
        mgr = CheckpointManager("resnet50", "voc_2007")
        check(mgr.all_steps() == [2], "pascal_train_resnet saved train_iter_2")
        image = os.path.join(voc, "JPEGImages", "000000.jpg")
        drawn = []

        def record(path, boxes, scores, classes, names, out_path=None):
            drawn.append((boxes, scores, classes))
            return os.path.join(root, "detections.png")

        cd.reset_launch_counts()
        with mock.patch.object(pascal_detect_resnet, "draw_detections",
                               record):
            run_cli(pascal_detect_resnet.main,
                    [image, "--nms", "--device", str(dev)],
                    "pascal_detect_resnet --nms")
        torch.cuda.synchronize()
        out["detect_launches"] = cd.DECODE_NMS_LAUNCHES
        check(out["detect_launches"] == 1, "the detect CLI launched B1 once")
        snap = read_snapshot(mgr.latest_path())
        yolo = YoloConfig()
        detect = pascal_detect_resnet.make_resnet_detect_fn(
            yolo, snap["model"], RESNET_THRESH, use_nms=True, device=dev)
        del snap
        want = [t[0].cpu().numpy()
                for t in detect(image_read(image, yolo.image_size)[None])]
        (got,) = drawn
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              "the detect CLI's boxes equal make_resnet_detect_fn's")
        out["detect_kept"] = int((want[1] > 0).sum())
        print(f"pascal_detect_resnet --nms: {out['detect_kept']} boxes kept "
              f"at {RESNET_THRESH}, equal to make_resnet_detect_fn's")
        del detect

        write_ilsvrc_tree(os.path.join(root, "data", "ILSVRC"),
                          np.random.RandomState(13))
        epoch = CLS_TREE[0] * CLS_TREE[1] // CLS_CLI_BATCH
        run_cli(imagenet_train_resnet.main,
                ["--batch-size", str(CLS_CLI_BATCH), "--iters", str(epoch),
                 "--save-every", str(epoch), "--eval-every", "2",
                 "--log-every", str(epoch), "--num-workers", "2",
                 "--device", str(dev)], "imagenet_train_resnet")
        steps = CheckpointManager("resnet50", "ilsvrc_2017_cls",
                                  save_by_epoch=True).all_steps()
        check(steps == [1], "imagenet_train_resnet saved train_epoch_1")
    return out


def random_weights_(model: torch.nn.Module,
                    gen: torch.Generator) -> torch.nn.Module:
    """Seeded random weights on the model's device, in place: He-normal
    conv and dense kernels, biases N(0, 0.05), BatchNorm scales U(0.5,
    1.5), biases and running means N(0, 0.1), running variances U(0.5, 2),
    so that an eval forward exercises every term."""
    from torch import nn

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.05, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                if m.weight is not None:  # the inception nets' have none
                    m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model


def outputs(y) -> list[torch.Tensor]:
    """A net's outputs, the logits (and the auxiliary logits), as float32
    tensors on the host."""
    return [t.float().cpu() for t in (y if isinstance(y, tuple) else (y,))]


def check_zoo(dev) -> dict:
    """Every registered net at its default size (the inception nets with
    their auxiliary heads where they have them), batch 2, seeded random
    weights drawn on the card, in eval mode: the float32 card forward
    (TF32 off) and the bf16 autocast forward against the CPU's float32
    forward of the same weights, every output (the worst is held)."""
    from tensorflow_yolo2_torch.models import registry

    out = {}
    for name in registry.list_networks():
        size = registry.default_image_size(name)
        kw = {"aux_logits": True} if name in AUX_NETS else {}
        with torch.device(dev):
            model = registry.get_network(name, **kw)
        random_weights_(model, torch.Generator(dev).manual_seed(len(name)))
        model.eval()
        x = torch.from_numpy(np.random.RandomState(size).uniform(
            -1, 1, (ZOO_BATCH, size, size, 3)).astype(np.float32))
        xd = x.to(dev)
        with torch.no_grad():
            f32 = outputs(model(xd))
            with torch.autocast("cuda", dtype=torch.bfloat16):
                bf16 = outputs(model(xd))
            wants = outputs(model.cpu()(x))
        want = wants[0]
        f32_errs = [rel_norm(g, w) for g, w in zip(f32, wants)]
        bf16_errs = [rel_norm(g, w) for g, w in zip(bf16, wants)]
        out[name] = {"size": size, "shape": list(want.shape),
                     "f32_rel_err": max(f32_errs),
                     "bf16_rel_err": max(bf16_errs)}
        aux = ""
        if len(wants) > 1:
            out[name].update(aux_f32_rel_err=f32_errs[1],
                             aux_bf16_rel_err=bf16_errs[1])
            aux = (f"; the auxiliary logits float32 {f32_errs[1]:.3e}, "
                   f"bf16 {bf16_errs[1]:.3e}")
        print(f"zoo {name} {size}², batch {ZOO_BATCH}, output "
              f"{tuple(want.shape)}: float32 card vs CPU "
              f"{f32_errs[0]:.3e} (bound {ZOO_F32_REL_TOL}), "
              f"bf16 {bf16_errs[0]:.3e} (bound "
              f"{ZOO_BF16_REL_TOL}), relative norm{aux}")
        check(all(bool(torch.isfinite(w).all()) and w.norm() > 0
                  for w in wants),
              f"zoo {name}: finite, non-zero CPU output")
        check(out[name]["f32_rel_err"] <= ZOO_F32_REL_TOL,
              f"zoo {name}: float32 card forward agrees with the CPU's")
        check(out[name]["bf16_rel_err"] <= ZOO_BF16_REL_TOL,
              f"zoo {name}: bf16 card forward agrees with the CPU's")
        del model, xd
        torch.cuda.empty_cache()
    return out


def check_inception_fold(dev) -> dict:
    """``inception_v3`` at 299² with its auxiliary head (1000 classes,
    seeded random weights drawn on the card, the statistics off the
    identity), eval mode, float32 (TF32 off), batch FOLD_BATCH: the logits
    and auxiliary logits of ``fold_params_identity``'s state dict against
    the unfolded ones, within FOLD_REL_TOL."""
    from tensorflow_yolo2_torch.models import registry
    from tensorflow_yolo2_torch.models.fold import fold_params_identity

    with torch.device(dev):
        model = registry.get_network("inception_v3", aux_logits=True)
    random_weights_(model, torch.Generator(dev).manual_seed(16))
    model.eval()
    x = torch.from_numpy(np.random.RandomState(16).uniform(
        -1, 1, (FOLD_BATCH, 299, 299, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        want = outputs(model(x))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        folded = fold_params_identity(before)
        model.load_state_dict(folded)
        got = outputs(model(x))
    changed = sum(not torch.equal(folded[k], before[k]) for k in before)
    errs = [rel_norm(g, w) for g, w in zip(got, want)]
    print(f"identity fold, inception_v3 299², aux head, float32, batch "
          f"{FOLD_BATCH}: {changed} of {len(before)} tensors folded; logits "
          f"{errs[0]:.3e}, auxiliary logits {errs[1]:.3e} from the unfolded "
          f"ones (relative norm; bound {FOLD_REL_TOL})")
    check(changed > 0 and all(torch.isfinite(g).all() for g in got),
          "the fold changed the state dict, finite logits")
    check(max(errs) <= FOLD_REL_TOL,
          "the folded inception_v3 gives the unfolded logits")
    return {"tensors_folded": changed, "logits_rel_err": errs[0],
            "aux_logits_rel_err": errs[1]}


def _to(state, dev, dtype=None):
    """A copy of an optimizer state on ``dev`` (in ``dtype``)."""
    from tensorflow_yolo2_torch.train.optimizers import OptState

    def move(d):
        return {k: v.to(dev, dtype, copy=True) for k, v in d.items()}

    return OptState(state.count, list(state.names),
                    {s: move(t) for s, t in state.slots.items()},
                    None if state.acc_grads is None else
                    move(state.acc_grads), state.mini_step)


def check_slim_optimizers(dev) -> dict:
    """Each of the nine optimizers, ``MultiSteps`` (rmsprop, k=2) and
    the EMA: from the same float32 parameters and slots, taken after 3
    float32 updates on the CPU, one float32 update on the card against
    the same update in float64 on the CPU (weight decay 4e-5, the clip at
    100, rate 1; the parameters N(0, 1e-4), so that each update, the
    difference of the parameters in float64, keeps its float32 digits):
    the update and every slot within OPT_REL_TOL relative norm, tensor by
    tensor. The reference is float64 (with the float32 bias corrections
    of Adam's family, as a float32 step takes them) because the CPU's own
    float32 norm of a 1M-value tensor, which the clip divides by, is
    ~1e-5 off."""
    from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
    from tensorflow_yolo2_torch.train import optimizers as opt

    bias_correction = opt._bias_correction
    rng = np.random.RandomState(12)
    shapes = {"conv.weight": (256, 128, 3, 3), "conv.bias": (256,),
              "bn.weight": (256,), "fc.weight": (1000, 1024),
              "zero.bias": (64,)}
    base = {k: torch.from_numpy(rng.normal(0, 1e-4, s).astype(np.float32))
            for k, s in shapes.items()}
    base["zero.bias"].zero_()
    grads = [{k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(OPT_WARM_STEPS + 1)]
    configs = {name: {"name": name} for name in opt.OPTIMIZERS}
    configs["multisteps_rmsprop_k2"] = {"name": "rmsprop",
                                        "grad_accum_steps": 2}
    out = {}
    for label, kw in configs.items():
        o = opt.make_optimizer(OptimizerConfig(
            **kw, weight_decay=4e-5, grad_clip_norm=100.0,
            schedule=LRScheduleConfig(learning_rate=1.0)))
        p = {k: v.clone() for k, v in base.items()}
        state = o.init(p)
        for g in grads[:OPT_WARM_STEPS]:
            o.update_(g, state, p)
        pd = {k: v.to(dev, copy=True) for k, v in p.items()}
        sd = _to(state, dev)
        p64 = {k: v.double() for k, v in p.items()}
        s64 = _to(state, "cpu", torch.float64)
        # float64 arithmetic with the float32 bias corrections that a
        # float32 step takes (optax's; 1.3e-5 from the double ones at b2)
        with mock.patch.object(
                opt, "_bias_correction", lambda decay, count, _:
                bias_correction(decay, count, torch.float32)):
            o.update_({k: v.double() for k, v in grads[-1].items()}, s64,
                      p64)
        o.update_({k: v.to(dev) for k, v in grads[-1].items()}, sd, pd)
        torch.cuda.synchronize()
        errs = [rel_norm(pd[k].double().cpu() - p[k].double(),
                         p64[k] - p[k].double()) for k in p]
        errs += [rel_norm(sd.slots[s][k], t) for s, slot in
                 s64.slots.items() for k, t in slot.items()]
        check(s64.count == sd.count and s64.mini_step == sd.mini_step,
              f"{label}: the card's counts are the CPU's")
        out[label] = max(errs)
    ema = opt.make_ema(0.999)
    e_cpu = [v.double() for v in base.values()]
    e_card = [v.to(dev) for v in base.values()]
    params = [v + 1.0 for v in base.values()]
    ema(e_cpu, [v.double() for v in params])
    ema(e_card, [v.to(dev) for v in params])
    out["ema"] = max(rel_norm(c, w) for c, w in zip(e_card, e_cpu))
    print(f"optimizers, one float32 update on the card vs float64 on the "
          f"CPU, after {OPT_WARM_STEPS} float32 ones on the CPU (worst "
          f"tensor, relative norm; bound {OPT_REL_TOL}): " +
          ", ".join(f"{k} {v:.2e}" for k, v in out.items()))
    for label, err in out.items():
        check(err <= OPT_REL_TOL, f"{label}: the card's update is the CPU's")
    return out


def check_accumulation(dev) -> dict:
    """``yolo1_pretrain`` at ACCUM_SIZE² (1000 classes, fresh seeded
    weights, float32, TF32 off), sgd at 0.1: k=2 on two batches of 16
    against one step on the batch of 32. Held within ACCUM_REL_TOL
    (relative norm of all the tensors, concatenated): the parameters
    after the applied update against those after the batch-32 step, and
    the mean gradient the inner update received against the mean of the
    two batch-16 gradients taken apart; B5 4 times a micro-step. Printed,
    not held: that mean gradient against the batch-32 gradient, and the
    batch-16 forward against the same images' rows of the batch-32
    forward (cuDNN computes the two batch sizes differently, so float32
    results differ in the last bits, and a max-pool or leaky-ReLU
    decision near a tie can flip)."""
    from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
    from tensorflow_yolo2_torch.models import registry
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task

    images, labels = (torch.from_numpy(a).to(dev) for a in cls_batch(
        np.random.RandomState(13), 32, CLS_CLASSES, ACCUM_SIZE))
    halves = [(images[:16], labels[:16]), (images[16:], labels[16:])]

    def trainer_for(k: int):
        return Trainer(registry.get_network(
            "yolo1_pretrain", num_classes=CLS_CLASSES,
            image_size=ACCUM_SIZE), softmax_task(), OptimizerConfig(
                name="sgd", grad_accum_steps=k,
                schedule=LRScheduleConfig(learning_rate=0.1)),
            device=dev, compute_dtype=torch.float32)

    def recording(store: dict, update_):
        def update(grads, state, params, grad_norm=None):
            store.update({k: grads[k].double().cpu() for k in state.names})
            return update_(grads, state, params, grad_norm)
        return update

    def flat(tensors: dict, keys) -> torch.Tensor:
        return torch.cat([tensors[k].detach().double().cpu().flatten()
                          for k in keys])

    one, two = trainer_for(1), trainer_for(2)
    sd = fresh_state_dict(trainer_for(1).model, dev)
    s1 = one.create_state(torch.Generator().manual_seed(0), sd)
    s2 = two.create_state(torch.Generator().manual_seed(0), sd)
    g32, acc = {}, {}
    one.optimizer.update_ = recording(g32, one.optimizer.update_)
    two.optimizer.inner.update_ = recording(acc, two.optimizer.inner.update_)
    cuda_pool.reset_launch_counts()
    for x, y in halves:
        two.train_step(s2, x, y)
    torch.cuda.synchronize()
    launches = cuda_pool.MAX_POOL2_BWD_LAUNCHES
    apart = [one.loss_and_grads(s1, x, y)[1] for x, y in halves]
    with torch.no_grad():
        fwd_rel = rel_norm(one._forward(images[:16]),
                           one._forward(images)[:16])
    one.train_step(s1, images, labels)
    check((s2.opt_state.count, s2.opt_state.mini_step, s2.step) == (1, 0, 2),
          "k=2: one update applied in two micro-steps")
    keys = list(g32)
    check(set(acc) == set(keys) == set(s1.params),
          "both runs updated every parameter once")
    mean = {k: (apart[0][k].double().cpu() + apart[1][k].double().cpu()) / 2
            for k in keys}
    out = {"param_rel_err": rel_norm(flat(s2.params, keys),
                                     flat(s1.params, keys)),
           "grad_vs_mean_rel_err": rel_norm(flat(acc, keys),
                                            flat(mean, keys)),
           "grad_vs_batch32_rel_err": rel_norm(flat(acc, keys),
                                               flat(g32, keys)),
           "forward_16_vs_32_rel_err": fwd_rel, "launches": launches}
    worst = max(keys, key=lambda k: rel_norm(acc[k], g32[k]))
    out["worst_tensor_vs_batch32"] = [worst, rel_norm(acc[worst], g32[worst])]
    print(f"yolo1_pretrain {ACCUM_SIZE}², float32, sgd, k=2 on 2×16 vs one "
          f"step on 32: parameters after {out['param_rel_err']:.3e}, the "
          f"accumulated gradient vs the mean of the two batch-16 gradients "
          f"{out['grad_vs_mean_rel_err']:.3e} (relative norm of all "
          f"tensors; bound {ACCUM_REL_TOL}); max_pool2_bwd {launches} in 2 "
          f"micro-steps. Not held: the accumulated gradient vs the batch-32 "
          f"gradient {out['grad_vs_batch32_rel_err']:.3e} (worst {worst} "
          f"{out['worst_tensor_vs_batch32'][1]:.3e}); the batch-16 forward "
          f"vs its rows of the batch-32 forward {fwd_rel:.3e}")
    check(launches == 8, "B5 ran 4 times a yolo1_pretrain micro-step")
    check(out["param_rel_err"] <= ACCUM_REL_TOL,
          "k=2 on two batches of 16 steps as one step on the batch of 32")
    check(out["grad_vs_mean_rel_err"] <= ACCUM_REL_TOL,
          "the accumulated gradient is the mean of the micro-steps'")
    return out


def check_remat(dev) -> dict:
    """Two bf16 steps of ``REMAT_NET`` at 224², batch ``REMAT_BATCH``
    (1000 classes, rmsprop, weight decay 4e-5, fresh seeded weights), with
    and without ``remat``, cuDNN deterministic: parameters, running
    statistics, optimizer slots and the generator bit-equal; the peak
    memory of each."""
    from tensorflow_yolo2_torch.config import LRScheduleConfig, OptimizerConfig
    from tensorflow_yolo2_torch.models import registry
    from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task

    images, labels = (torch.from_numpy(a).to(dev) for a in cls_batch(
        np.random.RandomState(14), REMAT_BATCH))
    sd = fresh_state_dict(registry.get_network(REMAT_NET), dev)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            trainer = Trainer(registry.get_network(REMAT_NET),
                              softmax_task(), OptimizerConfig(
                                  name="rmsprop", weight_decay=4e-5,
                                  schedule=LRScheduleConfig(
                                      learning_rate=1e-3)),
                              device=dev, remat=remat)
            state = trainer.create_state(torch.Generator().manual_seed(0),
                                         sd)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                state, metrics = trainer.train_step(state, images, labels)
            torch.cuda.synchronize()
            runs[remat] = {
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "model": {k: v.cpu() for k, v in
                          state.model.state_dict().items()},
                "slots": {f"{s}/{k}": v.cpu() for s, t in
                          state.opt_state.slots.items()
                          for k, v in t.items()},
                "rng": state.rng.get_state(),
                "loss": float(metrics["loss"])}
            del trainer, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    plain, remat = runs[False], runs[True]
    diff = max([(plain["model"][k].double() - remat["model"][k].double()
                 ).abs().max().item() for k in plain["model"]
                if plain["model"][k].is_floating_point()] +
               [(plain["slots"][k] - remat["slots"][k]).abs().max().item()
                for k in plain["slots"]])
    same_rng = torch.equal(plain["rng"], remat["rng"])
    print(f"remat {REMAT_NET} 224², batch {REMAT_BATCH}, two bf16 steps: "
          f"largest difference from the plain step {diff} (parameters, "
          f"running statistics, slots), generator equal {same_rng}, loss "
          f"{plain['loss']:.6f} / {remat['loss']:.6f}; peak memory "
          f"{plain['peak_gib']:.2f} GiB plain, {remat['peak_gib']:.2f} GiB "
          f"remat")
    check(diff == 0.0 and same_rng and plain["loss"] == remat["loss"],
          "a remat step leaves parameters, statistics and generator where "
          "the plain step does")
    return {"max_abs_diff": diff, "peak_gib_plain": plain["peak_gib"],
            "peak_gib_remat": remat["peak_gib"]}


def slim_train_times(dev) -> dict:
    """Train steps of SLIM_TIMES in bf16 with the CLI's rmsprop and
    weight decay 4e-5 (EMA 0.999 where asked; inception_v3 with its
    auxiliary head and loss), fresh seeded weights drawn on the card:
    ``time_train`` (images/s unprofiled, the idle share, B5 5 times a
    darknet19 step, 4 a yolo1 step, none on the zoo's and the inception
    nets' stock pools), each labelled with the card's name and power
    limit."""
    from tensorflow_yolo2_torch.config import (
        LRScheduleConfig,
        OptimizerConfig,
        YoloConfig,
    )
    from tensorflow_yolo2_torch.models import registry
    from tensorflow_yolo2_torch.train.trainer import (
        Trainer,
        softmax_task,
        yolo_task,
    )
    from tensorflow_yolo2_torch.utils.profiling import module_flops_per_image

    out = {}
    for name, size, batch, classes, ema in SLIM_TIMES:
        rng = np.random.RandomState(15)
        if classes is None:  # the YOLOv1 detector and its loss
            yolo = YoloConfig(image_size=size)
            model = registry.get_network(name, image_size=size)
            task = yolo_task(yolo)
            make_batch = functools.partial(train_batch, rng, yolo=yolo)
        else:
            kw = {"aux_logits": True} if name in AUX_NETS else {}
            model = registry.get_network(name, num_classes=classes,
                                         image_size=size, **kw)
            task = softmax_task()
            make_batch = functools.partial(cls_batch, rng,
                                           num_classes=classes, size=size)
        pools = {"darknet19": 5, "yolo1": 4}.get(name, 0)
        flops = 3 * module_flops_per_image(model, size, dev)
        trainer = Trainer(model, task, OptimizerConfig(
            name="rmsprop", weight_decay=4e-5,
            moving_average_decay=0.999 if ema else None,
            schedule=LRScheduleConfig(kind="exponential",
                                      learning_rate=1e-4)),
            device=dev)
        state = trainer.create_state(torch.Generator().manual_seed(0),
                                     fresh_state_dict(model, dev))
        aux = " aux" if name in AUX_NETS else ""
        out[f"{name}_{size}"] = time_train(
            trainer, state, lambda b: make_batch(b), flops,
            f"{name} {size}²{' EMA' if ema else ''}{aux} on {card_line()}",
            (batch,), pools)
        del trainer, state, model
        torch.cuda.empty_cache()
    return out


def run_slim_clis(dev) -> dict:
    """The slim tier's CLIs with ``--device cuda`` on a ``make_flowers``
    tree at 224² under a temporary run root: ``train_classifier`` on its
    defaults (darknet19, rmsprop, weight decay 4e-5) with
    ``--moving-average-decay 0.999 --grad-accum-steps 2
    --save-interval-secs 0.001 --activation-summaries`` (B5 5 times a
    micro-step, a snapshot every iteration with the EMA and the
    accumulation state), ``eval_classifier --use-ema`` on its snapshot
    (no fallback warning), then ``flowers_train`` resuming the run dir
    (B5 5 times a step). Each must exit 0."""
    import tempfile

    from tensorflow_yolo2_torch.entries import (
        eval_classifier,
        flowers_train,
        train_classifier,
    )
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.train.checkpoint import (
        CheckpointManager,
        read_snapshot,
    )
    from tensorflow_yolo2_torch.utils import cuda_build
    from tests import synthetic

    out = {}
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
        synthetic.make_flowers(os.path.join(root, "data", "TF_flowers"),
                               per_class=SLIM_FLOWERS_PER_CLASS)
        common = ["--batch-size", str(SLIM_CLI_BATCH), "--num-workers", "2",
                  "--device", str(dev)]
        cuda_pool.reset_launch_counts()
        text = run_cli(train_classifier.main, [
            "--model-name", "darknet19", "--iters", str(SLIM_CLI_ITERS),
            "--moving-average-decay", "0.999", "--grad-accum-steps", "2",
            "--save-interval-secs", "0.001", "--activation-summaries",
            "--log-every", "2", *common], "train_classifier")
        torch.cuda.synchronize()
        out["train_launches"] = cuda_pool.MAX_POOL2_BWD_LAUNCHES
        mgr = CheckpointManager("darknet19", "tf_flowers")
        snap = read_snapshot(mgr.latest_path())
        out["snapshots"] = mgr.all_steps()
        print(f"train_classifier: snapshots at {out['snapshots']}; "
              f"optimizer count {snap['optimizer']['count']}, mini_step "
              f"{snap['optimizer']['mini_step']}; B5 launched "
              f"{out['train_launches']} times in {SLIM_CLI_ITERS} "
              f"micro-steps")
        check(out["train_launches"] == 5 * SLIM_CLI_ITERS,
              "B5 ran 5 times a train_classifier micro-step")
        check(out["snapshots"] == list(range(1, SLIM_CLI_ITERS + 1)),
              "--save-interval-secs saved every iteration")
        check(snap["optimizer"]["count"] == SLIM_CLI_ITERS // 2 and
              snap["optimizer"]["mini_step"] == 0 and "ema" in snap,
              "the snapshot holds the EMA and the accumulation state")
        check("sparsity/backbone" in text, "activation summaries logged")
        text = run_cli(eval_classifier.main, [
            "--use-ema", "--batch-size", "4", "--max-batches", "2",
            "--device", str(dev)], "eval_classifier --use-ema")
        check("WARNING" not in text and
              f"eval at step {SLIM_CLI_ITERS}:" in text,
              "eval_classifier scored the snapshot's EMA")
        out["eval"] = text.strip().splitlines()[-1]
        cuda_pool.reset_launch_counts()
        run_cli(flowers_train.main, ["--iters", "2", "--eval-every", "1",
                                     "--log-every", "1", *common],
                "flowers_train")
        torch.cuda.synchronize()
        out["flowers_launches"] = cuda_pool.MAX_POOL2_BWD_LAUNCHES
        check(out["flowers_launches"] == 10,
              "B5 ran 5 times a flowers_train step")
    return out


def write_data_mirror(root: str) -> dict:
    """A local mirror of seeded raw datasets under ``root``: a CIFAR-10
    python archive (``cifar-10-python.tar.gz``, its ``file://`` URL) and
    MNIST's four gzipped IDX files; nothing is downloaded."""
    import tarfile

    from tests import synthetic

    cifar = synthetic.make_cifar10(
        os.path.join(root, "mirror", "cifar-10-batches-py"),
        per_batch=DATA_CIFAR_PER_BATCH)
    tarball = os.path.join(root, "mirror", "cifar-10-python.tar.gz")
    with tarfile.open(tarball, "w:gz") as tar:
        tar.add(cifar, "cifar-10-batches-py")
    mnist = synthetic.make_mnist(os.path.join(root, "mirror", "mnist"),
                                 *DATA_MNIST, gz=True)
    return {"cifar10_url": "file://" + tarball, "mnist": mnist}


def run_data_tier_clis(dev) -> dict:
    """The slim data tier and the inception family through the CLIs with
    ``--device cuda``, under a temporary run root: ``download_and_convert``
    of cifar10 from a ``file://`` URL (``write_data_mirror``), of mnist and
    of a flowers tree (``make_flowers``, 224²) from ``--source-dir``; then
    ``train_classifier`` on the prepared cifar10 shards (cifarnet, its
    preprocessing), on mnist (lenet, its preprocessing), on the prepared
    flowers shards (darknet19, its preprocessing; B5 5 times a step), and
    ``--model-name inception_v3 --aux-loss --preprocessing-name
    inception`` on the flowers tree at 299² (``aux_loss`` in its log);
    ``eval_classifier --preprocessing-name inception`` on that snapshot.
    Each must exit 0."""
    import tempfile

    from tensorflow_yolo2_torch.entries import (
        download_and_convert,
        eval_classifier,
        train_classifier,
    )
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.utils import cuda_build
    from tests import synthetic

    out = {}
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
        mirror = write_data_mirror(root)
        flowers = synthetic.make_flowers(
            os.path.join(root, "data", "TF_flowers"),
            per_class=SLIM_FLOWERS_PER_CLASS)
        data = os.path.join(root, "data")
        for name, source in (("cifar10", ["--download-url",
                                          mirror["cifar10_url"]]),
                             ("mnist", ["--source-dir", mirror["mnist"]]),
                             ("flowers", ["--source-dir", flowers])):
            text = run_cli(download_and_convert.main, [
                "--dataset-name", name, "--dataset-dir",
                os.path.join(data, f"{name}_prepared"), *source],
                f"download_and_convert {name}")
            check(f"{name}/train:" in text, f"{name} converted")
        common = ["--batch-size", str(SLIM_CLI_BATCH), "--num-workers", "2",
                  "--iters", str(SLIM_CLI_ITERS), "--log-every", "1",
                  "--device", str(dev)]
        runs = (
            ("cifarnet", ["--dataset-name", "prepared", "--data-path",
                          os.path.join(data, "cifar10_prepared", "train"),
                          "--preprocessing-name", "cifarnet"]),
            ("lenet", ["--dataset-name", "mnist", "--data-path",
                       mirror["mnist"], "--preprocessing-name", "lenet"]),
            ("darknet19", ["--dataset-name", "prepared", "--data-path",
                           os.path.join(data, "flowers_prepared", "train"),
                           "--preprocessing-name", "darknet19"]),
            ("inception_v3", ["--aux-loss", "--image-size",
                              str(DATA_INCEPTION_SIZE),
                              "--preprocessing-name", "inception"]))
        logs = {}
        for model, argv in runs:
            cuda_pool.reset_launch_counts()
            logs[model] = run_cli(train_classifier.main,
                                  ["--model-name", model, *argv, *common],
                                  f"train_classifier {model}")
            torch.cuda.synchronize()
            out[f"{model}_launches"] = cuda_pool.MAX_POOL2_BWD_LAUNCHES
            check(f"iter {SLIM_CLI_ITERS}: loss" in logs[model],
                  f"train_classifier {model} logged its last step")
        print(f"data tier CLIs: B5 launched {out['darknet19_launches']} "
              f"times in {SLIM_CLI_ITERS} darknet19 steps on the prepared "
              f"flowers shards; {out['cifarnet_launches']}, "
              f"{out['lenet_launches']}, {out['inception_v3_launches']} in "
              f"the cifarnet, lenet and inception_v3 runs (their pools are "
              f"stock)")
        check(out["darknet19_launches"] == 5 * SLIM_CLI_ITERS,
              "B5 ran 5 times a darknet19 step on prepared shards")
        check("aux_loss" in logs["inception_v3"],
              "inception_v3 --aux-loss logged aux_loss")
        text = run_cli(eval_classifier.main, [
            "--model-name", "inception_v3", "--preprocessing-name",
            "inception", "--image-size", str(DATA_INCEPTION_SIZE),
            "--batch-size", "4",
            "--max-batches", "2", "--device", str(dev)],
            "eval_classifier inception_v3")
        check(f"eval at step {SLIM_CLI_ITERS}:" in text,
              "eval_classifier scored the inception_v3 snapshot")
        out["eval"] = text.strip().splitlines()[-1]
    return out


def check_slim(dev) -> dict:
    """The slim tier on the card (section 13), each part timed."""
    out = {}
    for name, part in (("clis", run_slim_clis),
                       ("data tier clis", run_data_tier_clis),
                       ("zoo", check_zoo),
                       ("inception fold", check_inception_fold),
                       ("optimizers", check_slim_optimizers),
                       ("accumulation", check_accumulation),
                       ("remat", check_remat),
                       ("times", slim_train_times)):
        t0 = time.perf_counter()
        out[name] = part(dev)
        print(f"slim {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# -- 14. TF checkpoint import and adversarial training ------------------------

TF_DETECT_THRESH = 0.2  # the import check's detect CLI threshold
TF_RESNET_MOVE = 3 * 5e-4  # 2 Adam steps at 5e-4 move a weight at most this
ADV_BATCH = 18  # the reference's adversarial batch
ADV_IRV2_SIZE = 299
ADV_CLI_ITERS = 3
ADV_TIMED_PAIRS = 5
ADV_DARKNET_SIZE = 224
ADV_WARM_PAIRS = 3
ADV_CHECK_IMAGES = 4
ADV_EPSILON = 8 / 255 * 2
# the FGSM signs of the float32 card pair are held to the float64 ones
# where |g64| > ADV_SIGN_THRESH · max|g64|: below, float32 rounding of an
# ill-conditioned input gradient may flip a sign, which is not a fault
# (on the card signs flipped up to 0.113 and 0.038 of the largest value
# in two runs, in the CPU's own float32 pair up to 0.046)
ADV_SIGN_THRESH = 0.25
# the input gradient's relative norm from float64: the CPU's float32 pair
# is printed beside the card's
ADV_GRAD_REL_TOL = 1e-1
ADV_IMAGE_ATOL = 1e-6  # float32 against float64 rounding of x + ε·sign

# numpy dtype → TensorFlow's DataType enum, for the bundle writer
_TF_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
              np.dtype(np.int32): 3, np.dtype(np.uint8): 4,
              np.dtype(np.int16): 5, np.dtype(np.int8): 6,
              np.dtype(np.int64): 9, np.dtype(np.bool_): 10,
              np.dtype(np.float16): 19}


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(number: int, value) -> bytes:
    """A protobuf field: bytes are length-delimited, ints varints."""
    if isinstance(value, bytes):
        return _pb_varint(number << 3 | 2) + _pb_varint(len(value)) + value
    return _pb_varint(number << 3) + _pb_varint(value)


def _table_block(entries: list[tuple[bytes, bytes]]) -> bytes:
    """One leveldb table block of (key, value) pairs in key order, each
    entry a restart point (no shared key prefixes)."""
    body, restarts = bytearray(), []
    for key, value in entries:
        restarts.append(len(body))
        body += (_pb_varint(0) + _pb_varint(len(key)) +
                 _pb_varint(len(value)) + key + value)
    for r in restarts or [0]:
        body += r.to_bytes(4, "little")
    return bytes(body + len(restarts or [0]).to_bytes(4, "little"))


def write_tf_bundle(prefix: str, tensors: dict[str, np.ndarray]) -> None:
    """A TF V2 checkpoint (``prefix.index``, ``prefix.data-00000-of-
    00001``) of ``tensors`` by name, as TensorFlow's ``BundleWriter``
    lays it out: the tensors' little-endian bytes back to back, and a
    table whose key ``""`` holds the ``BundleHeaderProto`` (one shard,
    little-endian, version 1) and every other key a tensor's
    ``BundleEntryProto`` (dtype, shape, offset, size, masked crc32c)."""
    from tensorflow_yolo2_torch.compat.tf_bundle import (
        TABLE_MAGIC,
        crc32c,
        mask_crc,
    )

    header = _pb_field(1, 1) + _pb_field(3, _pb_field(1, 1))
    entries, offset = [(b"", header)], 0
    with open(f"{prefix}.data-00000-of-00001", "wb") as data:
        for name in sorted(tensors):
            a = np.asarray(tensors[name], order="C")
            raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
            shape = b"".join(_pb_field(2, _pb_field(1, d)) for d in a.shape)
            entries.append((name.encode(), (
                _pb_field(1, _TF_DTYPES[a.dtype]) + _pb_field(2, shape) +
                _pb_field(4, offset) + _pb_field(5, len(raw)) +
                _pb_varint(6 << 3 | 5) +
                mask_crc(crc32c(raw)).to_bytes(4, "little"))))
            data.write(raw)
            offset += len(raw)
    table, handles = bytearray(), []
    for block in (_table_block(entries), _table_block([])):
        handles.append(_pb_varint(len(table)) + _pb_varint(len(block)))
        table += block + b"\0" + mask_crc(crc32c(block + b"\0")).to_bytes(
            4, "little")
    index = _table_block([(entries[-1][0], handles[0])])
    index_handle = _pb_varint(len(table)) + _pb_varint(len(index))
    table += index + b"\0" + mask_crc(crc32c(index + b"\0")).to_bytes(
        4, "little")
    footer = handles[1] + index_handle
    table += footer + bytes(40 - len(footer)) + TABLE_MAGIC.to_bytes(
        8, "little")
    with open(f"{prefix}.index", "wb") as f:
        f.write(table)


_TF_BN = (("gamma", "weight"), ("beta", "bias"),
          ("moving_mean", "running_mean"), ("moving_variance", "running_var"))


def _tf_array(t: torch.Tensor) -> np.ndarray:
    """A conv kernel OIHW → HWIO, a dense (out, in) → (in, out), as TF
    lays them out; anything else as it is."""
    t = t.detach().cpu()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    elif t.dim() == 2:
        t = t.t()
    return t.contiguous().numpy()


def tf_darknet19_names(sd: dict) -> dict[str, np.ndarray]:
    """The reference detector's TF variables of a port Darknet19 v1
    detector state dict: the inverse of ``compat.tf_import``'s positional
    names (``darknet19/Variable_<2i>`` kernel, ``Variable_<2i+1>`` bias,
    ``batch_normalization_<i>``; the head's convs in the named scopes
    ``darknet19_detection/conv1..3, output``)."""
    out = {}

    def put(scope: str, var: int, bn: int, module: str) -> None:
        out[f"{scope}/Variable" + (f"_{var}" if var else "")] = _tf_array(
            sd[f"{module}.conv.weight"])
        out[f"{scope}/Variable_{var + 1}"] = _tf_array(
            sd[f"{module}.conv.bias"])
        scope_bn = f"{scope}/batch_normalization" + (f"_{bn}" if bn else "")
        for tf_leaf, leaf in _TF_BN:
            out[f"{scope_bn}/{tf_leaf}"] = _tf_array(sd[f"{module}.bn.{leaf}"])

    for i in range(18):
        put("darknet19", 2 * i, i, f"backbone.conv{i + 1}")
    for name in ("conv1", "conv2", "conv3", "output"):
        put(f"darknet19_detection/{name}", 0, 0, f"detection.{name}")
    return out


def tf_resnet50_trunk_names(sd: dict, prefix: str = ""
                            ) -> dict[str, np.ndarray]:
    """slim's ``resnet_v1_50`` variables of a port ``ResNet50V1`` trunk
    (its keys under ``prefix``): ``conv1/weights`` and ``BatchNorm``,
    ``block<b>/unit_<u>/bottleneck_v1/conv<c>`` and ``shortcut``."""
    scope, out = "resnet_v1_50", {}

    def put(dst: str, conv: str, bn: str) -> None:
        out[f"{dst}/weights"] = _tf_array(sd[f"{prefix}{conv}.weight"])
        for tf_leaf, leaf in _TF_BN:
            out[f"{dst}/BatchNorm/{tf_leaf}"] = _tf_array(
                sd[f"{prefix}{bn}.bn.{leaf}"])

    put(f"{scope}/conv1", "conv1", "conv1_bn")
    for b, units in enumerate((3, 4, 6, 3), start=1):
        for u in range(1, units + 1):
            src, dst = (f"block{b}_unit{u}",
                        f"{scope}/block{b}/unit_{u}/bottleneck_v1")
            for c in (1, 2, 3):
                put(f"{dst}/conv{c}", f"{src}.conv{c}", f"{src}.bn{c}")
            if f"{prefix}{src}.shortcut_conv.weight" in sd:
                put(f"{dst}/shortcut", f"{src}.shortcut_conv",
                    f"{src}.shortcut_bn")
    return out


def check_tf_import(dev) -> dict:
    """The TF checkpoint import at full width, under a temporary run
    root: the 448² v1 detector's seeded weights (``v1_detector``) written
    as a V2 bundle in the reference's names (``write_tf_bundle``); the
    port's import (``compat.tf_import``) equal to them bit for bit; the
    detect CLI with ``--tf-checkpoint --nms --device cuda`` on
    ``assets/demo.jpg`` (drawing recorded), B1 once, its boxes equal to
    ``make_detect_fn``'s from the same weights as a state dict; then a
    seeded ResNet-50 trunk written in slim's names, and
    ``pascal_train_resnet --tf-checkpoint`` for 2 iterations at batch 4
    on a synthetic VOC tree: every trunk tensor warm-started, each trunk
    weight of its snapshot within 2 Adam steps of the written one."""
    import tempfile

    from tensorflow_yolo2_torch.compat.tf_import import (
        import_darknet19_checkpoint,
        state_dict_for,
    )
    from tensorflow_yolo2_torch.data.augment import image_read
    from tensorflow_yolo2_torch.entries import (
        pascal_detect_darknet,
        pascal_train_resnet,
    )
    from tensorflow_yolo2_torch.models.resnet import ResNet50V1
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.train.checkpoint import (
        CheckpointManager,
        read_snapshot,
    )
    from tensorflow_yolo2_torch.utils import cuda_build
    from tests import synthetic

    out = {}
    yolo, state = v1_detector()
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
        prefix = os.path.join(root, "darknet19_pascal.ckpt")
        t0 = time.perf_counter()
        write_tf_bundle(prefix, tf_darknet19_names(state))
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        imported = state_dict_for(import_darknet19_checkpoint(prefix))
        out["import_s"] = time.perf_counter() - t0
        written = {k: v for k, v in state.items()
                   if not k.endswith("num_batches_tracked")}
        check(set(imported) == set(state) and all(
            torch.equal(imported[k], v) for k, v in written.items()),
            "the imported detector equals the written arrays bit for bit")
        print(f"TF import, v1 448² detector: {len(written)} tensors, "
              f"{os.path.getsize(prefix + '.data-00000-of-00001') / 2**20:.1f}"
              f" MiB written in {out['write_s']:.2f} s, imported in "
              f"{out['import_s']:.2f} s, bit-equal")
        drawn = []

        def record(path, boxes, scores, classes, names, out_path=None):
            drawn.append((boxes, scores, classes))
            return os.path.join(root, "detections.png")

        cd.reset_launch_counts()
        with mock.patch.object(pascal_detect_darknet, "draw_detections",
                               record):
            run_cli(pascal_detect_darknet.main,
                    [DEMO, "--tf-checkpoint", prefix, "--nms",
                     "--image-size", "448", "--threshold",
                     str(TF_DETECT_THRESH), "--device", str(dev)],
                    "pascal_detect_darknet --tf-checkpoint --nms")
        torch.cuda.synchronize()
        out["detect_launches"] = cd.DECODE_NMS_LAUNCHES
        check(out["detect_launches"] == 1, "the detect CLI launched B1 once")
        detect = pascal_detect_darknet.make_detect_fn(
            yolo, state, TF_DETECT_THRESH, use_nms=True, device=dev)
        want = [t[0].cpu().numpy()
                for t in detect(image_read(DEMO, yolo.image_size)[None])]
        (got,) = drawn
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              "the CLI's detections from the TF checkpoint equal those of "
              "the state dict")
        out["detect_kept"] = int((want[1] > 0).sum())
        print(f"pascal_detect_darknet --tf-checkpoint: {out['detect_kept']} "
              f"boxes at {TF_DETECT_THRESH}, equal to make_detect_fn's on "
              f"the state dict")
        del detect, imported

        trunk = random_weights_(ResNet50V1(), torch.Generator().manual_seed(
            3)).state_dict()
        names = tf_resnet50_trunk_names(trunk)
        rprefix = os.path.join(root, "resnet_v1_50.ckpt")
        write_tf_bundle(rprefix, names)
        synthetic.make_voc(os.path.join(root, "data", "VOCdevkit"),
                           n_images=VOC_TREE_IMAGES)
        text = run_cli(pascal_train_resnet.main,
                       ["--iters", "2", "--batch-size", str(RESNET_CLI_BATCH),
                        "--save-every", "2", "--log-every", "1",
                        "--num-workers", "2", "--device", str(dev),
                        "--tf-checkpoint", rprefix],
                       "pascal_train_resnet --tf-checkpoint")
        n_stats = sum(k.endswith(("moving_mean", "moving_variance"))
                      for k in names)
        check(f"Warm-started {len(names) - n_stats} param + {n_stats} "
              f"batch-stat tensors" in text,
              "pascal_train_resnet warm-started every trunk tensor")
        snap = read_snapshot(CheckpointManager("resnet50", "voc_2007")
                             .latest_path())["model"]
        params = [k for k in trunk if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))]
        out["resnet_trunk_max_move"] = max(
            (snap[f"backbone.{k}"] - trunk[k]).abs().max().item()
            for k in params)
        print(f"pascal_train_resnet --tf-checkpoint: {len(names)} trunk "
              f"tensors imported; after 2 Adam steps the trunk weights are "
              f"within {out['resnet_trunk_max_move']:.2e} of the written "
              f"ones (bound {TF_RESNET_MOVE:.1e})")
        check(out["resnet_trunk_max_move"] <= TF_RESNET_MOVE,
              "the snapshot's trunk is the imported one, 2 steps on")
        del snap
    return out


def adversarial_trainer(backbone: str, size: int, dtype: torch.dtype, dev,
                        grouped: bool = False, state_dict=None,
                        double: bool = False):
    """The adversarial entry's classifier (``ContrastInputModel`` around
    ``backbone``, 1000 classes at ``size``²) and trainer (momentum 0.9 at
    1e-3, or the grouped Adam optimizers), its state from seed 0 or
    ``state_dict``; ``double``: the model in float64 before its state is
    made (the float64 reference)."""
    from tensorflow_yolo2_torch.config import (
        LRScheduleConfig,
        OptimizerConfig,
    )
    from tensorflow_yolo2_torch.entries.imagenet_train_adversarial import (
        grouped_tx_factory,
    )
    from tensorflow_yolo2_torch.models.contrast import ContrastInputModel
    from tensorflow_yolo2_torch.models.registry import get_network
    from tensorflow_yolo2_torch.train.trainer import Trainer, softmax_task

    model = ContrastInputModel(get_network(backbone, num_classes=CLS_CLASSES,
                                           image_size=size))
    if double:
        model.double()
    trainer = Trainer(
        model, softmax_task(),
        OptimizerConfig(name="momentum", momentum=0.9,
                        schedule=LRScheduleConfig(learning_rate=1e-3)),
        device=dev, compute_dtype=dtype,
        tx_factory=grouped_tx_factory(1e-3) if grouped else None)
    return trainer, trainer.create_state(torch.Generator().manual_seed(0),
                                         state_dict)


def time_pairs(pair, label: str, batch: int) -> dict:
    """images/s of an adversarial pair (``pair()``: a clean step, the
    attack, the adversarial step) on a batch already on the card, host
    clock around pairs that end in a synchronize; then a profile."""
    pair()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ADV_TIMED_PAIRS):
        pair()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / ADV_TIMED_PAIRS
    prof = profile_call(pair, f"adversarial pair {label}", top=16)
    out = {"ms_per_pair": dt * 1e3, "images_per_s": batch / dt,
           "idle_share": prof["idle_share"], "kernels_ms": prof["kernels_ms"],
           "idle_share_unprofiled": 1 - prof["kernels_ms"] / (dt * 1e3),
           "card": card_line()}
    print(f"adversarial pair {label}, batch {batch}: {dt * 1e3:.1f} ms a "
          f"pair, {batch / dt:.1f} images/s (clean images a second; each "
          f"passes a train step, the attack and an adversarial step); "
          f"{prof['kernels_ms']:.1f} ms of kernels: idle share "
          f"{out['idle_share_unprofiled']:.3f} unprofiled "
          f"({prof['idle_share']:.3f} profiled); {card_line()}")
    return out


def pair_parts(trainer, state, images, labels, attack_model=None,
               adv_images=None) -> dict:
    """One adversarial pair (``train.adversarial``) with its attack's
    images and input gradient kept: the clean and adversarial losses, the
    FGSM images, and the gradient FGSM took the signs of. With
    ``adv_images`` the adversarial step takes those in place of the
    attack's own (which are kept all the same)."""
    from tensorflow_yolo2_torch.train.adversarial import (
        adversarial_train_step_pair,
        fgsm,
        make_attack_loss,
    )

    seen = {}

    def attack(x, y):
        loss = make_attack_loss(attack_model or state.model, y,
                                trainer.compute_dtype)

        def keep_gradient(images):
            images.register_hook(lambda g: seen.update(grad=g.detach()))
            return loss(images)

        seen["adv"] = fgsm(keep_gradient, x, ADV_EPSILON)
        return seen["adv"] if adv_images is None else adv_images

    _, clean, adv = adversarial_train_step_pair(
        trainer, state, images, labels, ADV_EPSILON, attack_fn=attack)
    return {"clean_loss": clean["loss"].item(),
            "adv_loss": adv["loss"].item(), **seen}


def check_pair_against_float64(state_dict: dict, images: torch.Tensor,
                               labels: torch.Tensor, dev) -> dict:
    """One adversarial pair of the white-box Darknet19 classifier from the
    weights of ``state_dict``: float32 on the card (TF32 off) against
    float64 on the CPU. The clean losses to LOSS_REL_TOL; the attack's
    input gradient to ADV_GRAD_REL_TOL (the CPU's own float32 pair is
    printed beside it); the FGSM images where the float64 input gradient
    is firm (|g| > ADV_SIGN_THRESH · max|g|) to ADV_IMAGE_ATOL, i.e. the
    same signs there; the
    adversarial step's losses to LOSS_REL_TOL, the float64 step taking
    the card's adversarial images (a sign flipped where the gradient is
    not firm moves a pixel by 2ε, and the loss with it: not a fault of
    the arithmetic). The float64 step on its own images is printed
    beside it."""
    cpu = torch.device("cpu")
    trainer, state = adversarial_trainer("darknet19", ADV_DARKNET_SIZE,
                                         torch.float32, dev,
                                         state_dict=state_dict)
    card = pair_parts(trainer, state, images.float().to(dev), labels.to(dev))
    del trainer, state
    t64, s64 = adversarial_trainer("darknet19", ADV_DARKNET_SIZE,
                                   torch.float32, cpu, state_dict=state_dict,
                                   double=True)
    adv32 = card["adv"].double().cpu()
    ref = pair_parts(t64, s64, images.double().cpu(), labels.cpu(),
                     adv_images=adv32)
    t64, s64 = adversarial_trainer("darknet19", ADV_DARKNET_SIZE,
                                   torch.float32, cpu, state_dict=state_dict,
                                   double=True)
    own = pair_parts(t64, s64, images.double().cpu(), labels.cpu())
    t32, s32 = adversarial_trainer("darknet19", ADV_DARKNET_SIZE,
                                   torch.float32, cpu, state_dict=state_dict)
    cpu32 = pair_parts(t32, s32, images.float().cpu(), labels.cpu())
    del t64, s64, t32, s32
    adv64, g64 = ref["adv"], ref["grad"]
    ratio = g64.abs() / g64.abs().max()
    firm = ratio > ADV_SIGN_THRESH
    flipped = (adv32 - adv64).abs() > ADV_IMAGE_ATOL

    def grad_err(g):
        return ((g.double().cpu() - g64).norm() / g64.norm()).item()

    def flip_ratio(adv):
        wrong = (adv.double().cpu() - adv64).abs() > ADV_IMAGE_ATOL
        return ratio[wrong].max().item() if wrong.any() else 0.0

    out = {
        "clean_loss": card["clean_loss"], "clean_loss64": ref["clean_loss"],
        "clean_loss_rel_err": abs(card["clean_loss"] - ref["clean_loss"]) /
        abs(ref["clean_loss"]),
        "adv_loss": card["adv_loss"], "adv_loss64": ref["adv_loss"],
        "adv_loss_rel_err": abs(card["adv_loss"] - ref["adv_loss"]) /
        abs(ref["adv_loss"]),
        "adv_loss64_own_images": own["adv_loss"],
        "input_grad_rel_err": grad_err(card["grad"]),
        "cpu_f32_input_grad_rel_err": grad_err(cpu32["grad"]),
        "cpu_f32_largest_flipped_ratio": flip_ratio(cpu32["adv"]),
        "firm_share": firm.double().mean().item(),
        "flips": int(flipped.sum()), "flips_firm": int((flipped & firm).sum()),
        "largest_flipped_ratio": flip_ratio(card["adv"]),
        "sign_thresh": ADV_SIGN_THRESH,
        "images_max_abs_err_firm": (adv32 - adv64)[firm].abs().max().item()}
    print(f"adversarial pair, float32 card (TF32 off) vs float64 CPU, batch "
          f"{len(images)}, {ADV_DARKNET_SIZE}²: clean loss "
          f"{out['clean_loss']:.6f} vs {out['clean_loss64']:.6f} (rel. "
          f"{out['clean_loss_rel_err']:.2e}, bound {LOSS_REL_TOL}); input "
          f"gradient rel. err {out['input_grad_rel_err']:.2e} (bound "
          f"{ADV_GRAD_REL_TOL}; the CPU's float32 pair "
          f"{out['cpu_f32_input_grad_rel_err']:.2e}, its largest flipped "
          f"|g64| / max {out['cpu_f32_largest_flipped_ratio']:.2e}); FGSM "
          f"images: {out['flips']} of {adv64.numel()} values on the other "
          f"side (sign flips), {out['flips_firm']} of them where |g64| > "
          f"{ADV_SIGN_THRESH} max|g64| ({out['firm_share']:.3f} of the "
          f"values), the largest flipped |g64| / max "
          f"{out['largest_flipped_ratio']:.2e}; adversarial step's loss "
          f"{out['adv_loss']:.6f} vs {out['adv_loss64']:.6f} on the same "
          f"images (rel. {out['adv_loss_rel_err']:.2e}, bound "
          f"{LOSS_REL_TOL}), float64 on its own images "
          f"{out['adv_loss64_own_images']:.6f}")
    check(out["clean_loss_rel_err"] <= LOSS_REL_TOL,
          "float32 clean loss of the pair vs float64")
    check(out["input_grad_rel_err"] <= ADV_GRAD_REL_TOL,
          "float32 input gradient of the attack vs float64")
    check(out["flips_firm"] == 0 and
          out["images_max_abs_err_firm"] <= ADV_IMAGE_ATOL,
          "FGSM images vs float64 where the input gradient is firm")
    check(out["adv_loss_rel_err"] <= LOSS_REL_TOL,
          "float32 adversarial step's loss vs float64 on the same images")
    return out


def check_adversarial(dev) -> dict:
    """Adversarial training at full width: the CLI
    (``imagenet_train_adversarial``: Inception-ResNet-v2 at 299², batch
    18, ``--attack-model inception_v3 --grouped-opt``, 3 iterations, a
    validation batch every 2) on the ``write_ilsvrc_tree`` tree: exit 0,
    the snapshot, both streams with ``clean/`` and ``adv/`` keys; a timed
    pair of that configuration; the white-box Darknet19 classifier at
    224², batch 18, bf16: B5 15 times a pair (5 in the clean step, 5 in
    the FGSM input gradient, 5 in the adversarial step), a timed pair;
    then one pair in float32 against float64
    (``check_pair_against_float64``) from the weights those pairs
    reached."""
    import tempfile

    from tensorflow_yolo2_torch.entries import imagenet_train_adversarial
    from tensorflow_yolo2_torch.models.darknet import init_params_
    from tensorflow_yolo2_torch.models.registry import get_network
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.train.adversarial import (
        adversarial_train_step_pair,
        make_attack,
    )
    from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
    from tensorflow_yolo2_torch.utils import cuda_build

    out = {}
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
        write_ilsvrc_tree(os.path.join(root, "data", "ILSVRC"),
                          np.random.RandomState(16))
        run_cli(imagenet_train_adversarial.main,
                ["--backbone", "inception_resnet_v2", "--image-size",
                 str(ADV_IRV2_SIZE), "--attack-model", "inception_v3",
                 "--grouped-opt", "--batch-size", str(ADV_BATCH),
                 "--iters", str(ADV_CLI_ITERS), "--eval-every", "2",
                 "--log-every", "1", "--save-every", str(ADV_CLI_ITERS),
                 "--num-workers", "2", "--device", str(dev)],
                "imagenet_train_adversarial inception_resnet_v2 299² "
                "--attack-model inception_v3 --grouped-opt")
        name = "inception_resnet_v2_adv"
        check(CheckpointManager(name, "ilsvrc_2017_cls").all_steps() ==
              [ADV_CLI_ITERS], f"the adversarial CLI saved train_iter_"
                               f"{ADV_CLI_ITERS}")
        streams = {}
        for split in ("train", "val"):
            path = os.path.join(root, "tensorboard", name, "ilsvrc_2017_cls",
                                split, "events.jsonl")
            with open(path) as f:
                recs = [json.loads(line) for line in f]
            keys = sorted({k for r in recs for k in r
                           if k.startswith(("clean/", "adv/"))})
            streams[split] = {"records": len(recs), "keys": keys}
            check(len(recs) >= 1 and all(
                k in keys for k in ("clean/loss", "clean/accuracy",
                                    "adv/loss", "adv/accuracy")),
                f"the {split} stream holds clean/ and adv/ metrics")
        out["cli_streams"] = streams
        print(f"adversarial CLI streams: {streams}")

    rng = np.random.RandomState(17)
    images, labels = (torch.from_numpy(a).to(dev) for a in cls_batch(
        rng, ADV_BATCH, num_classes=CLS_CLASSES, size=ADV_IRV2_SIZE))
    images = images.float() / 255.0 * 2.0 - 1.0
    trainer, state = adversarial_trainer("inception_resnet_v2",
                                         ADV_IRV2_SIZE, torch.bfloat16, dev,
                                         grouped=True)
    gen = get_network("inception_v3", num_classes=CLS_CLASSES,
                      image_size=ADV_IRV2_SIZE)
    init_params_(gen, torch.Generator().manual_seed(1))
    gen.to(dev, memory_format=torch.channels_last).requires_grad_(False)
    attack = make_attack(gen, ADV_EPSILON, torch.bfloat16)
    out["irv2_299_transfer_grouped"] = time_pairs(
        lambda: adversarial_train_step_pair(trainer, state, images, labels,
                                            ADV_EPSILON, attack),
        f"inception_resnet_v2 {ADV_IRV2_SIZE}², inception_v3 attack, "
        f"grouped Adam, bf16", ADV_BATCH)
    del trainer, state, gen, attack, images

    images, labels = (torch.from_numpy(a).to(dev) for a in cls_batch(
        rng, ADV_BATCH, num_classes=CLS_CLASSES, size=ADV_DARKNET_SIZE))
    images = images.float() / 255.0 * 2.0 - 1.0
    trainer, state = adversarial_trainer("darknet19", ADV_DARKNET_SIZE,
                                         torch.bfloat16, dev)
    losses = []
    for _ in range(ADV_WARM_PAIRS):
        state, clean, adv = adversarial_train_step_pair(
            trainer, state, images, labels, ADV_EPSILON)
        losses.append((clean["loss"].item(), adv["loss"].item()))
    torch.cuda.synchronize()
    cuda_pool.reset_launch_counts()
    state, clean, adv = adversarial_train_step_pair(
        trainer, state, images, labels, ADV_EPSILON)
    torch.cuda.synchronize()
    out["launches_adversarial_pair"] = cuda_pool.MAX_POOL2_BWD_LAUNCHES
    print(f"white-box adversarial pairs, darknet19 {ADV_DARKNET_SIZE}², "
          f"batch {ADV_BATCH}, bf16: (clean, adversarial) losses "
          f"{losses}; B5 launched {out['launches_adversarial_pair']} times "
          f"in one pair")
    check(out["launches_adversarial_pair"] == 15,
          "B5 ran 15 times an adversarial pair (clean step, FGSM input "
          "gradient, adversarial step)")
    check(all(math.isfinite(v) for pair in losses for v in pair),
          "finite adversarial losses")
    out["darknet19_224_white_box"] = time_pairs(
        lambda: adversarial_train_step_pair(trainer, state, images, labels,
                                            ADV_EPSILON),
        f"darknet19 {ADV_DARKNET_SIZE}², white-box, momentum, bf16",
        ADV_BATCH)
    trained = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    del trainer, state
    out["float64_pair"] = check_pair_against_float64(
        trained, images[:ADV_CHECK_IMAGES], labels[:ADV_CHECK_IMAGES], dev)
    return out


def card_grid(yolo, state, images, dev, pallas_stem: bool = False,
              dtype: torch.dtype = torch.bfloat16, **head) -> torch.Tensor:
    """The ``dtype`` detector's float32 grid of a uint8 batch, on the
    card; with ``pallas_stem``, through the stem kernel of ``dtype`` (B4,
    B4-f32) and the rest of the detector, as
    ``make_detect_fn(pallas_stem=True)`` runs it."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        build_detector,
        stem_weights,
    )
    from tensorflow_yolo2_torch.ops.cuda_stem import fused_detect_forward
    from tensorflow_yolo2_torch.utils.device import device_normalize

    model = build_detector(yolo, state, dtype=dtype, device=dev, **head)
    x = device_normalize(images.to(dev)).to(dtype)
    with torch.inference_mode():
        if pallas_stem:
            return fused_detect_forward(model, x, stem_weights(state, dev))
        return model(x)


def grid_rel_err(yolo, state, images, dev, pallas_stem: bool = False,
                 dtype: torch.dtype = torch.bfloat16, **head) -> float:
    """One image's grid, ``dtype`` on the card (through the stem kernel
    with ``pallas_stem``) against float32 on the CPU (BN unfolded, the
    stock stem), as a relative norm error."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        build_detector,
    )

    on_card = card_grid(yolo, state, images[:1], dev, pallas_stem, dtype,
                        **head).cpu().double()
    model = build_detector(yolo, state, fold_bn=False, dtype=torch.float32,
                           device="cpu", **head)
    with torch.inference_mode():
        on_cpu = model(images[:1].float() / 255.0 * 2.0 - 1.0).double()
    return ((on_card - on_cpu).norm() / on_cpu.norm()).item()


def serving_images() -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded uint8 batches of the serving paths: 448² and 416²."""
    rng = np.random.RandomState(0)
    return tuple(torch.from_numpy(rng.randint(
        0, 256, (max(PATH_BATCHES), size, size, 3)).astype(np.uint8))
        for size in (448, 416))


def v1_detector():
    """The v1 448² detector (S=14, B=2, C=20) with seeded weights: its
    config and state dict."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        randomize_,
    )

    yolo = YoloConfig(S=14, image_size=448)
    model = Darknet19Detector(output_channels=yolo.cell_channels)
    state = randomize_(model, torch.Generator().manual_seed(0)).state_dict()
    # larger w, h roots (channels 24-25, 28-29: boxes ~0.3 wide, several
    # cells at S=14) so that neighbouring boxes overlap and NMS has work
    state["detection.output.bn.bias"][[24, 25, 28, 29]] += 0.5
    return yolo, state


def v2_detector(passthrough: bool):
    """YOLOv2's VOC detector at 416² (S=13, B=5, C=20: 125 channels), the
    passthrough head or the linear-output ``--v2`` head, with seeded
    weights: its config and state dict."""
    from tensorflow_yolo2_torch.config import yolo_v2_config
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
        randomize_,
    )

    v2cfg = yolo_v2_config(416)
    model = (Darknet19DetectorV2(v2cfg.cell_channels) if passthrough
             else Darknet19Detector(v2cfg.cell_channels, bn_on_output=False))
    state = randomize_(model, torch.Generator().manual_seed(1)).state_dict()
    # a trained head's logits stay near its biases: scale the linear
    # output conv, make every slot confident (conf logit +2) and class 0
    # likely (+4), so that the grid keeps boxes at 0.05 and 0.5
    state["detection.output.conv.weight"] *= 0.1
    bias = state["detection.output.conv.bias"].view(5, 25)
    bias[:, 4] += 2.0
    bias[:, 5] += 4.0
    return v2cfg, state


# ``--decode-ab``: B1, B2 and B3 from several decode sources, side by side
DECODE_AB_BATCHES = (1, 32, BATCH)
DECODE_AB_THRESHOLDS = (0.5, 0.05)
DECODE_AB_KS = (K, 1)
DECODE_AB_GRID_S = (7, 14)  # B3's grids: synthetic 224², the real 448²


def kernel_registers(log: str, kernel: str) -> dict[str, str]:
    """ptxas's registers and spills for each instance of ``kernel`` in a
    build's output, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and ("registers" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         .strip()).strip()
    return out


def decode_ab(sources: list[str], card: str) -> int:
    """Builds each decode source (csrc/decode.cu first), prints ptxas's
    registers and spills for ``decode_nms_kernel`` and
    ``decode_grid_kernel`` and, where the source exports it, the launch
    geometry and blocks an SM at v1 448² and v2p 416²; holds each
    source's B1 and B2 to their plain versions on the real v1 448² and
    v2p 416² grids at batch 256 (thresholds 0.05 and 0.5, K=32 and K=n,
    class-aware NMS on and off), and its B3 to ``decode_grid_plain`` on a
    synthetic S=7 grid and the real v1 448² grid (S=14) at
    DECODE_AB_THRESHOLDS × DECODE_AB_BATCHES; prints how many candidates
    an image has and how many the greedy scan visits before its K-th
    pick; then times B1 and B2 of every source in AB_ROUNDS rounds, in
    turns (CUDA-graph replays), at each of DECODE_AB_THRESHOLDS ×
    DECODE_AB_KS × DECODE_AB_BATCHES, and B3 at each of DECODE_AB_GRID_S
    × DECODE_AB_THRESHOLDS × DECODE_AB_BATCHES. Prints a line a cell,
    then one JSON object. Returns 1 if a source fails its check, else
    0."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.ops.boxes import decode_grid_v2
    from tensorflow_yolo2_torch.utils import cuda_build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    logs = cuda_build.build(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(sources)} "
          f"sources")
    libs, rows = {}, {}
    for src in sources:
        libs[src] = cd.bind(ctypes.CDLL(cuda_build.library_path(src)))
        rows[src] = {"source": src, "registers": kernel_registers(
            logs[src], "decode_nms_kernel") | kernel_registers(
            logs[src], "decode_grid_kernel")}
        for name, regs in rows[src]["registers"].items():
            print(f"[{src}] {name}: {regs}")
        if hasattr(libs[src], "tfy2_decode_nms_occupancy"):
            rows[src]["geometry"] = {}
            for head, shape in (("v1 448²", (14, 2, 20, 0)),
                                ("v2p 416²", (13, 5, 20, 1))):
                out = (ctypes.c_int * 4)()
                err = libs[src].tfy2_decode_nms_occupancy(*shape, out)
                check(err == 0, f"tfy2_decode_nms_occupancy {shape}")
                geo = dict(zip(("threads", "smem_bytes", "chunks",
                                "blocks_per_sm"), out))
                rows[src]["geometry"][head] = geo
                print(f"[{src}] {head}: {geo}")

    images, v2_images = serving_images()
    yolo, v1_state = v1_detector()
    v2cfg, v2_state = v2_detector(passthrough=True)
    heads = {
        "decode_nms": (yolo, card_grid(yolo, v1_state, images[:BATCH], dev),
                       cd.decode_nms_plain),
        "decode_nms_v2": (v2cfg, card_grid(v2cfg, v2_state,
                                           v2_images[:BATCH], dev, v2=True,
                                           passthrough=True),
                          cd.decode_nms_v2_plain)}
    stats = {}
    for name, (cfg, grid, plain) in heads.items():
        n = cfg.S * cfg.S * cfg.B
        for thresh in DECODE_AB_THRESHOLDS:
            dense = (decode_grid_v2(grid, cfg, thresh) if cfg.per_slot_classes
                     else cd.decode_grid_plain(grid, cfg, thresh))
            alive = dense.scores.sort(dim=1, descending=True).values
            m = (alive > 0).sum(1)
            kept = plain(grid, cfg, thresh, 0.5, K).scores
            # the scan's last candidate: the K-th pick, or the end
            last = kept[:, -1:].clamp(min=1e-30)
            visited = torch.where(kept[:, -1] > 0, (alive >= last).sum(1), m)
            survivors = (plain(grid, cfg, thresh, 0.5, n).scores > 0).sum(1)
            stats[f"{name} {thresh}"] = s = {
                "candidates": m.float().mean().item(),
                "visited_before_kth_pick": visited.float().mean().item(),
                "survivors_at_k_n": survivors.float().mean().item()}
            print(f"{name}, threshold {thresh}: {s['candidates']:.1f} "
                  f"candidates an image, the scan visits "
                  f"{s['visited_before_kth_pick']:.1f} up to its {K}th pick "
                  f"(at or above its score), {s['survivors_at_k_n']:.1f} "
                  f"survive NMS at K=n")

    ok = True
    for name, (cfg, grid, plain) in heads.items():
        n = cfg.S * cfg.S * cfg.B
        for thresh, k, class_aware in itertools.product(
                DECODE_AB_THRESHOLDS, (K, n), (True, False)):
            want = plain(grid, cfg, thresh, 0.5, k, class_aware)
            for src, lib in libs.items():
                with mock.patch.object(cd, "_lib", lambda: lib):
                    try:
                        compare_kept(cd.decode_nms_fused(
                            grid, cfg, thresh, 0.5, k, class_aware), want,
                            name)
                    except RuntimeError as e:
                        print(f"[{src}] {e} (threshold {thresh}, K={k}, "
                              f"class_aware {class_aware})")
                        rows[src]["check"] = False
                        ok = False
        torch.cuda.synchronize()
    dense_grids = {  # B3's grids: S → (config, grid)
        7: (YoloConfig(S=7, image_size=224), torch.from_numpy(
            synthetic_grid(YoloConfig(S=7, image_size=224), BATCH, 7)
        ).to(dev)),
        14: (yolo, heads["decode_nms"][1])}
    for (S, (cfg, grid)), thresh, batch in itertools.product(
            dense_grids.items(), DECODE_AB_THRESHOLDS, DECODE_AB_BATCHES):
        want = cd.decode_grid_plain(grid[:batch], cfg, thresh)
        for src, lib in libs.items():
            with mock.patch.object(cd, "_lib", lambda: lib):
                try:
                    compare_dense(cd.decode_grid_fused(grid[:batch], cfg,
                                                       thresh), want)
                except RuntimeError as e:
                    print(f"[{src}] {e} (S={S}, threshold {thresh}, batch "
                          f"{batch})")
                    rows[src]["check"] = False
                    ok = False
    torch.cuda.synchronize()
    for row in rows.values():
        row.setdefault("check", True)

    cells = []
    for (name, (cfg, grid, _)), thresh, k, batch in itertools.product(
            heads.items(), DECODE_AB_THRESHOLDS, DECODE_AB_KS,
            DECODE_AB_BATCHES):
        g = grid[:batch]
        runs = {src: [] for src in sources}
        for r in range(AB_ROUNDS):
            for src in (sources if r % 2 == 0 else sources[::-1]):
                with mock.patch.object(cd, "_lib", lambda: libs[src]):
                    runs[src].append(graph_ms(lambda: cd.decode_nms_fused(
                        g, cfg, thresh, 0.5, k)))
        means = {src: sum(v) / len(v) for src, v in runs.items()}
        cells.append({"kernel": name, "threshold": thresh, "K": k,
                      "batch": batch, "us": {s: t * 1e3 for s, t in
                                             means.items()},
                      "runs_us": {s: [t * 1e3 for t in v]
                                  for s, v in runs.items()}})
        print(f"{name}, threshold {thresh}, K={k}, batch {batch}: " + ", ".join(
            f"{os.path.basename(src)} {means[src] * 1e3:.2f} us"
            for src in sources))
    for (S, (cfg, grid)), thresh, batch in itertools.product(
            dense_grids.items(), DECODE_AB_THRESHOLDS, DECODE_AB_BATCHES):
        g = grid[:batch]
        runs = {src: [] for src in sources}
        for r in range(AB_ROUNDS):
            for src in (sources if r % 2 == 0 else sources[::-1]):
                with mock.patch.object(cd, "_lib", lambda: libs[src]):
                    runs[src].append(graph_ms(lambda: cd.decode_grid_fused(
                        g, cfg, thresh)))
        means = {src: sum(v) / len(v) for src, v in runs.items()}
        cells.append({"kernel": "decode_grid", "S": S, "threshold": thresh,
                      "batch": batch, "us": {s: t * 1e3 for s, t in
                                             means.items()},
                      "runs_us": {s: [t * 1e3 for t in v]
                                  for s, v in runs.items()},
                      "bound_us": decode_bound(cfg, batch)[0] * 1e3})
        print(f"decode_grid, S={S}, threshold {thresh}, batch {batch}: "
              + ", ".join(f"{os.path.basename(src)} {means[src] * 1e3:.2f} "
                          f"us" for src in sources)
              + f" (bound {cells[-1]['bound_us']:.2f} us)")
    print(json.dumps({"card": card, "sources": list(rows.values()),
                      "scan": stats, "cells": cells}))
    return 0 if ok else 1


# -- parallelism (section 15): a world-1 NCCL group ------------------------

PAR_TRAIN_BATCH = 8  # the spatial live steps' batch
PAR_CLI_TIMEOUT = 300


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world1_group():
    """A world-1 NCCL process group in this process, started as the
    entries start one (``parallel.mesh.maybe_initialize_distributed``
    from torchrun's variables), destroyed after; it must start (no
    fallback)."""
    import torch.distributed as dist

    from tensorflow_yolo2_torch.parallel.mesh import (
        maybe_initialize_distributed,
    )

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    with mock.patch.dict(os.environ, env):
        check(maybe_initialize_distributed("cuda"),
              "a world-1 NCCL group started from torchrun's variables")
        check(dist.get_backend() == "nccl", "the group is NCCL's")
        try:
            yield
        finally:
            dist.destroy_process_group()


def rel_all(got: dict, want: dict) -> float:
    """Relative norm error of all tensors of ``want`` as one vector."""
    return rel_norm(torch.cat([got[k].double().cpu().ravel() for k in want]),
                    torch.cat([want[k].double().cpu().ravel()
                               for k in want]))


def check_dp(dev, weights: dict, images, labels) -> dict:
    """The data-parallel ``Trainer`` step on a (1, 1) mesh (BatchNorm
    synced over the data axis, gradients and metrics all-reduced,
    ``put_batch``) on the v1 224² detector from ``weights`` (section 6's,
    after its steps), batch 24: a bf16 step (B5 5 times); the float32
    step on the card (TF32 off) against the plain float64 step on the CPU
    with the bounds of every float32 step check
    (``check_train_step_against_cpu``: this trunk's float32 gradients are
    ~1e-2 from float64 by rounding alone, whichever float32 arithmetic
    computes them, so the DP step is held to float64, not to the plain
    float32 step, whose distance from it is printed); then both steps'
    images/s at batch 24 and 64 with the idle share."""
    from tensorflow_yolo2_torch.config import YoloConfig
    from tensorflow_yolo2_torch.models.darknet import Darknet19Detector
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.parallel.mesh import MeshConfig, make_mesh
    from tensorflow_yolo2_torch.train.trainer import Trainer, yolo_task

    yolo = YoloConfig()
    mesh = make_mesh(MeshConfig(data=1, model=1))
    check(mesh is not None and tuple(mesh.shape) == (1, 1),
          "a (1, 1) DeviceMesh")

    def build(dtype, where, state_dict=None, on_mesh=True):
        on_card = torch.device(where).type == "cuda"
        t = Trainer(Darknet19Detector(yolo.cell_channels), yolo_task(yolo),
                    device=where, compute_dtype=dtype,
                    mesh=mesh if on_mesh and on_card else None)
        return t, t.create_state(torch.Generator().manual_seed(0),
                                 state_dict)

    dp, dp_state = build(torch.bfloat16, dev, weights)
    cuda_pool.reset_launch_counts()
    dp_state, metrics = dp.train_step(dp_state, images, labels)
    torch.cuda.synchronize()
    out = {"launches": cuda_pool.MAX_POOL2_BWD_LAUNCHES}
    print(f"DP step, v1 224² bf16, batch {len(images)}, (1, 1) mesh: loss "
          f"{metrics['loss'].item():.4f}; B5 {out['launches']} launches")
    check(out["launches"] == 5, "B5 ran 5 times a data-parallel step")
    check(math.isfinite(metrics["loss"].item()), "finite DP loss")
    dp_loss, dp_grads = step_grads(build, torch.float32, dev, weights,
                                   images, labels)
    pl_loss, pl_grads = step_grads(
        functools.partial(build, on_mesh=False), torch.float32, dev,
        weights, images, labels)
    out["vs_plain_f32"] = {"loss_rel": abs(dp_loss - pl_loss) / abs(pl_loss),
                           "all_grads_rel": rel_all(dp_grads, pl_grads)}
    print(f"DP step vs the plain step, both float32 on the card (TF32 "
          f"off): loss {out['vs_plain_f32']['loss_rel']:.3e}, all gradients "
          f"{out['vs_plain_f32']['all_grads_rel']:.3e} (relative norm; "
          f"printed, float32 rounding alone is ~1e-2 here)")
    out["vs_float64"] = check_train_step_against_cpu(build, images, labels,
                                                     dev, weights)
    del dp_grads, pl_grads
    plain, plain_state = build(torch.bfloat16, dev, weights, on_mesh=False)
    trng = np.random.RandomState(22)
    flops = 3 * conv_flops_per_image(yolo.image_size, yolo.cell_channels)
    out["times_plain"] = detector_train_times(plain, plain_state, trng, yolo)
    out["times_dp"] = time_train(
        dp, dp_state, lambda b: train_batch(trng, b, yolo), flops,
        "v1 224² data-parallel (1, 1) mesh")
    for b in out["times_dp"]:
        print(f"DP step v1 224² batch {b}: "
              f"{out['times_dp'][b]['images_per_s']:.1f} images/s (idle "
              f"{out['times_dp'][b]['idle_share']:.3f}) vs the plain step's "
              f"{out['times_plain'][b]['images_per_s']:.1f} (idle "
              f"{out['times_plain'][b]['idle_share']:.3f}); {card_line()}")
    return out


def check_spatial_serving(dev, images, v2_images) -> dict:
    """``make_spatial_detect_fn`` over the world-1 spatial mesh at full
    width: v1 448² bf16 with NMS on and off (B1 and B3 once a call), v2p
    416² with NMS (B2 once a call); the sharded grid against the stock
    ``make_detect_fn`` grid (``GRID_REL_TOL``); B1 / B3 / B2 against their
    plain versions on it; images/s at batch 32 and 256 against
    ``make_detect_fn``'s, with the idle share."""
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_detect_fn,
        make_spatial_detect_fn,
    )
    from tensorflow_yolo2_torch.models.fold import fold_params
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.parallel.spatial import (
        spatial_detector_fn,
        spatial_mesh,
    )

    out = {"launches": {}, "errs": {"decode_nms": 0.0, "decode_grid": 0.0,
                                    "decode_nms_v2": 0.0}}
    mesh = spatial_mesh(1)
    for head in ("v1", "v2p"):
        v2 = head == "v2p"
        cfg, state = v2_detector(True) if v2 else v1_detector()
        imgs = v2_images if v2 else images
        kw = {"v2": True, "passthrough": True} if v2 else {}
        det = make_spatial_detect_fn(cfg, state, None, 0.5, use_nms=True,
                                     n_shards=1, device=dev, **kw)
        cd.reset_launch_counts()
        kept = det(imgs[:16])
        dense = None
        if not v2:
            dense = make_spatial_detect_fn(cfg, state, None, 0.5,
                                           use_nms=False, n_shards=1,
                                           device=dev)(imgs[:16])
        torch.cuda.synchronize()
        counts = {"decode_nms": cd.DECODE_NMS_LAUNCHES,
                  "decode_nms_v2": cd.DECODE_NMS_V2_LAUNCHES,
                  "decode_grid": cd.DECODE_GRID_LAUNCHES}
        want = ({"decode_nms_v2": 1, "decode_nms": 0, "decode_grid": 0}
                if v2 else {"decode_nms_v2": 0, "decode_nms": 1,
                            "decode_grid": 1})
        print(f"spatial {head} serving launches (one call with NMS"
              f"{'' if v2 else ', one without'}): {counts}")
        check(counts == want, f"spatial {head}: each decode kernel once a "
                              "call")
        out["launches"][head] = counts
        check(kept.boxes.shape == (16, K, 4) and
              bool(torch.isfinite(kept.scores).all()) and
              bool((kept.scores > 0).any()), f"spatial {head} detections")
        if dense is not None:
            check(dense.boxes.shape == (16, cfg.S * cfg.S * cfg.B, 4),
                  "spatial v1 dense shapes")
        folded = {k: v.float().to(dev, torch.bfloat16)
                  for k, v in fold_params(state).items()}
        fwd = spatial_detector_fn(mesh, bn_on_output=not v2,
                                  head="v2p" if v2 else "v1")
        with torch.inference_mode():
            grid = fwd(folded, imgs[:BATCH].to(dev))
        stock = card_grid(cfg, state, imgs[:BATCH], dev, **kw)
        rel = ((grid.double() - stock.double()).norm() /
               stock.double().norm()).item()
        out[f"grid_rel_{head}"] = rel
        print(f"spatial {head} grid (bf16, batch {BATCH}) against the stock "
              f"make_detect_fn grid: relative norm {rel:.3e} (bound "
              f"{GRID_REL_TOL})")
        check(rel <= GRID_REL_TOL, f"spatial {head} grid agrees with the "
                                   "stock grid")
        del stock
        for thresh in (0.05, 0.5):
            if v2:
                out["errs"]["decode_nms_v2"] = max(
                    out["errs"]["decode_nms_v2"], compare_kept(
                        cd.decode_nms_fused(grid, cfg, thresh, 0.5, K),
                        cd.decode_nms_v2_plain(grid, cfg, thresh, 0.5, K),
                        "decode_nms_v2"))
            else:
                out["errs"]["decode_nms"] = max(
                    out["errs"]["decode_nms"], compare_kept(
                        cd.decode_nms_fused(grid, cfg, thresh, 0.5, K),
                        cd.decode_nms_plain(grid, cfg, thresh, 0.5, K)))
                out["errs"]["decode_grid"] = max(
                    out["errs"]["decode_grid"], compare_dense(
                        cd.decode_grid_fused(grid, cfg, thresh),
                        cd.decode_grid_plain(grid, cfg, thresh)))
        torch.cuda.synchronize()
        del grid
        size = cfg.image_size
        flops = conv_flops_per_image(size, cfg.cell_channels,
                                     passthrough=v2)
        stock_det = make_detect_fn(cfg, state, object_thresh=0.5,
                                   use_nms=True, device=dev, **kw)
        out[f"times_{head}"] = {
            "spatial": time_path(det, imgs, dev, f"spatial {head} {size}²",
                                 flops),
            "stock": time_path(stock_det, imgs, dev, f"{head} {size}²",
                               flops)}
        for b in PATH_BATCHES:
            t = out[f"times_{head}"]
            print(f"spatial {head} {size}² batch {b}: "
                  f"{t['spatial'][b]['images_per_s']:.1f} images/s (idle "
                  f"{t['spatial'][b]['idle_share']:.3f}) vs make_detect_fn's "
                  f"{t['stock'][b]['images_per_s']:.1f} (idle "
                  f"{t['stock'][b]['idle_share']:.3f}); {card_line()}")
    print(f"spatial serving grids: the decode kernels match their plain "
          f"versions (max abs err {out['errs']})")
    return out


def check_spatial_training(dev, cases) -> dict:
    """One float32 (TF32 off) live-BatchNorm spatial step over the
    world-1 mesh for each of ``cases`` ((head, config, weights, uint8
    images, labels): v1 224² with ``spatial_yolo_train_fn``, v2p 416²
    with ``spatial_yolo_v2_train_fn``, batch ``PAR_TRAIN_BATCH``, from the
    weights sections 6 and 7 reached): B5 5 times a step; the loss (1e-4),
    the gradients (the float32 step bounds, ``grad_errors``) and the new
    running statistics (1e-2, relative norm of all) against the plain
    ``Trainer`` step in float64 on the CPU; the distance from the plain
    float32 step on the card printed."""
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.parallel.spatial import (
        spatial_mesh,
        spatial_yolo_train_fn,
        spatial_yolo_v2_train_fn,
    )

    def plain_step(cfg, dtype, where, weights, images, labels):
        """(loss, gradients, new running statistics) of the plain step."""
        trainer, state = make_trainer(cfg, torch.float32, where, weights)
        if dtype == torch.float64:
            state.model.double()
            images = images.double() / 255.0 * 2.0 - 1.0
        metrics, grads = trainer.loss_and_grads(state, images.to(where),
                                                labels.to(where))
        stats = {k: v.double().cpu()
                 for k, v in state.model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return (metrics["loss"].item(),
                {k: g.double().cpu() for k, g in grads.items()}, stats)

    mesh = spatial_mesh(1)
    out = {}
    for head, cfg, weights, images, labels in cases:
        images, labels = images.to(dev), labels.to(dev)
        trainer, state = make_trainer(cfg, torch.float32, dev, weights)
        model = state.model.train()
        params = dict(model.named_parameters())
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        cuda_pool.reset_launch_counts()
        if head == "v1":
            loss, grads, new = spatial_yolo_train_fn(mesh, cfg)(
                params, stats, images, labels)
        else:
            loss, grads, new = spatial_yolo_v2_train_fn(
                mesh, cfg, head="v2p")(params, stats, images, labels, 0)
        torch.cuda.synchronize()
        n_pool = cuda_pool.MAX_POOL2_BWD_LAUNCHES
        grads = {k: g.double().cpu() for k, g in grads.items()}
        new = {k: v.double().cpu() for k, v in new.items()}
        del trainer, state, model, params
        loss64, grads64, stats64 = plain_step(
            cfg, torch.float64, torch.device("cpu"), weights, images.cpu(),
            labels.cpu())
        loss32, grads32, stats32 = plain_step(cfg, torch.float32, dev,
                                              weights, images, labels)
        loss_rel = abs(loss.item() - loss64) / abs(loss64)
        worst, key, total = grad_errors(grads, grads64)
        stats_rel = rel_all(new, stats64)
        out[head] = {"launches": n_pool, "loss_rel": loss_rel,
                     "grad_rel_err": worst, "grad_tensor": key,
                     "all_grads_rel_err": total, "stats_rel": stats_rel,
                     "vs_plain_f32": {
                         "loss_rel": abs(loss.item() - loss32) / abs(loss32),
                         "all_grads_rel": rel_all(grads, grads32),
                         "stats_rel": rel_all(new, stats32)},
                     "plain_f32_all_grads_rel_err": rel_all(grads32,
                                                            grads64)}
        print(f"spatial live step {head} {cfg.image_size}², float32 (TF32 "
              f"off), batch {len(images)}, against the plain float64 step "
              f"on the CPU: loss {loss_rel:.3e} (bound {LOSS_REL_TOL}), "
              f"gradients worst {worst:.3e} ({key}), all {total:.3e} "
              f"(bounds {GRAD_REL_TOL}, {ALL_GRADS_REL_TOL}), running "
              f"statistics {stats_rel:.3e} (bound {ALL_GRADS_REL_TOL}); the "
              f"plain float32 card step's gradients {out[head]['plain_f32_all_grads_rel_err']:.3e} "
              f"from float64; spatial vs plain float32: "
              f"{out[head]['vs_plain_f32']}; B5 {n_pool} launches")
        check(n_pool == 5, f"B5 ran 5 times a spatial {head} step")
        check(loss_rel <= LOSS_REL_TOL and worst <= GRAD_REL_TOL and
              total <= ALL_GRADS_REL_TOL and stats_rel <= ALL_GRADS_REL_TOL,
              f"the spatial {head} step equals the plain step")
    return out


def run_parallel_clis(dev) -> dict:
    """``python -m torch.distributed.run --nproc-per-node 1 -m
    tensorflow_yolo2_torch.entries.train_classifier --num-clones 1`` on a
    ``make_flowers`` tree (exit 0, its snapshot), then ``train_classifier``
    in this process under the world-1 group: a (1, 1) mesh, B5 5 times a
    step."""
    import shutil
    import tempfile

    from tensorflow_yolo2_torch.entries import train_classifier
    from tensorflow_yolo2_torch.ops import cuda_pool
    from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
    from tensorflow_yolo2_torch.utils import cuda_build
    from tests import synthetic

    out = {}
    argv = ["--num-clones", "1", "--iters", "2", "--batch-size",
            str(SLIM_CLI_BATCH), "--save-every", "2", "--num-workers", "2",
            "--log-every", "1", "--device", str(dev)]
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        synthetic.make_flowers(os.path.join(root, "data", "TF_flowers"),
                               per_class=SLIM_FLOWERS_PER_CLASS)
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                            "RANK", "LOCAL_RANK")}
        env["TFY2_ROOT"] = root
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "1", "--master-addr", "127.0.0.1",
             "--master-port", str(_free_port()), "-m",
             "tensorflow_yolo2_torch.entries.train_classifier", *argv],
            env=env, capture_output=True, text=True,
            timeout=PAR_CLI_TIMEOUT)
        out["torchrun_s"] = time.perf_counter() - t0
        print(f"torchrun --nproc-per-node 1 train_classifier --num-clones 1 "
              f"({out['torchrun_s']:.1f} s), exit {done.returncode}:\n  " +
              "\n  ".join((done.stdout + done.stderr).strip()
                          .splitlines()[-8:]))
        check(done.returncode == 0, "train_classifier under torchrun "
                                    "exits 0")
        with mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
            mgr = CheckpointManager("darknet19", "tf_flowers")
            check(mgr.all_steps() == [2], "the torchrun run saved its "
                                          "snapshot")
            shutil.rmtree(mgr.dir)
            cuda_pool.reset_launch_counts()
            run_cli(train_classifier.main, argv,
                    "train_classifier under the world-1 group")
            torch.cuda.synchronize()
            out["in_process_launches"] = cuda_pool.MAX_POOL2_BWD_LAUNCHES
            check(out["in_process_launches"] == 10,
                  "B5 ran 5 times a step of train_classifier on the mesh")
            check(mgr.all_steps() == [2], "the in-process run saved its "
                                          "snapshot")
    return out


def check_parallel(dev, images, v2_images, dp_case, train_cases) -> dict:
    """Section 15: data and spatial parallelism (``parallel/``) on the
    card through a world-1 NCCL group; the launcher. ``dp_case`` is
    (weights, images, labels) of the v1 DP check, ``train_cases`` the
    spatial training cases (``check_spatial_training``)."""
    t0 = time.perf_counter()
    out = {}
    with world1_group():
        out["dp"] = check_dp(dev, *dp_case)
        out["spatial_serving"] = check_spatial_serving(dev, images,
                                                       v2_images)
        out["spatial_train"] = check_spatial_training(dev, train_cases)
        out["clis"] = run_parallel_clis(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"parallel: {out['seconds']:.1f} s")
    return out


# -- the quality program (section 16), small ------------------------------

QUALITY_FIXTURE = (128, 32)  # hard VOC: train, val images
QUALITY_PRETRAIN_ITERS = 100
QUALITY_V1_STAGES = ("150", "150,300")  # two calls: the second trains 150
QUALITY_V2_STAGES = "300"  # the plain v2 and v2p heads


def stage_rows(text: str) -> list[dict]:
    """The ``STAGE`` rows a ``quality_curve`` call printed."""
    return [json.loads(line[len("STAGE "):]) for line in text.splitlines()
            if line.startswith("STAGE ")]


def fresh_map(head: str, yolo, dev) -> float:
    """Train-split mAP of the head's detector with fresh seeded weights
    (flax's initializers, seed 0), scored as ``quality_curve`` scores a
    trained one."""
    from tensorflow_yolo2_torch.config import yolo_v2_config
    from tensorflow_yolo2_torch.entries import quality_curve
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_detect_fn,
    )
    from tensorflow_yolo2_torch.models.darknet import (
        Darknet19Detector,
        Darknet19DetectorV2,
        init_params_,
    )

    v2 = head != "v1"
    model = (Darknet19DetectorV2(yolo.cell_channels) if head == "v2p"
             else Darknet19Detector(yolo.cell_channels, bn_on_output=not v2))
    init_params_(model, torch.Generator().manual_seed(0))
    detect = make_detect_fn(yolo, model.state_dict(),
                            object_thresh=quality_curve.EVAL_THRESH,
                            use_nms=True, device=dev, v2=v2,
                            passthrough=head == "v2p")
    gt = yolo if v2 else yolo_v2_config(yolo.image_size)
    return quality_curve.score(detect, gt, "trainval")


def check_quality_program(dev) -> dict:
    """Section 16: the quality program (``entries.quality_curve``,
    ``entries.int8_quality``) small, with ``--device cuda``, under a run
    root of its own: the hard fixture at 128 train / 32 val, a 100-step
    classifier pretrain, v1 with ``--stages 150`` then ``--stages
    150,300`` (the second call trains only the delta to a step-300
    snapshot), ``--v2 --anchors kmeans --stages 300`` and ``--v2
    --passthrough --anchors kmeans --stages 300``, and ``int8_quality``
    on the v1 snapshot. Each call exits 0 with mAPs in [0, 1]; B5 runs 5
    times a train step, B1 once a v1 evaluation batch, B2 once an anchor
    head's one; each head's trained train-split mAP is above that of the
    same detector with fresh seeded weights."""
    import tempfile

    from tensorflow_yolo2_torch.config import (
        Paths,
        YoloConfig,
        yolo_v2_config,
    )
    from tensorflow_yolo2_torch.data.anchors import load_anchors
    from tensorflow_yolo2_torch.entries import int8_quality, quality_curve
    from tensorflow_yolo2_torch.ops import cuda_decode, cuda_pool
    from tensorflow_yolo2_torch.train.checkpoint import CheckpointManager
    from tensorflow_yolo2_torch.utils import cuda_build

    t0 = time.perf_counter()
    n_train, n_val = QUALITY_FIXTURE
    eval_batches = (math.ceil(n_train / quality_curve.EVAL_BATCH)
                    + math.ceil(n_val / quality_curve.EVAL_BATCH))
    fixture = ["--n-train", str(n_train), "--n-val", str(n_val),
               "--grad-clip", "5", "--device", str(dev)]
    out = {"launches": {}, "map": {}}

    def call(main, argv: list[str], what: str) -> tuple[str, dict]:
        cuda_pool.reset_launch_counts()
        cuda_decode.reset_launch_counts()
        text = run_cli(main, argv, what)
        torch.cuda.synchronize()
        counts = {"max_pool2_bwd": cuda_pool.MAX_POOL2_BWD_LAUNCHES,
                  "decode_nms": cuda_decode.DECODE_NMS_LAUNCHES,
                  "decode_nms_v2": cuda_decode.DECODE_NMS_V2_LAUNCHES,
                  "decode_grid": cuda_decode.DECODE_GRID_LAUNCHES}
        out["launches"][what] = counts
        return text, counts

    def check_rows(text: str, stages: list[int], what: str) -> list[dict]:
        rows = stage_rows(text)
        check([r["iters"] for r in rows] == stages,
              f"{what} scored the stages {stages}")
        check(all(math.isfinite(r[k]) and 0.0 <= r[k] <= 1.0
                  for r in rows for k in ("map_train", "map_val")),
              f"{what}: every mAP finite and in [0, 1]")
        return rows

    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            mock.patch.dict(os.environ, {"TFY2_ROOT": root}):
        what = "quality_curve v1 --stages 150 --pretrain-iters 100"
        text, n = call(quality_curve.main,
                       ["--stages", QUALITY_V1_STAGES[0], "--pretrain-iters",
                        str(QUALITY_PRETRAIN_ITERS), *fixture], what)
        steps = QUALITY_PRETRAIN_ITERS + 150
        check(n["max_pool2_bwd"] == 5 * steps,
              f"B5 ran 5 times a step of the pretrain and the stage "
              f"({n['max_pool2_bwd']} for {steps} steps)")
        check(n["decode_nms"] == eval_batches and n["decode_grid"] == 0,
              "B1 ran once a v1 evaluation batch (and B3 never)")
        check_rows(text, [150], what)
        check("Warm-started" in text, "the v1 stage warm-started from the "
                                      "pretrain's snapshot")

        what = "quality_curve v1 --stages 150,300"
        text, n = call(quality_curve.main,
                       ["--stages", QUALITY_V1_STAGES[1], *fixture], what)
        check(n["max_pool2_bwd"] == 5 * 150,
              "the second v1 call trained only the delta (150 steps)")
        check(n["decode_nms"] == eval_batches,
              "B1 ran once a v1 evaluation batch")
        v1_rows = check_rows(text, [300], what)
        check(CheckpointManager("darknet19", "voc_2007").all_steps()
              == [150, 300], "the v1 snapshots are at steps 150 and 300")

        anchor_rows, anchor_yolo = {}, {}
        for head, flags in (("v2", []), ("v2p", ["--passthrough"])):
            what = (f"quality_curve --v2 {' '.join(flags)} --anchors kmeans "
                    f"--stages {QUALITY_V2_STAGES}")
            text, n = call(quality_curve.main,
                           ["--stages", QUALITY_V2_STAGES, "--v2", *flags,
                            "--anchors", "kmeans", *fixture], what)
            check(n["max_pool2_bwd"] == 5 * 300,
                  f"B5 ran 5 times a {head} train step")
            check(n["decode_nms_v2"] == eval_batches
                  and n["decode_nms"] == 0,
                  f"B2 ran once a {head} evaluation batch")
            anchor_rows[head] = check_rows(text, [300], what)
            net = quality_curve.curve_net(True, head == "v2p")
            anchor_yolo[head] = quality_curve.snapshot_yolo(Paths(), net,
                                                            True)
            check(load_anchors(CheckpointManager(net, "voc_2007").dir,
                               anchor_yolo[head].S) == anchor_yolo[head]
                  .anchors != yolo_v2_config(anchor_yolo[head].image_size)
                  .anchors, f"the {head} run wrote its k-means priors to "
                  "anchors.json and the program decodes with them")

        what = "int8_quality (v1)"
        text, n = call(int8_quality.main, ["--device", str(dev)], what)
        int8_batches = 2 * (math.ceil(n_train / int8_quality.BATCH)
                            + math.ceil(n_val / int8_quality.BATCH))
        check(n["decode_nms"] == int8_batches,
              "B1 ran once an evaluation batch of the bf16 and int8 paths")
        line = [ln for ln in text.splitlines()
                if ln.startswith("INT8_QUALITY ")]
        check(len(line) == 1, "int8_quality printed its result")
        int8 = json.loads(line[0][len("INT8_QUALITY "):])
        check(all(math.isfinite(int8[f"map_{s}_{m}"])
                  and 0.0 <= int8[f"map_{s}_{m}"] <= 1.0
                  for s in ("train", "val") for m in ("bf16", "int8")),
              "int8_quality: every mAP finite and in [0, 1]")
        out["int8"] = int8

        fresh = {"v1": fresh_map("v1", YoloConfig(), dev),
                 **{head: fresh_map(head, y, dev)
                    for head, y in anchor_yolo.items()}}
    for head, rows in (("v1", v1_rows), *anchor_rows.items()):
        out["map"][head] = {"trained": rows[-1], "fresh_map_train":
                            fresh[head]}
        print(f"quality {head} @300: train mAP {rows[-1]['map_train']:.4f}, "
              f"val {rows[-1]['map_val']:.4f}; fresh seeded weights: train "
              f"mAP {fresh[head]:.4f}")
        check(rows[-1]["map_train"] > fresh[head],
              f"the trained {head} head scores above fresh weights on the "
              "train split")
    print(f"int8_quality v1 @300: {json.dumps(int8)}")
    out["seconds"] = time.perf_counter() - t0
    print(f"quality program: {out['seconds']:.1f} s")
    return out


# -- draws of the quality program's stages (--quality-draws) ---------------

DRAW_FIXTURE = ("--n-train", "1024", "--n-val", "128", "--bn-momentum",
                "0.9", "--grad-clip", "5")  # quality_program.sh's
DRAW_PRETRAIN_ITERS = 1500
DRAW_HEAD_FLAGS = {"v1": (), "v2": ("--v2", "--anchors", "kmeans"),
                   "v2p": ("--v2", "--passthrough", "--anchors", "kmeans")}
DRAW_STAGES = "600"  # each draw's cumulative stages
# (head, compute dtype, seed) of each draw, in order
DRAW_PLAN = (("v2", "bfloat16", 0), ("v2", "bfloat16", 1),
             ("v2", "bfloat16", 2), ("v2", "float32", 0),
             ("v2", "float32", 1), ("v2", "float32", 2),
             ("v2p", "bfloat16", 0), ("v1", "bfloat16", 0))


def float32_stages(head: str, seed: int, stages: list[int]) -> list[dict]:
    """``quality_curve``'s stage loop in float32: each stage's own
    ``pascal_train_darknet`` arguments (``quality_curve.train_argv``, the
    seed of the stage's first step) with ``--compute-dtype float32``,
    then the snapshot scored on both splits by ``quality_curve.score``,
    as ``quality_curve.main`` scores it."""
    from tensorflow_yolo2_torch.config import Paths, yolo_v2_config
    from tensorflow_yolo2_torch.entries import (
        pascal_train_darknet,
        quality_curve,
    )

    v2, passthrough = head != "v1", head == "v2p"
    program = argparse.Namespace(
        batch=24, bn_momentum=0.9, v2=v2, passthrough=passthrough,
        anchors="kmeans", multiscale=None, grad_clip=5.0, lr_decay=None,
        device="cuda")
    net = quality_curve.curve_net(v2, passthrough)
    rows, done = [], 0
    for stage in stages:
        run_cli(pascal_train_darknet.main,
                quality_curve.train_argv(program, stage - done,
                                         seed + done + 1)
                + ["--compute-dtype", "float32"], f"{head} float32 {stage}")
        done = stage
        yolo = quality_curve.snapshot_yolo(Paths(), net, v2)
        gt = yolo if v2 else yolo_v2_config(yolo.image_size)
        detect = quality_curve.build_detect(yolo, net, v2, passthrough,
                                            "cuda")
        rows.append({"iters": stage, **{
            f"map_{split}": round(quality_curve.score(detect, gt, name), 4)
            for split, name in (("train", "trainval"), ("val", "test"))}})
    return rows


def quality_draws(root: str, card: str) -> int:
    """The quality program's stages, ``DRAW_PLAN``'s draws, on one
    fixture and one pretrain (``quality_program.sh``'s: the hard
    synthetic VOC at 1024 / 128 images, a 1500-step classifier pretrain),
    each draw in a clean run root holding copies of them: a bf16 draw is
    ``quality_curve --stages DRAW_STAGES --seed SEED``, a float32 one
    ``float32_stages``. Prints a ``DRAW`` JSON line a stage; each draw's
    root is removed after it (its snapshots are ~0.6 GB each)."""
    import shutil

    from tensorflow_yolo2_torch.entries import quality_curve

    stage_list = [int(s) for s in DRAW_STAGES.split(",")]
    base = os.path.join(root, "base")
    with mock.patch.dict(os.environ, {"TFY2_ROOT": base}):
        run_cli(quality_curve.main,
                ["--stages", "0", "--pretrain-iters",
                 str(DRAW_PRETRAIN_ITERS), *DRAW_FIXTURE, "--device",
                 "cuda"],
                "fixture and pretrain")
    shared = [os.path.join("data", "VOCdevkit"), os.path.join("data", "ILSVRC"),
              "cache", os.path.join("ckpts", "darknet19", "ilsvrc_2017_cls")]
    for head, dtype, seed in DRAW_PLAN:
        draw = os.path.join(root, f"{head}_{dtype}_seed{seed}")
        for rel in shared:
            shutil.copytree(os.path.join(base, rel), os.path.join(draw, rel))
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, {"TFY2_ROOT": draw}):
            if dtype == "bfloat16":
                rows = stage_rows(run_cli(
                    quality_curve.main,
                    ["--stages", DRAW_STAGES, *DRAW_FIXTURE,
                     *DRAW_HEAD_FLAGS[head], "--seed", str(seed),
                     "--device", "cuda"], f"{head} bf16 seed {seed}"))
            else:
                rows = float32_stages(head, seed, stage_list)
        check([r["iters"] for r in rows] == stage_list,
              f"the {head} {dtype} seed {seed} draw scored every stage")
        for r in rows:
            print("DRAW " + json.dumps({
                "head": head, "dtype": dtype, "seed": seed, **r,
                "seconds": round(time.perf_counter() - t0, 1),
                "card": card}), flush=True)
        shutil.rmtree(draw)
    shutil.rmtree(base)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--stem-ab", nargs="*", metavar="STEM_CU",
        help="instead of the smoke run, time csrc/stem.cu and these other "
        "B4 sources side by side, whole and by phase (stem_ab)")
    parser.add_argument(
        "--decode-ab", nargs="*", metavar="DECODE_CU",
        help="instead of the smoke run, check and time B1 and B2 of "
        "csrc/decode.cu and these other decode sources side by side "
        "(decode_ab)")
    parser.add_argument(
        "--quality-draws", metavar="ROOT",
        help="instead of the smoke run, train and score the quality "
        "program's draws of DRAW_PLAN under the run root ROOT "
        "(quality_draws)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from tensorflow_yolo2_torch.config import YoloConfig, yolo_v2_config
    from tensorflow_yolo2_torch.entries.pascal_detect_darknet import (
        make_detect_fn,
    )
    from tensorflow_yolo2_torch.ops import cuda_decode as cd
    from tensorflow_yolo2_torch.ops.boxes import decode_grid_v2
    from tensorflow_yolo2_torch.utils import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    start = time.perf_counter()

    def mark(section: str) -> None:
        print(f"[{time.perf_counter() - start:.1f} s] {section}", flush=True)

    # 1. header and build ----------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; TF32 off for float32 checks")
    print("tensorflow importable on this machine: "
          f"{importlib.util.find_spec('tensorflow') is not None} (the port "
          "reads TF checkpoints without it)")
    if args.stem_ab is not None:
        return stem_ab([os.path.join(cuda_build.CSRC_DIR, "stem.cu"),
                        *args.stem_ab], card)
    if args.decode_ab is not None:
        return decode_ab([cuda_build.source_path("decode"), *args.decode_ab],
                         card)
    if args.quality_draws is not None:
        return quality_draws(args.quality_draws, card)
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(cuda_build.sources())}")
    # each library's own compiler output, this build's or the one that
    # made a library already on disk
    for log in logs.values():
        print(log, end="")
    check(not any(w in log for log in logs.values() for w in PIPELINE_LOST),
          "ptxas kept B4's wgmma pipeline (no serialization, no injected "
          "warpgroup waits)")

    errs = {"decode_nms": 0.0, "decode_nms_v2": 0.0, "decode_grid": 0.0}
    launches = {}

    # 2. kernels against their plain versions on synthetic grids -------------
    mark("section 2")
    for S in (7, 14):
        cfg = YoloConfig(S=S, image_size=32 * S)
        net = torch.from_numpy(synthetic_grid(cfg, BATCH, seed=S)).to(dev)
        errs["decode_grid"] = max(errs["decode_grid"], compare_dense(
            cd.decode_grid_fused(net, cfg, 0.5),
            cd.decode_grid_plain(net, cfg, 0.5)))
        for class_aware in (True, False):
            got = cd.decode_nms_fused(net, cfg, 0.5, 0.5, K, class_aware)
            want = cd.decode_nms_plain(net, cfg, 0.5, 0.5, K, class_aware)
            errs["decode_nms"] = max(errs["decode_nms"],
                                     compare_kept(got, want))
            kept = (want.scores > 0).sum(1)
            check(bool((kept >= 5).all()), "synthetic grids keep boxes")
        torch.cuda.synchronize()
    for S in (7, 10, 13, 14, 19):  # 224² to 608²
        cfg = yolo_v2_config(32 * S)
        net = torch.from_numpy(synthetic_grid_v2(cfg, BATCH, seed=S)).to(dev)
        for class_aware in (True, False):
            got = cd.decode_nms_fused(net, cfg, 0.5, 0.5, K, class_aware)
            want = cd.decode_nms_v2_plain(net, cfg, 0.5, 0.5, K,
                                          class_aware)
            errs["decode_nms_v2"] = max(errs["decode_nms_v2"], compare_kept(
                got, want, "decode_nms_v2"))
            kept = (want.scores > 0).sum(1)
            check(bool((kept >= 5).all()), "synthetic anchor grids keep "
                                           "boxes")
        torch.cuda.synchronize()
    print(f"synthetic grids: kernels match their plain versions "
          f"(max abs err {errs})")
    errs["max_pool2_bwd"] = check_pool_kernel(dev)
    print(f"max_pool2_bwd: bit-equal to its plain version and to autograd "
          f"of F.max_pool2d at the 224² pool sites (batch 24, bf16 and "
          f"float32), on ties, odd C and small maps (max abs err "
          f"{errs['max_pool2_bwd']})")

    images, v2_images = serving_images()

    # 3. the v1 serving path at full width (the main path) -------------------
    mark("section 3")
    yolo, state = v1_detector()
    v1_state = state
    batch = images[:16]

    v1_detect = make_detect_fn(yolo, state, object_thresh=0.5, use_nms=True)
    detect_dense = make_detect_fn(yolo, state, object_thresh=0.5,
                                  use_nms=False)
    cd.reset_launch_counts()
    kept = v1_detect(batch)
    dense = detect_dense(batch)
    torch.cuda.synchronize()
    launches["decode_nms"] = cd.DECODE_NMS_LAUNCHES
    launches["decode_grid"] = cd.DECODE_GRID_LAUNCHES
    print(f"v1 path launches: {launches}")
    check(launches["decode_nms"] > 0 and launches["decode_grid"] > 0,
          "the v1 path launched both kernels")
    check(kept.boxes.shape == (16, K, 4) and kept.scores.shape == (16, K)
          and kept.classes.shape == (16, K), "NMS output shapes")
    check(dense.boxes.shape == (16, 392, 4) and dense.scores.shape ==
          (16, 392), "dense output shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (*kept[:2], *dense[:2])),
          "finite outputs")
    check(bool((kept.scores > 0).any()), "the path kept detections")

    rel = grid_rel_err(yolo, state, images, dev)
    print(f"v1 grid, bf16 card vs float32 CPU forward: relative norm error "
          f"{rel:.3e} (bound {GRID_REL_TOL})")
    check(rel <= GRID_REL_TOL, "card grid agrees with the CPU forward")

    del detect_dense
    grid = v1_grid = card_grid(yolo, state, images[:BATCH], dev)
    for thresh in (0.05, 0.5):
        errs["decode_grid"] = max(errs["decode_grid"], compare_dense(
            cd.decode_grid_fused(grid, yolo, thresh),
            cd.decode_grid_plain(grid, yolo, thresh)))
        for class_aware in (True, False):
            want = cd.decode_nms_plain(grid, yolo, thresh, 0.5, K,
                                       class_aware)
            errs["decode_nms"] = max(errs["decode_nms"], compare_kept(
                cd.decode_nms_fused(grid, yolo, thresh, 0.5, K, class_aware),
                want))
        # with K = every slot, nothing is cut by K: kept < valid shows
        # that the sweep suppressed boxes
        n = yolo.S * yolo.S * yolo.B
        want = cd.decode_nms_plain(grid, yolo, thresh, 0.5, n)
        errs["decode_nms"] = max(errs["decode_nms"], compare_kept(
            cd.decode_nms_fused(grid, yolo, thresh, 0.5, n), want))
        valid = (cd.decode_grid_plain(grid, yolo, thresh).scores > 0).sum(1)
        n_kept = (want.scores > 0).sum(1)
        print(f"v1 real grid, threshold {thresh}: {valid.float().mean():.1f} "
              f"valid and {n_kept.float().mean():.1f} surviving slots per "
              f"image")
        check(bool((n_kept < valid).all()), "NMS suppressed boxes")
    torch.cuda.synchronize()
    print(f"v1 real grid: kernels match their plain versions (max abs err "
          f"{errs})")

    # 4. the anchor serving paths at full width: YOLOv2 at 416² -------------
    mark("section 4")
    for head in ("v2p", "v2"):
        passthrough = head == "v2p"
        v2cfg, state = v2_detector(passthrough)
        n = v2cfg.S * v2cfg.S * v2cfg.B
        kw = {"v2": True, "passthrough": passthrough}
        detect_nms = make_detect_fn(v2cfg, state, object_thresh=0.5,
                                    use_nms=True, **kw)
        detect_dense = make_detect_fn(v2cfg, state, object_thresh=0.5,
                                      use_nms=False, **kw)
        cd.reset_launch_counts()
        kept = detect_nms(v2_images[:16])
        dense = detect_dense(v2_images[:16])
        torch.cuda.synchronize()
        n_launch = cd.DECODE_NMS_V2_LAUNCHES
        print(f"{head} path launches: decode_nms_v2 {n_launch}, "
              f"decode_nms {cd.DECODE_NMS_LAUNCHES}, "
              f"decode_grid {cd.DECODE_GRID_LAUNCHES}")
        check(n_launch > 0, f"the {head} path launched the anchor kernel")
        check(kept.boxes.shape == (16, K, 4) and dense.boxes.shape ==
              (16, n, 4), f"{head} output shapes")
        check(all(bool(torch.isfinite(t).all())
                  for t in (*kept[:2], *dense[:2])), f"{head} finite outputs")
        check(bool((kept.scores > 0).any()),
              f"the {head} path kept detections")
        if passthrough:
            launches["decode_nms_v2"] = n_launch
            v2p_detect = detect_nms
        else:
            v2_state = state
        del detect_dense

        rel = grid_rel_err(v2cfg, state, v2_images, dev, **kw)
        print(f"{head} grid, bf16 card vs float32 CPU forward: relative norm "
              f"error {rel:.3e} (bound {GRID_REL_TOL})")
        check(rel <= GRID_REL_TOL,
              f"{head} card grid agrees with the CPU forward")

        grid = card_grid(v2cfg, state, v2_images[:BATCH], dev, **kw)
        for thresh in (0.05, 0.5):
            for class_aware in (True, False):
                errs["decode_nms_v2"] = max(errs["decode_nms_v2"], compare_kept(
                    cd.decode_nms_fused(grid, v2cfg, thresh, 0.5, K,
                                        class_aware),
                    cd.decode_nms_v2_plain(grid, v2cfg, thresh, 0.5, K,
                                           class_aware), "decode_nms_v2"))
            want = cd.decode_nms_v2_plain(grid, v2cfg, thresh, 0.5, n)
            errs["decode_nms_v2"] = max(errs["decode_nms_v2"], compare_kept(
                cd.decode_nms_fused(grid, v2cfg, thresh, 0.5, n), want,
                "decode_nms_v2"))
            valid = (decode_grid_v2(grid, v2cfg, thresh).scores > 0).sum(1)
            n_kept = (want.scores > 0).sum(1)
            print(f"{head} real grid, threshold {thresh}: "
                  f"{valid.float().mean():.1f} valid and "
                  f"{n_kept.float().mean():.1f} surviving slots per image")
            check(bool((n_kept > 0).all()), f"{head} grid keeps boxes")
            check(bool((n_kept < valid).all()),
                  f"{head} NMS suppressed boxes")
        torch.cuda.synchronize()
        if passthrough:
            v2_grid = grid
    print(f"anchor real grids: the kernel matches its plain version (max "
          f"abs err {errs['decode_nms_v2']})")

    # 5. B4, B4-f32 and the --pallas-stem serving paths in bf16 and float32:
    # v1 448², --v2 416² -----------------------------------------------------
    mark("section 5")
    from tensorflow_yolo2_torch.ops import cuda_stem as cs

    errs["stem"] = check_stem_kernel(dev, v1_state)
    errs["stem_f32"] = check_stem_kernel(dev, v1_state, torch.float32)
    f32 = torch.float32
    rel = grid_rel_err(yolo, v1_state, images, dev, dtype=f32)
    print(f"v1 grid, float32 card (TF32 off) vs float32 CPU forward: "
          f"relative norm error {rel:.3e} (bound {STEM_F32_PATH_REL_TOL})")
    check(rel <= STEM_F32_PATH_REL_TOL,
          "float32 card grid agrees with the CPU forward")
    stem_detect = {}
    for dtype, (head, cfg, st, imgs) in itertools.product(
            (torch.bfloat16, f32), (("v1", yolo, v1_state, images),
                                    ("v2", v2cfg, v2_state, v2_images))):
        kw = {"v2": True} if head == "v2" else {}
        kernel = cs.cuda_kernel(dtype)
        what = f"{head} {dtype} --pallas-stem"
        detect_nms = make_detect_fn(cfg, st, object_thresh=0.5, use_nms=True,
                                    pallas_stem=True, dtype=dtype, **kw)
        detect_dense = make_detect_fn(cfg, st, object_thresh=0.5,
                                      use_nms=False, pallas_stem=True,
                                      dtype=dtype, **kw)
        cd.reset_launch_counts()
        cs.reset_launch_counts()
        kept = detect_nms(imgs[:16])
        dense = detect_dense(imgs[:16])
        torch.cuda.synchronize()
        counts = {"stem": cs.STEM_LAUNCHES, "stem_f32": cs.STEM_F32_LAUNCHES,
                  "decode_nms": cd.DECODE_NMS_LAUNCHES,
                  "decode_nms_v2": cd.DECODE_NMS_V2_LAUNCHES,
                  "decode_grid": cd.DECODE_GRID_LAUNCHES}
        print(f"{what} path launches, one call with NMS and one without: "
              f"{counts}")
        check(counts[kernel] == 2 and sum(counts[k] for k in
                                          ("stem", "stem_f32")) == 2,
              f"{what}: {kernel} once a call, no other stem kernel")
        decode = ({"decode_nms_v2": 1, "decode_nms": 0, "decode_grid": 0}
                  if head == "v2" else
                  {"decode_nms_v2": 0, "decode_nms": 1, "decode_grid": 1})
        check(all(counts[k] == v for k, v in decode.items()),
              f"{what}: each decode kernel once a call")
        n_slots = cfg.S * cfg.S * cfg.B
        check(kept.boxes.shape == (16, K, 4) and dense.boxes.shape ==
              (16, n_slots, 4), f"{what} output shapes")
        check(all(bool(torch.isfinite(t).all())
                  for t in (*kept[:2], *dense[:2])), f"{what} finite outputs")
        check(bool((kept.scores > 0).any()), f"the {what} path kept "
                                             f"detections")
        if head == "v1":
            launches[kernel] = counts[kernel]
            stem_detect[dtype] = detect_nms
        del detect_dense

        grid = card_grid(cfg, st, imgs[:BATCH], dev, pallas_stem=True,
                         dtype=dtype, **kw)
        stock = card_grid(cfg, st, imgs[:BATCH], dev, dtype=dtype, **kw)
        rel_stock = ((grid.double() - stock.double()).norm() /
                     stock.double().norm()).item()
        del stock
        if dtype == f32:
            print(f"{what} grid against the stock float32 grid (TF32 off) at "
                  f"batch {BATCH}: relative norm {rel_stock:.3e} (bound "
                  f"{STEM_F32_PATH_REL_TOL})")
            check(rel_stock <= STEM_F32_PATH_REL_TOL,
                  f"{what} grid agrees with the stock grid")
        else:
            rel = grid_rel_err(cfg, st, imgs, dev, pallas_stem=True, **kw)
            print(f"{what} grid: against the float32 CPU forward {rel:.3e} "
                  f"(bound {GRID_REL_TOL}), against the stock bf16 grid at "
                  f"batch {BATCH} {rel_stock:.3e} (bound "
                  f"{STEM_PATH_REL_TOL}), relative norm")
            check(rel <= GRID_REL_TOL,
                  f"{what} grid agrees with the CPU forward")
            check(rel_stock <= STEM_PATH_REL_TOL,
                  f"{what} grid agrees with the stock grid")
        for thresh in (0.05, 0.5):
            for class_aware in (True, False):
                if head == "v2":
                    errs["decode_nms_v2"] = max(
                        errs["decode_nms_v2"], compare_kept(
                            cd.decode_nms_fused(grid, cfg, thresh, 0.5, K,
                                                class_aware),
                            cd.decode_nms_v2_plain(grid, cfg, thresh, 0.5, K,
                                                   class_aware),
                            "decode_nms_v2"))
                else:
                    errs["decode_nms"] = max(errs["decode_nms"], compare_kept(
                        cd.decode_nms_fused(grid, cfg, thresh, 0.5, K,
                                            class_aware),
                        cd.decode_nms_plain(grid, cfg, thresh, 0.5, K,
                                            class_aware)))
            if head == "v1":
                errs["decode_grid"] = max(errs["decode_grid"], compare_dense(
                    cd.decode_grid_fused(grid, cfg, thresh),
                    cd.decode_grid_plain(grid, cfg, thresh)))
        del grid
        torch.cuda.synchronize()
    print(f"--pallas-stem real grids, bf16 and float32: the decode kernels "
          f"match their plain versions (max abs err {errs})")

    # 6. the v1 training path at full width: 224², bf16 ---------------------
    mark("section 6")
    from tensorflow_yolo2_torch.ops import cuda_pool

    tyolo = YoloConfig()  # the reference's: 224², S=7, B=2, C=20
    trng = np.random.RandomState(3)
    images24, labels24 = (torch.from_numpy(a).to(dev) for a in
                          train_batch(trng, TRAIN_BATCHES[0], tyolo))
    trainer, tstate = make_trainer(tyolo, torch.bfloat16, dev)
    losses = []
    cuda_pool.reset_launch_counts()
    for _ in range(FALL_STEPS):
        tstate, metrics = trainer.train_step(tstate, images24, labels24)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches["max_pool2_bwd"] = cuda_pool.MAX_POOL2_BWD_LAUNCHES
    losses = torch.stack(losses).tolist()
    print(f"train path launches: max_pool2_bwd {launches['max_pool2_bwd']} "
          f"in {FALL_STEPS} steps; loss on one batch of "
          f"{TRAIN_BATCHES[0]}: " + ", ".join(f"{v:.3f}" for v in losses))
    check(launches["max_pool2_bwd"] == 5 * FALL_STEPS,
          "B5 ran 5 times a train step")
    check(all(math.isfinite(v) for v in losses), "finite train losses")
    check(sum(losses[-5:]) / 5 < 0.5 * losses[0],
          "the loss fell on a fixed batch (mean of the last 5 steps under "
          "half the first)")
    check(tstate.step == FALL_STEPS and all(
        bool(torch.isfinite(p).all()) for p in tstate.params.values()),
        "finite parameters after the steps")
    v1_trained = {k: v.detach().cpu().clone()
                  for k, v in tstate.model.state_dict().items()}
    train_check = check_train_step_against_cpu(
        functools.partial(make_trainer, tyolo), images24, labels24, dev,
        v1_trained)

    # 7. the v2p training path at full width: YOLOv2 at 416², bf16 ----------
    mark("section 7")
    vyolo = yolo_v2_config(V2P_TRAIN_SIZE)  # S=13, B=5, C=20, classic
    vrng = np.random.RandomState(4)
    vbatch = train_batch(vrng, TRAIN_BATCHES[0], vyolo)
    vimages, vlabels = (torch.from_numpy(a).to(dev) for a in vbatch)
    vtrainer, vstate = make_trainer(vyolo, torch.bfloat16, dev)
    vmetrics = []
    cuda_pool.reset_launch_counts()
    for _ in range(FALL_STEPS):
        vstate, metrics = vtrainer.train_step(vstate, vimages, vlabels)
        vmetrics.append(torch.stack([metrics["loss"],
                                     metrics["burnin_loss"]]))
    torch.cuda.synchronize()
    v2p_pool_launches = cuda_pool.MAX_POOL2_BWD_LAUNCHES
    vlosses, vburnin = torch.stack(vmetrics).T.tolist()
    print(f"train path v2p {V2P_TRAIN_SIZE}² launches: max_pool2_bwd "
          f"{v2p_pool_launches} in {FALL_STEPS} steps; loss on one batch of "
          f"{TRAIN_BATCHES[0]}: " + ", ".join(f"{v:.3f}" for v in vlosses) +
          "; burnin_loss: " + ", ".join(f"{v:.4f}" for v in vburnin))
    check(v2p_pool_launches == 5 * FALL_STEPS,
          "B5 ran 5 times a v2p train step")
    check(all(math.isfinite(v) for v in vlosses + vburnin),
          "finite v2p train losses")
    check(sum(vlosses[-5:]) / 5 < 0.5 * vlosses[0],
          "the v2p loss fell on a fixed batch (mean of the last 5 steps "
          "under half the first)")
    check(all(v > 0 for v in vburnin),
          f"the burn-in term is on (step · {TRAIN_BATCHES[0]} < "
          f"{vyolo.v2_burnin_samples} samples)")
    check(vstate.step == FALL_STEPS and all(
        bool(torch.isfinite(p).all()) for p in vstate.params.values()),
        "finite v2p parameters after the steps")
    v2p_trained = {k: v.detach().cpu().clone()
                   for k, v in vstate.model.state_dict().items()}
    v2p_train_check = check_train_step_against_cpu(
        functools.partial(make_trainer, vyolo), vimages[:V2P_CHECK_IMAGES],
        vlabels[:V2P_CHECK_IMAGES], dev, v2p_trained)

    # 7b. the plain v2 training path at the recipe's 224², bf16, and its
    # float32 chain on the card against float64 on the CPU ---------------
    mark("section 7b")
    v2_train = check_v2_plain_training(dev)

    # 8. evaluation on the card: run_eval at threshold 0.005, v2p and v1 ----
    # With the serving weights of 4 and 3 every slot of the v2p grid and
    # most of the v1 grid pass the threshold: B2 and B1 meet their most
    # candidates. (The v2p weights of 7, taught mostly "no object" in 30
    # steps, put no slot above it.)
    mark("section 8")
    erng = np.random.RandomState(5)
    evals = {
        "eval_v2p_416": check_eval(
            "v2p", vyolo, v2_detector(passthrough=True)[1],
            *train_batch(erng, EVAL_IMAGES, vyolo), dev),
        "eval_v1_448": check_eval("v1", yolo, v1_state,
                                  *train_batch(erng, EVAL_IMAGES, yolo), dev),
    }

    # 9. the native host layer ----------------------------------------------
    mark("section 9")
    demo, native_info = check_native()

    # 10. int8 serving at full width: v1 448², --v2 and v2p 416² ------------
    mark("section 10")
    int8 = {head: check_int8(head, cfg, st, imgs, dev) for head, cfg, st, imgs
            in (("v1", yolo, v1_state, images),
                ("v2", v2cfg, v2_state, v2_images),
                ("v2p", v2cfg, v2_detector(passthrough=True)[1], v2_images))}
    for head, r in int8.items():
        for name, err in r["errs"].items():
            errs[name] = max(errs[name], err)
    native_info["demo_cli"] = serve_demo_cli(demo, int8["v1"]["layers"],
                                             yolo, native_info, dev)
    evals["eval_int8_v1_448"] = check_eval(
        "v1 int8", yolo, v1_state, *train_batch(erng, EVAL_IMAGES, yolo),
        dev, calib=train_batch(erng, EVAL_BATCH, yolo)[0])

    # 11. the classifier at full width: training, int8, its three CLIs ----
    mark("section 11")
    cls_train = check_classifier_training(dev)
    cls_int8 = check_int8_classifier(cls_train.pop("trained"), dev)
    cls_clis = run_classifier_clis(dev)
    errs["max_pool2_bwd"] = max(errs["max_pool2_bwd"], cls_train["pool_err"])

    # 12. the ResNet50 family at full width: serving through B1 / B3 at
    # 224², detector training, the frozen-trunk fine-tune, the three CLIs
    mark("section 12")
    resnet_images = torch.from_numpy(np.random.RandomState(14).randint(
        0, 256, (BATCH, 224, 224, 3)).astype(np.uint8))
    resnet = check_resnet_serving(dev, resnet_images)
    for name in ("decode_nms", "decode_grid"):
        errs[name] = max(errs[name], resnet["errs"][name])
    resnet_train = check_resnet_training(dev)
    fine_tune = check_fine_tune(dev)
    resnet_clis = run_resnet_clis(dev)

    # 13. the slim tier: train_classifier / eval_classifier / flowers_train,
    # the zoo, the optimizer family, accumulation, remat, its train steps
    mark("section 13")
    slim = check_slim(dev)

    # 14. TF checkpoint import and adversarial training --------------------
    mark("section 14")
    tf_import = check_tf_import(dev)
    adversarial = check_adversarial(dev)

    # 15. parallelism: data-parallel and spatial steps, spatial serving,
    # the launcher, over a world-1 NCCL group ------------------------------
    mark("section 15")
    parallel = check_parallel(
        dev, images, v2_images,
        (v1_trained, images24, labels24),
        (("v1", tyolo, v1_trained, images24[:PAR_TRAIN_BATCH],
          labels24[:PAR_TRAIN_BATCH]),
         ("v2p", vyolo, v2p_trained, vimages[:PAR_TRAIN_BATCH],
          vlabels[:PAR_TRAIN_BATCH])))
    for name, err in parallel["spatial_serving"]["errs"].items():
        errs[name] = max(errs[name], err)

    # 16. the quality program, small: fixture, pretrain, v1 in two calls,
    # v2p with k-means priors, int8 on the v1 snapshot
    mark("section 16")
    quality = check_quality_program(dev)

    # 17. times --------------------------------------------------------------
    mark("section 17")
    print(f"times on {card}:")
    v1_flops = conv_flops_per_image(448, yolo.cell_channels)
    tf32 = (f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    path = {
        "v1_448": time_path(v1_detect, images, dev, "v1 448²", v1_flops),
        "v1_448_pallas_stem": time_path(
            stem_detect[torch.bfloat16], images, dev,
            "v1 448² --pallas-stem", v1_flops),
        "v1_448_f32": time_path(
            make_detect_fn(yolo, v1_state, object_thresh=0.5, use_nms=True,
                           dtype=torch.float32), images, dev,
            f"v1 448² float32 ({tf32})", v1_flops, F32_OPS_PER_S),
        "v1_448_f32_pallas_stem": time_path(
            stem_detect[torch.float32], images, dev,
            f"v1 448² float32 --pallas-stem ({tf32})", v1_flops,
            F32_OPS_PER_S),
        "v2p_416": time_path(v2p_detect, v2_images, dev, "v2p 416²",
                             conv_flops_per_image(416, v2cfg.cell_channels,
                                                  passthrough=True)),
        "train_224": detector_train_times(trainer, tstate, trng, tyolo),
        "train_checks": train_check,
        "train_v2p_416": {
            **detector_train_times(vtrainer, vstate, vrng, vyolo),
            "losses": vlosses, "burnin_losses": vburnin,
            "max_pool2_bwd_launches": v2p_pool_launches,
            "checks": v2p_train_check},
        "train_v2_224": v2_train,
        **evals,
        "train_cls_224": cls_train,
        "int8_cls_224": cls_int8,
        "cls_clis": cls_clis,
        "resnet50_224": {
            **time_path(resnet["detect"], resnet_images, dev,
                        "resnet50 224²", resnet50_flops_per_image(
                            224, grid_outputs=1470)),
            "grid_rel_err": resnet["grid_rel_err"],
            "launches": resnet["launches"]},
        "train_resnet50_224": resnet_train,
        "fine_tune_resnet50_224": fine_tune,
        "resnet_clis": resnet_clis,
        "slim": slim,
        "tf_import": tf_import,
        "adversarial": adversarial,
        "parallel": parallel,
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
    }
    for head, imgs, size in (("v1", images, 448), ("v2", v2_images, 416),
                             ("v2p", v2_images, 416)):
        cfg = yolo if head == "v1" else v2cfg
        flops = conv_flops_per_image(size, cfg.cell_channels,
                                     passthrough=head == "v2p")
        detect = int8[head]["detect"]
        timed = time_path(detect, imgs, dev, f"int8 {head} {size}²", flops,
                          INT8_OPS_PER_S)
        xb = imgs[:BATCH].to(dev)
        timed["profile"] = int8_phase_profile(
            lambda: detect(xb), f"{head} {size}² batch {BATCH}")
        del xb
        timed["bound_ms"] = BATCH * flops / INT8_OPS_PER_S * 1e3
        print(f"int8 {head} {size}², batch {BATCH}: operation bound "
              f"{timed['bound_ms']:.3f} ms ({flops / 1e9:.2f} GOP an image "
              f"at {INT8_OPS_PER_S / 1e12:.0f} int8 TOPS); the call takes "
              f"{timed[BATCH]['ms_per_batch']:.3f} ms")
        path[f"int8_{head}_{size}"] = {
            **timed, "checks": {k: int8[head][k] for k in (
                "launches", "errs", "calib_rel_err", "grid_rel_err",
                "fed_inputs")}}
    path["native"] = native_info
    del trainer, tstate, vtrainer, vstate

    kept_v1 = (cd.decode_nms_plain(v1_grid, yolo, 0.5, 0.5, K).scores > 0
               ).sum(1)
    kept_v2 = (cd.decode_nms_v2_plain(v2_grid, v2cfg, 0.5, 0.5, K).scores
               > 0).sum(1)
    runs = {  # name → (kernel, plain version, bound, shape, kernel at K=1)
        "decode_nms": (
            lambda: cd.decode_nms_fused(v1_grid, yolo, 0.5, 0.5, K),
            lambda: cd.decode_nms_plain(v1_grid, yolo, 0.5, 0.5, K),
            decode_bound(yolo, BATCH, kept_v1), "448² (S=14), threshold 0.5",
            lambda: cd.decode_nms_fused(v1_grid, yolo, 0.5, 0.5, 1)),
        "decode_nms_v2": (
            lambda: cd.decode_nms_fused(v2_grid, v2cfg, 0.5, 0.5, K),
            lambda: cd.decode_nms_v2_plain(v2_grid, v2cfg, 0.5, 0.5, K),
            decode_bound(v2cfg, BATCH, kept_v2),
            "416² (S=13, B=5), threshold 0.5",
            lambda: cd.decode_nms_fused(v2_grid, v2cfg, 0.5, 0.5, 1)),
        "decode_grid": (
            lambda: cd.decode_grid_fused(v1_grid, yolo, 0.5),
            lambda: cd.decode_grid_plain(v1_grid, yolo, 0.5),
            decode_bound(yolo, BATCH), "448² (S=14), threshold 0.5", None),
    }
    launches_int8 = {  # the decode kernels' launches on the int8 paths
        "decode_nms": {"int8_v1_448": int8["v1"]["launches"]["decode_nms"]},
        "decode_nms_v2": {f"int8_{h}_416": int8[h]["launches"]["decode_nms_v2"]
                          for h in ("v2", "v2p")},
        "decode_grid": {
            "int8_v1_448": int8["v1"]["launches"]["decode_grid"],
            "int8_v1_448_host_nms": native_info["demo_cli"]["launches"][
                "decode_grid"]},
    }
    rgrid, ryolo = resnet["grid"], resnet["yolo"]
    kept_resnet = (cd.decode_nms_plain(rgrid, ryolo, RESNET_THRESH, 0.5, K)
                   .scores > 0).sum(1)
    runs.update({  # B1 and B3 on the ResNet grid, at the CLI's threshold
        "decode_nms_resnet": (
            lambda: cd.decode_nms_fused(rgrid, ryolo, RESNET_THRESH, 0.5, K),
            lambda: cd.decode_nms_plain(rgrid, ryolo, RESNET_THRESH, 0.5, K),
            decode_bound(ryolo, BATCH, kept_resnet),
            f"224² (S=7), ResNet50 grid, threshold {RESNET_THRESH}", None),
        "decode_grid_resnet": (
            lambda: cd.decode_grid_fused(rgrid, ryolo, RESNET_THRESH),
            lambda: cd.decode_grid_plain(rgrid, ryolo, RESNET_THRESH),
            decode_bound(ryolo, BATCH),
            f"224² (S=7), ResNet50 grid, threshold {RESNET_THRESH}", None)})
    launches["decode_nms_resnet"] = resnet["launches"]["decode_nms"]
    launches["decode_grid_resnet"] = resnet["launches"]["decode_grid"]
    errs["decode_nms_resnet"] = resnet["errs"]["decode_nms"]
    errs["decode_grid_resnet"] = resnet["errs"]["decode_grid"]
    launches_int8.update(decode_nms_resnet={}, decode_grid_resnet={})
    launches_tf_import = {"decode_nms": tf_import["detect_launches"]}
    kernels = []
    for name, (fused, plain, (bound, by), shape, one_step) in runs.items():
        ms = graph_ms(fused)
        call_ms = cuda_ms(fused, 200)
        plain_ms = cuda_ms(plain, 5)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[name.removesuffix("_resnet")],
            "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "call_ms": call_ms, "launches_int8": launches_int8[name]})
        if name in launches_tf_import:  # the detect CLI on a TF checkpoint
            kernels[-1]["launches_tf_import_cli"] = launches_tf_import[name]
        if name in ("decode_nms", "decode_grid", "decode_nms_v2"):
            serving = parallel["spatial_serving"]["launches"]
            kernels[-1]["launches_spatial_serving"] = serving[
                "v2p" if name == "decode_nms_v2" else "v1"][name]
        eval_runs = {  # the same kernel under evaluation (section 8)
            ev_name: {k: ev[k] for k in (
                "threshold", "batch", "launches", "candidates_per_image",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
            for ev_name, ev in evals.items() if ev["kernel"] == name}
        if eval_runs:
            kernels[-1]["eval"] = eval_runs
        print(f"{name}, batch {BATCH}, {shape}: kernel "
              f"{ms * 1e3:.2f} us (graph replay; {call_ms * 1e3:.2f} us a "
              f"call from Python), plain {plain_ms * 1e3:.1f} us, bound "
              f"{bound * 1e3:.2f} us ({by}); no single PyTorch call computes "
              f"it")
        if one_step is not None:  # the decode and one step: the sweep's share
            kernels[-1]["k1_ms"] = k1_ms = graph_ms(one_step)
            print(f"  the same with K=1: {k1_ms * 1e3:.2f} us, so "
                  f"{(ms - k1_ms) / (K - 1) * 1e3:.2f} us a further step")

    sites = time_pool_sites(dev, TRAIN_BATCHES[0])
    for s in sites:
        print(f"max_pool2_bwd, bf16 {tuple(s['shape'])}: kernel "
              f"{s['ms'] * 1e3:.2f} us, max_pool2d_with_indices_backward "
              f"{s['library_ms'] * 1e3:.2f} us, plain {s['plain_ms']:.3f} "
              f"ms, bound {s['bound_ms'] * 1e3:.2f} us ({s['bound_by']}); "
              f"{s['copies']} input sets in turn")
    keys = ("ms", "library_ms", "plain_ms", "bound_ms")
    total = {k: sum(s[k] for s in sites) for k in keys}
    cls_sites = time_pool_sites(dev, CLS_BATCHES[0])
    cls_total = {k: sum(s[k] for s in cls_sites) for k in keys}
    kernels.append({
        "name": "max_pool2_bwd", "route": "cuda", "source": POOL_SOURCE,
        "replaces": TPU_KERNELS["max_pool2_bwd"],
        "launches": launches["max_pool2_bwd"],
        "max_abs_err": errs["max_pool2_bwd"],
        "launches_v2p_train": v2p_pool_launches,
        "launches_classifier_train": cls_train["launches"],
        "launches_classifier_clis": cls_clis["train_launches"],
        "launches_train_classifier_cli": slim["clis"]["train_launches"],
        "launches_flowers_train_cli": slim["clis"]["flowers_launches"],
        "launches_prepared_darknet19_cli":
            slim["data tier clis"]["darknet19_launches"],
        "launches_yolo1_pretrain_accum": slim["accumulation"]["launches"],
        "launches_adversarial_pair": adversarial["launches_adversarial_pair"],
        "launches_dp_step": parallel["dp"]["launches"],
        "launches_spatial_step": {
            h: parallel["spatial_train"][h]["launches"] for h in ("v1",
                                                                  "v2p")},
        "launches_train_classifier_mesh":
            parallel["clis"]["in_process_launches"],
        "launches_timed_steps": {k: v[b]["max_pool2_bwd_launches"]
                                 for k, v in slim["times"].items()
                                 for b in v},
        **total,
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in sites)
        else "operations", "sites": sites,
        "classifier_batch_48": {**cls_total, "sites": cls_sites}})
    for r in cls_sites:
        print(f"max_pool2_bwd, bf16 {tuple(r['shape'])}: kernel "
              f"{r['ms'] * 1e3:.2f} us, max_pool2d_with_indices_backward "
              f"{r['library_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us")
    for batch, tot in ((TRAIN_BATCHES[0], total), (CLS_BATCHES[0], cls_total)):
        print(f"max_pool2_bwd, the five sites of a 224² bf16 step at batch "
              f"{batch}: kernel {tot['ms'] * 1e3:.2f} us, "
              f"max_pool2d_with_indices_backward "
              f"{tot['library_ms'] * 1e3:.2f} us, plain "
              f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms'] * 1e3:.2f} "
              f"us")
    st = time_stem(dev, yolo, v1_state, images[:BATCH])
    kernels.append({
        "name": "stem", "route": "cuda", "source": STEM_SOURCE,
        "replaces": TPU_KERNELS["stem"], "launches": launches["stem"],
        "max_abs_err": errs["stem"], "library_ms": None, **st})
    print(f"stem (B4), bf16 {tuple(st['shape'])}: kernel {st['ms']:.3f} ms "
          f"(graph replay), the stock stem (conv1, bias, leaky, pool, "
          f"conv2, bias, leaky, pool) {st['stock_stem_ms']:.3f} ms, plain "
          f"{st['plain_ms']:.3f} ms; bound {st['bound_ms']:.3f} ms "
          f"({st['bound_by']}: bytes {st['bytes_bound_ms']:.3f} ms, "
          f"operations {st['ops_bound_ms']:.3f} ms); no single PyTorch call "
          f"computes it")
    st = time_stem(dev, yolo, v1_state, images[:BATCH], torch.float32)
    kernels.append({
        "name": "stem_f32", "route": "cuda", "source": STEM_F32_SOURCE,
        "replaces": TPU_KERNELS["stem_f32"], "launches": launches["stem_f32"],
        "max_abs_err": errs["stem_f32"], "library_ms": None, **st})
    print(f"stem_f32 (B4-f32), float32 {tuple(st['shape'])}: kernel "
          f"{st['ms']:.3f} ms (graph replay), the stock float32 stem "
          f"{st['stock_stem_ms']:.3f} ms with TF32 off, "
          f"{st['stock_stem_tf32_ms']:.3f} ms with TF32 on (not held to "
          f"1e-5), plain {st['plain_ms']:.3f} ms (TF32 off); bound "
          f"{st['bound_ms']:.3f} ms ({st['bound_by']}: FMA "
          f"{st['ops_bound_ms']:.3f} ms, bytes {st['bytes_bound_ms']:.3f} "
          f"ms; 3xTF32 on the tensor cores {st['ops_bound_3xtf32_ms']:.3f} "
          f"ms); no single PyTorch call computes it")
    mark("done")
    print(json.dumps({"path": path, "quality": quality, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
