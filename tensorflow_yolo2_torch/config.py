"""Configuration (port of tensorflow_yolo2_tpu/config.py).

The pieces the serving and training paths read: the run-directory
layout (``root_dir``, ``Paths``, ``TRAIN_SNAPSHOT_PREFIX``),
``YoloConfig`` with its channel layout, loss weights, the YOLOv2 loss's
stabilizers, grid offset and ``at_scale``, ``yolo_grid_offset``, the
anchor head's ``yolo_v2_config`` with ``CLASSIC_VOC_ANCHORS``, the
optimizer knobs ``LRScheduleConfig`` / ``OptimizerConfig``,
``scope_matches`` and ``VOC_CLASSES``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

# The run-directory root: $TFY2_ROOT, else the repository root.
_DEFAULT_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                             os.pardir))


def root_dir() -> str:
    return os.environ.get("TFY2_ROOT", _DEFAULT_ROOT)


@dataclass(frozen=True)
class Paths:
    """Run-directory layout, the JAX package's: ``data/VOCdevkit``,
    ``data/ILSVRC``, ``data/TF_flowers``, ``cache/``, ``weights/``, ``ckpts/<net>/<imdb>/``,
    ``tensorboard/<net>/<imdb>/``."""

    root: str = field(default_factory=root_dir)

    @property
    def pascal(self) -> str:
        return os.path.join(self.root, "data", "VOCdevkit")

    @property
    def ilsvrc(self) -> str:
        return os.path.join(self.root, "data", "ILSVRC")

    @property
    def flowers(self) -> str:
        return os.path.join(self.root, "data", "TF_flowers")

    @property
    def cache(self) -> str:
        return os.path.join(self.root, "cache")

    @property
    def weights(self) -> str:
        return os.path.join(self.root, "weights")

    @property
    def ckpts(self) -> str:
        return os.path.join(self.root, "ckpts")

    @property
    def tensorboard(self) -> str:
        return os.path.join(self.root, "tensorboard")

    def ckpts_dir(self, network_name: str, imdb_name: str) -> str:
        """The (created) checkpoint dir of one (network, dataset) run."""
        out = os.path.join(self.ckpts, network_name, imdb_name)
        os.makedirs(out, exist_ok=True)
        return out

    def tb_dirs(self, network_name: str, imdb_name: str, val: bool = True):
        """The (created) train and val metric dirs; val is None unless
        ``val``."""
        out = os.path.join(self.tensorboard, network_name, imdb_name)
        train_dir = os.path.join(out, "train")
        os.makedirs(train_dir, exist_ok=True)
        val_dir = None
        if val:
            val_dir = os.path.join(out, "val")
            os.makedirs(val_dir, exist_ok=True)
        return train_dir, val_dir


# Snapshot dirs are named <prefix>_<iter|epoch>_<N>.
TRAIN_SNAPSHOT_PREFIX = "train"


def scope_matches(key: str, scopes, sep: str = ".") -> bool:
    """True when ``key`` lies inside a scope prefix, matched per path
    component: ``backbone.conv1`` matches ``backbone.conv1.conv.weight``
    but not ``backbone.conv19.conv.weight``."""
    return any(key == s or key.startswith(s + sep) for s in scopes)


def yolo_grid_offset(S: int, B: int) -> np.ndarray:
    """The [S, S, B] column-index offset grid.

    ``offset[y, x, b] == x``; its (1, 0, 2) transpose gives the row index.
    """
    off = np.tile(np.arange(S, dtype=np.float32), S * B).reshape(B, S, S)
    return np.transpose(off, (1, 2, 0))


@dataclass(frozen=True)
class YoloConfig:
    """YOLO grid-detection head and loss hyperparameters.

    The v1 head emits ``S*S`` cells with channel layout
    ``[num_class | B confidences | B*(x, y, w, h)]`` (5B + C channels).
    ``per_slot_classes`` selects the YOLOv2 anchor layout, ``B*(5 + C)``
    channels: each slot carries ``(x, y, w, h, conf, C class logits)``.
    The ``v2_*`` fields are the YOLOv2 loss's training stabilizers
    (``losses.yolo_v2``).
    """

    S: int = 7
    B: int = 2
    num_class: int = 20
    image_size: int = 224
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5
    per_slot_classes: bool = False
    # Anchor priors (w, h) in grid-cell units; v2 decode only.
    anchors: tuple[tuple[float, float], ...] = ()
    # A non-owner slot whose decoded box overlaps any ground-truth box of
    # its image by more than this IoU is exempt from the no-object term
    # (darknet's region-layer thresh); 1.0 turns the exemption off.
    v2_ignore_iou: float = 0.6
    # For the first N training samples (step · batch), non-owner raw boxes
    # are regressed toward their prior at the cell centre with weight
    # v2_prior_weight (darknet's seen < 12800 burn-in); active only when
    # the trainer passes the step count to the loss.
    v2_burnin_samples: int = 12800
    v2_prior_weight: float = 0.01
    # Scale each object's coordinate term by (2 − w·h), w and h as image
    # fractions, so that small boxes weigh up to 2×.
    v2_coord_scale: bool = True

    @property
    def cell_channels(self) -> int:
        if self.per_slot_classes:
            return self.B * (5 + self.num_class)
        return self.num_class + 5 * self.B

    @property
    def offset(self) -> np.ndarray:
        return yolo_grid_offset(self.S, self.B)

    def at_scale(self, S: int) -> "YoloConfig":
        """This config re-gridded to an ``S``-cell grid (input = 32·S px).

        Anchor priors are in grid-cell units, so they rescale by the
        grid-size ratio: constant as image fractions. The product is not
        rounded, as in the JAX package: from a 13-grid config the anchors
        equal ``yolo_v2_config(32*S)``'s bit for bit, from another grid
        to within 2 ulp in double, and equal after the float32 rounding
        the decode uses."""
        if S == self.S:
            return self
        factor = S / self.S
        return dataclasses.replace(
            self, S=S, image_size=self.image_size * S // self.S,
            anchors=tuple((w * factor, h * factor)
                          for w, h in self.anchors))


# Classic YOLOv2 VOC anchor priors in 13-grid cell units (the YOLO9000
# k-means priors, yolo-voc.cfg); the --v2 heads serve with them unless an
# anchors.json gives others.
CLASSIC_VOC_ANCHORS = (
    (1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
    (8.98282, 9.77052), (11.2364, 10.0071))


def yolo_v2_config(image_size: int = 224,
                   anchors: tuple[tuple[float, float], ...] | None = None
                   ) -> YoloConfig:
    """Anchor-head ``YoloConfig`` at ``image_size`` (multiple of 32).

    Default priors are ``CLASSIC_VOC_ANCHORS`` rescaled from the 13-grid
    to S = image_size/32; ``anchors`` ((w, h) pairs already in this
    grid's cell units) override them, and B follows their count."""
    S = image_size // 32
    if anchors is None:
        scale = S / 13.0
        anchors = tuple((w * scale, h * scale)
                        for w, h in CLASSIC_VOC_ANCHORS)
    else:
        anchors = tuple((float(w), float(h)) for w, h in anchors)
    return YoloConfig(S=S, image_size=image_size, B=len(anchors),
                      per_slot_classes=True, anchors=anchors)


@dataclass(frozen=True)
class LRScheduleConfig:
    """Learning-rate schedule: ``kind`` is fixed, exponential (staircase
    every ``decay_steps``), polynomial or cosine, after an optional linear
    warmup. ``offset_steps`` is subtracted from the optimizer's step count
    (clamped at 0) before the schedule is evaluated, so that a resumed run
    decays over its own iterations."""

    kind: str = "fixed"
    learning_rate: float = 1e-3
    decay_factor: float = 0.94
    decay_steps: int = 10_000
    end_learning_rate: float = 1e-4
    power: float = 1.0
    warmup_steps: int = 0
    offset_steps: int = 0


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer family and hyperparameters, with the JAX package's fields
    and defaults: ``name`` is one of sgd, momentum, adam, adamw, lamb,
    rmsprop, adagrad, ftrl and adadelta, each with global-norm clipping,
    weight decay, EMA (``moving_average_decay``), ``trainable_scopes``
    and gradient accumulation (``train.optimizers.make_optimizer``)."""

    name: str = "adam"
    momentum: float = 0.9
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    epsilon: float = 1e-8
    rmsprop_decay: float = 0.9
    adadelta_rho: float = 0.95
    ftrl_learning_rate_power: float = -0.5
    ftrl_initial_accumulator_value: float = 0.1
    ftrl_l1: float = 0.0
    ftrl_l2: float = 0.0
    weight_decay: float = 0.0
    grad_clip_norm: float | None = None
    moving_average_decay: float | None = None
    trainable_scopes: tuple[str, ...] = ()
    grad_accum_steps: int = 1
    schedule: LRScheduleConfig = field(default_factory=LRScheduleConfig)


# VOC2007 class list.
VOC_CLASSES: Sequence[str] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
