"""Anchor priors persisted beside a snapshot (port of the serving half of
tensorflow_yolo2_tpu/data/anchors.py).

Training writes the priors its anchor head was fitted with to
``anchors.json`` (``{"S": grid, "anchors": [[w, h], ...]}``, cell units at
that grid); serving must decode with the same priors. The k-means fit and
the writer belong to training and are not ported yet.
"""

from __future__ import annotations

import json
import os

from tensorflow_yolo2_torch.config import YoloConfig, yolo_v2_config

ANCHORS_FILE = "anchors.json"


def load_anchors(ckpt_dir: str, S: int
                 ) -> tuple[tuple[float, float], ...] | None:
    """Priors from ``ckpt_dir/anchors.json`` rescaled to grid size S, or
    None when there is no such file.

    Like ``YoloConfig.at_scale`` they rescale linearly with S (constant
    as image fractions), so a snapshot serves at any 32·k resolution.
    """
    path = os.path.join(ckpt_dir, ANCHORS_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        payload = json.load(f)
    factor = S / float(payload["S"])
    return tuple((w * factor, h * factor) for w, h in payload["anchors"])


def v2_config_for_snapshot(snapshot_dir: str | None,
                           image_size: int) -> YoloConfig:
    """Anchor-head config with the priors of ``snapshot_dir/anchors.json``,
    else (no file, or no directory) the classic VOC priors."""
    stored = None
    if snapshot_dir is not None:
        stored = load_anchors(snapshot_dir, image_size // 32)
    return yolo_v2_config(image_size, anchors=stored)
