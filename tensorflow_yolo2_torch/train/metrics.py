"""Metric writer (port of tensorflow_yolo2_tpu/train/metrics.py).

Scalars and histogram summaries of one stream (train or val) go to
``events.jsonl`` in the stream's dir, always, and to TensorBoard event
files when ``tensorboardX`` imports. Callers pass host values: the train
loop fetches each step's metrics from the device in one copy, a step
late, so that logging does not wait for the device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import numpy as np


class MetricsWriter:
    """Scalar/histogram writer for one stream."""

    def __init__(self, logdir: str, tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a",
                           buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except Exception:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)

    def scalars(self, step: int, values: Mapping[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[k] = float(np.asarray(v))
            if self._tb is not None:
                self._tb.add_scalar(k, rec[k], step)
        self._jsonl.write(json.dumps(rec) + "\n")

    def histogram(self, step: int, name: str, values: Any) -> None:
        arr = np.asarray(values).ravel()
        if self._tb is not None:
            self._tb.add_histogram(name, arr, step)
        qs = np.percentile(arr, [0, 25, 50, 75, 100]).tolist()
        self._jsonl.write(json.dumps(
            {"step": int(step), "hist": name, "quantiles": qs}) + "\n")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
