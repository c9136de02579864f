"""Wall-clock step timer (port of tensorflow_yolo2_tpu/utils/timer.py).

``time.perf_counter`` around a call; on the card a step returns before
the device finishes, so without a synchronize it times the launch.
"""

from __future__ import annotations

import time


class Timer:
    """tic/toc timer with running totals and average."""

    def __init__(self) -> None:
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self) -> None:
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff
