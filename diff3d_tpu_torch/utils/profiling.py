"""Host-side step timing (counterpart: ``diff3d_tpu/utils/profiling.py``,
its ``StepTimer``; the profiler window waits for the port's tools, which
use ``torch.profiler`` directly)."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np


class StepTimer:
    """Wall-clock per-step timing.

    ``tick()`` marks a step boundary; ``summary()`` reports mean / p50 /
    p95 / max milliseconds over the retained window.  Pure host-side:
    synchronise the device yourself at window edges for device-inclusive
    times (the serving engine's view step ends in a fetch).
    """

    def __init__(self, window: int = 512):
        self._window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self._window:
                self._times = self._times[-self._window:]
        self._last = now

    def reset(self) -> None:
        self._times.clear()
        self._last = None

    def summary(self) -> dict:
        if not self._times:
            return {}
        ms = np.asarray(self._times) * 1e3
        return {
            "step_ms_mean": float(ms.mean()),
            "step_ms_p50": float(np.percentile(ms, 50)),
            "step_ms_p95": float(np.percentile(ms, 95)),
            "step_ms_max": float(ms.max()),
        }
