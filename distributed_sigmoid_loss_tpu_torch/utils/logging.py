"""Latency-window aggregation the serving stack's ``stats()`` snapshots are
built on (counterpart of the JAX package's ``utils/logging.py``)."""

from __future__ import annotations

import math
import threading
from collections import deque

__all__ = ["LatencyWindow"]


class LatencyWindow:
    """Rolling window of request durations → nearest-rank percentiles.

    Bounded (``maxlen`` most recent samples) so a long-lived service never
    grows its metrics state; thread-safe because producers are the serving
    stack's client threads.
    """

    def __init__(self, maxlen: int = 8192):
        self._samples: deque[float] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.count = 0  # total ever recorded (not just retained)

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))
            self.count += 1

    def percentiles_ms(self, ps: tuple[int, ...] = (50, 95)) -> dict[str, float]:
        """{"p50_ms": ..., "p95_ms": ...} over the retained window (zeros when
        nothing has been recorded yet). Nearest rank: the p-th percentile of
        N sorted samples is the one at index ``ceil(p/100 · N) − 1``."""
        with self._lock:
            samples = sorted(self._samples)
        if not samples:
            return {f"p{p}_ms": 0.0 for p in ps}
        n = len(samples)
        out = {}
        for p in ps:
            idx = min(n - 1, max(0, math.ceil(p / 100.0 * n) - 1))
            out[f"p{p}_ms"] = round(samples[idx] * 1000.0, 3)
        return out
