"""Metrics logging for the train loop (JSON lines with steps/sec) and the
latency-window aggregation the serving stack's ``stats()`` snapshots are
built on (counterpart of the JAX package's ``utils/logging.py``)."""

from __future__ import annotations

import json
import math
import sys
import threading
import time
from collections import deque
from typing import IO, Mapping

__all__ = ["LatencyWindow", "MetricsLogger"]


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


class MetricsLogger:
    """JSON-lines metrics logger with steps/sec tracking.

    Keeps host state only; pass scalars the caller has already read (tensors
    are read with ``float``), so the logger decides no device sync of its
    own. ``every``: log steps that are multiples of it. ``schema`` (a field
    set of ``obs/metrics_schema.py``, with ``schema_prefixes`` for dynamic
    families such as ``eval/``) turns on the emit-time check: an undeclared
    field warns on stderr and the line still prints.
    """

    def __init__(self, stream: IO | None = None, every: int = 1,
                 schema: frozenset | None = None, schema_prefixes: tuple = ()):
        self.stream = stream or sys.stdout
        self.every = every
        self.schema = schema
        self.schema_prefixes = tuple(schema_prefixes)
        self._last_time: float | None = None
        self._last_step: int | None = None

    @staticmethod
    def _warn_unregistered(record: Mapping, schema, prefixes) -> None:
        from distributed_sigmoid_loss_tpu_torch.obs.metrics_schema import validate_metrics

        problems = validate_metrics(dict(record), fields=schema, prefixes=tuple(prefixes))
        if problems:
            print("WARNING: metrics schema violation: " + "; ".join(problems), file=sys.stderr)

    @staticmethod
    def _jsonable(v):
        # Scalars as float; strings as they are; small count vectors as a
        # list of floats, so the line stays one self-describing record.
        if isinstance(v, str):
            return v
        try:
            return float(v)
        except (TypeError, ValueError, RuntimeError):
            return [float(x) for x in v]

    def log(self, step: int, metrics: Mapping[str, float], *, force: bool = False) -> None:
        """``force=True`` (out-of-band records, e.g. in-training eval)
        bypasses the ``every`` filter AND leaves the steps/sec clock alone,
        so the eval's wall time lands in the next train interval."""
        if step % self.every and not force:
            return
        now = time.perf_counter()
        record = {"step": step}
        record.update({k: self._jsonable(v) for k, v in metrics.items()})
        if not force:
            if self._last_time is not None and step > self._last_step:
                record["steps_per_sec"] = (step - self._last_step) / (now - self._last_time)
            self._last_time, self._last_step = now, step
        if self.schema is not None:
            self._warn_unregistered(record, self.schema, self.schema_prefixes)
        self.write(record)

    def write(self, record: Mapping, schema: frozenset | None = None,
              schema_prefixes: tuple = ()) -> None:
        """Emit a raw JSON-lines record with no step bookkeeping. ``schema``
        checks it against another registry than the constructor's (the
        serving stack's stats snapshots, health events)."""
        if schema is not None:
            self._warn_unregistered(record, schema, schema_prefixes)
        self.stream.write(json.dumps(dict(record)) + "\n")
        self.stream.flush()
