"""Host-side tracing spans: the host half of the run's timeline (the port's
copy of the JAX package's ``obs/spans.py``).

``utils.profiling.trace`` captures what the device did (``torch.profiler``'s
kernel and operator events); :class:`SpanRecorder` captures what the host
did around it: where a step interval went between fetch, h2d commit, step,
eval and checkpoint, or where a serve request sat between queue, batch
assembly and the engine call.

- **Thread-safe, ring-buffered**: producers append under a lock into a
  ``deque(maxlen=capacity)``, so a long-lived trainer or service never grows
  its tracing state; the newest ``capacity`` spans win.
- **Near-zero cost when disabled**: ``span()`` on a disabled recorder
  returns one preallocated no-op context manager: no allocation, no clock
  read, no lock.
- **Chrome-trace JSON export**: ``chrome_trace()`` writes the
  ``traceEvents`` format the device profiler writes, under a pid of its own,
  so the host timeline overlays a ``utils.profiling.trace`` capture in
  ui.perfetto.dev, and ``obs summarize`` merges both into one report.

Nesting needs no explicit tracking: spans carry (tid, ts, dur) and the
Chrome trace model nests same-thread spans by containment.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterable

from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = [
    "Span",
    "SpanRecorder",
    "summarize_spans",
    "merge_chrome_traces",
]

# One pid for every host span so perfetto groups them as a single "process"
# track beside the device's from utils.profiling.trace.
HOST_PID = 1_000_001


@dataclass(frozen=True)
class Span:
    """One completed host span. Times are ``time.perf_counter()`` seconds."""

    name: str
    t0: float
    t1: float
    tid: int

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _NoopSpan:
    """Reusable disabled-path context manager: no state, so one instance
    serves every call site and thread concurrently; the disabled hot path
    allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _LiveSpan:
    """Enabled-path context manager: records into its recorder on exit."""

    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.record(self._name, self._t0, time.perf_counter())
        return False


class SpanRecorder:
    """Ring-buffered recorder of nested host spans.

    ``with rec.span("step"): ...`` on the caller's thread; ``record(name,
    t0, t1)`` for spans whose start and end are observed on different control
    paths (the serve batcher's queue-wait: enqueue happens on the client
    thread, the batch flush on the worker). ``enabled=False`` (or
    ``disable()``) turns every ``span()`` into the shared no-op.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._lock = named_lock("obs.spans.SpanRecorder._lock")
        self.dropped = 0  # spans evicted by the ring (total ever)

    # -- recording -----------------------------------------------------------

    def span(self, name: str):
        """Context manager timing the enclosed block (no-op when disabled)."""
        if not self.enabled:
            return _NOOP
        return _LiveSpan(self, name)

    def record(self, name: str, t0: float, t1: float, tid: int | None = None) -> None:
        """Record one completed span (cross-thread span API)."""
        if not self.enabled:
            return
        s = Span(name, t0, t1, threading.get_ident() if tid is None else tid)
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)

    def disable(self) -> None:
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- export --------------------------------------------------------------

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def chrome_trace(self, label: str = "host") -> dict:
        """``{"traceEvents": [...]}``: the Perfetto/Chrome format the device
        profiler writes, so this file overlays a ``utils.profiling.trace``
        capture directly. Timestamps are perf_counter microseconds (a shared
        monotonic base across every recorder in the process)."""
        events: list[dict] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": HOST_PID,
                "args": {"name": f"python-{label}"},
            }
        ]
        tids = {}
        for s in self.spans():
            if s.tid not in tids:
                tids[s.tid] = len(tids)
                events.append({
                    "ph": "M",
                    "name": "thread_name",
                    "pid": HOST_PID,
                    "tid": tids[s.tid],
                    "args": {"name": f"{label}-thread-{tids[s.tid]}"},
                })
            events.append({
                "ph": "X",
                "name": s.name,
                "pid": HOST_PID,
                "tid": tids[s.tid],
                "ts": s.t0 * 1e6,
                "dur": (s.t1 - s.t0) * 1e6,
            })
        return {"traceEvents": events}

    def export(self, path: str, label: str = "host") -> None:
        """Write :meth:`chrome_trace` as JSON to ``path``."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(label), f)


def summarize_spans(spans: Iterable[Span]) -> dict[str, dict]:
    """Per-name aggregation: ``{name: {count, total_ms, mean_ms, p50_ms,
    p95_ms, max_ms}}`` sorted by total time descending. The host half of the
    ``obs summarize`` report."""
    by_name: dict[str, list[float]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.duration_s * 1000.0)
    out = {}
    for name, ds in sorted(
        by_name.items(), key=lambda kv: -sum(kv[1])
    ):
        ds.sort()
        n = len(ds)

        def rank(p):  # nearest-rank (the LatencyWindow convention)
            import math

            return ds[max(0, math.ceil(p / 100.0 * n) - 1)]

        out[name] = {
            "count": n,
            "total_ms": round(sum(ds), 3),
            "mean_ms": round(sum(ds) / n, 3),
            "p50_ms": round(rank(50), 3),
            "p95_ms": round(rank(95), 3),
            "max_ms": round(ds[-1], 3),
        }
    return out


def merge_chrome_traces(host_trace: dict, device_events: Iterable[list]) -> dict:
    """One combined ``traceEvents`` stream: host spans + every device event
    list (as ``utils.profiling.read_trace_files`` yields them). Device and
    host events keep their own pids, so perfetto shows them as separate
    processes on one shared timeline."""
    merged = list(host_trace.get("traceEvents", []))
    for events in device_events:
        merged.extend(events)
    return {"traceEvents": merged}
