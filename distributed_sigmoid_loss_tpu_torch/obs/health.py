"""Training health watchdog and flight recorder (the port's copy of the JAX
package's ``obs/health.py``).

The step's scalars (``grad_norm`` / ``param_norm`` / ``update_ratio``,
``train/train_step.py``) are cheap device reductions; this module is the
host side that watches them: non-finite detection over every scalar of the
metrics line, loss-spike detection against a rolling median, structured
events instead of stderr prints, and a ring-buffered flight recorder that
dumps the last N metrics lines and events when the run dies (a crash, a
divergence or SIGTERM through ``train/resilience.py``), so a divergence at
3 a.m. leaves its trajectory behind, not only a traceback.

Policy is the caller's: :class:`HealthWatchdog` only detects and reports.
``policy="skip"`` marks events skippable, so the train loop can route them
into ``train_resilient``'s rollback-and-skip path.
"""

from __future__ import annotations

import json
import math
import sys
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = ["HealthEvent", "HealthWatchdog", "FlightRecorder"]


@dataclass(frozen=True)
class HealthEvent:
    """One structured watchdog event."""

    step: int
    event: str  # "non_finite" | "loss_spike"
    detail: str
    skippable: bool = False

    def record(self) -> dict:
        """The JSON-lines form (emitted through MetricsLogger.write)."""
        return {
            "metric": "health_event",
            "step": self.step,
            "event": self.event,
            "detail": self.detail,
        }


class HealthWatchdog:
    """Host-side anomaly detection over train metrics lines.

    ``observe(step, metrics)`` returns the (possibly empty) list of events:

    - ``non_finite``: any scalar on the line is NaN/Inf. Always skippable —
      a non-finite loss/grad-norm means the update is poison.
    - ``loss_spike``: loss exceeds ``spike_factor ×`` the rolling median of
      the last ``window`` FINITE losses (armed only once ``min_history``
      samples exist, so warmup noise never trips it). Skippable only under
      ``policy="skip"`` with ``skip_on_spike=True`` — a spike is suspicious,
      a rollback is a judgment call; default is to report, not intervene.

    Cheap by construction: one deque append + a sorted-median over a bounded
    window, only on lines whose loss is finite.
    """

    def __init__(
        self,
        window: int = 64,
        min_history: int = 8,
        spike_factor: float = 4.0,
        policy: str = "warn",  # "warn" | "skip"
        skip_on_spike: bool = False,
    ):
        if policy not in ("warn", "skip"):
            raise ValueError(f"policy must be 'warn' or 'skip', got {policy!r}")
        if spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {spike_factor} (a factor "
                "<= 1 would flag ordinary fluctuation as a spike)"
            )
        self.window = window
        self.min_history = max(2, min_history)
        self.spike_factor = spike_factor
        self.policy = policy
        self.skip_on_spike = skip_on_spike
        self._losses: deque[float] = deque(maxlen=window)
        self.events: list[HealthEvent] = []

    def observe(self, step: int, metrics: dict) -> list[HealthEvent]:
        out: list[HealthEvent] = []
        bad = []
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(fv):
                bad.append(k)
        if bad:
            out.append(HealthEvent(
                step, "non_finite",
                f"non-finite metric(s) {bad} — poisoned batch, overflow, or "
                "a flaky interconnect; the update is not trustworthy",
                skippable=self.policy == "skip",
            ))
        loss = metrics.get("loss")
        if loss is not None and not bad:
            fl = float(loss)
            if len(self._losses) >= self.min_history:
                ordered = sorted(self._losses)
                median = ordered[len(ordered) // 2]
                # abs(): the sigmoid loss is positive, but a softmax/debug
                # objective near zero must not divide the factor away.
                if abs(fl) > self.spike_factor * max(abs(median), 1e-12):
                    out.append(HealthEvent(
                        step, "loss_spike",
                        f"loss {fl:.6g} is >{self.spike_factor}x the rolling "
                        f"median {median:.6g} over the last "
                        f"{len(self._losses)} steps",
                        skippable=self.policy == "skip" and self.skip_on_spike,
                    ))
            self._losses.append(fl)
        self.events.extend(out)
        return out

    def should_skip(self, events: list[HealthEvent]) -> bool:
        return any(e.skippable for e in events)


class FlightRecorder:
    """Ring buffer of the last N metrics lines + health events, dumped on
    crash/preemption.

    ``note_metrics`` / ``note_event`` are O(1) deque appends (bounded — a
    week-long run holds exactly ``capacity`` lines). ``dump`` writes ONE
    JSON document with the retained trajectory and the dump reason; it is
    idempotent-safe to call from both an except-path and a finally-path
    (every call writes, callers decide where). Wired through
    ``train_resilient(flight=...)``: divergence raise, loop crash, and the
    SIGTERM preemption stop all dump before control leaves the loop.
    """

    def __init__(self, capacity: int = 256, path: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.path = path  # default dump target (None -> one stderr line)
        self._metrics: deque[dict] = deque(maxlen=capacity)
        self._events: deque[dict] = deque(maxlen=capacity)
        self.dumps = 0

    def note_metrics(self, step: int, metrics: dict) -> None:
        line = {"step": int(step)}
        for k, v in metrics.items():
            try:
                line[k] = float(v)
            except (TypeError, ValueError):
                line[k] = str(v)
        self._metrics.append(line)

    def note_event(self, event: HealthEvent) -> None:
        self._events.append(event.record())

    def snapshot(self, reason: str) -> dict:
        return {
            "flight_recorder": {
                "reason": reason,
                "wall_time": time.time(),
                "capacity": self.capacity,
                "metrics": list(self._metrics),
                "events": list(self._events),
            }
        }

    def dump(self, reason: str, path: str | None = None, stream=None) -> dict:
        """Write the snapshot to ``path`` (one JSON file; defaults to the
        constructor's ``path``) or ``stream`` (default stderr, one JSON
        line). Returns the snapshot dict."""
        snap = self.snapshot(reason)
        self.dumps += 1
        if path is None and stream is None:
            path = self.path
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(snap, f, indent=1)
        else:
            print(json.dumps(snap), file=stream or sys.stderr, flush=True)
        return snap
