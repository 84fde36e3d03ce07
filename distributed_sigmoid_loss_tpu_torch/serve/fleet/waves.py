"""Fleet swap waves: SwapController generalized to coordinated
version fan-out across replicas.

A single-host :class:`~..swap.SwapController` publishes a new version with
zero downtime on ONE engine. Across a fleet the hard part is the window in
which replicas disagree about the current version: without coordination a
session could bounce between versions mid-conversation (embedding-space
incompatibility presented as "results got worse then better then worse").
The wave controller imposes the ordering that, combined with the router's
session-affinity pinning, makes that impossible:

1. waves are serialized (the controller lock — at most one wave in flight,
   the single-host swap-storm contract lifted to the fleet);
2. replicas swap in declared (wave) order, one at a time: **drain** (router
   stops new traffic; the replica's ``/healthz`` shows
   ``reasons=["swap_in_flight"]`` so the router can tell this drain from
   overload) → **wait idle** (zero in-flight — no request ever spans the
   version flip) → **swap** (the replica's own swap path: for a real
   engine, ``swap_params`` — zero recompiles, ``compile_count`` flat) →
   **undrain**;
3. sessions pinned to the old version keep landing on not-yet-swapped
   replicas; sessions created after a replica publishes the new version pin
   to it; once the last replica swaps, old-version sessions re-pin — only
   upward, only while idle (router invariant). At no instant do two
   versions serve one session.

A replica that is LOST when its turn comes is skipped (it picks the
version up on restart/revive — the rolling wave must not wedge behind a
dead host); the skip is visible in the wave result.
"""

from __future__ import annotations

import threading
import time

from distributed_sigmoid_loss_tpu_torch.utils.logging import LatencyWindow

__all__ = ["WaveController"]


class WaveController:
    """Wave-ordered version fan-out over a :class:`~.router.FleetRouter`.

    ``drain_timeout_s`` bounds the per-replica wait-idle barrier — a wedged
    replica fails the wave with a ``TimeoutError`` instead of wedging the
    controller forever.
    """

    def __init__(self, router, *, drain_timeout_s: float = 10.0):
        self.router = router
        self.drain_timeout_s = float(drain_timeout_s)
        self._lock = threading.Lock()
        self._wave_id = 0
        self._window = LatencyWindow(256)

    def _begin_wave_locked(self) -> int:
        self._wave_id += 1
        return self._wave_id

    def run_wave(self) -> dict:
        """Run one coordinated swap wave; returns ``{"wave_id", "swapped",
        "skipped", "duration_s"}``. Replica swap callables come from each
        :class:`~.router.ReplicaHandle`'s ``swap_fn`` (no-arg: the host
        closure knows what to publish — the double-buffered build is the
        host's job, exactly as in the single-host SwapController)."""
        t0 = time.monotonic()
        with self._lock:
            wave = self._begin_wave_locked()
            swapped, skipped = self._fan_out()
        duration = time.monotonic() - t0
        self._window.record(duration)
        return {
            "wave_id": wave,
            "swapped": swapped,
            "skipped": skipped,
            "duration_s": duration,
        }

    def _fan_out(self) -> tuple:
        """One replica at a time, wave order (controller lock held by
        run_wave — the lock IS the one-wave-at-a-time contract; the drain
        barrier polls via router.wait_idle, which sleeps without holding
        any router lock)."""
        swapped, skipped = [], []
        for replica in self.router.handles():
            status, _reasons = self.router._assess(replica)
            if status == "lost":
                skipped.append(replica.name)
                continue
            self.router.drain(replica.name)
            try:
                self.router.wait_idle(
                    replica.name, timeout_s=self.drain_timeout_s
                )
                if replica.swap_fn is not None:
                    replica.swap_fn()
                swapped.append(replica.name)
            finally:
                self.router.undrain(replica.name)
        return swapped, skipped

    def stats(self) -> dict:
        with self._lock:
            snap = {"wave_id": self._wave_id}
        return snap
