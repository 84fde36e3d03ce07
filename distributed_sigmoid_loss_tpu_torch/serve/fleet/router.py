"""Fleet router: one logical front door over N serving replicas.

Health-driven routing with the failure vocabulary the single-host stack
already speaks:

- **healthy** replicas share traffic by smooth weighted round-robin
  (deficit credits: each pick adds every candidate's weight to its credit,
  the max-credit candidate wins and pays the round's total — deterministic,
  no RNG in the routing path).
- **degraded** replicas are kept or drained by CAUSE, which is why
  ``/healthz`` grew the structured ``reasons`` list: ``"swap_in_flight"``
  means the wave controller is draining the replica for a version swap (no
  new traffic), while ``"shedding"`` means overloaded-but-serving — pulling
  an overloaded replica out of rotation would concentrate load on its
  siblings and collapse the fleet, so it stays routable.
- **lost** replicas (health probe raised, or a call surfaced
  :class:`~..siege.HostLostError`) are marked and the request retries on a
  sibling — the typed-error + reroute contract; when no sibling remains the
  caller gets a typed :class:`NoReplicaError`, never a hang or a silent
  drop.

Session affinity: a session is pinned to the index VERSION that served its
first request. While pinned, requests route only to replicas publishing
that version (``affinity_hits`` counts them); when no routable replica
publishes it anymore (a swap wave retired it) the session re-pins — only
upward (monotone), and only while it has zero requests in flight, which
together give the wave invariant: no two versions ever serve one session
concurrently.
"""

from __future__ import annotations

import time

from distributed_sigmoid_loss_tpu_torch.serve.siege import HostLostError
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = [
    "FleetRouter",
    "NoReplicaError",
    "ReplicaHandle",
]


class NoReplicaError(RuntimeError):
    """No routable replica can serve the request (all lost/draining, or a
    pinned session's version vanished mid-flight). Typed — clients back off
    and retry; the scenario harness counts it as a typed rejection, never a
    silent drop."""


class ReplicaHandle:
    """One replica as the router sees it: a submit callable plus optional
    health/version/swap probes (all host-local calls on one machine; the
    transport is not the contract)."""

    def __init__(
        self,
        name: str,
        call,
        *,
        health_fn=None,
        version_fn=None,
        swap_fn=None,
        weight: float = 1.0,
    ):
        if weight <= 0:
            raise ValueError(f"replica {name!r}: weight must be > 0")
        self.name = name
        self.call = call
        self.health_fn = health_fn
        self.version_fn = version_fn
        self.swap_fn = swap_fn
        self.weight = float(weight)

    def version(self) -> int:
        return int(self.version_fn()) if self.version_fn is not None else 0


class _Session:
    __slots__ = ("version", "inflight")

    def __init__(self):
        self.version = None
        self.inflight = 0


class FleetRouter:
    """The fleet front door (see module docstring)."""

    def __init__(self, replicas, *, drain_poll_s: float = 0.001):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self._replicas = {r.name: r for r in replicas}
        self._order = names
        self._drain_poll_s = drain_poll_s
        self._lock = named_lock("serve.fleet.router.FleetRouter._lock")
        self._credit = {n: 0.0 for n in names}
        self._inflight = {n: 0 for n in names}
        self._lost: set = set()
        self._draining: set = set()
        self._sessions: dict = {}
        self._reroutes = 0
        self._affinity_hits = 0
        self._routed = 0

    # -- health & membership -------------------------------------------------

    def handles(self) -> list:
        """Replicas in declared order — the wave order."""
        return [self._replicas[n] for n in self._order]

    def _assess(self, replica) -> tuple:
        """(status, reasons) from the replica's health probe; a probe that
        raises IS the lost signal (no probe = assumed ok)."""
        if replica.health_fn is None:
            return ("ok", [])
        try:
            payload = replica.health_fn()
        except Exception:  # noqa: BLE001 — any probe failure means lost
            return ("lost", ["probe_failed"])
        status = str(payload.get("status", "ok"))
        reasons = [str(r) for r in payload.get("reasons", ())]
        return (status, reasons)

    def drain(self, name: str) -> None:
        """Stop routing NEW requests to ``name`` (in-flight ones finish) —
        the wave controller's pre-swap step."""
        with self._lock:
            self._draining.add(name)

    def undrain(self, name: str) -> None:
        with self._lock:
            self._draining.discard(name)

    def mark_lost(self, name: str) -> None:
        with self._lock:
            self._lost.add(name)

    def revive(self, name: str) -> None:
        """Bring a restarted replica back into rotation."""
        with self._lock:
            self._lost.discard(name)

    def inflight(self, name: str) -> int:
        with self._lock:
            return self._inflight[name]

    def wait_idle(self, name: str, *, timeout_s: float = 10.0) -> None:
        """Block (poll, no lock held) until ``name`` has zero in-flight
        requests — the drain barrier a swap waits behind."""
        deadline = time.monotonic() + timeout_s
        while self.inflight(name) > 0:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replica {name!r} still has "
                    f"{self.inflight(name)} in-flight after {timeout_s}s"
                )
            time.sleep(self._drain_poll_s)

    # -- routing -------------------------------------------------------------

    def _pick(self, session_id, statuses, versions, tried) -> tuple:
        """(replica, version, session) under the router lock; raises
        NoReplicaError when nothing is routable. Increments in-flight
        counters for the pick — the caller MUST route exactly one call and
        then _finish/_fail it."""
        with self._lock:
            routable = [
                n for n in self._order
                if n not in tried
                and n not in self._lost
                and n not in self._draining
                and statuses[n][0] != "lost"
                and "swap_in_flight" not in statuses[n][1]
            ]
            if not routable:
                raise NoReplicaError(
                    f"no routable replica (lost={sorted(self._lost)}, "
                    f"draining={sorted(self._draining)}, "
                    f"tried={sorted(tried)})"
                )
            sess = None
            affinity = False
            candidates = routable
            if session_id is not None:
                sess = self._sessions.setdefault(session_id, _Session())
                if sess.version is not None:
                    on_pin = [
                        n for n in routable if versions[n] == sess.version
                    ]
                    if on_pin:
                        candidates = on_pin
                        affinity = True
                    else:
                        # The pinned version retired. Re-pin is legal only
                        # with nothing in flight (else two versions could
                        # serve the session concurrently) and only upward
                        # (versions monotone per session).
                        if sess.inflight > 0:
                            raise NoReplicaError(
                                f"session {session_id!r} pinned to retired "
                                f"version {sess.version} with "
                                f"{sess.inflight} in flight"
                            )
                        top = max(versions[n] for n in routable)
                        if top < sess.version:
                            raise NoReplicaError(
                                f"session {session_id!r} cannot re-pin "
                                f"downward ({sess.version} -> {top})"
                            )
                        sess.version = top
                        candidates = [
                            n for n in routable if versions[n] == top
                        ]
                else:
                    top = max(versions[n] for n in routable)
                    sess.version = top
                    candidates = [
                        n for n in routable if versions[n] == top
                    ]
            # Smooth weighted round-robin over the candidate set.
            total = 0.0
            for n in candidates:
                self._credit[n] += self._replicas[n].weight
                total += self._replicas[n].weight
            chosen = max(candidates, key=lambda n: (self._credit[n], n))
            self._credit[chosen] -= total
            self._inflight[chosen] += 1
            self._routed += 1
            if affinity:
                self._affinity_hits += 1
            if sess is not None:
                sess.inflight += 1
            return (self._replicas[chosen], versions[chosen], sess)

    def _finish(self, name: str, sess) -> None:
        with self._lock:
            self._inflight[name] = max(0, self._inflight[name] - 1)
            if sess is not None:
                sess.inflight = max(0, sess.inflight - 1)

    def _note_lost(self, name: str, sess) -> None:
        with self._lock:
            self._lost.add(name)
            self._reroutes += 1
            self._inflight[name] = max(0, self._inflight[name] - 1)
            if sess is not None:
                sess.inflight = max(0, sess.inflight - 1)

    def route(self, payload, *, session: str | None = None):
        """Route one request: pick → call → (on HostLostError) mark lost
        and retry on a sibling. Returns ``(result, replica_name, version)``.
        Raises typed errors only: the replica's own (ShedError & co. pass
        through untouched), :class:`~..siege.HostLostError` via
        :class:`NoReplicaError` once no sibling remains."""
        statuses = {
            n: self._assess(self._replicas[n]) for n in self._order
        }
        versions = {n: self._replicas[n].version() for n in self._order}
        tried: set = set()
        while True:
            replica, version, sess = self._pick(
                session, statuses, versions, tried
            )
            try:
                result = replica.call(payload)
            except HostLostError:
                self._note_lost(replica.name, sess)
                tried.add(replica.name)
                continue
            except BaseException:
                self._finish(replica.name, sess)
                raise
            self._finish(replica.name, sess)
            return (result, replica.name, version)

    # -- ops surface ---------------------------------------------------------

    def stats(self) -> dict:
        healthy = 0
        for n in self._order:
            status, reasons = self._assess(self._replicas[n])
            with self._lock:
                lost = n in self._lost
            if not lost and status != "lost":
                healthy += 1
        with self._lock:
            snap = {
                "replica_count": len(self._order),
                "healthy_replicas": healthy,
                "reroutes": self._reroutes,
                "affinity_hits": self._affinity_hits,
            }
        return snap
