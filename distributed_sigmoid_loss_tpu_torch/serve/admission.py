"""Per-tenant SLO-aware admission control: rate limits, quotas, and
priority-ordered load shedding in front of the MicroBatcher.

The bounded queue gave the serving stack backpressure, but it is
tenant-blind: under overload every caller degrades equally, so one
over-quota tenant's burst blows the p99 of every in-SLO tenant behind it.
This module is the missing front door. Every request is classified by
tenant and admitted through three checks, cheapest first:

1. **token bucket** — per-tenant sustained rate + burst allowance; the
   classic leaky-bucket refill arithmetic, no background thread.
2. **bounded quota** — per-tenant in-flight cap (submitted but not yet
   released), so a slow-consuming tenant (slowloris) saturates its OWN
   allowance and nothing else.
3. **priority-tiered capacity** — the global in-flight budget is tiered by
   tenant priority: rank r of K distinct priorities may fill
   ``capacity * r / K`` slots, the top rank the whole budget. Under
   overload low-priority traffic hits its (lower) watermark first — shed
   low first, never the other way around.

A rejected request raises :class:`ShedError` — typed, DISTINCT from the
batcher's ``QueueFullError`` (shed = policy said no, queue-full = the
whole stack is saturated) — carrying ``retry_after_s`` backoff guidance:
exponential in the tenant's consecutive sheds, deterministically jittered
(so a thundering herd decorrelates instead of re-synchronizing), capped,
and deadline-aware — ``retriable=False`` when the suggested wait would
blow the caller's remaining deadline, which is the signal to fail over
instead of retry-storming.

``stats()`` is schema-registered (obs/metrics_schema.py SERVE registry)
and rides ``EmbeddingService.stats()`` / the ``/metrics`` exporter; the
``per_tenant`` map flattens with a ``tenant=`` label.

The port's copy of the JAX package's ``serve/admission.py`` (standard
library only): the same decisions and the same ``retry_after_s`` guidance, under a
named lock (``obs/lockwatch.py``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field

from distributed_sigmoid_loss_tpu_torch.utils.logging import LatencyWindow
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = [
    "AdmissionController",
    "AdmissionTicket",
    "ShedError",
    "TenantPolicy",
    "parse_tenant_spec",
]

DEFAULT_TENANT = "default"

# Backoff guidance bounds: the first shed suggests ~base, consecutive sheds
# double it (capped) — a well-behaved client backs off instead of storming.
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 30.0
_BACKOFF_MAX_DOUBLINGS = 8


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's admission contract.

    ``rate`` — sustained admits/s through the token bucket (0 = unlimited).
    ``burst`` — bucket depth (0 = auto: one second of ``rate``, min 1).
    ``max_inflight`` — bounded quota: requests admitted but not yet released
    (0 = unlimited). ``priority`` — higher sheds LATER under overload.
    ``slo_ms`` — advisory latency target; violations are counted in stats
    (the per-tenant p99-vs-SLO signal), never enforced.
    """

    name: str
    priority: int = 1
    rate: float = 0.0
    burst: int = 0
    max_inflight: int = 0
    slo_ms: float | None = None

    def bucket_depth(self) -> float:
        if self.rate <= 0:
            return math.inf
        return float(self.burst) if self.burst > 0 else max(self.rate, 1.0)


class ShedError(RuntimeError):
    """Admission rejected the request (policy, not saturation).

    ``reason`` ∈ {"rate", "quota", "overload"}; ``retry_after_s`` is the
    backoff guidance (exponential + jittered, see module docstring) and
    ``retriable`` is False when that wait would exceed the caller's stated
    deadline — retrying is then guaranteed-wasted load.
    """

    def __init__(
        self,
        tenant: str,
        reason: str,
        retry_after_s: float,
        *,
        retriable: bool = True,
    ):
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = round(float(retry_after_s), 4)
        self.retriable = retriable
        advice = (
            f"retry after {self.retry_after_s}s"
            if retriable
            else "do not retry (guidance exceeds your deadline)"
        )
        super().__init__(
            f"tenant {tenant!r} shed ({reason}); {advice}"
        )


@dataclass
class _TenantState:
    tokens: float = math.inf
    refilled_at: float = field(default_factory=time.monotonic)
    inflight: int = 0
    admitted: int = 0
    shed: Counter = field(default_factory=Counter)
    consecutive_sheds: int = 0
    slo_violations: int = 0
    latency: LatencyWindow = field(default_factory=lambda: LatencyWindow(4096))


class AdmissionTicket:
    """One admitted request's handle: ``release()`` returns the in-flight
    slots and records the observed latency (idempotent; usable as a
    context manager so an exception path can never leak quota)."""

    def __init__(self, controller: "AdmissionController", tenant: str, items: int):
        self._controller = controller
        self.tenant = tenant
        self.items = items
        self._t0 = time.monotonic()
        self._released = False

    def release(self, *, ok: bool = True) -> None:
        if self._released:
            return
        self._released = True
        self._controller._release(
            self.tenant, self.items, time.monotonic() - self._t0, ok=ok
        )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.release(ok=exc_type is None)


class AdmissionController:
    """Thread-safe per-tenant admission front end (see module docstring).

    ``capacity`` is the global in-flight budget the priority tiers split;
    size it to what the engine sustains inside the SLO (≈ largest batch
    bucket × acceptable queue depth). Unknown tenants share
    ``default_policy`` (each still gets its own bucket/quota state).
    """

    def __init__(
        self,
        policies=(),
        *,
        capacity: int = 64,
        default_policy: TenantPolicy | None = None,
        shed_window_s: float = 5.0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.shed_window_s = float(shed_window_s)
        self._policies = {p.name: p for p in policies}
        self._default = default_policy or TenantPolicy(DEFAULT_TENANT)
        self._lock = named_lock("serve.admission.AdmissionController._lock")
        self._states: dict[str, _TenantState] = {}
        self._total_inflight = 0
        self._decisions: deque = deque(maxlen=65536)  # (ts, was_shed)
        # Priority rank table over the declared policy set (+ default):
        # rank r of K distinct priorities owns capacity*r/K slots.
        self._rebuild_thresholds()

    # -- policy surface ------------------------------------------------------

    def _rebuild_thresholds(self) -> None:
        prios = sorted({p.priority for p in self._policies.values()}
                       | {self._default.priority})
        k = len(prios)
        self._thresholds = {
            p: max(1, math.ceil(self.capacity * (i + 1) / k))
            for i, p in enumerate(prios)
        }

    def policy(self, tenant: str | None) -> TenantPolicy:
        name = tenant or DEFAULT_TENANT
        pol = self._policies.get(name)
        if pol is None:
            pol = (
                self._default
                if name == self._default.name
                else TenantPolicy(
                    name,
                    priority=self._default.priority,
                    rate=self._default.rate,
                    burst=self._default.burst,
                    max_inflight=self._default.max_inflight,
                    slo_ms=self._default.slo_ms,
                )
            )
        return pol

    def _state(self, name: str, pol: TenantPolicy) -> _TenantState:
        st = self._states.get(name)
        if st is None:
            st = _TenantState(tokens=pol.bucket_depth())
            self._states[name] = st
        return st

    # -- admission -----------------------------------------------------------

    def admit(
        self,
        tenant: str | None = None,
        *,
        items: int = 1,
        deadline_s: float | None = None,
    ) -> AdmissionTicket:
        """Admit ``items`` request slots for ``tenant`` or raise
        :class:`ShedError`. ``deadline_s`` = the caller's remaining budget,
        used only to mark hopeless retry guidance ``retriable=False``."""
        pol = self.policy(tenant)
        name = pol.name
        now = time.monotonic()
        with self._lock:
            try:
                st = self._state(name, pol)
                # 1) token bucket.
                if pol.rate > 0:
                    depth = pol.bucket_depth()
                    # max(0, ...): a freshly created state stamps refilled_at
                    # AFTER `now` was read, and a negative delta must not drain
                    # the bucket below its starting depth.
                    st.tokens = min(
                        depth,
                        st.tokens + max(0.0, now - st.refilled_at) * pol.rate,
                    )
                    st.refilled_at = now
                    if st.tokens < items:
                        raise self._shed(
                            st, name, "rate",
                            (items - st.tokens) / pol.rate, deadline_s, now,
                        )
                # 2) bounded per-tenant quota.
                if pol.max_inflight and st.inflight + items > pol.max_inflight:
                    p50 = st.latency.percentiles_ms((50,))["p50_ms"] / 1000.0
                    raise self._shed(
                        st, name, "quota", max(p50, _BACKOFF_BASE_S),
                        deadline_s, now,
                    )
                # 3) priority-tiered global capacity: shed low priority first.
                threshold = self._thresholds.get(
                    pol.priority,
                    max(1, math.ceil(
                        self.capacity
                        * self._rank_of(pol.priority)
                        / max(len(self._thresholds), 1)
                    )),
                )
                if self._total_inflight + items > threshold:
                    raise self._shed(
                        st, name, "overload", _BACKOFF_BASE_S, deadline_s, now
                    )
                if pol.rate > 0:
                    st.tokens -= items
                st.inflight += items
                st.admitted += 1
                st.consecutive_sheds = 0
                self._total_inflight += items
                self._decisions.append((now, False))
            except ShedError:
                self._decisions.append((now, True))
                raise
        return AdmissionTicket(self, name, items)

    def _rank_of(self, priority: int) -> int:
        below = sum(1 for p in self._thresholds if p <= priority)
        return max(below, 1)

    def _shed(
        self, st: _TenantState, name: str, reason: str,
        base_s: float, deadline_s: float | None, now: float,
    ) -> ShedError:
        """Build the typed rejection (lock already held; the caller raises
        it and records the decision)."""
        st.shed[reason] += 1
        st.consecutive_sheds += 1
        doublings = min(st.consecutive_sheds - 1, _BACKOFF_MAX_DOUBLINGS)
        backoff = min(base_s * (2.0 ** doublings), _BACKOFF_CAP_S)
        # Deterministic per-tenant jitter in [0.75, 1.25): Knuth hash of the
        # tenant's shed count — clients backing off together spread out
        # instead of re-arriving in the same wave (no retry storm).
        total_shed = sum(st.shed.values())
        frac = ((total_shed * 2654435761 + hash(name)) % 997) / 997.0
        retry_after = backoff * (0.75 + 0.5 * frac)
        retriable = deadline_s is None or retry_after <= deadline_s
        return ShedError(name, reason, retry_after, retriable=retriable)

    def _release(
        self, name: str, items: int, latency_s: float, *, ok: bool
    ) -> None:
        pol = self.policy(name)
        with self._lock:
            st = self._states.get(name)
            if st is None:
                return
            st.inflight = max(0, st.inflight - items)
            self._total_inflight = max(0, self._total_inflight - items)
            if ok:
                st.latency.record(latency_s)
                if pol.slo_ms is not None and latency_s * 1000.0 > pol.slo_ms:
                    st.slo_violations += 1

    # -- ops surface ---------------------------------------------------------

    def recent_shed_rate(self, window_s: float | None = None) -> float:
        """Fraction of admission decisions in the trailing window that were
        sheds (0.0 when idle) — the ``/healthz`` degraded signal."""
        window = self.shed_window_s if window_s is None else window_s
        cutoff = time.monotonic() - window
        with self._lock:
            recent = [shed for ts, shed in self._decisions if ts >= cutoff]
        if not recent:
            return 0.0
        return sum(recent) / len(recent)

    def stats(self) -> dict:
        """Schema-registered snapshot: global budget + one row per tenant
        (flattened with a ``tenant=`` label by the /metrics exporter)."""
        with self._lock:
            names = sorted(self._states)
            total_inflight = self._total_inflight
            per_tenant = {}
            for name in names:
                st = self._states[name]
                pol = self.policy(name)
                shed = sum(st.shed.values())
                seen = st.admitted + shed
                per_tenant[name] = {
                    "priority": pol.priority,
                    "admitted": st.admitted,
                    "shed": shed,
                    "shed_rate": round(shed / seen, 4) if seen else 0.0,
                    "inflight": st.inflight,
                    "slo_ms": pol.slo_ms,
                    "slo_violations": st.slo_violations,
                    "latency_ms": st.latency.percentiles_ms((50, 95, 99)),
                }
        snap = {
            "capacity": self.capacity,
            "inflight": total_inflight,
            "shed_rate": round(self.recent_shed_rate(), 4),
            "per_tenant": per_tenant,
        }
        return snap


def parse_tenant_spec(spec: str) -> list[TenantPolicy]:
    """Parse the CLI tenant grammar into policies.

    ``"gold:prio=2,quota=16,slo=250;free:prio=1,rate=40,quota=4"`` —
    semicolon-separated tenants, each ``name:key=value,...`` with keys
    ``prio``/``priority``, ``rate`` (req/s, 0 = unlimited), ``burst``,
    ``quota`` (max in-flight, 0 = unlimited), ``slo`` (ms).
    """
    policies = []
    for chunk in filter(None, (c.strip() for c in spec.split(";"))):
        name, _, body = chunk.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant spec chunk {chunk!r} has no name")
        kw: dict = {}
        for pair in filter(None, (p.strip() for p in body.split(","))):
            key, sep, value = pair.partition("=")
            if not sep:
                raise ValueError(
                    f"tenant {name!r}: expected key=value, got {pair!r}"
                )
            key = key.strip().lower()
            try:
                num = float(value)
            except ValueError:
                raise ValueError(
                    f"tenant {name!r}: {key}={value!r} is not a number"
                ) from None
            if key in ("prio", "priority"):
                kw["priority"] = int(num)
            elif key == "rate":
                kw["rate"] = num
            elif key == "burst":
                kw["burst"] = int(num)
            elif key == "quota":
                kw["max_inflight"] = int(num)
            elif key == "slo":
                kw["slo_ms"] = num
            else:
                raise ValueError(
                    f"tenant {name!r}: unknown key {key!r} (use prio/rate/"
                    "burst/quota/slo)"
                )
        policies.append(TenantPolicy(name, **kw))
    if not policies:
        raise ValueError(f"empty tenant spec {spec!r}")
    return policies
