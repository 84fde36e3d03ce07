"""Fleet distributed admission: bounded-staleness token leases.

The single-host :class:`~..admission.AdmissionController` enforces a
tenant's rate/quota inside ONE process. A fleet of N replicas each running
that controller at full rate would admit N× the contract. This module
splits every tenant's GLOBAL ceiling into per-host slices via time-bounded
leases, with the classic lease-safety asymmetry making over-admission
structurally impossible rather than merely unobserved:

- the **coordinator** (:class:`LeaseCoordinator`) owns the grant table. A
  grant for tenant ``t`` to host ``h`` is a fraction of the tenant's global
  rate/quota, stamped with ``granted_at`` and the coordinator's ``ttl_s``.
  The table invariant — the sum of unexpired fractions per tenant never
  exceeds 1.0 — is enforced at grant time: a grant that would break it
  raises :class:`OverCommitError` instead of landing (the "pinned
  impossible" half of the contract; :func:`LeaseCoordinator.grant` is the
  low-level entry tests trip it through).
- each **host** (:class:`LeaseClient`) renews on a period well inside the
  TTL and stops USING a lease at ``granted_at + USE_FRACTION * ttl_s`` —
  strictly before the coordinator reclaims it at ``granted_at + ttl_s``.
  A host killed -9 (or partitioned from the coordinator) therefore goes
  quiet before its slice is re-granted to survivors: the two sides never
  overlap, so the summed in-use fraction stays ≤ 1.0 at every instant even
  across failures. Bounded staleness means shed-early is the safe failure
  mode — a partitioned host under-admits (sheds with reason ``"lease"``),
  never over-admits.
- :class:`LeasedAdmission` is the host-side front door: a per-tenant token
  bucket + in-flight quota scaled by the CURRENT lease fraction, raising
  the same typed :class:`~..admission.ShedError` contract as the
  single-host controller (so the chaos harness's clients obey the same backoff
  guidance) and recording admit timestamps so the fleet scenarios can
  prove the summed admitted rate stayed under the ceiling at every sample.

Stdlib-only on purpose: the coordinator "hop" is a direct method call on
one machine (the EngineProcess stand-in convention) — the protocol is the
contract, not the transport.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from distributed_sigmoid_loss_tpu_torch.serve.admission import (
    _BACKOFF_BASE_S,
    _BACKOFF_CAP_S,
    _BACKOFF_MAX_DOUBLINGS,
    AdmissionTicket,
    ShedError,
    TenantPolicy,
)
from distributed_sigmoid_loss_tpu_torch.serve.siege import maybe_inject

__all__ = [
    "USE_FRACTION",
    "Lease",
    "LeaseCoordinator",
    "LeaseClient",
    "LeasedAdmission",
    "OverCommitError",
]

# The staleness bound: a host stops using a lease at this fraction of the
# TTL, the coordinator reclaims only at the full TTL — the gap is the
# safety margin that keeps a dead host's slice and its re-grant from ever
# being in use simultaneously (clock skew would eat into it on a real
# multi-host deployment; on one machine time.monotonic is shared).
USE_FRACTION = 0.75

_EPS = 1e-9


class OverCommitError(RuntimeError):
    """A grant would push a tenant's summed live fractions past 1.0 — the
    over-admission path exists only as this raise."""


@dataclass(frozen=True)
class Lease:
    """One host's slice of one tenant's global ceiling."""

    tenant: str
    host: str
    fraction: float
    epoch: int
    granted_at: float
    ttl_s: float

    def expires_at(self) -> float:
        """When the COORDINATOR may reclaim (the host stops using earlier,
        at ``granted_at + USE_FRACTION * ttl_s``)."""
        return self.granted_at + self.ttl_s

    def usable_until(self) -> float:
        return self.granted_at + USE_FRACTION * self.ttl_s


class LeaseCoordinator:
    """The grant-table owner: equal-share target, availability-capped.

    ``ceilings`` maps tenant name → global rate (req/s; 0.0 = the tenant is
    quota-only — fractions still slice its in-flight quota). A renewing
    host is granted ``min(1/n_live, 1 - sum(other live fractions))`` per
    tenant: immediately after a host dies its slice is still counted live
    (until TTL), so survivors cannot absorb it early — the ceiling dips,
    never overshoots — and after the sweep reclaims it the next renewals
    converge back to full coverage within one renew period.
    """

    def __init__(self, ceilings: dict, *, ttl_s: float = 0.5):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.ttl_s = float(ttl_s)
        self.ceilings = dict(ceilings)
        self._lock = threading.Lock()
        self._grants: dict = {t: {} for t in self.ceilings}
        self._members: frozenset = frozenset()
        self._epoch = 0
        self._reclaims = 0

    # -- internals (lock held) ----------------------------------------------

    def _sweep_locked(self, now: float) -> None:
        expired = False
        for row in self._grants.values():
            for host, lease in list(row.items()):
                if now >= lease.expires_at():
                    del row[host]
                    self._reclaims += 1
                    expired = True
        if expired:
            self._epoch += 1

    def _grant_locked(
        self, tenant: str, host: str, fraction: float, now: float
    ) -> Lease:
        row = self._grants[tenant]
        others = sum(
            lease.fraction for h, lease in row.items() if h != host
        )
        if others + fraction > 1.0 + _EPS:
            raise OverCommitError(
                f"granting {fraction:.4f} of tenant {tenant!r} to host "
                f"{host!r} would commit {others + fraction:.4f} > 1.0 of "
                "the global ceiling — the grant-table invariant every "
                "admission bound rests on"
            )
        lease = Lease(
            tenant=tenant, host=host, fraction=fraction,
            epoch=self._epoch, granted_at=now, ttl_s=self.ttl_s,
        )
        row[host] = lease
        return lease

    def _renew_locked(self, host: str, now: float) -> dict:
        self._sweep_locked(now)
        live = {
            h for row in self._grants.values() for h in row
        } | {host}
        if frozenset(live) != self._members:
            self._members = frozenset(live)
            self._epoch += 1
        target = 1.0 / max(len(live), 1)
        out = {}
        for tenant in self._grants:
            row = self._grants[tenant]
            others = sum(
                lease.fraction
                for h, lease in row.items()
                if h != host
            )
            fraction = min(target, max(0.0, 1.0 - others))
            out[tenant] = self._grant_locked(tenant, host, fraction, now)
        return out

    # -- protocol surface ----------------------------------------------------

    def acquire(self, host: str) -> dict:
        """Grant/renew ``host``'s slice of every tenant: the one RPC of the
        protocol. Returns ``{tenant: Lease}``."""
        now = time.monotonic()
        with self._lock:
            return self._renew_locked(host, now)

    def grant(self, tenant: str, host: str, fraction: float) -> Lease:
        """Low-level single grant, invariant enforced — the entry the
        over-commit falsification test drives directly."""
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            return self._grant_locked(tenant, host, fraction, now)

    # -- ops surface ---------------------------------------------------------

    def granted_fraction(self, tenant: str) -> float:
        """Sum of live (unexpired) fractions for ``tenant`` — ≤ 1.0 by the
        grant invariant."""
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            return sum(
                lease.fraction
                for lease in self._grants.get(tenant, {}).values()
            )

    def stats(self) -> dict:
        with self._lock:
            snap = {
                "lease_epoch": self._epoch,
                "lease_reclaims": self._reclaims,
            }
        return snap


class LeaseClient:
    """One host's lease cache + renew loop.

    ``alive_fn`` ties renewal to the host's liveness (an EngineProcess's
    ``alive``): a kill -9'd host stops renewing exactly like a lost real
    host would, and its slice ages out at the coordinator. ``partition``
    simulates a coordinator partition deterministically (the
    ``fleet-splitbrain`` scenario's handle); the ``fleet.partition`` chaos
    point lets the chaos harness arm the same failure through the DSL_CHAOS gate.
    """

    def __init__(
        self,
        coordinator: LeaseCoordinator,
        host: str,
        *,
        renew_interval_s: float | None = None,
        alive_fn=None,
    ):
        self.host = host
        self._coordinator = coordinator
        self._alive_fn = alive_fn
        self.renew_interval_s = (
            renew_interval_s
            if renew_interval_s is not None
            else coordinator.ttl_s / 4.0
        )
        self._lock = threading.Lock()
        self._leases: dict = {}
        self._partitioned = False
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "LeaseClient":
        """Synchronous first renew (a host serves nothing before it holds
        leases), then the background renew loop."""
        self.renew_once()
        self._thread = threading.Thread(
            target=self._renew_loop, daemon=True,
            name=f"lease-renew-{self.host}",
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.renew_interval_s):
            try:
                self.renew_once()
            except OverCommitError:
                # A refused grant is the coordinator protecting the
                # invariant; the host simply keeps aging toward shed-all.
                continue

    def renew_once(self) -> bool:
        """One renew attempt; False when skipped (partitioned/dead host).
        The coordinator call happens OUTSIDE the client lock — the lease
        snapshot swap is the only guarded write."""
        maybe_inject("fleet.partition")
        with self._lock:
            partitioned = self._partitioned
        if partitioned:
            return False
        if self._alive_fn is not None and not self._alive_fn():
            return False
        leases = self._coordinator.acquire(self.host)
        with self._lock:
            self._leases = leases
        return True

    def partition(self, on: bool = True) -> None:
        """Cut (or heal) this host's path to the coordinator. While cut,
        existing leases age out at USE_FRACTION·TTL and the host sheds —
        the bounded-staleness under-admission the splitbrain drill pins."""
        with self._lock:
            self._partitioned = on

    def fraction(self, tenant: str) -> float:
        """The fraction of ``tenant``'s global ceiling this host may use
        RIGHT NOW: 0.0 once the lease passes its usable window (strictly
        before the coordinator's reclaim point)."""
        now = time.monotonic()
        with self._lock:
            lease = self._leases.get(tenant)
        if lease is None or now >= lease.usable_until():
            return 0.0
        return lease.fraction

    def lease_epoch(self) -> int:
        with self._lock:
            leases = dict(self._leases)
        return max((l.epoch for l in leases.values()), default=0)


@dataclass
class _LeasedBucket:
    tokens: float
    refilled_at: float
    inflight: int = 0
    ok: int = 0
    shed: int = 0
    consecutive_sheds: int = 0


class LeasedAdmission:
    """Host-side admission front door over leased slices.

    Per-tenant token bucket at ``global_rate × fraction`` with depth
    ``global_depth × fraction`` (no floor: a sliver too small to hold one
    request admits nothing — under-admission is always the safe direction),
    plus an in-flight quota of ``floor(global_quota × fraction)``. The
    aggregate bound across hosts: since live fractions sum ≤ 1.0 at every
    instant, total admits over any window W ≤ ceiling·W + global burst —
    the inequality the fleet scenarios sample and assert.
    """

    def __init__(self, client: LeaseClient, policies):
        self._client = client
        self._policies = {p.name: p for p in policies}
        self._lock = threading.Lock()
        self._buckets: dict = {}
        # (monotonic timestamp, items) per admit — the scenario harness's
        # over-admission evidence; bounded so a soak can't grow it.
        self._admits: deque = deque(maxlen=262144)

    def policy(self, tenant: str) -> TenantPolicy:
        pol = self._policies.get(tenant)
        if pol is None:
            pol = TenantPolicy(tenant)
            self._policies[tenant] = pol
        return pol

    def admit(
        self,
        tenant: str,
        *,
        items: int = 1,
        deadline_s: float | None = None,
    ) -> AdmissionTicket:
        pol = self.policy(tenant)
        fraction = self._client.fraction(tenant)
        now = time.monotonic()
        with self._lock:
            st = self._buckets.get(tenant)
            if st is None:
                # Start full at the CURRENT scaled depth (single-host
                # semantics); fleet-safe because scaled depths sum ≤ the
                # global depth while live fractions sum ≤ 1.0.
                depth0 = (
                    pol.bucket_depth() * fraction if pol.rate > 0 else 0.0
                )
                st = _LeasedBucket(tokens=depth0, refilled_at=now)
                self._buckets[tenant] = st
            if pol.rate > 0 or pol.max_inflight:
                if fraction <= 0.0:
                    # No usable lease: expired, partitioned, or never
                    # granted — shed-early, the bounded-staleness contract.
                    raise self._shed(
                        st, tenant, "lease",
                        self._client.renew_interval_s, deadline_s,
                    )
            if pol.rate > 0:
                rate = pol.rate * fraction
                depth = pol.bucket_depth() * fraction
                st.tokens = min(
                    depth,
                    st.tokens + max(0.0, now - st.refilled_at) * rate,
                )
                st.refilled_at = now
                if st.tokens < items:
                    raise self._shed(
                        st, tenant, "rate",
                        (items - st.tokens) / max(rate, 1e-9), deadline_s,
                    )
            if pol.max_inflight:
                quota = int(pol.max_inflight * fraction)
                if st.inflight + items > quota:
                    raise self._shed(
                        st, tenant, "quota", _BACKOFF_BASE_S, deadline_s,
                    )
            if pol.rate > 0:
                st.tokens -= items
                # Only rate-limited admits join the evidence trail: the
                # over-admission sweep proves the summed RATE ceiling, and
                # unlimited tenants are outside it by policy.
                self._admits.append((now, items))
            st.inflight += items
            st.ok += 1
            st.consecutive_sheds = 0
        return AdmissionTicket(self, tenant, items)

    def _shed(
        self, st: _LeasedBucket, tenant: str, reason: str,
        base_s: float, deadline_s: float | None,
    ) -> ShedError:
        """Build the typed rejection (lock already held by admit). Same
        exponential + deterministically jittered backoff guidance as the
        single-host controller, so fleet clients never retry-storm."""
        st.shed += 1
        st.consecutive_sheds += 1
        doublings = min(st.consecutive_sheds - 1, _BACKOFF_MAX_DOUBLINGS)
        backoff = min(base_s * (2.0 ** doublings), _BACKOFF_CAP_S)
        frac = ((st.shed * 2654435761 + hash(tenant)) % 997) / 997.0
        retry_after = backoff * (0.75 + 0.5 * frac)
        retriable = deadline_s is None or retry_after <= deadline_s
        return ShedError(tenant, reason, retry_after, retriable=retriable)

    def _release(
        self, name: str, items: int, latency_s: float, *, ok: bool
    ) -> None:
        del latency_s, ok  # latency accounting lives with the router
        with self._lock:
            st = self._buckets.get(name)
            if st is not None:
                st.inflight = max(0, st.inflight - items)

    def admit_times(self) -> list:
        """Snapshot of (timestamp, items) admits — the over-admission
        evidence trail the scenarios aggregate across hosts."""
        with self._lock:
            return list(self._admits)

    def counts(self) -> dict:
        """Per-tenant {ok, shed} rows (merged into the scenario record's
        per_tenant map by the harness, not a schema surface itself)."""
        with self._lock:
            return {
                t: {"ok": st.ok, "shed": st.shed}
                for t, st in sorted(self._buckets.items())
            }
