"""Fleet scenarios: the fleet-level chaos drills.

Three scenarios, run through the same :func:`~..siege.run_scenario`
closed-loop multi-tenant harness as the single-host drills (same typed
outcome taxonomy, same record contract, fleet fields added):

- ``fleet-rolling-swap`` — a coordinated swap wave every 200ms under the
  burst load shape: zero errors, per-session versions monotone, never two
  versions serving one session (the router+wave invariant), compile flat
  when the hosts are engine-backed.
- ``fleet-hostloss`` — kill -9 one replica mid-traffic: the router marks
  it lost on the first typed :class:`~..siege.HostLostError` and reroutes
  to siblings (zero silent drops); the dead host stops renewing, its
  lease slices expire at TTL, and the coordinator redistributes them so
  the surviving hosts' summed ceiling returns to full — no stranded quota.
- ``fleet-splitbrain`` — partition one host from the coordinator: its
  slices age out at USE_FRACTION·TTL (it sheds, reason ``"lease"``) while
  the coordinator re-grants them to reachable hosts only after the full
  TTL — both sides under-admit through the hand-off and the summed
  admitted rate never exceeds the global ceiling (the record's
  ``over_ceiling_samples`` is the per-sample proof, asserted zero).

Every record carries the admitted-rate evidence: per-host admit timestamps
are merged and swept with a sliding window against
``ceiling·window + global burst`` — the bound that holds because live lease
fractions sum ≤ 1.0 at every instant (see leases.py).

Stdlib-only: hosts are :class:`~..siege.EngineProcess` echo workers by
default, so ``serve-bench --fleet-scenario`` runs before any device is
set up (the hostloss-drill convention). The workers' start method is
:func:`~..siege.drill_start_method`'s unless ``ctx`` names one.
"""

from __future__ import annotations

import bisect

from distributed_sigmoid_loss_tpu_torch.serve.admission import TenantPolicy
from distributed_sigmoid_loss_tpu_torch.serve.fleet.leases import (
    LeaseClient,
    LeaseCoordinator,
    LeasedAdmission,
)
from distributed_sigmoid_loss_tpu_torch.serve.fleet.router import (
    FleetRouter,
    ReplicaHandle,
)
from distributed_sigmoid_loss_tpu_torch.serve.fleet.waves import WaveController
from distributed_sigmoid_loss_tpu_torch.serve.siege import (
    EngineProcess,
    run_scenario,
)

__all__ = [
    "FLEET_SCENARIOS",
    "Fleet",
    "FleetHost",
    "build_fleet",
    "run_fleet_scenario",
]

FLEET_SCENARIOS = (
    "fleet-rolling-swap",
    "fleet-hostloss",
    "fleet-splitbrain",
)


class FleetHost:
    """One serving host: leased admission in front of a compute backend
    (an :class:`~..siege.EngineProcess` for process-backed drills, or an
    in-process callable for engine-backed tests), plus the published index
    version the swap wave advances."""

    def __init__(
        self,
        name: str,
        *,
        admission: LeasedAdmission,
        client: LeaseClient,
        proc: EngineProcess | None = None,
        compute=None,
        swap_impl=None,
    ):
        self.name = name
        self.admission = admission
        self.client = client
        self.proc = proc
        self.compute = compute
        self.swap_impl = swap_impl
        self.version = 1

    def call(self, request):
        """One admitted request: ``request = (tenant, items, body)`` —
        admission from the leased slice, then the backend round-trip."""
        tenant, items, body = request
        with self.admission.admit(tenant, items=items, deadline_s=5.0):
            if self.proc is not None:
                return self.proc.call(body, timeout_s=5.0)
            if self.compute is not None:
                return self.compute(body)
            return body

    def health(self) -> dict:
        if self.proc is not None and not self.proc.alive():
            return {"status": "lost", "reasons": ["host_lost"]}
        return {"status": "ok", "reasons": []}

    def swap(self) -> None:
        """The per-replica swap step a wave runs while this host is
        drained and idle (engine-backed hosts swap weights here —
        zero-recompile — before the version advances)."""
        if self.swap_impl is not None:
            self.swap_impl()
        self.version += 1

    def kill(self) -> None:
        """kill -9 the backend; the lease client's alive_fn makes renewal
        stop with it, so the slices age out exactly like a lost host's."""
        if self.proc is not None:
            self.proc.kill()

    def restart(self) -> None:
        if self.proc is not None:
            self.proc.restart()

    def close(self) -> None:
        self.client.close()
        if self.proc is not None:
            self.proc.close()


class Fleet:
    """A built fleet: coordinator + hosts + router + wave controller."""

    def __init__(self, coordinator, hosts, router, waves):
        self.coordinator = coordinator
        self.hosts = hosts
        self.router = router
        self.waves = waves

    def close(self) -> None:
        for host in self.hosts:
            host.close()

    def admit_events(self) -> list:
        """All hosts' (timestamp, items) admits, time-sorted — the
        over-admission evidence trail."""
        events = []
        for host in self.hosts:
            events.extend(host.admission.admit_times())
        events.sort()
        return events


def build_fleet(
    *,
    replicas: int = 3,
    tenants,
    ttl_s: float = 0.5,
    renew_interval_s: float | None = None,
    ctx: str | None = None,
    engine_latency_s: float = 0.002,
    process_backed: bool = True,
    computes=None,
    swap_impls=None,
    drain_timeout_s: float = 10.0,
) -> Fleet:
    """Wire up a fleet: one coordinator, N hosts (each with its own lease
    client + leased admission), the router over their handles, and the
    wave controller. ``computes``/``swap_impls`` (per-replica lists) swap
    the process backend for in-process callables — the engine-backed path
    the compile-flat acceptance test uses."""
    if replicas < 2:
        raise ValueError(
            f"a fleet needs >= 2 replicas (got {replicas}); with one there "
            "is no sibling to reroute to and no wave to order"
        )
    tenants = list(tenants)
    coordinator = LeaseCoordinator(
        {p.name: p.rate for p in tenants}, ttl_s=ttl_s
    )
    hosts = []
    for k in range(replicas):
        name = f"replica-{k}"
        proc = None
        if process_backed:
            proc = EngineProcess(ctx=ctx, latency_s=engine_latency_s)
        client = LeaseClient(
            coordinator, name,
            renew_interval_s=renew_interval_s,
            alive_fn=proc.alive if proc is not None else None,
        )
        host = FleetHost(
            name,
            admission=LeasedAdmission(client, tenants),
            client=client,
            proc=proc,
            compute=computes[k] if computes else None,
            swap_impl=swap_impls[k] if swap_impls else None,
        )
        client.start()
        hosts.append(host)
    handles = [
        ReplicaHandle(
            h.name, h.call,
            health_fn=h.health,
            version_fn=(lambda h=h: h.version),
            swap_fn=h.swap,
        )
        for h in hosts
    ]
    router = FleetRouter(handles)
    waves = WaveController(router, drain_timeout_s=drain_timeout_s)
    return Fleet(coordinator, hosts, router, waves)


def _default_fleet_tenants(offered_load: float) -> list:
    # Rates sum to 0.75 × offered: the fleet runs with real admission
    # pressure, so lease hand-offs are visible as shed-rate movement.
    return [
        TenantPolicy(
            "gold", priority=2, rate=0.45 * offered_load,
            max_inflight=24, slo_ms=500.0,
        ),
        TenantPolicy(
            "free", priority=1, rate=0.30 * offered_load, max_inflight=12,
        ),
    ]


def _over_ceiling_sweep(
    events, ceiling: float, burst: float,
    *, window_s: float = 1.0, step_s: float = 0.05,
) -> tuple:
    """Slide a window over the merged admit trail; returns
    ``(over_ceiling_samples, peak_admitted_rate)``. The bound per window is
    ``ceiling·window + burst`` — the token-bucket inequality that holds
    when live fractions sum ≤ 1.0 (over_ceiling_samples > 0 means the
    lease invariant was violated at some instant)."""
    if not events:
        return (0, 0.0)
    times = [t for t, _items in events]
    prefix = [0]
    for _t, items in events:
        prefix.append(prefix[-1] + items)
    over = 0
    peak = 0.0
    t = times[0]
    t_end = times[-1]
    while t <= t_end:
        lo = bisect.bisect_left(times, t)
        hi = bisect.bisect_left(times, t + window_s)
        admitted = prefix[hi] - prefix[lo]
        peak = max(peak, admitted / window_s)
        if admitted > ceiling * window_s + burst + 1e-6:
            over += 1
        t += step_s
    return (over, peak)


def run_fleet_scenario(
    scenario: str,
    *,
    replicas: int = 3,
    tenants=None,
    duration_s: float = 2.0,
    offered_load: float = 160.0,
    clients_per_tenant: int = 4,
    lease_ttl_s: float = 0.5,
    ctx: str | None = None,
    engine_latency_s: float = 0.002,
    seed: int = 0,
) -> dict:
    """Run one fleet scenario end to end and return its degradation
    record (metric ``fleet_siege``, the JAX package's keys; the serve-bench
    ``--fleet-scenario`` path emits it through the same strict-zero-drops
    gate as the single-host drills)."""
    if scenario not in FLEET_SCENARIOS:
        raise ValueError(
            f"unknown fleet scenario {scenario!r}; pick from "
            f"{FLEET_SCENARIOS}"
        )
    tenants = (
        list(tenants) if tenants else _default_fleet_tenants(offered_load)
    )
    fleet = build_fleet(
        replicas=replicas, tenants=tenants, ttl_s=lease_ttl_s,
        ctx=ctx, engine_latency_s=engine_latency_s,
    )
    router, waves = fleet.router, fleet.waves
    victim = fleet.hosts[-1]

    def submit(tenant, i, *, items=1, fresh=False):
        del fresh
        session = f"{tenant}/{i % clients_per_tenant}"
        router.route((tenant, items, i), session=session)

    kill_fn = restart_fn = swap_fn = None
    if scenario == "fleet-hostloss":
        kill_fn = victim.kill

        def restart_fn():
            victim.restart()
            router.revive(victim.name)
    elif scenario == "fleet-splitbrain":
        kill_fn = victim.client.partition

        def restart_fn():
            victim.client.partition(False)
    elif scenario == "fleet-rolling-swap":
        swap_fn = waves.run_wave

    try:
        record = run_scenario(
            scenario,
            submit=submit,
            tenants=tenants,
            admission=None,
            duration_s=duration_s,
            offered_load=offered_load,
            clients_per_tenant=clients_per_tenant,
            kill_fn=kill_fn,
            restart_fn=restart_fn,
            swap_fn=swap_fn,
            seed=seed,
        )
        events = fleet.admit_events()
        ceiling = sum(p.rate for p in tenants if p.rate > 0)
        burst = sum(
            p.bucket_depth() for p in tenants if p.rate > 0
        )
        over, peak = _over_ceiling_sweep(events, ceiling, burst)
        record.update(router.stats())
        record.update(waves.stats())
        record.update(fleet.coordinator.stats())
        record["metric"] = "fleet_siege"
        record["fleet_replicas"] = replicas
        record["lease_ttl_s"] = lease_ttl_s
        record["ceiling_rate"] = round(ceiling, 2)
        record["peak_admitted_rate"] = round(peak, 2)
        record["over_ceiling_samples"] = over
        record["restarts"] = sum(
            h.proc.restarts for h in fleet.hosts if h.proc is not None
        )
    finally:
        fleet.close()
    return record
