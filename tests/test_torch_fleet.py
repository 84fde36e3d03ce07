"""The port's fleet tier vs the JAX package's on the CPU.

- ``LeaseCoordinator`` / ``LeaseClient`` / ``LeasedAdmission`` under one
  scripted sequence on a stepped fake clock: the same grants, fractions,
  reclaims, epochs, admit/shed decisions and ``retry_after_s`` as JAX's;
  over-commit refused the same way.
- ``FleetRouter``: the replica each request lands on, the version it is
  served from and every typed refusal, equal to JAX's over a seeded random
  script of weights, sessions, version bumps, drains, losses and revivals.
- ``WaveController`` order and skips; the fleet scenarios' records; and
  ``serve-bench --fleet-scenario`` with the JAX command's record keys,
  valid under JAX's ``validate_record``, with its refusals.
"""

import json

import numpy as np
import pytest

from distributed_sigmoid_loss_tpu import cli as jax_cli
from distributed_sigmoid_loss_tpu.analysis.bench_schema import validate_record
from distributed_sigmoid_loss_tpu.serve import admission as jax_admission
from distributed_sigmoid_loss_tpu.serve.fleet import leases as jax_leases
from distributed_sigmoid_loss_tpu.serve.fleet import router as jax_router
from distributed_sigmoid_loss_tpu.serve.siege import HostLostError as JaxHostLostError
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.serve import (
    FLEET_SCENARIOS,
    FleetRouter,
    HostLostError,
    LeaseClient,
    LeaseCoordinator,
    NoReplicaError,
    OverCommitError,
    ReplicaHandle,
    TenantPolicy,
    WaveController,
    admission,
    build_fleet,
    run_fleet_scenario,
)
from distributed_sigmoid_loss_tpu_torch.serve.fleet import leases, router, scenarios


class FakeClock:
    def __init__(self, t: float = 1e9):
        self.t = t

    def monotonic(self) -> float:
        return self.t


def _lease_script(lmod, amod, clock):
    """Two then three hosts renewing, one going silent (its slices age out
    and are reclaimed), one partitioned, with leased admission on host a
    throughout; every observable step recorded."""
    tenants = [amod.TenantPolicy("gold", priority=2, rate=20.0, burst=4, max_inflight=6),
               amod.TenantPolicy("free", priority=1, rate=8.0, max_inflight=2),
               amod.TenantPolicy("open", priority=1)]
    coord = lmod.LeaseCoordinator({p.name: p.rate for p in tenants}, ttl_s=1.0)
    alive = {"a": True, "b": True, "c": True}
    clients = {h: lmod.LeaseClient(coord, h, alive_fn=lambda h=h: alive[h]) for h in alive}
    adm = lmod.LeasedAdmission(clients["a"], tenants)
    log, tickets = [], []

    def snap(tag):
        log.append((tag, clock.t, coord.stats(),
                    {t.name: round(coord.granted_fraction(t.name), 9) for t in tenants},
                    {h: {t.name: c.fraction(t.name) for t in tenants}
                     for h, c in clients.items()},
                    {h: c.lease_epoch() for h, c in clients.items()}))

    def admit(tenant, items=1, deadline=None):
        try:
            tickets.append(adm.admit(tenant, items=items, deadline_s=deadline))
            log.append(("ok", tenant, items))
        except amod.ShedError as e:
            log.append(("shed", e.tenant, e.reason, e.retry_after_s, e.retriable, str(e)))

    clients["a"].renew_once()
    admit("gold")  # no lease for b yet: a holds everything
    clients["b"].renew_once()
    clients["a"].renew_once()
    snap("two hosts")
    for _ in range(5):
        admit("gold")
    admit("free", 1)
    admit("free", 1)
    admit("open")
    clock.t += 0.2
    clients["c"].renew_once()
    snap("c joins")
    for h in "ab":
        clients[h].renew_once()
    snap("three hosts")
    for t in tickets[:3]:
        t.release()
    admit("gold", 2)
    admit("gold", 9, deadline=0.001)
    alive["c"] = False  # c dies silently: it stops renewing
    for _ in range(6):
        clock.t += 0.25
        for h in "ab":
            assert clients[h].renew_once() is True
        assert clients["c"].renew_once() is False
        snap("c silent")
        admit("free")
    clients["b"].partition()
    clock.t += 0.8  # b's leases pass their usable window
    assert clients["b"].renew_once() is False
    snap("b partitioned")
    clients["b"].partition(False)
    clients["b"].renew_once()
    snap("b healed")
    log.append(("counts", adm.counts(), len(adm.admit_times())))
    try:
        coord.grant("gold", "z", 0.9)
    except lmod.OverCommitError as e:
        log.append(("overcommit", str(e)))
    return log


def test_leases_equal_to_jax_under_a_scripted_clock(monkeypatch):
    logs = []
    for lmod, amod in ((leases, admission), (jax_leases, jax_admission)):
        clock = FakeClock()
        monkeypatch.setattr(lmod, "time", clock)
        monkeypatch.setattr(amod, "time", clock)
        logs.append(_lease_script(lmod, amod, clock))
    port, ref = logs
    assert port == ref
    tags = [entry[0] for entry in port]
    assert "overcommit" in tags and tags.count("shed") >= 3
    reclaims = [entry[2]["lease_reclaims"] for entry in port if entry[0] == "c silent"]
    assert reclaims[-1] > reclaims[0]  # the dead host's slices came back


def test_overcommit_refused_never_recorded():
    coord = LeaseCoordinator({"t": 10.0}, ttl_s=5.0)
    coord.grant("t", "a", 0.6)
    with pytest.raises(OverCommitError, match="1.0"):
        coord.grant("t", "b", 0.5)
    assert coord.granted_fraction("t") == pytest.approx(0.6)
    with pytest.raises(ValueError, match="ttl_s"):
        LeaseCoordinator({}, ttl_s=0)
    client = LeaseClient(coord, "a").start()
    try:
        assert client.fraction("t") > 0
    finally:
        client.close()


def _router_script(rmod, lost_error, seed):
    """A seeded random script through ``rmod``'s router: weighted replicas,
    sessions, version bumps, drains, health flips, losses and revivals.
    Returns every route's (replica, version) or typed refusal, and the
    stats after each step."""
    rng = np.random.default_rng(seed)
    names = ["r0", "r1", "r2", "r3"]
    version = {n: 1 for n in names}
    status = {n: {"status": "ok", "reasons": []} for n in names}
    dying = set()

    def make_call(n):
        def call(payload):
            if n in dying:
                dying.discard(n)
                raise lost_error(f"{n} lost mid-call")
            return (n, payload)
        return call

    r = rmod.FleetRouter([
        rmod.ReplicaHandle(n, make_call(n), health_fn=lambda n=n: status[n],
                           version_fn=lambda n=n: version[n], weight=float(w))
        for n, w in zip(names, (1, 2, 3, 1))
    ])
    log = []
    for step in range(300):
        op = rng.random()
        n = names[int(rng.integers(len(names)))]
        if op < 0.6:
            session = None if rng.random() < 0.3 else f"s{int(rng.integers(6))}"
            try:
                result, name, ver = r.route(step, session=session)
                log.append(("ok", name, ver, result))
            except rmod.NoReplicaError as e:
                log.append(("no_replica", str(e)))
        elif op < 0.7:
            version[n] += 1
        elif op < 0.75:
            r.drain(n)
        elif op < 0.82:
            r.undrain(n)
        elif op < 0.86:
            status[n] = {"status": "degraded",
                         "reasons": [["shedding"], ["swap_in_flight"]][int(rng.integers(2))]}
        elif op < 0.9:
            status[n] = {"status": "ok", "reasons": []}
        elif op < 0.94:
            dying.add(n)
        else:
            r.revive(n)
        log.append(("stats", r.stats(), r.inflight(n)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_router_choice_and_pinning_equal_to_jax(seed):
    port = _router_script(router, HostLostError, seed)
    ref = _router_script(jax_router, JaxHostLostError, seed)
    assert port == ref
    kinds = {entry[0] for entry in port}
    assert {"ok", "no_replica"} <= kinds
    assert port[-1][1]["affinity_hits"] > 0 and port[-1][1]["reroutes"] > 0


def test_router_refusals_and_wait_idle():
    with pytest.raises(ValueError, match="at least one"):
        FleetRouter([])
    with pytest.raises(ValueError, match="duplicate"):
        FleetRouter([ReplicaHandle("a", lambda p: p), ReplicaHandle("a", lambda p: p)])
    with pytest.raises(ValueError, match="weight"):
        ReplicaHandle("a", lambda p: p, weight=0)
    r = FleetRouter([ReplicaHandle("a", lambda p: p)])
    r.wait_idle("a", timeout_s=0.1)
    r.mark_lost("a")
    with pytest.raises(NoReplicaError):
        r.route(0)


def test_wave_swaps_in_declared_order_and_skips_lost():
    log = []
    lost = {"b"}

    def handle(name):
        return ReplicaHandle(
            name, lambda p: p,
            health_fn=lambda: {"status": "lost" if name in lost else "ok"},
            swap_fn=lambda: log.append(name))

    waves = WaveController(FleetRouter([handle(n) for n in "abc"]))
    first = waves.run_wave()
    assert log == ["a", "c"] and first["swapped"] == ["a", "c"] and first["skipped"] == ["b"]
    lost.clear()
    assert waves.run_wave()["swapped"] == ["a", "b", "c"]
    assert waves.stats() == {"wave_id": 2}


def test_build_fleet_in_process_backends_and_validation():
    tenants = [TenantPolicy("t", rate=100.0, max_inflight=8)]
    with pytest.raises(ValueError, match=">= 2"):
        build_fleet(replicas=1, tenants=tenants)
    swapped = []
    fleet = build_fleet(replicas=2, tenants=tenants, process_backed=False,
                        computes=[lambda b: ("c0", b), lambda b: ("c1", b)],
                        swap_impls=[lambda: swapped.append(0), lambda: swapped.append(1)])
    try:
        for host in fleet.hosts:  # converge to equal shares (the second host starts at 0)
            host.client.renew_once()
        served = {fleet.router.route(("t", 1, i))[0][0] for i in range(4)}
        assert served == {"c0", "c1"}
        fleet.waves.run_wave()
        assert swapped == [0, 1] and [h.version for h in fleet.hosts] == [2, 2]
    finally:
        fleet.close()
    assert len(fleet.admit_events()) == 4
    with pytest.raises(ValueError, match="unknown fleet scenario"):
        run_fleet_scenario("fleet-meltdown")


def test_over_ceiling_sweep_equal_to_jax():
    from distributed_sigmoid_loss_tpu.serve.fleet import scenarios as jax_scenarios

    rng = np.random.default_rng(3)
    events = sorted((float(t), int(n)) for t, n in zip(rng.uniform(0, 3, 400),
                                                       rng.integers(1, 3, 400)))
    for ceiling, burst in ((100.0, 10.0), (150.0, 4.0), (400.0, 0.0)):
        assert scenarios._over_ceiling_sweep(events, ceiling, burst) == \
            jax_scenarios._over_ceiling_sweep(events, ceiling, burst)
    assert scenarios._over_ceiling_sweep([], 1.0, 1.0) == (0, 0.0)


# ---------------------------------------------------------------------------
# The fleet scenarios, and serve-bench --fleet-scenario against JAX's command
# ---------------------------------------------------------------------------

FLEET_ARGS = ["serve-bench", "--fleet-replicas", "3", "--lease-ttl-s", "0.3",
              "--duration-s", "1.0", "--offered-load", "100", "--seed", "3"]


@pytest.mark.parametrize("scenario", FLEET_SCENARIOS)
def test_cli_fleet_scenario_record_keys_equal_jax(scenario, capsys):
    argv = FLEET_ARGS + ["--fleet-scenario", scenario]
    assert cli.main(argv) == 0  # no device: the drill's workers are stand-ins
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(port) == list(ref)
    assert {k: list(v) for k, v in port["per_tenant"].items()} == \
        {k: list(v) for k, v in ref["per_tenant"].items()}
    assert validate_record(port) == []
    assert port["metric"] == "fleet_siege" and port["scenario"] == scenario
    assert port["silent_drops"] == 0 and port["over_ceiling_samples"] == 0
    assert port["fleet_replicas"] == 3 and port["replica_count"] == 3
    if scenario == "fleet-rolling-swap":
        assert port["wave_id"] >= 1  # a wave every 200 ms of the 1 s
    if scenario == "fleet-hostloss":
        assert port["restarts"] == 1


@pytest.mark.parametrize("argv", [
    ["--fleet-scenario", "fleet-hostloss", "--scenario", "burst"],
    ["--fleet-replicas", "3"],
    ["--lease-ttl-s", "0.5"],
    ["--fleet-scenario", "fleet-hostloss", "--fleet-replicas", "1"],
    ["--fleet-scenario", "fleet-splitbrain", "--duration-s", "0"],
    ["--fleet-scenario", "fleet-splitbrain", "--tenants", "gold:prio"],
    ["--fleet-scenario", "fleet-meltdown"],
])
def test_cli_fleet_refusals_exit_2_like_jax(argv, capsys):
    def run(main):
        try:
            return main(["serve-bench"] + argv)
        except SystemExit as e:  # argparse's own refusals
            return e.code

    assert run(cli.main) == run(jax_cli.main) == 2
    capsys.readouterr()
