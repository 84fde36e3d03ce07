"""The port's lockwatch (``obs/lockwatch.py``) held to the JAX package's.

The JAX package's witness tests, run on the port's copy and its serving,
admission and fleet stacks (a lock-order inversion is reported even when
no deadlock happens; two instances of one name never make a self-loop; the
churned stacks stay acyclic under ``DSL_LOCKWATCH=1``), and the same
acquisition orders through both packages' ``WitnessGraph`` give the same
edges and cycles.
"""

import threading
import time

import pytest

from distributed_sigmoid_loss_tpu_torch.obs import lockwatch
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import (
    WATCHED_LOCKS,
    WitnessGraph,
    watched_lock,
)


# ---------------------------------------------------------------------------
# WitnessGraph unit behavior
# ---------------------------------------------------------------------------


def test_witness_records_nested_edges_and_stays_acyclic():
    g = WitnessGraph()
    a = watched_lock("A", graph=g)
    b = watched_lock("B", graph=g)
    with a:
        with b:
            pass
    # same direction again: no duplicate edge, still no cycle
    with a:
        with b:
            pass
    assert g.edge_names() == [("A", "B")]
    assert g.cycles() == []


def test_witness_trips_on_seeded_inversion_across_two_threads():
    """The Goodlock property: thread 1 nests A→B, thread 2 nests B→A with
    the threads run strictly one after the other — no deadlock can possibly
    manifest, yet the witnessed order graph has the A⇄B cycle."""
    g = WitnessGraph()
    a = watched_lock("A", graph=g)
    b = watched_lock("B", graph=g)

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    t1 = threading.Thread(target=forward)
    t1.start()
    t1.join()
    t2 = threading.Thread(target=backward)
    t2.start()
    t2.join()
    cycles = g.cycles()
    assert cycles, "inversion not witnessed"
    assert {"A", "B"} == set(cycles[0])


def test_witness_no_false_self_loop_for_two_instances_of_one_name():
    """Nesting two INSTANCES of the same lock class in one consistent order
    (the shard-index fan-out pattern) must not read as a self-deadlock."""
    g = WitnessGraph()
    l1 = watched_lock("L", graph=g)
    l2 = watched_lock("L", graph=g)
    with l1:
        with l2:
            pass
    assert g.edge_names() == [("L", "L")]  # name-level: informational
    assert g.cycles() == []  # instance-level: no cycle

    # ...but a genuine inversion BETWEEN the two instances is a cycle.
    with l2:
        with l1:
            pass
    assert [set(c) for c in g.cycles()] == [{"L"}]


def test_witness_timeout_failed_acquire_still_records_attempt_order():
    """Edges are recorded at attempt time: a timed-out acquire witnessed
    the attempted order (the conservative direction for deadlock hunting),
    and a failed acquire must not corrupt the held stack."""
    g = WitnessGraph()
    a = watched_lock("A", graph=g)
    b = watched_lock("B", graph=g)
    b._inner.acquire()  # someone else holds B
    try:
        with a:
            assert a.locked()
            assert not b.acquire(blocking=False)
    finally:
        b._inner.release()
    assert g.edge_names() == [("A", "B")]
    # stack clean: a fresh B-then-A nesting records only the new direction
    g.reset()
    with b:
        with a:
            pass
    assert g.edge_names() == [("B", "A")]


def test_witness_reset_drops_edges():
    g = WitnessGraph()
    a = watched_lock("A", graph=g)
    b = watched_lock("B", graph=g)
    with a, b:
        pass
    assert g.edge_names()
    g.reset()
    assert g.edge_names() == []
    assert g.cycles() == []


# ---------------------------------------------------------------------------
# named_lock factory behavior
# ---------------------------------------------------------------------------


def test_named_lock_rejects_unregistered_names():
    with pytest.raises(KeyError, match="WATCHED_LOCKS"):
        lockwatch.named_lock("serve.nonexistent._lock")
    with pytest.raises(KeyError, match="what it guards"):
        lockwatch.named_rlock("serve.nonexistent._lock")
    with pytest.raises(KeyError):
        lockwatch.named_condition("serve.nonexistent._lock")


def test_named_lock_is_raw_threading_primitive_when_disabled(monkeypatch):
    monkeypatch.delenv("DSL_LOCKWATCH", raising=False)
    lk = lockwatch.named_lock("serve.cache.EmbeddingCache._lock")
    assert isinstance(lk, type(threading.Lock()))
    cv = lockwatch.named_condition("serve.cache.EmbeddingCache._lock")
    assert isinstance(cv, threading.Condition)


def test_named_lock_is_watched_when_enabled(monkeypatch):
    monkeypatch.setenv("DSL_LOCKWATCH", "1")
    lk = lockwatch.named_lock("serve.cache.EmbeddingCache._lock")
    assert isinstance(lk, lockwatch._WatchedLock)
    with lk:
        assert lk.locked()
    assert not lk.locked()
    # Condition over a watched RLock: wait() must see an owned lock
    # (the _is_owned delegation), i.e. not raise "un-acquired lock".
    cv = lockwatch.named_condition("serve.cache.EmbeddingCache._lock")
    with cv:
        assert not cv.wait(timeout=0.01)


def test_registry_names_mirror_the_shipped_modules():
    """Every watched name is `<pkg>.<module>[.Class].<attr>` under a real
    package path: JAX's 25 rows, plus the port's engine call lock and the
    native loader's pin-registry lock."""
    from distributed_sigmoid_loss_tpu.obs.lockwatch import WATCHED_LOCKS as JAX_LOCKS

    assert set(WATCHED_LOCKS) == set(JAX_LOCKS) | {
        "serve.engine.InferenceEngine._call_lock",
        "data.native_loader.NativeSyntheticImageText._pin_lock"}
    for name, rationale in WATCHED_LOCKS.items():
        assert rationale.strip(), name
        assert name.split(".")[0] in {"serve", "obs", "data", "utils"}, name


# ---------------------------------------------------------------------------
# the real serving stack under the witness: close/swap/shed churn
# ---------------------------------------------------------------------------


def test_batcher_admission_churn_acyclic_witness_no_unresolved(monkeypatch):
    """8 client threads drive AdmissionController→MicroBatcher while the
    main thread churns the batcher (close → swap in a fresh one) — under
    DSL_LOCKWATCH=1 so every lock in the path is witnessed. Asserts the
    drain pin end to end: every submitted future resolves (result or
    typed shutdown error, never a hang), plus the witness property: the
    witnessed lock-order graph is acyclic."""
    from distributed_sigmoid_loss_tpu_torch.serve.admission import (
        AdmissionController,
        ShedError,
        TenantPolicy,
    )
    from distributed_sigmoid_loss_tpu_torch.serve.batcher import (
        BatcherClosedError,
        MicroBatcher,
        QueueFullError,
    )

    monkeypatch.setenv("DSL_LOCKWATCH", "1")
    g = lockwatch.witness()

    ctrl = AdmissionController(
        policies=[
            TenantPolicy("gold", rate=0.0, max_inflight=6, priority=2),
            TenantPolicy("free", rate=0.0, max_inflight=2, priority=0),
        ],
        capacity=8,
    )

    def run_batch(items):
        time.sleep(0.001)
        return [x * 2 for x in items]

    def make_batcher():
        return MicroBatcher(
            run_batch, max_batch_size=8, max_wait_ms=1.0, max_queue=64
        )

    holder = {"b": make_batcher()}
    stop = threading.Event()
    futures = []
    fut_lock = threading.Lock()
    sheds = {"n": 0}

    def client(i):
        tenant = "gold" if i % 2 == 0 else "free"
        while not stop.is_set():
            try:
                ticket = ctrl.admit(tenant)
            except ShedError:
                sheds["n"] += 1  # benign race on the counter: stats only
                time.sleep(0.001)
                continue
            try:
                fut = holder["b"].submit(i)
                with fut_lock:
                    futures.append(fut)
                try:
                    fut.result(timeout=5.0)
                    ok = True
                except Exception:
                    ok = False
                ticket.release(ok=ok)
            except (BatcherClosedError, QueueFullError):
                ticket.release(ok=False)

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(8)
    ]
    for t in threads:
        t.start()
    # churn: close (drain-guaranteed) and swap in a fresh batcher
    for _ in range(6):
        time.sleep(0.05)
        old = holder["b"]
        holder["b"] = make_batcher()
        old.close(wait=True)
    stop.set()
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()
    holder["b"].close(wait=True)

    # zero unresolved futures: everything submitted is done NOW
    with fut_lock:
        unresolved = [f for f in futures if not f.done()]
    assert unresolved == [], f"{len(unresolved)} futures left hanging"
    assert len(futures) > 0

    # the witness property: no lock-order inversion was witnessed
    cycles = g.cycles()
    assert cycles == [], f"witnessed potential deadlock(s): {cycles}"
    # the witness actually saw the stack (edges exist when any nesting
    # occurred; at minimum the admission→latency-window edge)
    edges = g.edge_names()
    assert ("serve.admission.AdmissionController._lock",
            "utils.logging.LatencyWindow._lock") in edges, edges


# ---------------------------------------------------------------------------
# the fleet tier under the witness: lease churn × routing × swap waves
# ---------------------------------------------------------------------------


def test_fleet_lease_churn_routing_swap_waves_acyclic_witness(monkeypatch):
    """The fleet stress under DSL_LOCKWATCH=1: 6 client threads route
    sessions through the fleet router (leased admission on every host)
    while every lease client renews on a hot 20ms period, one host flaps
    partition on/off, and the main thread runs back-to-back swap waves.
    All five fleet locks (coordinator, client, admission, router, wave
    controller) interleave with the latency-window lock — the witnessed
    order graph must stay acyclic (waves→router is the one expected
    cross-module edge)."""
    from distributed_sigmoid_loss_tpu_torch.serve.admission import (
        ShedError,
        TenantPolicy,
    )
    from distributed_sigmoid_loss_tpu_torch.serve.fleet import (
        NoReplicaError,
        build_fleet,
    )

    monkeypatch.setenv("DSL_LOCKWATCH", "1")
    g = lockwatch.witness()

    fleet = build_fleet(
        replicas=3,
        tenants=[
            TenantPolicy("gold", priority=2, rate=400.0, max_inflight=48),
            TenantPolicy("free", priority=1, rate=200.0, max_inflight=24),
        ],
        ttl_s=0.25,
        renew_interval_s=0.02,  # hot renew loop: maximal lease churn
        process_backed=False,
        computes=[lambda body: body] * 3,
    )
    try:
        stop = threading.Event()
        fatal = []

        def client(i):
            tenant = "gold" if i % 2 == 0 else "free"
            session = f"sess-{i}"
            while not stop.is_set():
                try:
                    fleet.router.route((tenant, 1, i), session=session)
                except (ShedError, NoReplicaError):
                    time.sleep(0.001)  # typed churn is the point
                except Exception as e:  # pragma: no cover - failure path
                    fatal.append(repr(e))
                    return

        threads = [
            threading.Thread(target=client, args=(i,), daemon=True)
            for i in range(6)
        ]
        for t in threads:
            t.start()
        flapper = fleet.hosts[0].client
        for k in range(8):  # waves × partition flaps over the churn
            time.sleep(0.04)
            flapper.partition(k % 2 == 0)
            fleet.waves.run_wave()
        flapper.partition(False)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
        assert fatal == [], fatal
    finally:
        fleet.close()

    cycles = g.cycles()
    assert cycles == [], f"witnessed potential deadlock(s): {cycles}"
    edges = g.edge_names()
    # The ONE expected cross-module edge: the wave controller drains and
    # polls the router while holding the wave lock.
    assert ("serve.fleet.waves.WaveController._lock",
            "serve.fleet.router.FleetRouter._lock") in edges, edges
    # The three lease locks are LEAF locks by construction (coordinator
    # RPC outside the client lock, fraction read before the admission
    # lock, locked-helper pattern in the coordinator): they must appear
    # in NO edge at all — nesting one would be a discipline regression.
    witnessed = {n for edge in edges for n in edge}
    for name in (
        "serve.fleet.leases.LeaseCoordinator._lock",
        "serve.fleet.leases.LeaseClient._lock",
        "serve.fleet.leases.LeasedAdmission._lock",
    ):
        assert name not in witnessed, (name, edges)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _replay(module, seed: int):
    """A seeded sequence of nested acquisitions over four named locks (two
    of them instances of one name) through ``module``'s WitnessGraph, on
    two threads run one after the other: its edges and cycles."""
    import numpy as np

    g = module.WitnessGraph()
    locks = [module.watched_lock(n, graph=g) for n in ("A", "B", "C", "C")]
    rng = np.random.default_rng(seed)
    plans = [[rng.permutation(4)[: rng.integers(2, 5)] for _ in range(6)] for _ in range(2)]

    def run(plan):
        for order in plan:
            held = []
            for i in order:
                locks[i].acquire()
                held.append(locks[i])
            for lk in reversed(held):
                lk.release()

    for plan in plans:
        t = threading.Thread(target=run, args=(plan,))
        t.start()
        t.join()
    return g.edge_names(), g.cycles()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_acquisition_order_gives_jaxs_edges_and_cycles(seed):
    from distributed_sigmoid_loss_tpu.obs import lockwatch as jax_lockwatch

    assert _replay(lockwatch, seed) == _replay(jax_lockwatch, seed)


def test_named_locks_of_the_port_modules_are_raw_when_disabled(monkeypatch):
    """With the witness off, the serving stack's named locks are threading's
    own (no wrapper, no cost)."""
    from distributed_sigmoid_loss_tpu_torch.serve.batcher import MicroBatcher
    from distributed_sigmoid_loss_tpu_torch.serve.cache import EmbeddingCache
    from distributed_sigmoid_loss_tpu_torch.serve.index import RetrievalIndex

    monkeypatch.delenv("DSL_LOCKWATCH", raising=False)
    raw = type(threading.Lock())
    batcher = MicroBatcher(lambda items: items)
    try:
        assert type(batcher._hist_lock) is raw
    finally:
        batcher.close(wait=True)
    assert type(EmbeddingCache(8)._lock) is raw
    assert type(RetrievalIndex()._lock) is raw
    monkeypatch.setenv("DSL_LOCKWATCH", "1")
    assert isinstance(EmbeddingCache(8)._lock, lockwatch._WatchedLock)
