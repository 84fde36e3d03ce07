"""A Goodlock-style potential-deadlock witness for the threaded host stack
(the port's copy of the JAX package's ``obs/lockwatch.py``).

Every lock of the serving, data and obs host tier is made through
``named_lock`` / ``named_rlock`` / ``named_condition`` with a name
registered in ``WATCHED_LOCKS``, the one inventory of what each lock guards.
Normally the factories return plain ``threading`` primitives: no wrapper,
no cost. Under ``DSL_LOCKWATCH=1`` they return instrumented locks that
record the lock-acquisition-order graph into a global
:class:`WitnessGraph`: whenever a thread acquires lock B while holding lock
A, the edge A→B is recorded. A cycle in that graph is a potential deadlock
(two threads that interleave the inverted orders can wedge), found even
when no deadlock happened in the run.

Known limits of the instrumentation: ``Condition.wait``'s internal release
and re-acquire go through the wrapped lock's plain ``release`` /
``acquire`` (the standard library's fallback), so recursive holds deeper
than one level across a ``wait`` are not supported under watch; and an
acquisition that timed out still records its edge, the conservative
direction for a potential-deadlock detector.

Standard library only.
"""

from __future__ import annotations

import os
import threading

__all__ = [
    "WATCHED_LOCKS",
    "lockwatch_enabled",
    "named_lock",
    "named_rlock",
    "named_condition",
    "watched_lock",
    "WitnessGraph",
    "witness",
]

# The lock inventory: every host-stack lock, with what it guards. Name
# convention: dotted module path (within the package) + owner + attribute
# (function-local locks use the function's name as owner).
WATCHED_LOCKS = {
    "serve.service.RetrievalRouter._publish_lock": (
        "index-version publication: the _versions map and the _current "
        "pointer swap (search reads _current lock-free by design — "
        "publication is the only writer)"
    ),
    "serve.service.RetrievalRouter._stats_lock": (
        "router counters: _swap_count/_swaps_in_flight/_swap_latency/"
        "_searches/_recall_sum/_recall_n/_last_rerank_k"
    ),
    "serve.service.EmbeddingService._lock": (
        "service request counters: _requests/_items/_rejected/_timeouts/"
        "_shed (client threads increment, stats() snapshots)"
    ),
    "serve.engine.InferenceEngine._lock": (
        "the bucket compile cache (_compiled) and the hot-swapped params "
        "reference — swap_params vs _run vs compile_count"
    ),
    "serve.engine.InferenceEngine._call_lock": (
        "one tower call on the device at a time (the port's engine runs its "
        "eager towers under it; taken after _lock is released, never inside it)"
    ),
    "serve.index.RetrievalIndex._lock": (
        "the chunked corpus blocks/id blocks and size — add() vs the "
        "_snapshot() read that gives search its consistent prefix"
    ),
    "serve.cache.EmbeddingCache._lock": (
        "the LRU map plus hits/misses/evictions counters (get/put mutate "
        "both together; stats() snapshots under the same lock)"
    ),
    "serve.shard_index.ShardedIndex._lock": (
        "the per-query-bucket compile-count bookkeeping (_compiled) on the "
        "sharded top-k path"
    ),
    "serve.swap.SwapController._lock": (
        "swap serialization: at most one build+publish window in flight; "
        "the begin_swap/end_swap degraded-health window opens and closes "
        "inside it"
    ),
    "serve.batcher.MicroBatcher._hist_lock": (
        "the batch-size histogram (_batch_sizes) the worker appends and "
        "batch_size_histogram() snapshots"
    ),
    "serve.admission.AdmissionController._lock": (
        "ALL per-tenant admission state: token buckets, inflight quotas, "
        "shed counters/backoff clocks, the shed-event window, and the "
        "priority thresholds rebuild"
    ),
    "serve.siege._INJECT_LOCK": (
        "the armed-fault registry _INJECTORS (install/clear/count-decrement "
        "of FaultPlans; released before any delay/raise fires)"
    ),
    "serve.siege.EngineProcess._lock": (
        "the child Pipe: exactly one send→poll→recv exchange at a time — "
        "the pipe IS the serialized resource"
    ),
    "serve.siege.run_scenario.tally_lock": (
        "per-tenant request tallies (ok/shed/errors/latencies) shared by "
        "the scenario's client threads"
    ),
    "serve.fleet.leases.LeaseCoordinator._lock": (
        "the lease table: _grants/_members/_epoch/_reclaims — grant, "
        "renew, and the TTL expiry sweep are one atomic step so summed "
        "live fractions can never exceed 1.0 mid-transition"
    ),
    "serve.fleet.leases.LeaseClient._lock": (
        "the host's local lease snapshot (_leases/_partitioned) — the "
        "renew thread republishes it; admission reads fractions from it "
        "(coordinator.acquire is called OUTSIDE this lock)"
    ),
    "serve.fleet.leases.LeasedAdmission._lock": (
        "per-tenant leased buckets (tokens/inflight/shed-backoff) plus the "
        "admit-timestamp evidence deque the over-admission sweep reads"
    ),
    "serve.fleet.router.FleetRouter._lock": (
        "routing state: WRR credits, per-replica+per-session in-flight "
        "counts, lost/draining sets, session pins (replica.call and health "
        "probes happen OUTSIDE this lock; wait_idle polls lock-free)"
    ),
    "serve.fleet.waves.WaveController._lock": (
        "wave serialization: at most one swap wave in flight fleet-wide — "
        "the drain→wait-idle→swap→undrain fan-out runs inside it, the "
        "fleet analogue of SwapController._lock's single-swap window"
    ),
    "obs.telemetry.TelemetryExporter._lock": (
        "the scrape-snapshot cache (_cached/_cached_at) plus scrapes/"
        "render_count — render deliberately happens inside the lock so a "
        "scrape storm collapses to one stats() call per refresh window"
    ),
    "obs.spans.SpanRecorder._lock": (
        "the span ring buffer and dropped counter (record vs clear vs "
        "spans snapshot)"
    ),
    "data.native_loader._build_lock": (
        "one-time native dataloader .so build/load (the _lib cache write)"
    ),
    "data.native_loader.NativeSyntheticImageText._iter_lock": (
        "serializes next() against close(): the native ring is "
        "single-consumer and destroy must not race a blocked "
        "dsl_pipeline_next"
    ),
    "data.native_loader.NativeSyntheticImageText._close_lock": (
        "serializes concurrent close()rs; always taken BEFORE _iter_lock "
        "(the data tier's outermost lock)"
    ),
    "data.native_loader.NativeSyntheticImageText._pin_lock": (
        "the zero-copy stream's registry of CUDA-registered ring slots "
        "(a consumer's first-use register vs close()'s unregister-all); "
        "taken inside _iter_lock by close(), alone by a consumer"
    ),
    "data.native_decode._build_lock": (
        "one-time libjpeg engine build/load (the _lib/_lib_failed latch)"
    ),
    "utils.logging.LatencyWindow._lock": (
        "the bounded sample deque + count — record() appends vs the "
        "percentiles_ms sorted snapshot"
    ),
}


def lockwatch_enabled() -> bool:
    """True only when the witness is armed via ``DSL_LOCKWATCH=1``; off, the
    factories return raw ``threading`` primitives."""
    return os.environ.get("DSL_LOCKWATCH") == "1"


class WitnessGraph:
    """Runtime lock-acquisition-order graph with per-thread held stacks.

    Nodes are lock *instances* (unique ``name#k`` tokens), so two same-named
    instances never produce a false self-loop — yet a genuine inversion
    between two instances of one class (thread 1 nests A1→A2 while thread 2
    nests A2→A1) is still a reported cycle, because at instance granularity
    it IS a potential deadlock. Cycles are reported with registered names.
    """

    def __init__(self):
        # The graph's own mutex is a raw lock on purpose: the witness must
        # never witness itself.
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._edges: dict[str, set[str]] = {}
        self._names: dict[str, str] = {}
        self._seq = 0

    def new_token(self, name: str) -> str:
        with self._mu:
            self._seq += 1
            token = f"{name}#{self._seq}"
            self._names[token] = name
            return token

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquiring(self, token: str) -> None:
        """Record held→token edges at ATTEMPT time (a timeout'd acquire
        still witnessed the attempted order — the conservative direction)."""
        st = self._stack()
        if not st:
            return
        with self._mu:
            for held in st:
                if held != token:
                    self._edges.setdefault(held, set()).add(token)

    def note_acquired(self, token: str) -> None:
        self._stack().append(token)

    def note_released(self, token: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == token:
                del st[i]
                return

    def edge_names(self) -> list[tuple[str, str]]:
        """Name-level snapshot of the recorded acquisition-order edges."""
        with self._mu:
            return sorted({
                (self._names[a], self._names[b])
                for a, succs in self._edges.items()
                for b in succs
            })

    def cycles(self) -> list[tuple[str, ...]]:
        """Every distinct cycle in the instance graph, as name tuples —
        non-empty means a potential deadlock was witnessed."""
        with self._mu:
            graph = {u: sorted(vs) for u, vs in self._edges.items()}
            names = dict(self._names)
        color: dict[str, int] = {}  # 0 white / 1 grey / 2 black
        path: list[str] = []
        sigs: set[tuple[str, ...]] = set()
        found: list[tuple[str, ...]] = []

        def visit(start: str) -> None:
            color[start] = 1
            path.append(start)
            stack = [(start, iter(graph.get(start, ())))]
            while stack:
                node, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    color[node] = 2
                    path.pop()
                    stack.pop()
                    continue
                c = color.get(nxt, 0)
                if c == 0:
                    color[nxt] = 1
                    path.append(nxt)
                    stack.append((nxt, iter(graph.get(nxt, ()))))
                elif c == 1:
                    cyc = tuple(
                        names[t] for t in path[path.index(nxt):]
                    )
                    k = min(
                        range(len(cyc)),
                        key=lambda j: cyc[j:] + cyc[:j],
                    )
                    sig = cyc[k:] + cyc[:k]
                    if sig not in sigs:
                        sigs.add(sig)
                        found.append(sig)

        for u in sorted(graph):
            if color.get(u, 0) == 0:
                visit(u)
        return found

    def reset(self) -> None:
        """Drop recorded edges (names/tokens survive). Test scaffolding —
        the session witness is never reset mid-run."""
        with self._mu:
            self._edges.clear()


_WITNESS = WitnessGraph()


def witness() -> WitnessGraph:
    """The process-global witness graph the named factories record into."""
    return _WITNESS


class _WatchedLock:
    """Witness-recording wrapper with the threading lock protocol."""

    def __init__(self, name: str, graph: WitnessGraph, factory):
        self._inner = factory()
        self._graph = graph
        self._token = graph.new_token(name)
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._graph.note_acquiring(self._token)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._graph.note_acquired(self._token)
        return ok

    def release(self) -> None:
        self._graph.note_released(self._token)
        self._inner.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False

    def _is_owned(self) -> bool:
        # threading.Condition probes this; delegate so a watched RLock
        # behaves (the stdlib try-acquire fallback would mis-report an
        # owned RLock as free, reentrancy being reentrant).
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self) -> str:
        return f"<watched {self.name} {self._inner!r}>"


def _require_registered(name: str) -> None:
    if name not in WATCHED_LOCKS:
        raise KeyError(
            f"unregistered lock name {name!r}: register it in "
            "obs/lockwatch.py WATCHED_LOCKS with a rationale saying what "
            "it guards"
        )


def named_lock(name: str):
    """A ``threading.Lock`` in production; a witness-recording wrapper
    under ``DSL_LOCKWATCH=1``. ``name`` must be a registered constant."""
    _require_registered(name)
    if lockwatch_enabled():
        return _WatchedLock(name, _WITNESS, threading.Lock)
    return threading.Lock()


def named_rlock(name: str):
    """``named_lock`` for reentrant locks."""
    _require_registered(name)
    if lockwatch_enabled():
        return _WatchedLock(name, _WITNESS, threading.RLock)
    return threading.RLock()


def named_condition(name: str):
    """A ``threading.Condition`` whose underlying lock is witnessed under
    ``DSL_LOCKWATCH=1`` (wait's internal re-acquire included, via the
    stdlib release/acquire fallback)."""
    _require_registered(name)
    if lockwatch_enabled():
        return threading.Condition(
            _WatchedLock(name, _WITNESS, threading.RLock)
        )
    return threading.Condition()


def watched_lock(name: str, graph: WitnessGraph | None = None):
    """Always-instrumented lock on an explicit graph — test scaffolding for
    seeding/fixturing witness scenarios without touching the session
    witness or the registry. Production code uses ``named_lock``."""
    return _WatchedLock(name, graph if graph is not None else _WITNESS,
                        threading.Lock)
