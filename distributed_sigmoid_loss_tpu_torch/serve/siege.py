"""Fault injection and chaos scenarios for the serving stack.

The serving stack's failure semantics (typed shed/queue-full/shutdown
rejections, drain-on-close, swap-under-load, host loss) are contracts, and
contracts that are never exercised rot. This module makes them drillable:

- **chaos gate** — every fault-injection point is a ``maybe_inject(point)``
  call in production code that is DEAD unless the ``DSL_CHAOS`` environment
  hook is set AND a fault is armed. Points must be registered in
  :data:`CHAOS_POINTS` with a rationale; an unregistered point raises
  ``KeyError`` at the call site, so a call site cannot drift from the
  registry unnoticed.
- **host-loss machinery** — :class:`EngineProcess` runs an engine worker in
  a separate OS process behind a pipe; a SIGKILLed worker surfaces as a
  typed :class:`HostLostError` to every in-flight caller, never a hang, and
  ``restart()`` measures recovery. Workers start by ``fork`` until CUDA is
  initialized in this process, and from a fork server after that
  (:func:`drill_start_method`): a forked child of a process with a CUDA
  context and the serving threads can deadlock on a lock another thread
  held at the fork.
- **scenario generator** — :func:`run_scenario` drives multi-tenant client
  load (burst / skew / slowloris / hostloss / swapstorm) through an
  :class:`~.admission.AdmissionController`-fronted submit callable and
  emits one schema-validated degradation record (p99 vs offered load,
  per-tenant shed_rate, recovery_time_s, silent_drops) for the
  ``serve-bench --scenario`` path to print.

Module-level imports stay stdlib + admission + utils (``serve.batcher``
imports this module for its injection point, so importing service/engine
here would cycle through the partially-initialized package). The port's
copy of the JAX package's ``serve/siege.py``, with plain
``threading.Lock``s where JAX takes named locks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from distributed_sigmoid_loss_tpu_torch.serve.admission import (
    AdmissionController,
    ShedError,
    TenantPolicy,
)
from distributed_sigmoid_loss_tpu_torch.utils.logging import LatencyWindow

__all__ = [
    "CHAOS_POINTS",
    "SCENARIOS",
    "EngineProcess",
    "FaultPlan",
    "HostLostError",
    "chaos_enabled",
    "clear_faults",
    "drill_start_method",
    "hostloss_drill",
    "inject",
    "install_fault",
    "maybe_inject",
    "run_scenario",
]

# Every fault-injection point in the serving stack, with the rationale for
# why that failure mode is worth drilling. A maybe_inject call site naming
# a point missing here raises KeyError.
CHAOS_POINTS = {
    "engine.latency": (
        "slow accelerator step (thermal throttle, preempted donor VM): the "
        "deadline + shed path must degrade p99 gracefully, not queue-collapse"
    ),
    "engine.exception": (
        "engine call raises (OOM, CUDA runtime fault): every future in the "
        "batch must fail typed; the worker must keep serving later batches"
    ),
    "batcher.stall": (
        "worker thread wedges before the engine call (lock contention, GC "
        "pause): queue fills, submits must hit typed backpressure, and "
        "close() must still drain"
    ),
    "swap.storm": (
        "hot swap under overload: swaps serialize, searches stay on their "
        "version, /healthz must show degraded while a swap is mid-flight"
    ),
    "fleet.partition": (
        "lease client partitioned from the coordinator (network split): the "
        "host must stop using its slices at the staleness bound and shed — "
        "bounded staleness means under-admit is the only legal failure mode"
    ),
}

# Armed fault plans, point -> FaultPlan. Mutable module state by design:
# tests and scenario drivers arm faults cross-thread, and the production
# read path must stay one dict probe.
_INJECTORS: dict = {}
_INJECT_LOCK = threading.Lock()


def chaos_enabled() -> bool:
    """The DSL_CHAOS hook: fault injection is dead unless this env var is
    exactly "1"."""
    return os.environ.get("DSL_CHAOS", "") == "1"


@dataclass
class FaultPlan:
    """One armed fault: sleep ``delay_s``, then raise ``exception`` (if
    any), at most ``count`` times (None = every pass through the point)."""

    delay_s: float = 0.0
    exception: BaseException | None = None
    count: int | None = None
    fired: int = 0

    def _take(self) -> bool:
        if self.count is not None and self.fired >= self.count:
            return False
        self.fired += 1
        return True


def install_fault(
    point: str,
    *,
    delay_s: float = 0.0,
    exception: BaseException | None = None,
    count: int | None = None,
) -> FaultPlan:
    """Arm a fault at a registered injection point (unregistered → KeyError).

    Arming does NOT flip the gate: nothing fires unless ``DSL_CHAOS=1`` is
    also set in the environment — the gate stays a deliberate, separate act.
    """
    if point not in CHAOS_POINTS:
        raise KeyError(
            f"unregistered chaos point {point!r}; register it in "
            f"serve/siege.py CHAOS_POINTS (known: {sorted(CHAOS_POINTS)})"
        )
    plan = FaultPlan(delay_s=delay_s, exception=exception, count=count)
    with _INJECT_LOCK:
        _INJECTORS[point] = plan
    return plan


def clear_faults(point: str | None = None) -> None:
    with _INJECT_LOCK:
        if point is None:
            _INJECTORS.clear()
        else:
            _INJECTORS.pop(point, None)


@contextmanager
def inject(point: str, **kwargs):
    """``with inject("engine.latency", delay_s=0.05): ...`` — arm for the
    block, disarm on exit (the env gate is still the caller's job)."""
    plan = install_fault(point, **kwargs)
    try:
        yield plan
    finally:
        clear_faults(point)


def maybe_inject(point: str) -> None:
    """The production-side injection point. Unregistered point → KeyError
    (a call site that drifts from the registry fails loudly, not silently);
    otherwise a no-op unless the DSL_CHAOS gate is up AND a fault is armed.
    """
    if point not in CHAOS_POINTS:
        raise KeyError(
            f"maybe_inject({point!r}): not a registered chaos point "
            f"(known: {sorted(CHAOS_POINTS)})"
        )
    if not chaos_enabled():
        return
    with _INJECT_LOCK:
        plan = _INJECTORS.get(point)
        live = plan is not None and plan._take()
    if not live:
        return
    if plan.delay_s > 0:
        time.sleep(plan.delay_s)
    if plan.exception is not None:
        raise plan.exception


# -- host-loss machinery ------------------------------------------------------


class HostLostError(RuntimeError):
    """The engine's host process died mid-request (kill -9, OOM-kill,
    preemption). Typed so admitted requests fail loudly instead of hanging —
    the zero-silent-drops contract."""


def _echo_worker(conn, latency_s: float) -> None:
    """Default engine surrogate for drills: echoes payloads after an
    optional simulated compute delay. Top-level so every mp start method
    can pickle it. Pure stdlib on purpose — the drill exercises the SERVING
    failure semantics (pipe loss, typed errors, recovery), not the model
    forward, so the child never touches the device."""
    while True:
        try:
            kind, payload = conn.recv()
        except (EOFError, OSError):
            return
        if kind == "stop":
            return
        if latency_s > 0:
            time.sleep(latency_s)
        try:
            conn.send(("ok", payload))
        except (BrokenPipeError, OSError):
            return


def drill_start_method() -> str:
    """The start method of drill workers: ``"fork"`` (instant) until CUDA is
    initialized in this process, ``"forkserver"`` after. The fork server is
    a fresh interpreter with no CUDA context and no serving threads; it
    imports this module (and the main module) once, and forks every worker
    from there."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return "forkserver"
    return "fork"


class EngineProcess:
    """An engine worker in a separate OS process, callable over a pipe.

    The serving-side half of the kill -9 / resume machinery: ``kill()``
    SIGKILLs the worker mid-traffic (no cleanup, like a lost host), after
    which every in-flight and subsequent ``call`` raises
    :class:`HostLostError` until ``restart()`` brings a fresh worker up.
    ``restarts`` counts recoveries.

    ``ctx`` picks the multiprocessing start method; None takes
    :func:`drill_start_method` (``"fork"`` until CUDA is initialized here,
    ``"forkserver"`` after).
    """

    def __init__(self, worker=None, *, ctx: str | None = None, latency_s: float = 0.0):
        self._worker = worker or _echo_worker
        self._ctx_name = ctx or drill_start_method()
        self._latency_s = latency_s
        self._lock = threading.Lock()
        self.restarts = 0
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context(self._ctx_name)
        if self._ctx_name == "forkserver":
            # Preloaded once in the server, so a forked worker unpickles its
            # target without importing anything.
            ctx.set_forkserver_preload(["__main__", __name__])
        parent_end, child_end = ctx.Pipe()
        self._proc = ctx.Process(
            target=self._worker,
            args=(child_end, self._latency_s),
            daemon=True,
        )
        self._proc.start()
        # Close the parent's copy of the child end: once the worker dies its
        # end is the LAST writer, so recv() raises EOFError instead of
        # blocking forever — the typed-loss path depends on this.
        child_end.close()
        self._conn = parent_end

    @property
    def pid(self) -> int:
        return self._proc.pid

    def alive(self) -> bool:
        return self._proc.is_alive()

    def call(self, payload, *, timeout_s: float = 30.0):
        """One round-trip through the worker; raises HostLostError when the
        worker is gone or unresponsive past ``timeout_s``."""
        with self._lock:
            try:
                self._conn.send(("req", payload))
                if not self._conn.poll(timeout_s):
                    raise HostLostError(
                        f"engine process pid={self._proc.pid} unresponsive "
                        f"after {timeout_s}s"
                    )
                kind, result = self._conn.recv()
            except (EOFError, BrokenPipeError, OSError) as e:
                raise HostLostError(
                    f"engine process pid={self._proc.pid} lost: "
                    f"{type(e).__name__}"
                ) from e
        if kind != "ok":
            raise HostLostError(f"engine process error: {result}")
        return result

    def kill(self) -> None:
        """SIGKILL the worker — no shutdown handshake, like a lost host."""
        if self._proc.is_alive():
            os.kill(self._proc.pid, signal.SIGKILL)
        self._proc.join(timeout=10.0)

    def restart(self) -> None:
        """Bring up a fresh worker (the resume half of the drill)."""
        try:
            self._conn.close()
        except OSError:
            pass
        if self._proc.is_alive():
            self.kill()
        self._start()
        self.restarts += 1

    def close(self) -> None:
        try:
            self._conn.send(("stop", None))
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout=5.0)
        if self._proc.is_alive():
            self.kill()
        try:
            self._conn.close()
        except OSError:
            pass


# -- scenario generator -------------------------------------------------------

SCENARIOS = (
    "burst",
    "skew",
    "slowloris",
    "hostloss",
    "swapstorm",
    # Fleet-tier drills (serve/fleet/scenarios.py wires the hooks): same
    # harness, same record contract, fleet fields merged in afterwards.
    "fleet-rolling-swap",
    "fleet-hostloss",
    "fleet-splitbrain",
)

# Scenarios that reuse the kill_fn/restart_fn slots (kill at 40% of the run,
# restart at 60%): for the fleet drills "kill" is replica kill -9 or a
# coordinator partition, and "restart" is restart+revive or heal.
_KILL_SCENARIOS = frozenset({
    "hostloss", "fleet-hostloss", "fleet-splitbrain",
})
# Scenarios that run the swap thread (swap_fn every 200ms).
_SWAP_SCENARIOS = frozenset({"swapstorm", "fleet-rolling-swap"})
# Scenarios with the square-wave (burst) load shape.
_BURST_SCENARIOS = frozenset({"burst", "fleet-rolling-swap"})

# Exception type names the harness counts as TYPED rejections: the contract
# is that every non-ok outcome is one of these (anything else is a silent
# drop — an outcome the client cannot act on). Matched by name so this
# module never imports service/batcher at module level.
_TYPED_REJECTIONS = frozenset({
    "ShedError",
    "QueueFullError",
    "BatcherClosedError",
    "ShutdownError",
    "RequestTimeoutError",
    "HostLostError",
    "NoReplicaError",
})


@dataclass
class _TenantTally:
    sent: int = 0
    ok: int = 0
    shed: int = 0
    typed_errors: int = 0
    silent_drops: int = 0


def _hog_and_victims(tenants):
    """The scenario's adversary is the lowest-priority tenant (ties: last
    declared); everyone else is a victim whose SLO must hold."""
    hog = min(tenants, key=lambda p: (p.priority, -tenants.index(p)))
    victims = [p for p in tenants if p is not hog] or [hog]
    return hog, victims


def run_scenario(
    scenario: str,
    *,
    submit,
    tenants,
    admission: AdmissionController | None,
    duration_s: float = 2.0,
    offered_load: float = 200.0,
    clients_per_tenant: int = 4,
    kill_fn=None,
    restart_fn=None,
    swap_fn=None,
    seed: int = 0,
) -> dict:
    """Drive one chaos scenario and return its degradation record.

    ``submit(tenant, i, items=1, fresh=False)`` performs ONE request end to
    end (admission included) and raises typed errors on rejection; ``i`` is
    a monotonically increasing per-client counter the harness varies so
    ``fresh=True`` traffic can be made cache-hostile by the caller.

    Scenario shapes (hog = lowest-priority tenant):

    - ``burst``    — square-wave load: 2.5x offered rate for half a second,
      near-idle the next; sheds must absorb the crest, not the trough.
    - ``skew``     — the hog sends 85% of the load, all cache-hostile
      (``fresh=True``): the memory-bandwidth-bound worst case.
    - ``slowloris``— the hog sends few, LARGE requests (items=16) that camp
      on in-flight quota; victims stay single-item and must stay in SLO.
    - ``hostloss`` — ``kill_fn()`` at 40% of the run, ``restart_fn()`` at
      60%; recovery_time_s = first post-kill success minus the kill time.
    - ``swapstorm``— ``swap_fn()`` every 200ms under full load.

    Every client obeys the rejection's ``retry_after_s`` guidance (capped),
    so the harness itself never retry-storms.
    """
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; pick from {SCENARIOS}")
    if scenario in _KILL_SCENARIOS and (kill_fn is None or restart_fn is None):
        raise ValueError(f"{scenario} scenario needs kill_fn and restart_fn")
    if scenario in _SWAP_SCENARIOS and swap_fn is None:
        raise ValueError(f"{scenario} scenario needs swap_fn")
    tenants = list(tenants)
    hog, _victims = _hog_and_victims(tenants)
    tallies = {p.name: _TenantTally() for p in tenants}
    windows = {p.name: LatencyWindow(8192) for p in tenants}
    overall_window = LatencyWindow(8192)
    tally_lock = threading.Lock()
    stop = threading.Event()
    t_start = time.monotonic()
    kill_at = {"t": None}
    first_ok_after_kill = {"t": None}

    # Per-tenant offered rate (requests/s across that tenant's clients).
    n = len(tenants)
    share = {p.name: offered_load / n for p in tenants}
    if scenario == "skew" and n > 1:
        share = {
            p.name: (
                offered_load * 0.85
                if p is hog
                else offered_load * 0.15 / (n - 1)
            )
            for p in tenants
        }
    if scenario == "slowloris":
        # Large requests: keep the hog's ITEM rate comparable while its
        # request rate drops 8x (items=16 below).
        share[hog.name] = share[hog.name] / 8.0

    def rate_mult(now_s: float) -> float:
        if scenario not in _BURST_SCENARIOS:
            return 1.0
        return 2.5 if (now_s % 1.0) < 0.5 else 0.1

    def client(policy: TenantPolicy, client_idx: int) -> None:
        rng_step = seed * 7919 + client_idx * 104729 + hash(policy.name) % 997
        i = client_idx
        tally = tallies[policy.name]
        window = windows[policy.name]
        items = 16 if (scenario == "slowloris" and policy is hog) else 1
        fresh = scenario == "skew" and policy is hog
        while not stop.is_set():
            now = time.monotonic() - t_start
            rate = share[policy.name] * rate_mult(now) / clients_per_tenant
            # Deterministically jittered interarrival around 1/rate.
            rng_step = (rng_step * 6364136223846793005 + 1442695040888963407) % (2**64)
            jitter = 0.5 + (rng_step >> 33) / (2**31)
            pause = jitter / max(rate, 1e-6)
            if stop.wait(min(pause, 0.25)):
                break
            i += clients_per_tenant
            t0 = time.monotonic()
            try:
                submit(policy.name, i, items=items, fresh=fresh)
            except ShedError as e:
                with tally_lock:
                    tally.sent += 1
                    tally.shed += 1
                # Obey the backoff guidance — the no-retry-storm contract.
                if e.retriable and e.retry_after_s > 0:
                    stop.wait(min(e.retry_after_s, 0.5))
                continue
            except Exception as e:  # noqa: BLE001 — classify the outcome
                typed = type(e).__name__ in _TYPED_REJECTIONS
                with tally_lock:
                    tally.sent += 1
                    if typed:
                        tally.typed_errors += 1
                    else:
                        tally.silent_drops += 1
                stop.wait(0.02)
                continue
            t_ok = time.monotonic()
            with tally_lock:
                tally.sent += 1
                tally.ok += 1
                if (
                    kill_at["t"] is not None
                    and first_ok_after_kill["t"] is None
                    and t_ok > kill_at["t"]
                ):
                    first_ok_after_kill["t"] = t_ok
            window.record(t_ok - t0)
            overall_window.record(t_ok - t0)

    threads = [
        threading.Thread(
            target=client, args=(p, c), daemon=True,
            name=f"siege-{p.name}-{c}",
        )
        for p in tenants
        for c in range(clients_per_tenant)
    ]
    for t in threads:
        t.start()

    swapper = None
    if scenario in _SWAP_SCENARIOS:
        def swap_loop():
            while not stop.wait(0.2):
                swap_fn()
        swapper = threading.Thread(target=swap_loop, daemon=True, name="siege-swap")
        swapper.start()

    deadline = t_start + duration_s
    killed = restarted = False
    while time.monotonic() < deadline:
        if scenario in _KILL_SCENARIOS:
            now = time.monotonic() - t_start
            if not killed and now >= 0.4 * duration_s:
                with tally_lock:
                    kill_at["t"] = time.monotonic()
                kill_fn()
                killed = True
            elif killed and not restarted and now >= 0.6 * duration_s:
                restart_fn()
                restarted = True
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=10.0)
    if swapper is not None:
        swapper.join(timeout=10.0)

    recovery_time_s = 0.0
    if kill_at["t"] is not None and first_ok_after_kill["t"] is not None:
        recovery_time_s = first_ok_after_kill["t"] - kill_at["t"]

    per_tenant = {}
    total_sent = total_shed = total_drops = 0
    for p in tenants:
        tally = tallies[p.name]
        pcts = windows[p.name].percentiles_ms((50, 99))
        total_sent += tally.sent
        total_shed += tally.shed
        total_drops += tally.silent_drops
        adm_row = (
            admission.stats()["per_tenant"].get(p.name, {})
            if admission is not None
            else {}
        )
        per_tenant[p.name] = {
            "sent": tally.sent,
            "ok": tally.ok,
            "shed": tally.shed,
            "shed_rate": round(tally.shed / tally.sent, 4) if tally.sent else 0.0,
            "typed_errors": tally.typed_errors,
            "silent_drops": tally.silent_drops,
            "p50_ms": pcts["p50_ms"],
            "p99_ms": pcts["p99_ms"],
            "slo_ms": p.slo_ms,
            "slo_violations": adm_row.get("slo_violations", 0),
        }
    overall_p99 = overall_window.percentiles_ms((99,))["p99_ms"]
    return {
        "metric": "serve_siege",
        "value": overall_p99,
        "unit": "ms",
        "scenario": scenario,
        "offered_load": offered_load,
        "duration_s": duration_s,
        "tenants": len(tenants),
        "shed_rate": round(total_shed / total_sent, 4) if total_sent else 0.0,
        "recovery_time_s": round(recovery_time_s, 4),
        "silent_drops": total_drops,
        "per_tenant": per_tenant,
    }


def hostloss_drill(
    *,
    tenants=None,
    duration_s: float = 2.0,
    offered_load: float = 120.0,
    capacity: int = 32,
    ctx: str | None = None,
    engine_latency_s: float = 0.002,
    seed: int = 0,
) -> dict:
    """Self-contained serving host-loss drill: admission → MicroBatcher →
    :class:`EngineProcess`, kill -9 mid-traffic, resume, and return the
    degradation record (used by tests and ``serve-bench --scenario
    hostloss``; the engine is the stdlib surrogate worker — the drill is
    about the serving stack's failure semantics, not the model forward).
    ``ctx``: the worker's start method, as :class:`EngineProcess`'s."""
    from distributed_sigmoid_loss_tpu_torch.serve.batcher import MicroBatcher

    tenants = list(tenants) if tenants else [
        TenantPolicy("gold", priority=2, max_inflight=16, slo_ms=500.0),
        TenantPolicy("free", priority=1, rate=offered_load, max_inflight=8),
    ]
    admission = AdmissionController(tenants, capacity=capacity)
    proc = EngineProcess(ctx=ctx, latency_s=engine_latency_s)
    batcher = MicroBatcher(
        lambda rows: proc.call(rows, timeout_s=5.0),
        max_batch_size=8,
        max_wait_ms=2.0,
        max_queue=max(capacity * 2, 64),
        name="siege-drill",
    )

    def submit(tenant, i, *, items=1, fresh=False):
        del fresh
        with admission.admit(tenant, items=items, deadline_s=5.0):
            batcher.submit(i).result(timeout=5.0)

    try:
        record = run_scenario(
            "hostloss",
            submit=submit,
            tenants=tenants,
            admission=admission,
            duration_s=duration_s,
            offered_load=offered_load,
            kill_fn=proc.kill,
            restart_fn=proc.restart,
            seed=seed,
        )
    finally:
        batcher.close()
        proc.close()
    record["restarts"] = proc.restarts
    return record
