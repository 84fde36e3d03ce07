"""The port's admission control, chaos points, host-loss machinery and
scenario harness vs the JAX package's on the CPU.

- ``parse_tenant_spec`` field by field; ``AdmissionController`` and its
  ``ShedError`` guidance under one scripted sequence on a stepped fake clock
  (the same decisions, reasons, ``retry_after_s`` and stats as JAX's).
- The chaos gate: the registry's points, dead unless ``DSL_CHAOS=1`` and
  armed, typed through the batcher's futures and the engine's calls.
- ``EngineProcess`` kill/restart and ``hostloss_drill``; ``run_scenario``
  records with JAX's keys; the service's shed accounting, ``health()`` and
  ``/healthz``.
- ``serve-bench --scenario`` on the tiny model: each scenario exits 0 with
  the JAX command's record keys, valid under JAX's ``validate_record``.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from distributed_sigmoid_loss_tpu import cli as jax_cli
from distributed_sigmoid_loss_tpu.analysis.bench_schema import validate_record
from distributed_sigmoid_loss_tpu.serve import admission as jax_admission
from distributed_sigmoid_loss_tpu.serve import siege as jax_siege
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.serve import (
    AdmissionController,
    EmbeddingService,
    EngineProcess,
    HostLostError,
    InferenceEngine,
    MicroBatcher,
    RetrievalRouter,
    ShedError,
    TenantPolicy,
    admission,
    hostloss_drill,
    inject,
    maybe_inject,
    parse_tenant_spec,
    run_scenario,
    siege,
)


class FakeClock:
    """``time`` for a module under test: ``monotonic()`` returns a value the
    test steps."""

    def __init__(self, t: float = 1e9):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t


def record_keys(record: dict) -> dict:
    """A record's key structure: top-level keys in order, and the keys of the
    nested maps whose keys do not depend on the run's numbers."""
    out = {"": list(record)}
    for key in ("latency_ms", "cache", "swap_latency_ms", "admission"):
        if isinstance(record.get(key), dict):
            out[key] = sorted(record[key])
    for key in ("stage_latency_ms",):
        if isinstance(record.get(key), dict):
            out[key] = {k: sorted(v) for k, v in record[key].items()}
    for rows in (record.get("per_tenant"), (record.get("admission") or {}).get("per_tenant")):
        if isinstance(rows, dict):
            out.setdefault("per_tenant", []).append({k: list(v) for k, v in rows.items()})
    return out


# ---------------------------------------------------------------------------
# Tenant grammar and the admission controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "gold:prio=2,quota=24,slo=500;free:prio=1,rate=80,quota=8",
    "a:priority=3,rate=2.5,burst=4 ; b: ; c:slo=12.5,quota=0",
    "solo",
])
def test_parse_tenant_spec_equal_to_jax(spec):
    got, want = parse_tenant_spec(spec), jax_admission.parse_tenant_spec(spec)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("name", "priority", "rate", "burst", "max_inflight", "slo_ms"):
            assert getattr(g, field) == getattr(w, field), (spec, field)
        assert g.bucket_depth() == w.bucket_depth()


@pytest.mark.parametrize("spec", ["", ";", ":prio=1", "a:prio", "a:rate=x", "a:color=3"])
def test_parse_tenant_spec_errors_equal_to_jax(spec):
    with pytest.raises(ValueError) as port:
        parse_tenant_spec(spec)
    with pytest.raises(ValueError) as ref:
        jax_admission.parse_tenant_spec(spec)
    assert str(port.value) == str(ref.value)


def _scripted_admission(mod, clock):
    """One scripted sequence of admits, releases and clock steps through
    ``mod``'s controller; returns every outcome, the stats and the shed
    rates."""
    policies = [
        mod.TenantPolicy("gold", priority=2, max_inflight=3, slo_ms=100.0),
        mod.TenantPolicy("free", priority=1, rate=4.0, burst=2, max_inflight=2),
        mod.TenantPolicy("bulk", priority=0, rate=10.0),
    ]
    ctl = mod.AdmissionController(policies, capacity=4, shed_window_s=2.0,
                                  default_policy=mod.TenantPolicy("default", priority=1,
                                                                  max_inflight=1))
    tickets, outcomes = [], []
    script = [
        ("admit", "gold", 1, None), ("admit", "gold", 2, None), ("admit", "gold", 1, 10.0),
        ("step", 0.05), ("release", 0, True), ("admit", "free", 1, None),
        ("admit", "free", 1, None), ("admit", "free", 1, None), ("admit", "free", 1, 0.01),
        ("step", 0.3), ("admit", "free", 1, None), ("admit", "bulk", 1, None),
        ("admit", "bulk", 1, None), ("admit", "stranger", 1, None), ("admit", None, 1, None),
        ("admit", "stranger", 1, None), ("step", 0.2), ("release", 1, True),
        ("release", 2, False), ("admit", "gold", 3, None), ("admit", "gold", 1, None),
        ("step", 1.0), ("release", 3, True), ("release", 4, True), ("release", 5, True),
        ("admit", "free", 2, None), ("admit", "free", 2, None), ("admit", "free", 2, None),
        ("step", 3.0), ("admit", "bulk", 1, None),
    ]
    for op in script:
        if op[0] == "step":
            clock.t += op[1]
        elif op[0] == "release":
            if op[1] < len(tickets):
                tickets[op[1]].release(ok=op[2])
                tickets[op[1]].release(ok=op[2])  # idempotent
        else:
            _, tenant, items, deadline = op
            try:
                tickets.append(ctl.admit(tenant, items=items, deadline_s=deadline))
                outcomes.append(("ok", tenant, items))
            except mod.ShedError as e:
                outcomes.append(("shed", e.tenant, e.reason, e.retry_after_s, e.retriable,
                                 str(e)))
        outcomes.append(("rate", ctl.recent_shed_rate()))
    return outcomes, ctl.stats()


def test_admission_decisions_and_retry_guidance_equal_to_jax(monkeypatch):
    clocks = {}
    for mod in (admission, jax_admission):
        clocks[mod] = FakeClock()
        monkeypatch.setattr(mod, "time", clocks[mod])
    port = _scripted_admission(admission, clocks[admission])
    ref = _scripted_admission(jax_admission, clocks[jax_admission])
    assert port == ref
    outcomes, stats = port
    reasons = {o[2] for o in outcomes if o[0] == "shed"}
    assert reasons == {"rate", "quota", "overload"}  # the script reaches every check
    assert any(o[0] == "shed" and not o[4] for o in outcomes)  # a hopeless deadline
    assert stats["per_tenant"]["gold"]["slo_violations"] >= 1


def test_backoff_doubles_with_consecutive_sheds_and_caps():
    ctl = AdmissionController([TenantPolicy("t", rate=1.0, burst=1)], capacity=8)
    ctl.admit("t").release()
    waits = []
    for _ in range(12):
        with pytest.raises(ShedError) as ei:
            ctl.admit("t")
        waits.append(ei.value.retry_after_s)
    assert waits[1] > waits[0] and waits[-1] <= admission._BACKOFF_CAP_S * 1.25
    with pytest.raises(ValueError, match="capacity"):
        AdmissionController(capacity=0)


# ---------------------------------------------------------------------------
# The chaos gate
# ---------------------------------------------------------------------------


def test_chaos_registry_and_gate(monkeypatch):
    assert list(siege.CHAOS_POINTS) == list(jax_siege.CHAOS_POINTS)
    assert all(siege.CHAOS_POINTS.values())
    assert siege.SCENARIOS == jax_siege.SCENARIOS
    with pytest.raises(KeyError, match="registered"):
        maybe_inject("engine.warp_core")
    with pytest.raises(KeyError, match="unregistered"):
        siege.install_fault("engine.warp_core")
    monkeypatch.delenv("DSL_CHAOS", raising=False)
    with inject("engine.exception", exception=RuntimeError("boom")):
        maybe_inject("engine.exception")  # armed, gate down: dead
    monkeypatch.setenv("DSL_CHAOS", "1")
    assert siege.chaos_enabled()
    with inject("engine.exception", exception=RuntimeError("boom"), count=2) as plan:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="boom"):
                maybe_inject("engine.exception")
        maybe_inject("engine.exception")  # spent
        assert plan.fired == 2
    maybe_inject("engine.exception")  # disarmed on exit
    siege.install_fault("batcher.stall", delay_s=0.01)
    siege.clear_faults()
    maybe_inject("batcher.stall")


def _toy_engine():
    return InferenceEngine(
        lambda p, x: x.reshape(len(x), -1)[:, :4].float(),
        lambda p, x: x[:, :4].float(),
        {}, batch_buckets=(1, 4), text_len_buckets=(4,), image_shape=(2, 2, 3), device="cpu")


def test_batcher_and_engine_chaos_points_fail_typed(monkeypatch):
    monkeypatch.setenv("DSL_CHAOS", "1")
    engine = _toy_engine()
    with inject("engine.exception", exception=RuntimeError("device fault"), count=1):
        with pytest.raises(RuntimeError, match="device fault"):
            engine.encode_text(np.ones((2, 4), np.int32))
        np.testing.assert_array_equal(engine.encode_text(np.ones((2, 4), np.int32)),
                                      np.ones((2, 4), np.float32))
    with inject("engine.latency", delay_s=0.05, count=1):
        t0 = time.monotonic()
        engine.encode_image(np.zeros((1, 2, 2, 3), np.float32))
        assert time.monotonic() - t0 >= 0.05
    with MicroBatcher(lambda items: [i * 2 for i in items], max_batch_size=4,
                      max_wait_ms=1.0) as mb:
        with inject("batcher.stall", exception=RuntimeError("wedged"), count=1):
            first = mb.submit(1)
            with pytest.raises(RuntimeError, match="wedged"):
                first.result(timeout=10)
            assert mb.submit(3).result(timeout=10) == 6  # the worker keeps serving


# ---------------------------------------------------------------------------
# Host loss and the scenario harness
# ---------------------------------------------------------------------------


def test_engine_process_kill_is_typed_and_restart_recovers():
    assert siege.drill_start_method() == "fork"  # no CUDA context in this process
    proc = EngineProcess(latency_s=0.0)
    try:
        assert proc.call({"x": 1}) == {"x": 1}
        proc.kill()
        assert not proc.alive()
        with pytest.raises(HostLostError):
            proc.call(2, timeout_s=2.0)
        proc.restart()
        assert proc.restarts == 1 and proc.call(3) == 3
    finally:
        proc.close()


def test_hostloss_drill_recovers_with_zero_silent_drops():
    record = hostloss_drill(duration_s=1.5, offered_load=80.0, capacity=24, seed=3)
    assert record["silent_drops"] == 0 and record["restarts"] == 1
    assert record["recovery_time_s"] > 0
    # The dead window surfaced as typed HostLostError, not as hangs.
    assert sum(r["typed_errors"] for r in record["per_tenant"].values()) > 0
    assert validate_record(record) == []


def _stub_rig(mod):
    tenants = [mod.TenantPolicy("gold", priority=2, max_inflight=8, slo_ms=200.0),
               mod.TenantPolicy("free", priority=1, rate=30.0, max_inflight=4)]
    ctl = mod.AdmissionController(tenants, capacity=8)

    def submit(tenant, i, *, items=1, fresh=False):
        with ctl.admit(tenant, items=items, deadline_s=5.0):
            time.sleep(0.002)

    return tenants, ctl, submit


@pytest.mark.parametrize("scenario", ["burst", "skew", "slowloris", "swapstorm", "hostloss"])
def test_run_scenario_records_match_jax_keys(scenario):
    records, swaps = [], []
    for mod, harness in ((siege, run_scenario), (jax_siege, jax_siege.run_scenario)):
        tenants, ctl, submit = _stub_rig(
            admission if mod is siege else jax_admission)
        kw = {}
        if scenario == "swapstorm":
            kw["swap_fn"] = lambda mod=mod: swaps.append(mod)
        if scenario == "hostloss":
            kw.update(kill_fn=lambda: None, restart_fn=lambda: None)
        records.append(harness(scenario, submit=submit, tenants=tenants, admission=ctl,
                               duration_s=0.5, offered_load=120.0, seed=3, **kw))
    port, ref = records
    assert record_keys(port) == record_keys(ref)
    assert port["scenario"] == scenario and port["silent_drops"] == 0
    assert validate_record(port) == []
    assert all(row["sent"] > 0 for row in port["per_tenant"].values())
    if scenario == "swapstorm":
        assert swaps.count(siege) >= 1  # a swap every 200 ms of the 0.5 s
    with pytest.raises(ValueError, match="needs"):
        run_scenario("hostloss", submit=lambda *a, **k: None, tenants=[TenantPolicy("a")],
                     admission=None)


# ---------------------------------------------------------------------------
# The service's admission hook, health and /healthz
# ---------------------------------------------------------------------------


def _tenant_service(**kw):
    ctl = AdmissionController([TenantPolicy("gold", priority=2, max_inflight=16, slo_ms=500.0),
                               TenantPolicy("free", priority=1, rate=5.0, burst=1)],
                              capacity=16)
    return EmbeddingService(_toy_engine(), cache=None, admission=ctl, max_wait_ms=1.0,
                            default_timeout=10.0, **kw)


def test_service_sheds_typed_and_reports_degraded_health():
    from distributed_sigmoid_loss_tpu_torch.obs.metrics_schema import (
        SERVE_STATS_FIELDS,
        validate_metrics,
    )

    with _tenant_service() as svc:
        assert svc.health() == {"status": "ok", "shed_rate": 0.0, "swap_in_flight": False,
                                "reasons": []}
        row = np.arange(4, dtype=np.int32)
        svc.encode_text(row, tenant="free")  # burst 1 admits once
        with pytest.raises(ShedError) as ei:
            svc.encode_text(row, tenant="free")
        assert ei.value.reason == "rate"
        svc.encode_text(row, tenant="gold")
        with pytest.raises(ShedError):
            svc.search(np.ones((1, 4), np.float32), k=1, tenant="free")
        snap = svc.stats()
        assert snap["shed"] == 2 and snap["rejected"] == 0 and snap["shed_rate"] > 0
        assert snap["admission"]["per_tenant"]["free"]["shed"] == 2
        assert validate_metrics({"metric": "serve_stats", **snap}, SERVE_STATS_FIELDS) == []
        health = svc.health()
        assert health["status"] == "degraded" and health["reasons"] == ["shedding"]
        exporter = svc.start_metrics_server(port=0)
        base = f"http://{exporter.host}:{exporter.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["status"] == "degraded"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert 'tenant="free"' in text and 'tenant="gold"' in text


def test_search_on_embeddings_through_router_with_tenant():
    router = RetrievalRouter()
    router.publish(np.eye(4, dtype=np.float32))
    with _tenant_service(index=router) as svc:
        scores, ids, version = svc.search(np.eye(4, dtype=np.float32)[2:3], k=2,
                                          tenant="gold", return_version=True)
        assert ids[0][0] == 2 and version == 1
        router.begin_swap()
        assert svc.health()["reasons"] == ["swap_in_flight"]
        router.end_swap()
        assert svc.health()["status"] == "ok"


def test_batcher_close_drains_under_concurrent_clients():
    gate = threading.Event()

    def slow(items):
        gate.wait(timeout=5)
        return items

    mb = MicroBatcher(slow, max_batch_size=2, max_wait_ms=1.0, max_queue=64)
    futures = [mb.submit(i) for i in range(10)]
    closer = threading.Thread(target=mb.close)
    closer.start()
    gate.set()
    closer.join(timeout=30)
    outcomes = []
    for f in futures:
        try:
            outcomes.append(("ok", f.result(timeout=10)))
        except Exception as e:  # noqa: BLE001 — every outcome must be typed
            outcomes.append((type(e).__name__, None))
    assert len(outcomes) == 10
    assert {kind for kind, _ in outcomes} <= {"ok", "ShutdownError", "BatcherClosedError"}


# ---------------------------------------------------------------------------
# serve-bench --scenario against the JAX command
# ---------------------------------------------------------------------------

SCENARIO_ARGS = ["serve-bench", "--requests", "32", "--clients", "2", "--pool", "16",
                 "--index-size", "16", "--batch-buckets", "1,4,8", "--duration-s", "0.8",
                 "--offered-load", "80", "--seed", "2"]


@pytest.mark.parametrize("scenario", ["burst", "skew", "slowloris", "swapstorm", "hostloss"])
def test_cli_scenario_record_keys_equal_jax(scenario, capsys):
    argv = SCENARIO_ARGS + ["--scenario", scenario]
    assert cli.main(argv + ["--cpu-devices", "1"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record_keys(port) == record_keys(ref)
    assert validate_record(port) == []
    assert port["metric"] == "serve_siege" and port["scenario"] == scenario
    assert port["silent_drops"] == 0
    if scenario != "hostloss":
        assert port["compile_count"] == port["bucket_space"] == 6
    if scenario == "swapstorm":
        assert port["swap_count"] >= 2 and not port["swap_in_flight"]
