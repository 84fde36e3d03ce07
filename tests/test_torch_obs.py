"""The port's host spans, health watchdog, flight recorder and telemetry file
(``distributed_sigmoid_loss_tpu_torch/obs/{spans,health,telemetry}.py``)
held to the JAX package's on the same inputs from a numpy seed, and the
flight recorder's dumps through the port's ``train_resilient`` on
divergence, SIGTERM and a crash."""

import json
import math
import os
import signal
import threading

import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.obs import health as jax_health
from distributed_sigmoid_loss_tpu.obs import spans as jax_spans
from distributed_sigmoid_loss_tpu_torch.obs import health, spans, telemetry
from distributed_sigmoid_loss_tpu_torch.train import (
    PreemptionGuard,
    TrainingDiverged,
    train_resilient,
)

NAMES = ("fetch", "step", "eval", "checkpoint", "h2d_commit")


def _records(seed: int, n: int = 40):
    """Seeded (name, t0, t1, tid) spans: start times, durations, names."""
    rng = np.random.default_rng(seed)
    t0 = np.cumsum(rng.random(n) * 0.01) + 100.0
    dur = rng.random(n) * 0.005
    names = rng.integers(0, len(NAMES), n)
    tids = rng.integers(0, 3, n) + 7
    return [(NAMES[k], float(a), float(a + d), int(t)) for k, a, d, t in
            zip(names, t0, dur, tids)]


def _recorders(capacity=8192):
    return spans.SpanRecorder(capacity), jax_spans.SpanRecorder(capacity)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_records_give_jaxs_chrome_trace_and_summary(seed):
    port, jax_rec = _recorders()
    for rec in (port, jax_rec):
        for name, a, b, tid in _records(seed):
            rec.record(name, a, b, tid=tid)
    assert port.chrome_trace("host") == jax_rec.chrome_trace("host")
    assert spans.summarize_spans(port.spans()) == jax_spans.summarize_spans(jax_rec.spans())
    device = [[{"ph": "X", "name": "k", "pid": 0, "tid": 1, "ts": 1.0, "dur": 2.0}]]
    assert spans.merge_chrome_traces(port.chrome_trace(), device) == \
        jax_spans.merge_chrome_traces(jax_rec.chrome_trace(), device)


def test_ring_stays_bounded_and_counts_drops_as_jax():
    port, jax_rec = _recorders(capacity=16)
    for rec in (port, jax_rec):
        for name, a, b, tid in _records(3, n=50):
            rec.record(name, a, b, tid=tid)
    assert len(port.spans()) == 16 and port.dropped == jax_rec.dropped == 34
    assert port.spans() == [spans.Span(*s) for s in (
        (x.name, x.t0, x.t1, x.tid) for x in jax_rec.spans())]


def test_disabled_recorder_hands_out_one_noop_and_records_nothing():
    rec = spans.SpanRecorder(enabled=False)
    a, b = rec.span("step"), rec.span("fetch")
    assert a is b  # one preallocated context manager: no allocation
    with a:
        pass
    rec.record("step", 0.0, 1.0)
    assert rec.spans() == []
    rec.enable()
    with rec.span("step"):
        pass
    assert [s.name for s in rec.spans()] == ["step"]


def test_spans_from_threads_land_on_their_own_tracks(tmp_path):
    rec = spans.SpanRecorder()

    def work():
        with rec.span("h2d_commit"):
            pass

    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    path = tmp_path / "host_spans.trace.json"
    rec.export(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert events[0]["args"]["name"] == "python-host"
    assert sum(1 for e in events if e["ph"] == "X") == 3
    assert all(e["pid"] == spans.HOST_PID for e in events)


def _metric_lines(seed: int):
    """Seeded metrics lines: normal, then a NaN, an Inf, a spike, normal."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(24):
        loss = float(2.0 + 0.1 * rng.standard_normal())
        line = {"loss": loss, "grad_norm": float(rng.random()), "t": 10.0,
                "controller_mode": "greedy"}
        if i == 12:
            line["grad_norm"] = float("nan")
        if i == 15:
            line["loss"] = float("inf")
        if i == 18:
            line["loss"] = 50.0
        lines.append(line)
    return lines


@pytest.mark.parametrize("policy,skip_on_spike", [("warn", False), ("skip", False),
                                                  ("skip", True)])
def test_watchdog_gives_jaxs_events(policy, skip_on_spike):
    port = health.HealthWatchdog(policy=policy, skip_on_spike=skip_on_spike)
    ref = jax_health.HealthWatchdog(policy=policy, skip_on_spike=skip_on_spike)
    got, want = [], []
    for step, line in enumerate(_metric_lines(0), start=1):
        evs, ref_evs = port.observe(step, line), ref.observe(step, line)
        got.append(([e.record() for e in evs], port.should_skip(evs)))
        want.append(([e.record() for e in ref_evs], ref.should_skip(ref_evs)))
    assert got == want
    kinds = [e.event for e in port.events]
    assert kinds == ["non_finite", "non_finite", "loss_spike"]


def test_watchdog_refuses_what_jax_refuses():
    for kw in ({"policy": "halt"}, {"spike_factor": 1.0}):
        with pytest.raises(ValueError):
            health.HealthWatchdog(**kw)
        with pytest.raises(ValueError):
            jax_health.HealthWatchdog(**kw)


def _without_wall_time(snapshot: dict) -> dict:
    rec = dict(snapshot["flight_recorder"])
    rec.pop("wall_time")
    return rec


def test_flight_recorder_snapshot_equals_jaxs(tmp_path):
    port, ref = health.FlightRecorder(capacity=8), jax_health.FlightRecorder(capacity=8)
    dog = health.HealthWatchdog()
    for step, line in enumerate(_metric_lines(1), start=1):
        for rec in (port, ref):
            rec.note_metrics(step, line)
        for ev in dog.observe(step, line):
            port.note_event(ev)
            ref.note_event(jax_health.HealthEvent(ev.step, ev.event, ev.detail,
                                                  ev.skippable))
    snap = port.dump("crash at step 24", path=str(tmp_path / "flight.json"))
    assert _without_wall_time(snap) == _without_wall_time(ref.snapshot("crash at step 24"))
    on_disk = json.loads((tmp_path / "flight.json").read_text())
    assert _without_wall_time(on_disk) == _without_wall_time(snap)
    assert len(snap["flight_recorder"]["metrics"]) == 8
    assert math.isnan(snap["flight_recorder"]["metrics"][0]["grad_norm"]) is False


def _toy_state():
    return {"w": torch.zeros(3)}


def _step(state, batch):
    state = {"w": state["w"] + batch}
    return state, {"loss": batch.sum()}


def _loop(tmp_path, batches, **kw):
    flight = health.FlightRecorder(path=str(tmp_path / "flight.json"))
    if "total_steps" not in kw:
        kw["total_steps"] = len(batches)
    try:
        train_resilient(_toy_state(), _step, batches, ckpt_dir=str(tmp_path / "ck"),
                        ckpt_every=100, flight=flight,
                        on_metrics=lambda s, m: flight.note_metrics(s, m), **kw)
    finally:
        record = (json.loads((tmp_path / "flight.json").read_text())["flight_recorder"]
                  if (tmp_path / "flight.json").exists() else None)
    return flight, record


def test_flight_dumps_on_divergence_through_train_resilient(tmp_path):
    batches = [torch.ones(3), torch.ones(3), torch.full((3,), float("nan"))]
    with pytest.raises(TrainingDiverged):
        _loop(tmp_path, batches)
    record = json.loads((tmp_path / "flight.json").read_text())["flight_recorder"]
    assert record["reason"] == "divergence: non-finite loss at step 2"
    assert [m["step"] for m in record["metrics"]] == [1, 2]


def test_flight_dumps_on_sigterm_through_train_resilient(tmp_path):
    def batches():
        for i in range(10):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield torch.ones(3)

    with PreemptionGuard() as guard:
        flight, record = _loop(tmp_path, batches(), total_steps=10, guard=guard)
    assert flight.dumps == 1
    assert record["reason"].startswith("preemption (SIGTERM) at step")


def test_flight_dumps_on_a_crash_through_train_resilient(tmp_path):
    def batches():
        yield torch.ones(3)
        raise OSError("shard vanished")

    with pytest.raises(OSError):
        _loop(tmp_path, batches(), total_steps=5)
    record = json.loads((tmp_path / "flight.json").read_text())["flight_recorder"]
    assert record["reason"] == "crash at step 1: OSError: shard vanished"
    assert [m["step"] for m in record["metrics"]] == [1]


def test_telemetry_file_is_replaced_atomically(tmp_path):
    path = tmp_path / "obs" / "telemetry.json"
    for step in (1, 2):
        telemetry.write_telemetry_file(str(path), {"step": step, "metrics": {"loss": 1.0}})
    assert json.loads(path.read_text())["step"] == 2
    assert sorted(os.listdir(path.parent)) == ["telemetry.json"]
