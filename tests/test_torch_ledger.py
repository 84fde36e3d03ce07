"""The port's run ledger (``distributed_sigmoid_loss_tpu_torch/obs/ledger.py``)
held to the JAX package's: the same entries give the same statuses,
trajectories, summaries and record diffs; appends and reads round-trip;
and the ledger lives under ``build/``, never in the JAX package's
``LEDGER.jsonl``."""

import json
import os

import numpy as np
import pytest

from distributed_sigmoid_loss_tpu.obs import ledger as jax_ledger
from distributed_sigmoid_loss_tpu_torch.obs import ledger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entries(seed: int, n: int = 30):
    """Seeded ledger entries over three metrics, with outages, deferrals,
    errors and records carrying the field-fallback figures."""
    rng = np.random.default_rng(seed)
    metrics = ("serve_qps", "data_pairs_per_s", "train_pairs_per_s")
    out = []
    for i in range(n):
        rec = {"metric": metrics[rng.integers(0, 3)], "value": float(rng.random() * 100),
               "unit": "items/s"}
        kind = rng.integers(0, 6)
        if kind == 0:
            rec["error"] = "backend unavailable (no CUDA)"
        elif kind == 1:
            rec["deferred"] = True
        elif kind == 2:
            rec["error"] = "worker died"
        if rng.random() < 0.3:
            rec["error_budget"] = float(rng.random())
        if rng.random() < 0.5:
            rec["device_kind"] = "NVIDIA H100 80GB HBM3"
        entry = {"schema": 1, "ts": 1000.0 + i, "source": "serve-bench",
                 "status": ledger.record_status(rec), "env": {"host": "h"}, "record": rec}
        if rng.random() < 0.3:
            entry["round"] = int(rng.integers(1, 9))
        out.append(entry)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statuses_trajectories_and_summaries_equal_jaxs(seed):
    entries = _entries(seed)
    assert [ledger.record_status(e["record"]) for e in entries] == \
        [jax_ledger.record_status(e["record"]) for e in entries]
    for metric in (None, "serve_qps", "error_budget", "missing"):
        got = ledger.trajectory(entries, metric=metric)
        assert got == jax_ledger.trajectory(entries, metric=metric)
        for points in got.values():
            assert ledger.trajectory_summary(points) == jax_ledger.trajectory_summary(points)


@pytest.mark.parametrize("seed", [0, 1])
def test_record_diffs_equal_jaxs(seed):
    entries = _entries(seed)
    for a, b in zip(entries, entries[1:]):
        assert ledger.diff_records(a["record"], b["record"]) == \
            jax_ledger.diff_records(a["record"], b["record"])


def test_append_and_read_round_trip_and_heal_a_torn_line(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    rec = {"metric": "serve_qps", "value": 12.5, "unit": "req/s"}
    entry = ledger.append_record(rec, path=path, source="serve-bench", problems=["x"])
    assert entry["status"] == "ok" and entry["schema_violations"] == ["x"]
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"torn": ')  # a writer killed mid-append
    ledger.append_record({**rec, "error": "backend unavailable"}, path=path)
    got = ledger.read_ledger(path)
    assert [e["status"] for e in got] == ["ok", "no-backend"]
    assert got == jax_ledger.read_ledger(path)


def test_default_ledger_is_under_build_and_the_env_overrides_it(monkeypatch, tmp_path):
    monkeypatch.delenv("DSL_LEDGER_PATH", raising=False)
    assert ledger.ledger_path() == os.path.join(REPO, "build", "ledger.jsonl")
    assert ledger.ledger_path() != jax_ledger.ledger_path()
    monkeypatch.setenv("DSL_LEDGER_PATH", "")
    assert ledger.ledger_path() is None
    assert ledger.append_record({"metric": "m", "value": 1.0}) is None
    monkeypatch.setenv("DSL_LEDGER_PATH", str(tmp_path / "l.jsonl"))
    assert ledger.append_record({"metric": "m", "value": 1.0}) is not None
    assert len(ledger.read_ledger()) == 1


def test_fingerprint_is_passive_about_the_device():
    import torch

    env = ledger.environment_fingerprint()
    assert env["torch"] == torch.__version__
    assert {"host", "git_sha"} <= set(env)
    # No device here: CUDA is never initialized by the fingerprint.
    assert "device_kind" not in env


def test_append_never_raises(tmp_path, capsys):
    target = tmp_path / "dir"
    target.mkdir()
    assert ledger.append_record({"metric": "m", "value": 1.0}, path=str(target)) is None
    assert "ledger append failed" in capsys.readouterr().err


def test_a_ledger_entry_is_one_json_line(tmp_path):
    path = tmp_path / "ledger.jsonl"
    ledger.append_record({"metric": "m", "value": 1.0}, path=str(path))
    line = path.read_text().splitlines()[0]
    assert set(json.loads(line)) == {"schema", "ts", "source", "status", "env", "record"}
