"""The observability surface of the port's command line on the CPU
(``--cpu-devices 1``), in process, beside the JAX package's CLI:

- ``train --obs-dir D --watchdog warn`` writes ``D/host_spans.trace.json``
  with the span names JAX's run writes, and ``D/telemetry.json``; every
  step line carries ``mfu_est`` in (0, 1] and ``comm_bytes_total`` 0 (one
  process); a non-finite step emits JAX's ``health_event`` line.
- ``obs summarize|ledger|diff`` read those files and the run ledger;
  ``serve-bench`` and ``data-bench`` append their records to the ledger.
"""

import contextlib
import io
import json
import os

import pytest

from distributed_sigmoid_loss_tpu import cli as jax_cli
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.obs import ledger

TRAIN = ["train", "--tiny", "--batch", "8", "--steps", "4", "--eval-every", "2",
         "--ckpt-every", "2", "--watchdog", "warn"]


def run(main, argv):
    """``main(argv)`` in process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def span_names(obs_dir):
    with open(os.path.join(obs_dir, "host_spans.trace.json"), encoding="utf-8") as f:
        return {e["name"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's and the JAX CLI's train runs under --obs-dir."""
    root = tmp_path_factory.mktemp("obs_cli")
    dirs = {k: str(root / k) for k in ("port", "jax", "port_ck", "jax_ck")}
    port = run(cli.main, [*TRAIN, "--cpu-devices", "1", "--obs-dir", dirs["port"],
                          "--ckpt-dir", dirs["port_ck"]])
    ref = run(jax_cli.main, [*TRAIN, "--obs-dir", dirs["jax"], "--ckpt-dir", dirs["jax_ck"]])
    assert port[0] == 0, port[2]
    assert ref[0] == 0, ref[2]
    return {"port": port, "jax": ref, "dirs": dirs, "root": root}


def test_obs_dir_holds_jaxs_host_spans_and_the_telemetry_file(runs):
    port, ref = runs["dirs"]["port"], runs["dirs"]["jax"]
    assert span_names(port) == span_names(ref) == {
        "fetch", "h2d_commit", "step", "eval", "checkpoint"}
    with open(os.path.join(port, "telemetry.json"), encoding="utf-8") as f:
        tele = json.load(f)
    assert tele["step"] == 4 and tele["env"]["torch"]
    assert set(tele["metrics"]) >= {"loss", "mfu_est", "comm_bytes_total"}
    assert "obs: host spans ->" in runs["port"][2]


def test_every_step_line_carries_the_attribution_fields(runs):
    lines = [json.loads(x) for x in runs["port"][1].splitlines() if x.startswith("{")]
    steps = [x for x in lines if "loss" in x]
    assert [x["step"] for x in steps] == [1, 2, 3, 4]
    assert all(0.0 < x["mfu_est"] <= 1.0 and x["comm_bytes_total"] == 0.0 for x in steps)
    ref = [json.loads(x) for x in runs["jax"][1].splitlines() if x.startswith("{")]
    assert [set(x) for x in steps] == [set(x) for x in ref if "loss" in x]
    assert "obs attribution: comm_bytes_total=0.0 mfu_est=" in runs["port"][2]


def test_a_non_finite_step_emits_jaxs_health_event():
    """A learning rate that overflows the weights: the watchdog's lines are
    the ones JAX's watchdog gives for the same metrics lines."""
    from distributed_sigmoid_loss_tpu.obs.health import HealthWatchdog

    rc, out, err = run(cli.main, ["train", "--tiny", "--cpu-devices", "1", "--batch", "8",
                                  "--steps", "3", "--lr", "1e38", "--watchdog", "warn"])
    assert rc == 0, err
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    events = [x for x in lines if x.get("metric") == "health_event"]
    dog = HealthWatchdog(policy="warn")
    want = [e.record() for x in lines if "loss" in x
            for e in dog.observe(x["step"], {k: v for k, v in x.items()
                                             if k not in ("step", "steps_per_sec")})]
    assert events and [e["event"] for e in events] == [e["event"] for e in want]
    assert all(set(e) == {"metric", "step", "event", "detail"} for e in events)


def test_obs_summarize_and_the_merged_trace(runs, tmp_path):
    merged = tmp_path / "merged.json"
    rc, out, err = run(cli.main, ["obs", "summarize", runs["dirs"]["port"],
                                  "--merged-out", str(merged)])
    assert rc == 0, err
    assert "== host spans" in out and "  step " in out and "  checkpoint " in out
    events = json.loads(merged.read_text())["traceEvents"]
    assert {e["name"] for e in events if e["ph"] == "X"} == span_names(runs["dirs"]["port"])
    rc, _, err = run(cli.main, ["obs", "summarize", str(tmp_path / "nothing")])
    assert rc == 2 and "no host_spans.trace.json" in err


def test_obs_diff_of_two_run_dirs(runs):
    rc, out, err = run(cli.main, ["obs", "diff", runs["dirs"]["port"], runs["dirs"]["jax"]])
    assert rc == 0, err
    assert "== span summary diff" in out and "h2d_commit" in out
    rc, _, err = run(cli.main, ["obs", "diff", runs["dirs"]["port"]])
    assert rc == 2 and "exactly two operands" in err


def test_serve_and_data_bench_append_to_the_ledger_and_obs_reads_it(tmp_path, monkeypatch):
    path = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("DSL_LEDGER_PATH", path)
    rc, out, err = run(cli.main, ["serve-bench", "--cpu-devices", "1", "--model", "tiny"])
    assert rc == 0, err
    rc, out, err = run(cli.main, ["data-bench", "--cpu-devices", "1", "--model", "tiny"])
    assert rc == 0, err
    entries = ledger.read_ledger(path)
    sources = [e["source"] for e in entries]
    assert sources[0] == "serve-bench" and set(sources[1:]) == {"data-bench"}
    assert all(e["status"] == "ok" and e["env"]["torch"] for e in entries)
    metric = entries[0]["record"]["metric"]
    rc, out, err = run(cli.main, ["obs", "ledger", "--metric", metric])
    assert rc == 0, err
    assert f"== {metric} (1 entr(y/ies))" in out and "serve-bench" in out
    data_metric = entries[1]["record"]["metric"]
    rc, out, err = run(cli.main, ["obs", "diff", f"{data_metric}@0", "--ledger", path,
                                  f"{data_metric}@-1"])
    assert rc == 0, err
    assert "== record diff" in out
    rc, _, err = run(cli.main, ["obs", "ledger", "--metric", "no_such_metric"])
    assert rc == 2 and "no entries" in err
    monkeypatch.setenv("DSL_LEDGER_PATH", str(tmp_path / "empty.jsonl"))
    rc, _, err = run(cli.main, ["obs", "ledger"])
    assert rc == 2 and "is empty" in err
