"""The append-only run ledger (the port's copy of the JAX package's
``obs/ledger.py``).

``serve-bench`` and ``data-bench`` print one record each; each is also
appended as one JSON line to the ledger, carrying

- the schema-validated record itself, unmodified (the printed line is
  untouched),
- an environment fingerprint (torch version, the device's name and count,
  host, git sha), so any number can be tied to the program and the machine
  that produced it,
- an explicit ``status``: ``ok`` / ``no-backend`` / ``deferred`` / ``error``,
  so a dead backend lands as ``no-backend``, not as a 0.0 that looks like a
  measurement.

``obs ledger`` summarizes the per-metric trajectory (no-backend and error
entries excluded from the baseline statistics), ``obs diff A B`` diffs two
entries' records.

The port's ledger is ``build/ledger.jsonl`` at the root of the checkout (a
directory that is never committed), not the JAX package's ``LEDGER.jsonl``;
``DSL_LEDGER_PATH`` overrides it and the empty string disables appends. The
JAX package's backfill from its round files has no counterpart: those rounds
are a TPU's.

Standard library only: the fingerprint reads torch only if something else
already imported it, and the device only if CUDA is already initialized.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

__all__ = [
    "DEFAULT_LEDGER_PATH",
    "ledger_path",
    "environment_fingerprint",
    "record_status",
    "append_record",
    "read_ledger",
    "trajectory",
    "trajectory_summary",
    "diff_records",
]

LEDGER_SCHEMA_VERSION = 1

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PACKAGE_DIR)
DEFAULT_LEDGER_PATH = os.path.join(_REPO_ROOT, "build", "ledger.jsonl")

_FINGERPRINT_CACHE: dict = {}


def ledger_path(path: str | None = None) -> str | None:
    """Resolve the ledger file: an explicit ``path`` wins, then the
    ``DSL_LEDGER_PATH`` environment variable (the empty string disables
    appends), then :data:`DEFAULT_LEDGER_PATH`."""
    if path:
        return path
    env = os.environ.get("DSL_LEDGER_PATH")
    if env is not None:
        return env or None
    return DEFAULT_LEDGER_PATH


def _git_sha() -> str:
    if "git_sha" not in _FINGERPRINT_CACHE:
        sha = ""
        try:
            r = subprocess.run(
                ["git", "-C", _REPO_ROOT, "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5,
            )
            if r.returncode == 0:
                sha = r.stdout.strip()
        except Exception:
            pass
        _FINGERPRINT_CACHE["git_sha"] = sha
    return _FINGERPRINT_CACHE["git_sha"]


def environment_fingerprint() -> dict:
    """Who and what produced this entry: host, git sha, the torch version
    and, only when CUDA is already initialized, the device's name and count.

    Passive about torch: importing it here would pull a large runtime into a
    standard-library emit path, and initializing CUDA could hang on a dead
    device (the situation no-backend entries are recorded in). An
    already-imported torch with CUDA already initialized is read; anything
    else is left alone. A chip run adds the card's power limit.
    """
    env = {"host": socket.gethostname(), "git_sha": _git_sha()}
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        env["torch"] = getattr(torch_mod, "__version__", "?")
        try:
            cuda = torch_mod.cuda
            if cuda.is_initialized():
                env["device_kind"] = cuda.get_device_name(0)
                env["device_count"] = cuda.device_count()
                limit = _power_limit()
                if limit:
                    env["device_power_limit"] = limit
        except Exception:
            pass
    return env


def _power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` prints it ("" if it
    cannot be read): a card set below its maximum runs slower under load."""
    if "power_limit" not in _FINGERPRINT_CACHE:
        limit = ""
        try:
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=5,
            )
            if r.returncode == 0 and r.stdout.strip():
                limit = r.stdout.strip().splitlines()[0]
        except Exception:
            pass
        _FINGERPRINT_CACHE["power_limit"] = limit
    return _FINGERPRINT_CACHE["power_limit"]


def record_status(record: dict) -> str:
    """Classify one record for the trajectory: ``deferred`` (handed off to a
    detached child), ``no-backend`` (the device was dead: the 0.0 is an
    outage, not a measurement), ``error`` (the run itself failed), else
    ``ok``."""
    if record.get("deferred"):
        return "deferred"
    err = str(record.get("error") or "")
    if "backend unavailable" in err or "backend init" in err:
        return "no-backend"
    if err:
        return "error"
    return "ok"


def append_record(
    record: dict,
    *,
    path: str | None = None,
    source: str = "bench",
    round_hint: int | None = None,
    problems=None,
) -> dict | None:
    """Append one record to the ledger; returns the written entry (None when
    the ledger is disabled). Never raises: a measurement must not be lost to
    its own ledger; a failure warns on stderr.
    """
    try:
        target = ledger_path(path)
        if target is None:
            return None
        entry = {
            "schema": LEDGER_SCHEMA_VERSION,
            "ts": round(time.time(), 3),
            "source": source,
            "status": record_status(record),
            "env": environment_fingerprint(),
            "record": dict(record),
        }
        if round_hint is not None:
            entry["round"] = int(round_hint)
        if problems:
            entry["schema_violations"] = list(problems)
        line = json.dumps(entry)
        parent = os.path.dirname(os.path.abspath(target))
        os.makedirs(parent, exist_ok=True)
        # A writer killed mid-append leaves a torn final line with no
        # newline; appending straight after it would corrupt THIS entry too.
        # Start on a fresh line so one torn write costs one entry, not two.
        needs_newline = False
        try:
            with open(target, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                needs_newline = rf.read(1) != b"\n"
        except (OSError, ValueError):
            pass  # missing or empty file: no heal needed
        with open(target, "a", encoding="utf-8") as f:
            f.write(("\n" if needs_newline else "") + line + "\n")
        return entry
    except Exception as e:  # noqa: BLE001 — see docstring
        print(f"WARNING: ledger append failed ({type(e).__name__}: {e})",
              file=sys.stderr)
        return None


def read_ledger(path: str | None = None) -> list[dict]:
    """Parse the ledger into entries, tolerating torn lines (a process killed
    mid-append leaves a truncated final line — skipped, never fatal)."""
    target = ledger_path(path)
    if target is None or not os.path.exists(target):
        return []
    entries = []
    with open(target, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and isinstance(obj.get("record"), dict):
                entries.append(obj)
    return entries


def _records_in_tail(tail: str) -> list[dict]:
    """The JSON record lines (dicts carrying ``metric``) in a captured
    output ``tail`` (``obs diff`` takes such a file as an operand)."""
    out = []
    for line in tail.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metric" in obj:
            out.append(obj)
    return out


# Statuses the trajectory summary treats as non-measurements: they appear in
# the listing (outages are information) but never in the baseline stats.
_EXCLUDED_FROM_BASELINE = ("no-backend", "deferred", "error")


def trajectory(
    entries: list[dict], metric: str | None = None,
) -> dict[str, list[dict]]:
    """metric -> ordered points ``{round?, ts?, value, status, source,
    device_kind?}``; ``metric`` filters to one stream."""
    out: dict[str, list[dict]] = {}
    for e in entries:
        rec = e.get("record", {})
        name = rec.get("metric")
        if not name or (metric and name != metric):
            continue
        point = {
            "value": rec.get("value"),
            "unit": rec.get("unit"),
            "status": e.get("status", record_status(rec)),
            "source": e.get("source", "?"),
        }
        if e.get("round") is not None:
            point["round"] = e["round"]
        if e.get("ts") is not None:
            point["ts"] = e["ts"]
        kind = rec.get("device_kind") or e.get("env", {}).get("device_kind")
        if kind:
            point["device_kind"] = kind
        out.setdefault(name, []).append(point)
    if metric and not out:
        # Field fallback: some figures (wire_savings_wallclock_ratio,
        # dcn_measured_mbps, error_budget, ...) are fields of other streams'
        # records, not streams of their own. When no stream matches, build
        # one from every record carrying the named field; the unit column
        # names the host stream so the provenance stays visible.
        for e in entries:
            rec = e.get("record", {})
            if metric not in rec or rec.get("metric") == metric:
                continue
            point = {
                "value": rec.get(metric),
                "unit": f"on {rec.get('metric')}",
                "status": e.get("status", record_status(rec)),
                "source": e.get("source", "?"),
            }
            if e.get("round") is not None:
                point["round"] = e["round"]
            if e.get("ts") is not None:
                point["ts"] = e["ts"]
            kind = (
                rec.get("device_kind") or e.get("env", {}).get("device_kind")
            )
            if kind:
                point["device_kind"] = kind
            out.setdefault(metric, []).append(point)
    return out


def trajectory_summary(points: list[dict]) -> dict:
    """Baseline stats over ONE metric's points with non-measurements
    (no-backend / deferred / error) excluded: an outage must never drag the
    baseline to 0.0."""
    measured = [
        p for p in points
        if p["status"] not in _EXCLUDED_FROM_BASELINE
        and isinstance(p.get("value"), (int, float))
    ]
    excluded = len(points) - len(measured)
    if not measured:
        return {"n": 0, "excluded": excluded, "last": None, "best": None}
    values = [float(p["value"]) for p in measured]
    return {
        "n": len(measured),
        "excluded": excluded,
        "last": measured[-1],
        "best": max(values),
        "mean": sum(values) / len(values),
    }


def diff_records(a: dict, b: dict) -> dict:
    """Field-level diff of two records: ``added`` / ``removed`` field sets
    and ``changed`` with per-field (a, b) pairs plus a relative delta for
    numeric fields — what `obs diff` renders."""
    changed: dict = {}
    for k in sorted(set(a) & set(b)):
        va, vb = a[k], b[k]
        if va == vb:
            continue
        entry = {"a": va, "b": vb}
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)) and (
            not isinstance(va, bool) and not isinstance(vb, bool)
        ):
            entry["delta"] = vb - va
            if va:
                entry["rel"] = round((vb - va) / abs(va), 4)
        changed[k] = entry
    return {
        "added": sorted(set(b) - set(a)),
        "removed": sorted(set(a) - set(b)),
        "changed": changed,
    }
