"""Live telemetry: an OpenMetrics-style ``/metrics`` endpoint + atomic
telemetry files.

Post-hoc JSON records answer "what happened"; production serving
additionally needs PULL-based live state — a scraper hitting ``/metrics``
every few seconds without touching the metrics log. Two pieces:

- :func:`render_openmetrics` flattens the serving stack's ``stats()``
  snapshot (the declared ``SERVE_STATS_FIELDS`` schema) into Prometheus/
  OpenMetrics text: numeric scalars become gauges, percentile dicts become
  ``quantile``-labelled series, histograms become labelled counters, and
  string fields collect into one ``_info`` series. ``labels=`` stamps a
  constant label set onto EVERY series — the per-tenant scoping hook (one
  exporter per tenant, ``tenant="..."`` label, same schema).
- :class:`TelemetryExporter` serves that text from a stdlib HTTP server on a
  daemon thread, with bounded work under scrape storms: the rendered bytes
  are cached for ``refresh_s`` and concurrent scrapes inside the window are
  answered from the SAME cached buffer — no new snapshot, no re-render, no
  per-request allocation of the payload (pinned by test).

The port's copy of the JAX package's ``obs/telemetry.py`` (standard library
only), with a plain ``threading.Lock`` where JAX takes ``named_lock``. Its
``write_telemetry_file`` (the train loop's ``--obs-dir`` file) comes with
``--obs-dir`` (ROADMAP queue A item 6.5).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Mapping

__all__ = [
    "render_openmetrics",
    "TelemetryExporter",
]

_PERCENTILE_KEY = re.compile(r"p(\d+)_ms$")

# Intermediate-dict label names for the known nested stats shapes; anything
# else falls back to a generic "key" label (schema-complete beats pretty).
_NEST_LABEL = {
    "stage_latency_ms": "stage",
    "search_stage_latency_ms": "stage",
    "batch_size_hist": "modality",
    "cache": "field",
    # serve/admission.py AdmissionController.stats(): the nested per-tenant
    # rows flatten into tenant="..."-labelled series (the per-tenant hook).
    "per_tenant": "tenant",
    "admission": "field",
}


def _sanitize(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))


def _escape(value) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def _label_str(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_sanitize(k)}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _flatten(
    name: str, value, labels: dict, depth_label: str | None,
) -> Iterable[tuple[str, dict, float]]:
    """Yield (metric_name, labels, numeric_value) triples for one snapshot
    field. Percentile keys become a ``quantile`` label; other nested keys
    become the shape's registered label (or ``key``)."""
    if isinstance(value, bool):
        yield name, labels, 1.0 if value else 0.0
        return
    if isinstance(value, (int, float)):
        yield name, labels, float(value)
        return
    if isinstance(value, Mapping):
        for k, v in value.items():
            m = _PERCENTILE_KEY.fullmatch(str(k))
            if m is not None:
                yield from _flatten(
                    name, v, {**labels, "quantile": m.group(1)}, depth_label
                )
            else:
                lbl = depth_label or "key"
                # The child's own depth label comes from the registry too, so
                # a registered shape nested INSIDE another (admission stats'
                # per_tenant map) still gets its tenant="..." label instead
                # of a colliding generic "key".
                yield from _flatten(
                    name, v,
                    {**labels, lbl: str(k)},
                    _NEST_LABEL.get(str(k), "key"),
                )
    # strings/None are handled by the caller (info series); other types skip


def render_openmetrics(
    snapshot: Mapping,
    *,
    prefix: str = "dsl_serve",
    labels: Mapping[str, str] | None = None,
) -> str:
    """One stats snapshot -> Prometheus/OpenMetrics exposition text.

    Every snapshot key lands in the output: numeric (and nested-numeric)
    fields as ``{prefix}_{field}`` gauges, string fields as label values on
    the single ``{prefix}_info`` gauge — so a scrape is schema-complete by
    construction and a parser can recover the whole declared field set.
    """
    base = dict(labels or {})
    lines: list[str] = []
    info_labels: dict[str, str] = {}
    for key in snapshot:
        value = snapshot[key]
        if value is None:
            continue
        if isinstance(value, str):
            info_labels[_sanitize(key)] = value
            continue
        metric = f"{prefix}_{_sanitize(key)}"
        series = list(_flatten(metric, value, base, _NEST_LABEL.get(key)))
        # The TYPE line is emitted even for a field whose container is still
        # empty (e.g. no stage latencies recorded yet): a scrape stays
        # schema-complete — every declared field is discoverable — from the
        # very first request.
        lines.append(f"# TYPE {metric} gauge")
        for mname, mlabels, mval in series:
            out = f"{mval:.6f}".rstrip("0").rstrip(".") or "0"
            lines.append(f"{mname}{_label_str(mlabels)} {out}")
    info_name = f"{prefix}_info"
    lines.append(f"# TYPE {info_name} gauge")
    lines.append(f"{info_name}{_label_str({**base, **info_labels})} 1")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class TelemetryExporter:
    """Pull-based live metrics: GET ``/metrics`` (exposition text) and
    ``/healthz`` (JSON liveness) from a stdlib HTTP server thread.

    ``snapshot_fn`` is called at most once per ``refresh_s`` seconds no
    matter how many scrapers hit the endpoint; in between, requests are
    answered from the cached rendered bytes (one shared buffer — the
    bounded/allocation-free snapshot-reuse contract). ``port=0`` binds an
    ephemeral port; read it back from :attr:`port` after :meth:`start`.
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], Mapping],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        prefix: str = "dsl_serve",
        labels: Mapping[str, str] | None = None,
        refresh_s: float = 0.25,
        health_fn: Callable[[], Mapping] | None = None,
    ):
        self.snapshot_fn = snapshot_fn
        self.host = host
        self.prefix = prefix
        self.labels = dict(labels or {})
        self.refresh_s = float(refresh_s)
        # Optional richer /healthz: merged into the liveness payload, so a
        # serving stack can report status="degraded" (still HTTP 200 — the
        # process is up) while shedding or mid-swap. Without it the payload
        # stays the bare {"ok": true} liveness contract.
        self.health_fn = health_fn
        self._requested_port = port
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._cached: bytes = b""
        self._cached_at = 0.0
        self.scrapes = 0
        self.render_count = 0  # how many times snapshot_fn actually ran

    # -- payload -------------------------------------------------------------

    def payload(self) -> bytes:
        """The current ``/metrics`` body — cached across the refresh window."""
        now = time.monotonic()
        with self._lock:
            self.scrapes += 1
            if self._cached and now - self._cached_at < self.refresh_s:
                return self._cached
            # Render INSIDE the lock: a scrape storm collapses onto one
            # snapshot call instead of stampeding the service's stats lock.
            text = render_openmetrics(
                self.snapshot_fn(), prefix=self.prefix, labels=self.labels
            )
            self._cached = text.encode("utf-8")
            self._cached_at = time.monotonic()
            self.render_count += 1
            return self._cached

    # -- server --------------------------------------------------------------

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API name
                if self.path.split("?", 1)[0] == "/metrics":
                    body = exporter.payload()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?", 1)[0] == "/healthz":
                    health: dict = {"ok": True}
                    if exporter.health_fn is not None:
                        health.update(exporter.health_fn())
                    body = json.dumps(health).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dsl-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self.port

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
