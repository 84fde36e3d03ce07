"""EmbeddingService — the serving front end tying engine, batcher, cache and
index together — and RetrievalRouter, the tiered, versioned index behind it.

One request flows: (optional) admission → content hash → cache probe → (on
miss) micro-batcher → bucketed engine → cache fill → caller, with the whole
round trip bounded by a per-request timeout. Text and image traffic get
separate batchers, so one modality's burst never stalls the other's
deadline.

``stats()`` is the operational contract: qps, latency percentiles,
per-modality batch-size histograms, cache hit rate, engine compile count vs
bucket space, the backpressure/timeout/shed counters, and, with a
:class:`RetrievalRouter` as the index, its tier/version/swap/recall fields:
one JSON record whose fields are all registered in
``obs/metrics_schema.SERVE_STATS_FIELDS`` (the ``serve-bench`` command
prints this snapshot). ``health()`` is the ``/healthz`` payload, and
``start_metrics_server`` mounts the live ``/metrics`` endpoint.

The port of the JAX package's ``serve/service.py``: its locks are named
(``obs/lockwatch.py``) and its host spans (``spans=``, ``obs/spans.py``)
carry JAX's names.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass
from typing import Callable

import numpy as np

from distributed_sigmoid_loss_tpu_torch.eval.retrieval import merge_topk
from distributed_sigmoid_loss_tpu_torch.serve.admission import AdmissionController, ShedError
from distributed_sigmoid_loss_tpu_torch.serve.ann import AnnIndex
from distributed_sigmoid_loss_tpu_torch.serve.batcher import MicroBatcher, QueueFullError
from distributed_sigmoid_loss_tpu_torch.serve.cache import EmbeddingCache, content_key
from distributed_sigmoid_loss_tpu_torch.serve.engine import InferenceEngine
from distributed_sigmoid_loss_tpu_torch.serve.index import RetrievalIndex
from distributed_sigmoid_loss_tpu_torch.serve.shard_index import ShardedIndex
from distributed_sigmoid_loss_tpu_torch.utils.logging import LatencyWindow, MetricsLogger
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = ["EmbeddingService", "RequestTimeoutError", "RetrievalRouter"]


class RequestTimeoutError(TimeoutError):
    """The request's deadline passed before its batch finished encoding."""


@dataclass(frozen=True)
class _IndexVersion:
    """One immutable published generation of index segments. A search reads
    the CURRENT version once and keeps it for its whole lifetime — a swap
    mid-search can never hand it a torn mix of old and new segments."""

    version: int
    exact: RetrievalIndex
    sharded: ShardedIndex | None
    ann: AnnIndex | None
    size: int


class RetrievalRouter:
    """Versioned, tiered retrieval front end: ``exact`` / ``sharded`` / ``ann``.

    Drop-in for ``EmbeddingService``'s ``index=`` slot (same ``search`` /
    ``__len__`` surface) with three additions the plain index cannot offer:

    - **tier routing** — ``exact`` is the single-host chunked oracle scan,
      ``sharded`` fans per-shard top-k over ``devices`` and merges the
      gathered candidates (``serve/shard_index.py``), ``ann`` prunes with
      quantized coarse scores then re-ranks exactly (``serve/ann.py``);
    - **versioned publication** — ``publish`` builds fresh index segments
      double-buffered (the old version keeps serving during the build) and
      swaps one reference atomically; every response can report the version
      it was served from (``return_version=True``), which is monotonically
      non-decreasing across a client's requests;
    - **measured recall** — on the ann tier every ``measure_every``-th
      search is ALSO answered by the exact oracle and the id overlap feeds
      the running ``recall_at_k`` in :meth:`stats` (exact/sharded report
      1.0 by construction — they are ranking-identical to the oracle).

    Per-stage latencies (fan-out / merge / coarse / re-rank / exact scan)
    land in :meth:`stats` and, when ``spans`` is wired, on the host timeline
    as ``serve/search/<stage>`` spans.
    """

    TIERS = ("exact", "sharded", "ann")
    STAGES = ("exact", "fanout", "merge", "coarse", "rerank")

    def __init__(
        self,
        *,
        tier: str = "exact",
        devices=None,
        coarse: str = "int8",
        rerank_k: int | None = None,
        measure_every: int = 16,
        chunk_size: int = 4096,
        query_buckets=(1, 8, 64),
        spans=None,
    ):
        if tier not in self.TIERS:
            raise ValueError(f"tier must be one of {self.TIERS}, got {tier!r}")
        if tier == "sharded" and not devices:
            raise ValueError(
                "tier='sharded' needs devices= (one per shard, the devices "
                "the corpus partitions over), e.g. [torch.device('cuda')]"
            )
        self.tier = tier
        self.devices = tuple(devices) if devices else ()
        self.coarse = coarse
        self.rerank_k = rerank_k if rerank_k else None
        self.measure_every = max(int(measure_every), 0)
        self.chunk_size = chunk_size
        self.query_buckets = tuple(query_buckets)
        self.spans = spans
        self._current: _IndexVersion | None = None
        self._publish_lock = named_lock("serve.service.RetrievalRouter._publish_lock")
        self._versions = 0
        self._stats_lock = named_lock("serve.service.RetrievalRouter._stats_lock")
        self._swap_count = 0
        self._swaps_in_flight = 0
        self._swap_window = LatencyWindow(1024)
        self._stage_windows = {s: LatencyWindow(4096) for s in self.STAGES}
        self._searches = 0
        self._recall_sum = 0.0
        self._recall_n = 0
        self._last_rerank_k = 0

    # -- publication ---------------------------------------------------------

    def build(self, embeddings, ids=None) -> dict:
        """Build fresh index segments for a corpus WITHOUT publishing them —
        the double-buffer half: runs outside any lock while the current
        version keeps serving. Feed the result to :meth:`publish_built`."""
        emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        exact = RetrievalIndex(chunk_size=self.chunk_size)
        exact.add(emb, ids)
        sharded = ann = None
        if self.tier == "sharded":
            sharded = ShardedIndex(
                emb, ids, devices=self.devices, query_buckets=self.query_buckets,
            )
        elif self.tier == "ann":
            ann = AnnIndex(emb, ids, coarse=self.coarse, rerank_k=self.rerank_k)
        return {"exact": exact, "sharded": sharded, "ann": ann, "size": len(emb)}

    def publish_built(self, built: dict | None) -> int:
        """Atomically publish segments from :meth:`build` (None re-publishes
        the current segments under a new version — a params-only swap).
        Returns the new version number; in-flight searches finish on the
        version they started with."""
        with self._publish_lock:
            if built is None:
                cur = self._current
                if cur is None:
                    raise ValueError("publish_built(None) before any publish()")
                built = {
                    "exact": cur.exact, "sharded": cur.sharded,
                    "ann": cur.ann, "size": cur.size,
                }
            self._versions += 1
            self._current = _IndexVersion(version=self._versions, **built)
            return self._versions

    def publish(self, embeddings, ids=None) -> int:
        """Build + atomically publish a new corpus; returns the version."""
        return self.publish_built(self.build(embeddings, ids))

    @property
    def version(self) -> int:
        v = self._current
        return v.version if v is not None else 0

    def record_swap(self, seconds: float) -> None:
        """Swap bookkeeping (called by ``serve.swap.SwapController``)."""
        with self._stats_lock:
            self._swap_count += 1
        self._swap_window.record(seconds)

    def begin_swap(self) -> None:
        """Mark a hot swap mid-flight (SwapController, before the build);
        ``/healthz`` reports ``degraded`` while any swap is in progress."""
        with self._stats_lock:
            self._swaps_in_flight += 1

    def end_swap(self) -> None:
        with self._stats_lock:
            self._swaps_in_flight = max(0, self._swaps_in_flight - 1)

    @property
    def swap_in_flight(self) -> bool:
        with self._stats_lock:
            return self._swaps_in_flight > 0

    # -- search --------------------------------------------------------------

    def _stage(self, stage: str, t0: float, t1: float) -> None:
        self._stage_windows[stage].record(t1 - t0)
        if self.spans is not None:
            self.spans.record(f"serve/search/{stage}", t0, t1)

    def search(self, queries, k: int = 10, *, return_version: bool = False):
        """Top-k under the shared ranking contract, routed by tier. Returns
        ``(scores, ids)`` — or ``(scores, ids, version)`` with
        ``return_version=True``, where version is the index generation this
        answer was computed from."""
        v = self._current
        if v is None:
            raise ValueError("search() before the first publish()")
        arr = np.asarray(queries)
        squeeze = arr.ndim == 1
        k = min(int(k), v.size)
        if self.tier == "exact":
            t0 = time.monotonic()
            scores, ids = v.exact.search(arr, k)
            self._stage("exact", t0, time.monotonic())
        elif self.tier == "sharded":
            t0 = time.monotonic()
            cand_s, cand_i = v.sharded.candidates(arr, k)
            t1 = time.monotonic()
            self._stage("fanout", t0, t1)
            scores, ids = merge_topk(cand_s, cand_i, k)
            if squeeze:
                scores, ids = scores[0], ids[0]
            self._stage("merge", t1, time.monotonic())
        else:  # ann
            rk = v.ann._resolve_rerank_k(k, None)
            t0 = time.monotonic()
            pos = v.ann.coarse_positions(arr, rk)
            t1 = time.monotonic()
            self._stage("coarse", t0, t1)
            scores, ids = v.ann.rerank(arr, pos, k)
            if squeeze:
                scores, ids = scores[0], ids[0]
            self._stage("rerank", t1, time.monotonic())
            self._measure_recall(v, arr, k, ids, rk)
        with self._stats_lock:
            self._searches += 1
        if return_version:
            return scores, ids, v.version
        return scores, ids

    def _measure_recall(self, v, queries, k, ann_ids, rk) -> None:
        """Every measure_every-th ann search is also answered exactly; the
        id overlap feeds the running recall@k stat."""
        with self._stats_lock:
            self._last_rerank_k = rk
            due = self.measure_every and self._searches % self.measure_every == 0
        if not due:
            return
        _, exact_ids = v.exact.search(queries, k)
        ann2 = np.atleast_2d(np.asarray(ann_ids))
        exact2 = np.atleast_2d(exact_ids)
        hits = [
            len(set(a.tolist()) & set(e.tolist())) / max(len(e), 1)
            for a, e in zip(ann2, exact2)
        ]
        with self._stats_lock:
            self._recall_sum += float(np.mean(hits))
            self._recall_n += 1

    def __len__(self) -> int:
        v = self._current
        return v.size if v is not None else 0

    # -- ops surface ---------------------------------------------------------

    def stats(self) -> dict:
        """The router's registered stats fields (obs/metrics_schema.py SERVE
        registry), merged into ``EmbeddingService.stats()``'s snapshot."""
        with self._stats_lock:
            swap_count = self._swap_count
            recall = (
                round(self._recall_sum / self._recall_n, 4)
                if self._recall_n
                else (1.0 if self.tier != "ann" else None)
            )
            rerank_k = self.rerank_k or self._last_rerank_k
        v = self._current
        snap = {
            "index_tier": self.tier,
            "index_version": v.version if v is not None else 0,
            "shard_count": v.sharded.shard_count
            if v is not None and v.sharded is not None
            else 1,
            "swap_count": swap_count,
            "swap_latency_ms": self._swap_window.percentiles_ms((50, 95, 99)),
            "recall_at_k": recall,
            "rerank_k": rerank_k,
            "search_stage_latency_ms": {
                s: w.percentiles_ms((50, 95, 99))
                for s, w in self._stage_windows.items()
                if w.count
            },
            "swap_in_flight": self.swap_in_flight,
        }
        return snap


class EmbeddingService:
    """``encode_text`` / ``encode_image`` / ``search`` over a bucketed engine.

    ``tokenize(texts, length) -> (n, length) int ids`` enables raw-string
    requests; pre-tokenized rows and pixel arrays always work.
    ``cache=None`` disables caching; ``index`` defaults to an empty
    :class:`RetrievalIndex` that ``search`` queries after corpus embeddings
    are ``add``-ed to it — or pass a :class:`RetrievalRouter` for tiered
    (sharded/ann) and hot-swappable retrieval, whose stats fields then ride
    :meth:`stats`. ``admission``: an :class:`AdmissionController` front
    door; requests then take ``tenant=`` and may raise ``ShedError`` before
    they reach a batcher. ``logger``: where :meth:`log_stats` writes.
    """

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        tokenize: Callable | None = None,
        cache: EmbeddingCache | None = None,
        index: RetrievalIndex | None = None,
        max_batch_size: int | None = None,
        max_wait_ms: float = 5.0,
        max_queue: int = 1024,
        default_timeout: float | None = 10.0,
        admission: AdmissionController | None = None,
        logger: MetricsLogger | None = None,
        spans=None,
    ):
        self.engine = engine
        self.tokenize = tokenize
        self.cache = cache
        self.index = index if index is not None else RetrievalIndex()
        self.default_timeout = default_timeout
        self.admission = admission
        self.logger = logger
        # An obs/spans.py SpanRecorder or None: per-request spans on the
        # caller threads plus per-stage spans on the batcher workers.
        self.spans = spans
        if max_batch_size is None:
            max_batch_size = engine.batch_buckets[-1]
        self._batchers = {
            kind: MicroBatcher(
                fn, max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
                max_queue=max_queue, name=kind, spans=spans,
            )
            for kind, fn in (("text", self._encode_rows_text),
                             ("image", self._encode_rows_image))
        }
        self._latency = LatencyWindow()
        self._lock = named_lock("serve.service.EmbeddingService._lock")
        self._requests = 0
        self._items = 0
        self._rejected = 0
        self._timeouts = 0
        self._shed = 0
        self._started = time.monotonic()
        self._exporter = None  # the live /metrics endpoint (start_metrics_server)

    # -- engine-facing batch fns (worker thread only) ------------------------

    def _encode_rows_text(self, rows: list[np.ndarray]) -> list[np.ndarray]:
        # Coalesced rows may have different lengths; right-pad with id 0 to
        # the longest so one flush is one engine call.
        smax = max(r.shape[0] for r in rows)
        batch = np.zeros((len(rows), smax), dtype=self.engine.token_dtype)
        for i, r in enumerate(rows):
            batch[i, : r.shape[0]] = r
        return list(self.engine.encode_text(batch))

    def _encode_rows_image(self, rows: list[np.ndarray]) -> list[np.ndarray]:
        return list(self.engine.encode_image(np.stack(rows)))

    # -- request paths -------------------------------------------------------

    def _normalize_text(self, texts) -> list[np.ndarray]:
        """str | (s,) ids | list of either | (n, s) ids → list of (s,) rows."""
        if isinstance(texts, str):
            texts = [texts]
        elif isinstance(texts, np.ndarray):
            if texts.ndim == 1:  # a single token row, not n scalar requests
                texts = [texts]
            elif texts.ndim == 2:
                texts = list(texts)
            else:
                raise ValueError(f"token input must be (s,) or (n, s), got {texts.shape}")
        rows: list = list(texts)
        str_pos = [i for i, t in enumerate(rows) if isinstance(t, str)]
        if str_pos:
            if self.tokenize is None:
                raise ValueError(
                    "string requests need a tokenize fn (construct the service "
                    "with tokenize=...)"
                )
            length = self.engine.text_len_buckets[-1]
            tokenized = self.tokenize([rows[i] for i in str_pos], length)
            for i, row in zip(str_pos, tokenized):
                rows[i] = row
        return [np.asarray(r, dtype=self.engine.token_dtype) for r in rows]

    def _admit(self, tenant, items: int, deadline_s):
        """Pass the admission front door (or raise the typed ShedError).
        Returns the ticket to release, or None when no admission is wired."""
        if self.admission is None:
            return None
        try:
            return self.admission.admit(tenant, items=items, deadline_s=deadline_s)
        except ShedError:
            with self._lock:
                self._shed += 1
            raise

    def _encode(self, kind: str, rows: list[np.ndarray], timeout, tenant=None) -> np.ndarray:
        timeout = self.default_timeout if timeout is None else timeout
        # Admission covers the whole request (cache probe included): the
        # quota a tenant holds is its end-to-end concurrency, and the token
        # bucket meters offered rate, not just cache misses.
        ticket = self._admit(tenant, len(rows), timeout)
        ok = False
        try:
            out = self._encode_batched(kind, rows, timeout)
            ok = True
            return out
        finally:
            if ticket is not None:
                ticket.release(ok=ok)

    def _encode_batched(self, kind: str, rows: list[np.ndarray], timeout) -> np.ndarray:
        t0 = time.monotonic()
        results: list[np.ndarray | None] = [None] * len(rows)
        pending: list[tuple[int, str | None, object]] = []
        try:
            for i, row in enumerate(rows):
                key = None
                if self.cache is not None:
                    key = content_key(row, kind)
                    hit = self.cache.get(key)
                    if hit is not None:
                        results[i] = hit
                        continue
                try:
                    fut = self._batchers[kind].submit(row)
                except QueueFullError:
                    with self._lock:
                        self._rejected += 1
                    raise
                pending.append((i, key, fut))
            for i, key, fut in pending:
                remaining = None
                if timeout is not None:
                    remaining = max(0.0, timeout - (time.monotonic() - t0))
                try:
                    emb = fut.result(timeout=remaining)
                except FutureTimeoutError:
                    with self._lock:
                        self._timeouts += 1
                    raise RequestTimeoutError(
                        f"{kind} request missed its {timeout}s deadline "
                        f"({len(pending)} item(s) in flight)"
                    ) from None
                results[i] = emb
                if self.cache is not None:
                    self.cache.put(key, emb)
        finally:
            with self._lock:
                self._requests += 1
                self._items += len(rows)
            t1 = time.monotonic()
            self._latency.record(t1 - t0)
            if self.spans is not None:
                self.spans.record(f"serve/request/{kind}", t0, t1)
        return np.stack(results)

    def encode_text(self, texts, *, timeout: float | None = None,
                    tenant: str | None = None) -> np.ndarray:
        """Texts (strings or token rows) → (n, embed_dim) embeddings."""
        return self._encode("text", self._normalize_text(texts), timeout, tenant)

    def encode_image(self, images, *, timeout: float | None = None,
                     tenant: str | None = None) -> np.ndarray:
        """(n, h, w, 3) or (h, w, 3) pixels → (n, embed_dim) embeddings."""
        arr = np.asarray(images, dtype=np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        return self._encode("image", list(arr), timeout, tenant)

    def search(self, queries, k: int = 10, *, timeout: float | None = None,
               tenant: str | None = None, return_version: bool = False):
        """Top-k over the index. Queries: strings / int token rows (encoded
        through the text tower) or float rows (used as embeddings directly).
        Returns ``(scores, ids)`` in ``RetrievalIndex``'s order;
        ``return_version=True`` (a :class:`RetrievalRouter` index only) adds
        the index version that served the answer."""
        kw = {"return_version": True} if return_version else {}
        if isinstance(queries, np.ndarray) and np.issubdtype(queries.dtype, np.floating):
            # Already embeddings: no encode path, so the admission check (one
            # per request) happens here instead of inside _encode.
            n = queries.shape[0] if queries.ndim > 1 else 1
            deadline = self.default_timeout if timeout is None else timeout
            ticket = self._admit(tenant, n, deadline)
            ok = False
            try:
                out = self.index.search(queries, k, **kw)
                ok = True
                return out
            finally:
                if ticket is not None:
                    ticket.release(ok=ok)
        emb = self.encode_text(queries, timeout=timeout, tenant=tenant)
        return self.index.search(emb, k, **kw)

    # -- ops surface ---------------------------------------------------------

    def stats(self) -> dict:
        """One JSON-able snapshot of the service's operational state."""
        elapsed = max(1e-9, time.monotonic() - self._started)
        with self._lock:
            requests, items = self._requests, self._items
            rejected, timeouts = self._rejected, self._timeouts
            shed = self._shed
        snap = {
            "uptime_s": round(elapsed, 3),
            "requests": requests,
            "items": items,
            "qps": round(requests / elapsed, 2),
            "items_per_sec": round(items / elapsed, 2),
            "latency_ms": self._latency.percentiles_ms((50, 95, 99)),
            "batch_size_hist": {
                kind: b.batch_size_histogram() for kind, b in self._batchers.items()
            },
            "stage_latency_ms": {
                kind: b.stage_latency_ms() for kind, b in self._batchers.items()
            },
            "rejected": rejected,
            "timeouts": timeouts,
            # Admission sheds are a separate stream from queue-full rejects:
            # shed = policy said no (tenant over rate/quota, or shed by
            # priority), rejected = the whole stack was saturated.
            "shed": shed,
            "shed_rate": (round(self.admission.recent_shed_rate(), 4)
                          if self.admission is not None else 0.0),
            "compile_count": self.engine.compile_count,
            "bucket_space": self.engine.bucket_space,
            "index_size": len(self.index),
        }
        if self.cache is not None:
            snap["cache"] = self.cache.stats()
        if self.admission is not None:
            snap["admission"] = self.admission.stats()
        if isinstance(self.index, RetrievalRouter):
            snap.update(self.index.stats())
        return snap

    def health(self) -> dict:
        """The ``/healthz`` payload: ``degraded`` (still HTTP 200: the
        process is up and answering) while admission is shedding or a hot
        swap is mid-flight, ``ok`` otherwise. ``reasons`` names each cause:
        the fleet router drains a replica on ``"swap_in_flight"`` but keeps
        routing to one that is merely ``"shedding"``."""
        shed_rate = (self.admission.recent_shed_rate()
                     if self.admission is not None else 0.0)
        swap = (self.index.swap_in_flight
                if isinstance(self.index, RetrievalRouter) else False)
        reasons = []
        if swap:
            reasons.append("swap_in_flight")
        if shed_rate > 0:
            reasons.append("shedding")
        return {
            "status": "degraded" if reasons else "ok",
            "shed_rate": round(shed_rate, 4),
            "swap_in_flight": bool(swap),
            "reasons": reasons,
        }

    def start_metrics_server(self, port: int = 0, *, host: str = "127.0.0.1",
                             labels: dict | None = None, refresh_s: float = 0.25):
        """Mount the live OpenMetrics-style ``/metrics`` endpoint
        (``obs/telemetry.py``): a standard-library HTTP thread serving the
        :meth:`stats` snapshot, rendered at most once per ``refresh_s``
        however often it is scraped, and ``/healthz`` (:meth:`health`).
        ``labels`` stamps a constant label set onto every series. Returns
        the started ``TelemetryExporter`` (``.port`` / ``.url``);
        :meth:`close` stops it."""
        from distributed_sigmoid_loss_tpu_torch.obs.telemetry import TelemetryExporter

        if self._exporter is not None:
            raise RuntimeError("metrics server already started")
        self._exporter = TelemetryExporter(
            self.stats, host=host, port=port, labels=labels, refresh_s=refresh_s,
            health_fn=self.health,
        )
        self._exporter.start()
        return self._exporter

    def log_stats(self) -> dict:
        """Emit :meth:`stats` through the wired MetricsLogger, checked
        against the declared serve-stats schema; returns it."""
        snap = self.stats()
        if self.logger is not None:
            from distributed_sigmoid_loss_tpu_torch.obs.metrics_schema import SERVE_STATS_FIELDS

            self.logger.write({"metric": "serve_stats", **snap}, schema=SERVE_STATS_FIELDS)
        return snap

    def close(self) -> None:
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        for b in self._batchers.values():
            b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
