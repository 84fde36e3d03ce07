"""EmbeddingService — the serving front end tying engine, batcher, cache and
index together.

One request flows: content hash → cache probe → (on miss) micro-batcher →
bucketed engine → cache fill → caller, with the whole round trip bounded by a
per-request timeout. Text and image traffic get separate batchers, so one
modality's burst never stalls the other's deadline.

The core of the JAX package's ``serve/service.py``. Its admission control,
tiered/versioned retrieval router, metrics server and spans are not ported
yet.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable

import numpy as np

from distributed_sigmoid_loss_tpu_torch.serve.batcher import MicroBatcher, QueueFullError
from distributed_sigmoid_loss_tpu_torch.serve.cache import EmbeddingCache, content_key
from distributed_sigmoid_loss_tpu_torch.serve.engine import InferenceEngine
from distributed_sigmoid_loss_tpu_torch.serve.index import RetrievalIndex
from distributed_sigmoid_loss_tpu_torch.utils.logging import LatencyWindow

__all__ = ["EmbeddingService", "RequestTimeoutError"]


class RequestTimeoutError(TimeoutError):
    """The request's deadline passed before its batch finished encoding."""


class EmbeddingService:
    """``encode_text`` / ``encode_image`` / ``search`` over a bucketed engine.

    ``tokenize(texts, length) -> (n, length) int ids`` enables raw-string
    requests; pre-tokenized rows and pixel arrays always work.
    ``cache=None`` disables caching; ``index`` defaults to an empty
    :class:`RetrievalIndex` that ``search`` queries after corpus embeddings
    are ``add``-ed to it.
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
    ):
        self.engine = engine
        self.tokenize = tokenize
        self.cache = cache
        self.index = index if index is not None else RetrievalIndex()
        self.default_timeout = default_timeout
        if max_batch_size is None:
            max_batch_size = engine.batch_buckets[-1]
        self._batchers = {
            kind: MicroBatcher(
                fn, max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
                max_queue=max_queue, name=kind,
            )
            for kind, fn in (("text", self._encode_rows_text),
                             ("image", self._encode_rows_image))
        }
        self._latency = LatencyWindow()
        self._lock = threading.Lock()
        self._requests = 0
        self._items = 0
        self._rejected = 0
        self._timeouts = 0
        self._started = time.monotonic()

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

    def _encode(self, kind: str, rows: list[np.ndarray], timeout) -> np.ndarray:
        timeout = self.default_timeout if timeout is None else timeout
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
            self._latency.record(time.monotonic() - t0)
        return np.stack(results)

    def encode_text(self, texts, *, timeout: float | None = None) -> np.ndarray:
        """Texts (strings or token rows) → (n, embed_dim) embeddings."""
        return self._encode("text", self._normalize_text(texts), timeout)

    def encode_image(self, images, *, timeout: float | None = None) -> np.ndarray:
        """(n, h, w, 3) or (h, w, 3) pixels → (n, embed_dim) embeddings."""
        arr = np.asarray(images, dtype=np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        return self._encode("image", list(arr), timeout)

    def search(self, queries, k: int = 10, *, timeout: float | None = None):
        """Top-k over the index. Queries: strings / int token rows (encoded
        through the text tower) or float rows (used as embeddings directly).
        Returns ``(scores, ids)`` in ``RetrievalIndex``'s order."""
        if isinstance(queries, np.ndarray) and np.issubdtype(queries.dtype, np.floating):
            return self.index.search(queries, k)
        return self.index.search(self.encode_text(queries, timeout=timeout), k)

    # -- ops surface ---------------------------------------------------------

    def stats(self) -> dict:
        """One JSON-able snapshot of the service's operational state."""
        elapsed = max(1e-9, time.monotonic() - self._started)
        with self._lock:
            requests, items = self._requests, self._items
            rejected, timeouts = self._rejected, self._timeouts
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
            "compile_count": self.engine.compile_count,
            "bucket_space": self.engine.bucket_space,
            "index_size": len(self.index),
        }
        if self.cache is not None:
            snap["cache"] = self.cache.stats()
        return snap

    def close(self) -> None:
        for b in self._batchers.values():
            b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
