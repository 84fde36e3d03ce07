"""LRU embedding cache keyed by content hash.

Serving embeddings is read-heavy and repetitive — the same captions and the
same catalog images arrive over and over. An embedding is a pure function of
the request content and the deployed params, so a content-addressed cache is
exact: key = blake2b of the raw token/pixel bytes (plus a caller-supplied
namespace for the model/params generation), value = the host-side embedding
row. Hits skip tokenize→pad→device→encode entirely.

Thread-safe: ``get``/``put`` run under one lock (the service's batcher workers
and client threads share the cache). Counters (hits/misses/evictions) feed the
service's ``stats()`` snapshot. A copy of the JAX package's ``serve/cache.py``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = ["EmbeddingCache", "content_key"]


def content_key(content, namespace: str = "") -> str:
    """Content hash of a request payload: str, bytes, or ndarray.

    Arrays hash their dtype+shape+bytes (two token rows of different length
    must never collide); ``namespace`` distinguishes model/params generations
    and modalities sharing one cache (e.g. ``"text"`` vs ``"image"``).
    """
    h = hashlib.blake2b(digest_size=16)
    if namespace:
        h.update(namespace.encode())
        h.update(b"\x00")
    if isinstance(content, str):
        content = content.encode()
    if isinstance(content, (bytes, bytearray)):
        h.update(b"raw")
        h.update(content)
    else:
        arr = np.ascontiguousarray(content)
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class EmbeddingCache:
    """Bounded LRU mapping content keys → embedding rows (host numpy).

    ``capacity`` is an entry count, not bytes: embedding rows are fixed-size
    (embed_dim floats), so entries are the natural budget unit and the byte
    footprint is ``capacity * embed_dim * 4``.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: OrderedDict[str, np.ndarray] = OrderedDict()
        self._lock = named_lock("serve.cache.EmbeddingCache._lock")
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key: str) -> np.ndarray | None:
        with self._lock:
            value = self._data.get(key)
            if value is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: str, value: np.ndarray) -> None:
        with self._lock:
            if key in self._data:
                # Refresh recency; the value is content-addressed so any
                # overwrite is byte-identical by construction.
                self._data.move_to_end(key)
                return
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._data),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
            }
