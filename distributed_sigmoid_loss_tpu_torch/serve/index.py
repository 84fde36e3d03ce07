"""In-memory exact retrieval index: dot-product top-k over L2-normalized rows.

Exact, not approximate: brute force over host numpy is both the correctness
oracle and the baseline any approximate tier must reproduce on its recall
ceiling. A copy of the JAX package's ``serve/index.py`` (host numpy, no JAX).

The scan is CHUNKED over index rows: per query block only a
(queries × chunk_size) score panel is live, so memory stays bounded by the
chunk knob while the index itself can hold millions of rows. The running
top-k is merged per chunk with a STABLE sort, which pins the tie order to
insertion position — the same deterministic contract as
:func:`eval.retrieval.topk_ids` (chunk size never changes the result).
"""

from __future__ import annotations

import threading

import numpy as np

from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = ["RetrievalIndex"]


class RetrievalIndex:
    """Append-only exact top-k index over embedding rows.

    ``add`` stacks rows (with optional integer ids; default = insertion
    order); ``search`` returns ``(scores, ids)`` of the top-k by dot product,
    descending, ties broken by insertion order (earlier row wins). Thread-safe
    for concurrent add/search (snapshot semantics: a search sees the rows
    present when it started — an ``add`` landing MID-scan is invisible to
    that search, never a torn chunk).
    """

    def __init__(self, *, chunk_size: int = 4096, dtype=np.float32):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.chunk_size = chunk_size
        self.dtype = np.dtype(dtype)
        self._blocks: list[np.ndarray] = []
        self._ids: list[np.ndarray] = []
        self._size = 0
        self._lock = named_lock("serve.index.RetrievalIndex._lock")

    def __len__(self) -> int:
        with self._lock:
            return self._size

    @property
    def dim(self) -> int | None:
        with self._lock:
            return self._blocks[0].shape[1] if self._blocks else None

    def add(self, embeddings, ids=None) -> np.ndarray:
        """Append (n, d) rows; returns the assigned ids (n,)."""
        emb = np.ascontiguousarray(embeddings, dtype=self.dtype)
        if emb.ndim == 1:
            emb = emb[None]
        if emb.ndim != 2:
            raise ValueError(f"embeddings must be (n, d), got {emb.shape}")
        with self._lock:
            if self._blocks and emb.shape[1] != self._blocks[0].shape[1]:
                raise ValueError(
                    f"dim {emb.shape[1]} != index dim {self._blocks[0].shape[1]}"
                )
            if ids is None:
                ids = np.arange(self._size, self._size + len(emb), dtype=np.int64)
            else:
                ids = np.asarray(ids, dtype=np.int64)
                if ids.shape != (len(emb),):
                    raise ValueError(
                        f"ids shape {ids.shape} != ({len(emb)},)"
                    )
            self._blocks.append(emb)
            self._ids.append(ids)
            self._size += len(emb)
            return ids

    def _snapshot(self) -> tuple[list[np.ndarray], list[np.ndarray], int]:
        with self._lock:
            return list(self._blocks), list(self._ids), self._size

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(q, d) or (d,) queries → (scores (q, k), ids (q, k)), score-descending,
        ties by insertion order. k is clamped to the index size."""
        blocks, id_blocks, size = self._snapshot()
        if size == 0:
            raise ValueError("search on an empty index")
        q = np.ascontiguousarray(queries, dtype=self.dtype)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None]
        k = min(int(k), size)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")

        best_scores = np.full((len(q), 0), -np.inf, dtype=self.dtype)
        best_ids = np.zeros((len(q), 0), dtype=np.int64)
        # Iterate fixed-size chunks across block boundaries, in insertion
        # order: within each merge, retained rows (earlier positions) precede
        # chunk rows (later positions), and the STABLE argsort therefore
        # resolves every tie to the earlier insertion — chunk size never
        # changes the result.
        for chunk, chunk_ids in self._chunks(blocks, id_blocks):
            sims = q @ chunk.T  # (q, chunk)
            cand_scores = np.concatenate([best_scores, sims], axis=1)
            cand_ids = np.concatenate(
                [best_ids, np.broadcast_to(chunk_ids, (len(q), len(chunk_ids)))],
                axis=1,
            )
            order = np.argsort(-cand_scores, axis=1, kind="stable")[:, :k]
            best_scores = np.take_along_axis(cand_scores, order, axis=1)
            best_ids = np.take_along_axis(cand_ids, order, axis=1)
        if squeeze:
            return best_scores[0], best_ids[0]
        return best_scores, best_ids

    def _chunks(self, blocks, id_blocks):
        """Yield (rows, ids) panels of at most chunk_size, splitting and
        coalescing add()-blocks as needed."""
        pend_rows: list[np.ndarray] = []
        pend_ids: list[np.ndarray] = []
        pending = 0
        for block, ids in zip(blocks, id_blocks):
            start = 0
            while start < len(block):
                take = min(self.chunk_size - pending, len(block) - start)
                pend_rows.append(block[start : start + take])
                pend_ids.append(ids[start : start + take])
                pending += take
                start += take
                if pending == self.chunk_size:
                    yield np.concatenate(pend_rows), np.concatenate(pend_ids)
                    pend_rows, pend_ids, pending = [], [], 0
        if pending:
            yield np.concatenate(pend_rows), np.concatenate(pend_ids)
