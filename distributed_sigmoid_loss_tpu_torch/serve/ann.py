"""Approximate retrieval tier: coarse quantized scoring, exact re-rank.

The exact scan streams ``N * d * 4`` bytes per query batch and the workload
is memory-bandwidth-bound (PAPERS.md, "Dissecting Embedding Bag Performance
in DLRM Inference") — so the second lever after sharding is shrinking the
bytes the candidate scan touches. This tier scores EVERY row with a cheap
quantized representation (the pruning pass), keeps the best ``rerank_k``
candidates, and re-ranks only those with exact f32 dot products:

- ``coarse="int8"`` (default): per-row symmetric int8 via the SAME
  ``ops.quant.quantize_int8`` recipe the serving/eval int8 towers use —
  4x fewer corpus bytes, int32 accumulation, per-row scales applied before
  selection (activation scales are per-query constants and cannot change a
  row's ordering). Quantization error is ~1e-2 of the score scale, so the
  coarse ORDER is nearly exact and modest ``rerank_k`` already recovers the
  exact top-k (measured recall@k is surfaced in stats, floor-enforced in
  tests).
- ``coarse="sign"``: 1-bit sign sketches (``ops.quant.sign_sketch``) — 32x
  fewer bytes; sign-agreement count is a monotone proxy good enough to
  prune, never to rank. Needs a larger ``rerank_k`` for the same recall.

The re-rank stage reuses :func:`eval.retrieval.merge_topk`, so WITHIN the
survivor set the returned ordering (including exact-tie order) is identical
to the exact path's — an ANN answer differs from the oracle only by
candidates the coarse pass pruned, which is exactly what recall@k measures.

Like ``ShardedIndex``, instances are immutable snapshots: refresh = build a
new one and publish it through the router/swap controller. The port's copy
of the JAX package's ``serve/ann.py``: it stays on the host, as there; the
corpus is quantized by the port's ``ops.quant.quantize_int8`` on the CPU,
JAX's recipe bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.eval.retrieval import merge_topk
from distributed_sigmoid_loss_tpu_torch.ops.quant import (
    quantize_int8,
    sign_sketch,
    sign_sketch_scores,
)

__all__ = ["AnnIndex", "default_rerank_k"]


def default_rerank_k(k: int, size: int) -> int:
    """The default pruning width: enough head-room over k that int8-grade
    coarse error stays above the 0.95 recall floor on realistic corpora,
    clamped to the corpus."""
    return min(max(8 * k, 64), size)


class AnnIndex:
    """Quantize-then-rerank approximate top-k over embedding rows.

    ``search(queries, k)`` routes coarse pruning → exact re-rank; the split
    methods (:meth:`coarse_positions` / :meth:`rerank`) let the router time
    and span the two stages separately.
    """

    def __init__(
        self,
        embeddings,
        ids=None,
        *,
        coarse: str = "int8",
        rerank_k: int | None = None,
    ):
        rows = np.ascontiguousarray(embeddings, dtype=np.float32)
        if rows.ndim != 2 or not len(rows):
            raise ValueError(
                f"embeddings must be a non-empty (n, d) array, got {rows.shape}"
            )
        if ids is None:
            ids = np.arange(len(rows), dtype=np.int64)
        else:
            ids = np.asarray(ids, dtype=np.int64)
            if ids.shape != (len(rows),):
                raise ValueError(f"ids shape {ids.shape} != ({len(rows)},)")
        if coarse not in ("int8", "sign"):
            raise ValueError(f"coarse must be 'int8' or 'sign', got {coarse!r}")
        self.coarse = coarse
        self.rerank_k = rerank_k  # None = per-search default_rerank_k(k)
        self._rows = rows
        self._ids = ids
        self.size = len(rows)
        self.dim = rows.shape[1]
        if coarse == "int8":
            q8, scale = quantize_int8(torch.from_numpy(rows), axis=-1)  # the shared recipe
            self._q8 = q8.numpy()                     # (n, d) int8
            self._scale = scale.numpy()[:, 0]         # (n,) f32 per-row
        else:
            self._bits = sign_sketch(rows)            # (n, ceil(d/8)) uint8

    def __len__(self) -> int:
        return self.size

    def _resolve_rerank_k(self, k: int, rerank_k: int | None) -> int:
        rk = rerank_k if rerank_k is not None else self.rerank_k
        if rk is None or rk <= 0:
            rk = default_rerank_k(k, self.size)
        return min(max(int(rk), k), self.size)

    def coarse_positions(self, queries, rerank_k: int) -> np.ndarray:
        """The pruning pass: (q, rerank_k) corpus POSITIONS (not ids) of the
        best coarse-scored candidates, per query row (unordered)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        if self.coarse == "int8":
            # Query-side quantization is a host-hot-path numpy mirror of the
            # quantize_int8 recipe (same abs-max scale, same round-half-even,
            # same clip): JAX's own query path, bit for bit. The per-row query scale is a positive
            # constant per score row, so it cannot change any row's ordering
            # and is dropped.
            scale = np.maximum(
                np.max(np.abs(q), axis=1, keepdims=True), 1e-12
            ) / 127.0
            qq = np.clip(np.rint(q / scale), -127, 127).astype(np.int8)
            # int32 queries x int8 corpus: numpy promotes the accumulator to
            # int32 while the BIG operand stays int8 in memory — the bytes
            # the scan streams are the point.
            acc = qq.astype(np.int32) @ self._q8.T  # (q, n)
            scores = acc.astype(np.float32) * self._scale[None, :]
        else:
            scores = sign_sketch_scores(sign_sketch(q), self._bits, self.dim)
        if rerank_k >= self.size:
            return np.broadcast_to(
                np.arange(self.size), (len(q), self.size)
            ).copy()
        part = np.argpartition(-scores, rerank_k - 1, axis=1)[:, :rerank_k]
        return part

    def rerank(
        self, queries, positions: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact f32 re-rank of the survivor ``positions``: top-k under the
        shared :func:`eval.retrieval.merge_topk` ordering contract."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None]
        survivors = self._rows[positions]  # (q, rk, d)
        exact = np.einsum("qd,qrd->qr", q, survivors)
        return merge_topk(exact, self._ids[positions], min(k, self.size))

    def search(
        self, queries, k: int, *, rerank_k: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(q, d) or (d,) queries → approximate top-k ``(scores, ids)``.
        Scores of returned candidates are EXACT (re-ranked); approximation
        only ever drops candidates, never mis-scores them."""
        arr = np.asarray(queries)
        squeeze = arr.ndim == 1
        k = min(int(k), self.size)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        rk = self._resolve_rerank_k(k, rerank_k)
        pos = self.coarse_positions(arr, rk)
        scores, ids = self.rerank(arr, pos, k)
        if squeeze:
            return scores[0], ids[0]
        return scores, ids

    def stats(self) -> dict:
        return {
            "size": self.size,
            "coarse": self.coarse,
            "rerank_k": self.rerank_k or 0,
        }
