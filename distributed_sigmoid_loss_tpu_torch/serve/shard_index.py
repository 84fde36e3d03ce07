"""Sharded retrieval index: per-shard exact top-k on each shard's device,
merged candidates on the host.

``serve.index.RetrievalIndex`` is a single-host O(corpus) scan per query:
correct, but the whole corpus streams through one memory bus on every
search. Sharding is the first lever: partition the corpus rows over a list
of devices so each scans 1/W of the rows, take each shard's exact top-k on
its device, and merge the gathered ``(score, id)`` candidate lists on the
host. The port of the JAX package's ``serve/shard_index.py``, whose shards
live on a ``dp`` mesh axis inside a ``shard_map``; here a shard is a tensor
on a ``torch.device``, and a device may repeat in the list (four shards on
one card, or on the CPU, still exercise the merge).

The merge is ranking-identical to the one-matrix oracle
(:func:`eval.retrieval.topk_ids`) including tie order, by construction:

- rows are partitioned CONTIGUOUSLY (shard w holds insertion positions
  ``[w*n_per, (w+1)*n_per)``), so within a shard ascending local index is
  ascending global id;
- each shard orders its scores by a STABLE descending sort, so exact ties
  keep the lower index (JAX's ``lax.top_k`` is stable; ``torch.topk``
  promises no order among ties, on any device, and is not used) — a
  shard's own list already prefers the lower id, so truncating to k per
  shard can never drop a candidate the global merge would have picked;
- the host merge (:func:`eval.retrieval.merge_topk`) resolves cross-shard
  ties toward the lower id — exactly ``topk_ids``'s lower-index tie break
  when ids are insertion positions (the default).

Snapshot semantics are IMMUTABLE: an instance is built once from a corpus
and never mutated. Live refresh is a new instance published atomically by
``serve.swap.SwapController`` / ``RetrievalRouter``; there is no lock on the
search path. Queries are padded up to a fixed ``query_buckets`` grid, and
``compile_count`` counts the distinct (query bucket, k_local) shapes run,
as JAX counts its compiled fan-out programs.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.eval.retrieval import merge_topk

__all__ = ["ShardedIndex"]


class ShardedIndex:
    """Immutable sharded exact top-k index over embedding rows.

    ``embeddings``: (n, d) rows, a numpy array or a tensor (a tensor on a
    shard's device is split there, with no host round trip).
    ``devices``: one device per shard, in row order. ``search`` returns
    ``(scores (q, k), ids (q, k))``, score-descending, exact ties broken
    toward the LOWER id — with default ids (insertion positions) this is the
    ``eval.retrieval.topk_ids`` ranking. ``candidates`` exposes the raw
    gathered per-shard lists, so the ``RetrievalRouter`` can time fan-out
    and merge as separate stages.
    """

    def __init__(
        self,
        embeddings,
        ids=None,
        *,
        devices,
        query_buckets=(1, 8, 64),
        dtype=np.float32,
    ):
        if isinstance(embeddings, torch.Tensor):
            rows = embeddings.detach().to(torch.from_numpy(np.empty(0, dtype)).dtype)
        else:
            rows = torch.from_numpy(np.ascontiguousarray(embeddings, dtype=dtype))
        if rows.ndim != 2 or not len(rows):
            raise ValueError(
                f"embeddings must be a non-empty (n, d) array, got {tuple(rows.shape)}"
            )
        if ids is None:
            ids = np.arange(len(rows), dtype=np.int64)
        else:
            ids = np.asarray(ids, dtype=np.int64)
            if ids.shape != (len(rows),):
                raise ValueError(f"ids shape {ids.shape} != ({len(rows)},)")
            if (ids < 0).any():
                raise ValueError("ids must be >= 0 (negative marks padding)")
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("devices must name at least one device (one per shard)")
        self.query_buckets = tuple(sorted(set(int(b) for b in query_buckets)))
        if not self.query_buckets or self.query_buckets[0] < 1:
            raise ValueError(f"bad query_buckets {query_buckets!r}")
        self.size = len(rows)
        self.dim = rows.shape[1]
        self.shard_count = len(self.devices)
        # Contiguous partition, padded so every shard holds n_per rows (one
        # shape for every shard's product); pad rows are zeros with id -1,
        # masked to -inf before the sort.
        self.rows_per_shard = -(-self.size // self.shard_count)
        self._rows, self._ids, self._real = [], [], []
        for w, device in enumerate(self.devices):
            lo = min(w * self.rows_per_shard, self.size)
            hi = min(lo + self.rows_per_shard, self.size)
            shard = torch.zeros((self.rows_per_shard, self.dim), dtype=rows.dtype,
                                device=device)
            shard[: hi - lo].copy_(rows[lo:hi])
            shard_ids = np.full(self.rows_per_shard, -1, dtype=np.int64)
            shard_ids[: hi - lo] = ids[lo:hi]
            self._rows.append(shard)
            self._ids.append(torch.from_numpy(shard_ids).to(device))
            self._real.append(hi - lo)
        self._compiled: set[tuple[int, int]] = set()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self.size

    @property
    def compile_count(self) -> int:
        """Distinct (query bucket, k_local) shapes searched so far: the
        engine's bucket discipline, for the index."""
        with self._lock:
            return len(self._compiled)

    def _query_bucket(self, n: int) -> int:
        for b in self.query_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"query batch {n} exceeds the largest query bucket "
            f"{self.query_buckets[-1]}; split the request or extend "
            "query_buckets"
        )

    def candidates(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Gathered per-shard candidate lists: ``(scores, ids)`` each
        (q, W * k_local) — the fan-out stage. ``merge_topk`` of these is the
        global top-k; :meth:`search` does exactly that."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        k = min(k, self.size)
        k_local = min(k, self.rows_per_shard)
        qb = self._query_bucket(len(q))
        padded = np.zeros((qb, self.dim), dtype=np.float32)
        padded[: len(q)] = q
        with self._lock:
            self._compiled.add((qb, k_local))
        host_q = torch.from_numpy(padded).to(self._rows[0].dtype)
        # Issue every shard's product and sort before reading any back, so
        # shards on different devices run at once.
        per_shard = []
        with torch.inference_mode():
            for rows, ids, real in zip(self._rows, self._ids, self._real):
                sims = host_q.to(rows.device) @ rows.T  # (qb, n_per)
                if real < self.rows_per_shard:
                    sims[:, real:] = -torch.inf
                # Stable: exact ties keep the lower index, like lax.top_k.
                scores, idx = torch.sort(sims, dim=1, descending=True, stable=True)
                per_shard.append((scores[:, :k_local], ids[idx[:, :k_local]]))
            s = np.stack([sc.float().cpu().numpy() for sc, _ in per_shard])
            i = np.stack([ix.cpu().numpy() for _, ix in per_shard])
        s, i = s[:, : len(q)], i[:, : len(q)]
        # (W, q, k_local) -> (q, W * k_local) gathered candidate lists.
        cand_s = np.moveaxis(s, 0, 1).reshape(len(q), -1)
        cand_i = np.moveaxis(i, 0, 1).reshape(len(q), -1)
        return cand_s, cand_i

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(q, d) or (d,) queries → top-k ``(scores, ids)`` under the shared
        ranking contract. k clamps to the corpus size."""
        squeeze = np.asarray(queries).ndim == 1
        cand_s, cand_i = self.candidates(queries, k)
        k = min(int(k), self.size)
        scores, ids = merge_topk(cand_s, cand_i, k)
        if squeeze:
            return scores[0], ids[0]
        return scores, ids

    def stats(self) -> dict:
        return {
            "size": self.size,
            "shard_count": self.shard_count,
            "rows_per_shard": self.rows_per_shard,
            "compile_count": self.compile_count,
        }
