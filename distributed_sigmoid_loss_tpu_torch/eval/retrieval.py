"""The exact top-k ranking contract shared by offline eval and serving:
descending score, exact ties broken toward the lower id. Host numpy: the
stable sort that pins the tie order runs on materialized scores."""

from __future__ import annotations

import numpy as np

__all__ = ["topk_ids", "merge_topk"]


def topk_ids(sims, k: int) -> np.ndarray:
    """Exact top-k ids over the last axis: descending score, ties to the
    lower id. ``serve.index.RetrievalIndex.search`` reproduces this order."""
    sims = np.asarray(sims)
    order = np.argsort(-sims, axis=-1, kind="stable")
    return order[..., :k]


def merge_topk(scores, ids, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-row candidate ``(score, id)`` lists (``(..., C)``, any
    order) into the global top-k under the :func:`topk_ids` contract.
    Candidates with id < 0 are padding and never win over a real one."""
    scores = np.asarray(scores)
    ids = np.asarray(ids, dtype=np.int64)
    scores = np.where(ids < 0, -np.inf, scores)
    # Ascending id first; the stable score sort then resolves every exact
    # tie to the lower id.
    by_id = np.argsort(ids, axis=-1, kind="stable")
    s = np.take_along_axis(scores, by_id, axis=-1)
    i = np.take_along_axis(ids, by_id, axis=-1)
    order = np.argsort(-s, axis=-1, kind="stable")[..., :k]
    return (
        np.take_along_axis(s, order, axis=-1),
        np.take_along_axis(i, order, axis=-1),
    )
