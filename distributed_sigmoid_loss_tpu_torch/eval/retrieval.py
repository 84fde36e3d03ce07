"""Image↔text retrieval metrics (recall@K), the standard SigLIP eval, and
the exact top-k ranking contract shared by offline eval and serving.

Ranks are exact: the count of texts scoring strictly higher than the
positive, read out of the same similarity product (ties resolve
optimistically; identical embeddings give recall@1 = 1). With more than one
rank, each ranks its own rows against the gathered texts, as the JAX
package's ``_sharded_ranks`` does, and the recalls are means over the global
batch. ``topk_ids`` / ``merge_topk`` are host numpy: the stable sort that
pins the tie order runs on materialized scores.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.collectives import all_gather
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_index, axis_size, batch_group

__all__ = ["topk_ids", "merge_topk", "retrieval_ranks", "recall_at_k", "retrieval_metrics",
           "global_mean"]


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


def retrieval_ranks(zimg: torch.Tensor, ztxt: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of each row's positive: ``ranks[i]`` is the number of
    texts scoring strictly higher than text ``i`` against image ``i``, over
    L2-normalized (N, d) rows on one device."""
    sims = zimg @ ztxt.T
    pos = torch.diagonal(sims)
    return torch.sum(sims > pos[:, None], dim=-1)


def recall_at_k(ranks: torch.Tensor, k: int) -> torch.Tensor:
    return torch.mean((ranks < k).float())


def _sharded_ranks(zimg: torch.Tensor, ztxt: torch.Tensor) -> torch.Tensor:
    """This rank's ranks of its diagonal positives against every rank's
    texts. Rows shard alike on both sides, so local image row i's positive
    is local text row i of this rank's own block, read out of the product."""
    group = batch_group()
    all_txt = all_gather(ztxt, group=group)  # (W, b_local, d)
    sims = torch.einsum("id,wjd->iwj", zimg, all_txt)  # (b_local, W, b_local)
    pos = torch.diagonal(sims[:, axis_index(group)])
    return torch.sum(sims > pos[:, None, None], dim=(1, 2))


def global_mean(values: torch.Tensor) -> torch.Tensor:
    """The mean of ``values`` over every rank's rows (all ranks call it):
    one ``all_reduce`` of the sum and the count. At world size 1 the plain
    mean."""
    group = batch_group()
    if axis_size(group) == 1:
        return torch.mean(values.float())
    both = torch.stack([values.float().sum(), torch.tensor(float(values.numel()),
                                                          device=values.device)])
    dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
    return both[0] / both[1]


@torch.no_grad()
def retrieval_metrics(
    zimg: torch.Tensor,
    ztxt: torch.Tensor,
    ks: tuple[int, ...] = (1, 5, 10),
) -> dict[str, torch.Tensor]:
    """Image→text and text→image recall@K over the global batch, as 0-d
    tensors. Every rank calls it on its own rows; the rows are split over
    the ambient grid's batch axes (the world without a grid); with one part,
    the single-device ranks. (JAX's takes a mesh and its axis name.)"""
    if axis_size(batch_group()) == 1:
        i2t, t2i = retrieval_ranks(zimg, ztxt), retrieval_ranks(ztxt, zimg)
    else:
        i2t, t2i = _sharded_ranks(zimg, ztxt), _sharded_ranks(ztxt, zimg)
    out = {}
    for k in ks:
        out[f"i2t_recall@{k}"] = global_mean(i2t < k)
        out[f"t2i_recall@{k}"] = global_mean(t2i < k)
    return out
