"""Distributed softmax (CLIP/InfoNCE) contrastive loss over
``torch.distributed``, ported from the JAX package's
``parallel/contrastive.py``: the same two communication patterns as the
sigmoid pair.

- :func:`allgather_contrastive_loss`: gather both modalities (backward: a
  reduce-scatter) and score one (local_b, W·local_b) block per direction,
  open_clip's ``ClipLoss(gather_with_grad=True)``.
- :func:`ring_contrastive_loss`: both modalities' blocks travel the ring
  (backward: the reverse exchange) while each rank keeps a running
  (rowmax, sumexp) pair per local row, the online-softmax recurrence of ring
  attention applied to the loss normalizer. Exact, with O(local_b²) logits
  live instead of the all-gather's O(W·local_b²).

Each returns this rank's loss, the mean over its local rows of both
directions; the mean over ranks is the global loss (every rank owns local_b
rows of each direction). As for the sigmoid loss (``parallel/api.py``), a
caller averages the parameters' gradients over the ranks afterwards. The
logits are f32 before the logsumexp, whatever the embeddings' dtype.
"""

from __future__ import annotations

import torch

from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import scaled_products
from distributed_sigmoid_loss_tpu_torch.parallel.collectives import all_gather, ring_shift_right
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    data_axis,
)

__all__ = ["allgather_contrastive_loss", "ring_contrastive_loss"]


def _logits(a, b, t_prime, precision):
    return scaled_products(a, b, t_prime, precision=precision).float()


def allgather_contrastive_loss(zimg, ztxt, t_prime, *, axis_name: str = data_axis, group=None,
                               precision: str = "highest"):
    """This rank's symmetric InfoNCE with all-gathered negatives: i2t rows
    are its images against every text, t2i rows its texts against every
    image; the positives sit at global column ``rank·local_b + row``."""
    group = axis_group(axis_name, group)
    local_b, d = zimg.shape
    w, idx = axis_size(group), axis_index(group)
    all_img = all_gather(zimg, group=group).reshape(w * local_b, d)
    all_txt = all_gather(ztxt, group=group).reshape(w * local_b, d)
    rows = torch.arange(local_b, device=zimg.device)
    pos_col = idx * local_b + rows

    i2t_logits = _logits(zimg, all_txt, t_prime, precision)
    i2t = torch.logsumexp(i2t_logits, dim=1) - i2t_logits[rows, pos_col]
    t2i_logits = _logits(ztxt, all_img, t_prime, precision)
    t2i = torch.logsumexp(t2i_logits, dim=1) - t2i_logits[rows, pos_col]
    return (i2t.mean() + t2i.mean()) / 2


def _row_stats(logits):
    m = torch.amax(logits, dim=1)
    return m, torch.exp(logits - m[:, None]).sum(dim=1)


def _merge(m, s, bm, bs):
    m_new = torch.maximum(m, bm)
    return m_new, s * torch.exp(m - m_new) + bs * torch.exp(bm - m_new)


def ring_contrastive_loss(zimg, ztxt, t_prime, *, axis_name: str = data_axis, group=None,
                          precision: str = "highest"):
    """This rank's symmetric InfoNCE with ring-streamed negatives (exact).

    Hop 0 scores the local (n, n) block, whose transpose serves the t2i
    direction and whose diagonal holds the positives; each of the W−1 hops
    shifts both modalities' blocks one rank right and merges their row
    statistics with ``m' = max(m, rowmax); s' = s·e^{m−m'} + Σe^{logits−m'}``,
    as the JAX scan does."""
    group = axis_group(axis_name, group)
    logits0 = _logits(zimg, ztxt, t_prime, precision)
    m_i, s_i = _row_stats(logits0)
    m_t, s_t = _row_stats(logits0.T)
    pos = torch.diagonal(logits0)
    img_blk, txt_blk = zimg, ztxt
    for _ in range(axis_size(group) - 1):
        img_blk = ring_shift_right(img_blk, group=group)
        txt_blk = ring_shift_right(txt_blk, group=group)
        m_i, s_i = _merge(m_i, s_i, *_row_stats(_logits(zimg, txt_blk, t_prime, precision)))
        m_t, s_t = _merge(m_t, s_t, *_row_stats(_logits(ztxt, img_blk, t_prime, precision)))
    i2t = m_i + torch.log(s_i) - pos
    t2i = m_t + torch.log(s_t) - pos
    return (i2t.mean() + t2i.mean()) / 2
