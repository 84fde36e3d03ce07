"""All-gather distributed sigmoid loss, ported from the JAX package's
``parallel/allgather_loss.py`` (the reference's ``DDPSigmoidLoss``,
distributed_sigmoid_loss.py:8-48).

Each rank gathers every rank's text shard (differentiably: the backward is a
reduce-scatter) and computes its images against all of them, with the
positive diagonal on its own chunk, columns ``rank·local_b + row``. The
summed loss is divided by the local batch, as the reference does (:47).
"""

from __future__ import annotations

import torch

from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import (
    pairwise_logits,
    sigmoid_loss_chunk_scan,
    sigmoid_xent,
)
from distributed_sigmoid_loss_tpu_torch.ops.streaming_sigmoid_loss import (
    streaming_block_loss_or_none,
)
from distributed_sigmoid_loss_tpu_torch.parallel.collectives import all_gather
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    data_axis,
)

__all__ = ["allgather_sigmoid_loss"]


def allgather_sigmoid_loss(
    zimg: torch.Tensor,
    ztxt: torch.Tensor,
    t_prime: torch.Tensor,
    bias: torch.Tensor,
    *,
    axis_name: str = data_axis,
    group=None,
    precision: str = "highest",
    use_pallas: bool = False,
    loss_impl: str = "fused",
    quant: str = "",
) -> torch.Tensor:
    """This rank's loss of the all-gather variant; every rank of ``group``
    calls it together.

    ``loss_impl="fused"`` computes one (local_b × W·local_b) block;
    ``"chunked"`` runs :func:`sigmoid_loss_chunk_scan` over the W gathered
    chunks, the positive diagonal on chunk ``rank``, so only one
    (local_b × local_b) block is live at a time. ``use_pallas`` makes the
    streaming loss kernel (K4-K6, or its int8 mode under ``quant="int8"``)
    the block body of either: the fused block at offset ``rank·local_b``, or
    each chunk; a block its dispatch refuses takes the plain path at
    ``precision``, as in JAX.
    """
    group = axis_group(axis_name, group)
    local_b, d = zimg.shape
    w, idx = axis_size(group), axis_index(group)
    gathered = all_gather(ztxt, group=group)  # (W, local_b, d) in rank order

    if loss_impl == "chunked":
        return sigmoid_loss_chunk_scan(zimg, gathered, t_prime, bias, positive_chunk=idx,
                                       precision=precision, use_pallas=use_pallas, quant=quant)
    if loss_impl != "fused":
        raise ValueError(f"unknown loss_impl: {loss_impl!r}")

    all_txt = gathered.reshape(w * local_b, d)
    if use_pallas:
        fused = streaming_block_loss_or_none(zimg, all_txt, t_prime, bias, idx * local_b,
                                             quant=quant)
        if fused is not None:
            return fused

    logits = pairwise_logits(zimg, all_txt, t_prime, bias, precision=precision)
    rows = torch.arange(local_b, device=logits.device)[:, None]
    cols = torch.arange(w * local_b, device=logits.device)[None, :]
    labels = torch.where(cols == idx * local_b + rows, 1.0, -1.0).to(logits.dtype)
    return sigmoid_xent(logits, labels).sum() / local_b
