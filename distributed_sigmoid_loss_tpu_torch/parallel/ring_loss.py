"""Ring (neighbour-exchange) distributed sigmoid loss, ported from the JAX
package's ``parallel/ring_loss.py`` (the reference's ``SigLipLoss``,
rwightman_sigmoid_loss.py:12-124).

Each rank computes its positive block, then its text shard travels the ring
while each rank adds the negative-only blocks of the shards it receives:
``(W-1)//2`` paired bidirectional exchanges plus one unidirectional
remainder hop when W is even (``bidir=True``), or ``W-1`` rightward hops.
Hop order and accumulation order are the JAX module's, line for line. The
exchanges are ``torch.distributed`` P2P under autograd
(:mod:`~distributed_sigmoid_loss_tpu_torch.parallel.collectives`): the
gradients of the received shards ride the ring back to their owners.
Every payload that feeds both a block and the next exchange goes through
:func:`~distributed_sigmoid_loss_tpu_torch.parallel.collectives.fork`, so
its gradient sums the block's part first in either hop loop.
"""

from __future__ import annotations

import torch

from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import sigmoid_loss_block
from distributed_sigmoid_loss_tpu_torch.ops.streaming_sigmoid_loss import (
    NEGATIVE_ONLY_OFFSET,
    streaming_block_loss_or_none,
)
from distributed_sigmoid_loss_tpu_torch.parallel.collectives import (
    double_buffered_scan,
    fork,
    neighbour_exchange,
    neighbour_exchange_bidir,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_size, data_axis

__all__ = ["ring_sigmoid_loss"]


def ring_sigmoid_loss(
    zimg: torch.Tensor,
    ztxt: torch.Tensor,
    t_prime: torch.Tensor,
    bias: torch.Tensor,
    *,
    axis_name: str = data_axis,
    group=None,
    bidir: bool = True,
    precision: str = "highest",
    use_pallas: bool = False,
    overlap: bool = False,
    quant: str = "",
) -> torch.Tensor:
    """This rank's loss of the ring variant, normalized by its local batch;
    every rank of ``group`` calls it together.

    ``overlap=True`` issues hop k+1's exchange before hop k's blocks
    (:func:`~distributed_sigmoid_loss_tpu_torch.parallel.collectives.double_buffered_scan`)
    with the accumulation order unchanged, so the overlapped ring is bitwise
    equal to the serial one. ``use_pallas=True`` makes the streaming loss
    kernel (K4-K6; ``quant="int8"``: its int8 mode) every hop's block body
    where the block passes the kernel's dispatch, the plain block at
    ``precision`` elsewhere, as in JAX.
    """
    group = axis_group(axis_name, group)

    def block(ztxt_chunk, negative_only):
        if use_pallas:
            offset = NEGATIVE_ONLY_OFFSET if negative_only else 0
            fused = streaming_block_loss_or_none(zimg, ztxt_chunk, t_prime, bias, offset,
                                                 quant=quant)
            if fused is not None:
                return fused
        return sigmoid_loss_block(zimg, ztxt_chunk, t_prime, bias,
                                  negative_only=negative_only, precision=precision)

    w = axis_size(group)
    if overlap and w > 1:
        return _ring_sigmoid_loss_overlapped(block, ztxt, group, w, bidir)

    if w == 1:
        return block(ztxt, False)
    # Positive (own-shard) block: rwightman_sigmoid_loss.py:69.
    if bidir:
        num_bidir, remainder = divmod(w - 1, 2)
        if num_bidir == 0:
            own, to_right = fork(ztxt)
        else:
            own, to_left, to_right = fork(ztxt, 3)
        loss = block(own, False)
        for hop in range(num_bidir):
            from_right, from_left = neighbour_exchange_bidir(to_left, to_right, group=group)
            if hop + 1 < num_bidir:
                (from_right, from_left), (to_left, to_right) = fork((from_right, from_left))
            elif remainder:
                from_left, to_right = fork(from_left)
            # from_right then from_left: the reference's recv loop,
            # rwightman_sigmoid_loss.py:86-93.
            loss = loss + block(from_right, True) + block(from_left, True)
        if remainder:
            # Even W: one extra unidirectional hop, rwightman_sigmoid_loss.py:96-107.
            from_left = neighbour_exchange(to_right, to_right=True, group=group)
            loss = loss + block(from_left, True)
    else:
        # Unidirectional ring: W-1 rightward hops, rwightman_sigmoid_loss.py:108-122.
        own, to_right = fork(ztxt)
        loss = block(own, False)
        for hop in range(w - 1):
            from_left = neighbour_exchange(to_right, to_right=True, group=group)
            if hop + 1 < w - 1:
                from_left, to_right = fork(from_left)
            loss = loss + block(from_left, True)
    return loss


def _ring_sigmoid_loss_overlapped(block, ztxt, group, w: int, bidir: bool):
    """Double-buffered hop loop: every exchange is issued before the compute
    it can overlap with (hop 1 before the positive block, hop k+1 before hop
    k's blocks, the even-W remainder hop before the last pair's blocks), in
    the serial ring's hop and accumulation order."""
    if bidir:
        num_bidir, remainder = divmod(w - 1, 2)
        if num_bidir == 0:
            # W == 2: the lone remainder hop, issued before the positive block.
            own, to_right = fork(ztxt)
            pending = neighbour_exchange(to_right, to_right=True, group=group, async_op=True)
            loss = block(own, False)
            return loss + block(pending.wait(), True)

        own, to_left, to_right = fork(ztxt, 3)
        first = neighbour_exchange_bidir(to_left, to_right, group=group, async_op=True)
        loss = block(own, False)
        (from_right, from_left), loss = double_buffered_scan(
            lambda pair: neighbour_exchange_bidir(pair[0], pair[1], group=group, async_op=True),
            lambda pair, acc: acc + block(pair[0], True) + block(pair[1], True),
            first,
            loss,
            num_bidir,
        )
        last = None
        if remainder:
            # The serial ring sends its last pair's from_left: the same payload.
            from_left, to_right = fork(from_left)
            last = neighbour_exchange(to_right, to_right=True, group=group, async_op=True)
        loss = loss + block(from_right, True) + block(from_left, True)
        if last is not None:
            loss = loss + block(last.wait(), True)
        return loss

    own, to_right = fork(ztxt)
    first = neighbour_exchange(to_right, to_right=True, group=group, async_op=True)
    loss = block(own, False)
    last, loss = double_buffered_scan(
        lambda cur: neighbour_exchange(cur, to_right=True, group=group, async_op=True),
        lambda cur, acc: acc + block(cur, True),
        first,
        loss,
        w - 1,
    )
    return loss + block(last, True)
