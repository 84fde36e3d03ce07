"""The loss family/variant dispatch and the user-facing sharded loss, ported
from the JAX package's ``parallel/api.py``, over ``torch.distributed``.

JAX hands ``make_sharded_loss_fn`` a mesh and returns the ``pmean`` of the
per-shard losses, whose gradient is already the data-parallel average. Here
each process runs the returned function on its own rows; its gradient is
that of this rank's loss, so, as the reference does under DDP
(test_distributed_sigmoid_loss.py:79-83), the gradients are averaged over
the ranks afterwards with :func:`average_gradients`. A rank's gradient with
respect to its own embeddings is W × JAX's gradient of the ``pmean``'d loss
with respect to those rows; the average over ranks of the parameters'
gradients equals JAX's. The same holds for both families: the sigmoid
(SigLIP) and the softmax (CLIP/InfoNCE, ``parallel/contrastive.py``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Literal

import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.allgather_loss import allgather_sigmoid_loss
from distributed_sigmoid_loss_tpu_torch.parallel.collectives import flat_collective_
from distributed_sigmoid_loss_tpu_torch.parallel.contrastive import (
    allgather_contrastive_loss,
    ring_contrastive_loss,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_size, data_axis
from distributed_sigmoid_loss_tpu_torch.parallel.ring_loss import ring_sigmoid_loss

__all__ = [
    "make_per_shard_loss",
    "make_sharded_loss_fn",
    "average_gradients",
    "all_reduce_mean_",
]


def make_per_shard_loss(
    *,
    family: Literal["sigmoid", "softmax"] = "sigmoid",
    variant: Literal["all_gather", "ring"] = "all_gather",
    axis_name: str = data_axis,
    bidir: bool = True,
    precision: str = "highest",
    use_pallas: bool = False,
    loss_impl: Literal["fused", "chunked"] = "fused",
    ring_overlap: bool = False,
    quant: str = "",
    group=None,
) -> Callable:
    """The family/variant dispatch shared with the JAX package: returns
    ``per_shard(zimg, ztxt, t_prime, bias)``, this rank's loss of its
    (local_b, d) embeddings normalized by the local batch, over ``group``
    (default: the world group; one process without ``torch.distributed``).

    ``use_pallas`` makes the streaming loss kernel (K4-K6) the block body of
    every composition: the fused all-gather block, each chunk of the chunked
    scan, each ring hop. ``family="softmax"`` takes the contrastive pair of
    ``parallel/contrastive.py``; its ``per_shard`` ignores ``bias``, which
    then gets no gradient (InfoNCE has no bias). The JAX refusals of
    flag/variant mismatches are kept word for word. ``quant="int8"`` (with
    ``use_pallas``, sigmoid family) runs the kernel's int8 mode in every
    block its dispatch takes.
    """
    if family not in ("sigmoid", "softmax"):
        raise ValueError(f"unknown family: {family!r}")
    if variant not in ("all_gather", "ring"):
        raise ValueError(f"unknown loss variant: {variant!r}")
    if loss_impl not in ("fused", "chunked"):
        raise ValueError(f"unknown loss_impl: {loss_impl!r}")
    if loss_impl == "chunked" and variant != "all_gather":
        raise ValueError(
            "loss_impl='chunked' applies to the all-gather variant only (the "
            "ring already streams negatives one chunk per hop)"
        )
    if ring_overlap and variant != "ring":
        raise ValueError(
            "ring_overlap applies to the ring variant only (the all-gather "
            "variant has no hop loop to overlap)"
        )
    if family == "softmax" and (loss_impl != "fused" or ring_overlap):
        raise ValueError(
            "loss_impl/ring_overlap apply to the sigmoid family only (the "
            "softmax ring already streams its logsumexp)"
        )
    if quant not in ("", "int8"):
        raise ValueError(f"unknown loss quant: {quant!r}")
    if quant and not use_pallas:
        # Refuse, don't drop: the int8 loss matmul lives in the streaming
        # kernel — without it the flag would silently run full precision.
        raise ValueError(
            "quant='int8' for the loss requires use_pallas (the int8 MXU "
            "block product is the streaming kernel's; the XLA path has none)"
        )
    if quant and family != "sigmoid":
        raise ValueError("loss quant applies to the sigmoid family only")

    if family == "softmax":
        if use_pallas:
            raise ValueError("use_pallas applies to the sigmoid family only")
        fn = {"all_gather": allgather_contrastive_loss, "ring": ring_contrastive_loss}[variant]

        def per_shard(zimg, ztxt, t_prime, bias=None):
            del bias  # InfoNCE has no bias term
            return fn(zimg, ztxt, t_prime, axis_name=axis_name, group=group, precision=precision)

        return per_shard

    if variant == "all_gather":
        return partial(
            allgather_sigmoid_loss,
            axis_name=axis_name, group=group, precision=precision, use_pallas=use_pallas,
            loss_impl=loss_impl, quant=quant,
        )
    return partial(
        ring_sigmoid_loss,
        axis_name=axis_name, group=group, bidir=bidir, precision=precision,
        use_pallas=use_pallas, overlap=ring_overlap, quant=quant,
    )


class _ReportMean(torch.autograd.Function):
    """Value: the mean of ``x`` over the ranks (JAX's ``pmean``); gradient:
    that of this rank's ``x``, passed through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / axis_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_sharded_loss_fn(
    group=None,
    *,
    variant: Literal["all_gather", "ring"] = "all_gather",
    family: Literal["sigmoid", "softmax"] = "sigmoid",
    axis_name: str = data_axis,
    bidir: bool = True,
    precision: str = "highest",
    use_pallas: bool = False,
    loss_impl: Literal["fused", "chunked"] = "fused",
    ring_overlap: bool = False,
    quant: str = "",
) -> Callable:
    """Build ``loss_fn(params, zimg, ztxt) -> scalar``, called by every rank
    of ``group`` on its own (local_b, d) rows; ``params`` holds ``t_prime``
    and ``bias``.

    The returned scalar's value is the mean over the ranks of the per-rank
    losses (JAX's ``pmean``, the same number on every rank); its gradient is
    that of this rank's loss. Average the parameters' gradients over the
    ranks afterwards (:func:`average_gradients`) to get JAX's gradient.
    """
    per_shard = make_per_shard_loss(
        family=family, variant=variant, axis_name=axis_name, bidir=bidir,
        precision=precision, use_pallas=use_pallas, loss_impl=loss_impl,
        ring_overlap=ring_overlap, quant=quant, group=group,
    )
    group = axis_group(axis_name, group)

    def loss_fn(params, zimg, ztxt):
        loss = per_shard(zimg, ztxt, params["t_prime"], params["bias"])
        if axis_size(group) == 1:
            return loss
        return _ReportMean.apply(loss, group)

    return loss_fn


def all_reduce_mean_(tensors, group=None) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    ``all_reduce(SUM)`` over a flat buffer per dtype, then ``/ W``. A no-op
    at world size 1."""
    group = axis_group(data_axis, group)
    w = axis_size(group)
    if w == 1:
        return

    def mean_(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= w

    flat_collective_(tensors, mean_)


@torch.no_grad()
def average_gradients(params, group=None) -> None:
    """DDP's gradient averaging: each parameter's ``.grad`` becomes its mean
    over the ranks (``all_reduce(SUM) / W``), issued as one collective per
    dtype over a flat buffer, not one per tensor."""
    all_reduce_mean_([p.grad for p in params if p.grad is not None], group)
