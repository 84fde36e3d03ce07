"""The loss family/variant dispatch of the train step: ``make_per_shard_loss``
from the JAX package's ``parallel/api.py``, at world size 1.

At one process both variants of the sigmoid family are the positive block
alone: the ring's first block before any hop (JAX ``ring_loss.py:100-104``),
the all-gather's single chunk. The world-size > 1 paths (neighbour exchanges,
the all-gather with its reduce-scatter backward), the streaming loss kernels
(K4-K6) and the softmax family are not ported: they raise, naming their
ROADMAP rows.
"""

from __future__ import annotations

from typing import Callable, Literal

import torch

from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import (
    LOSS_KERNELS_ROADMAP_ROW,
    sigmoid_loss_block,
    sigmoid_loss_chunk_scan,
)

__all__ = ["make_per_shard_loss", "world_size", "DISTRIBUTED_ROADMAP_ROW"]

DISTRIBUTED_ROADMAP_ROW = (
    "ROADMAP.md queue A item 3 (the reference capability over "
    "torch.distributed: parallel/collectives.py, ring_loss.py and "
    "allgather_loss.py at W > 1, DDP gradient averaging)"
)
SOFTMAX_ROADMAP_ROW = (
    "ROADMAP.md queue A item 3 (ops/softmax_loss.py and parallel/contrastive.py)"
)


def world_size() -> int:
    """Processes in the default ``torch.distributed`` group (1 when it is
    not initialised)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_per_shard_loss(
    *,
    family: Literal["sigmoid", "softmax"] = "sigmoid",
    variant: Literal["all_gather", "ring"] = "all_gather",
    axis_name: str = "dp",
    bidir: bool = True,
    precision: str = "highest",
    use_pallas: bool = False,
    loss_impl: Literal["fused", "chunked"] = "fused",
    ring_overlap: bool = False,
    quant: str = "",
) -> Callable:
    """The family/variant dispatch shared with the JAX package: returns
    ``per_shard(zimg, ztxt, t_prime, bias)``, the loss of this process's
    (local_b, d) embeddings normalized by the local batch. The JAX refusals
    of flag/variant mismatches are kept word for word; paths not ported
    raise ``NotImplementedError`` naming their ROADMAP rows, here for the
    softmax family and the streaming kernels, and at call time when
    ``torch.distributed`` runs more than one process.
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
        raise NotImplementedError(
            f"the softmax (CLIP/InfoNCE) loss family is not ported yet: {SOFTMAX_ROADMAP_ROW}"
        )
    if use_pallas:
        raise NotImplementedError(
            f"use_pallas: the streaming loss kernels are not ported yet: {LOSS_KERNELS_ROADMAP_ROW}"
        )

    def per_shard(zimg, ztxt, t_prime, bias):
        w = world_size()
        if w > 1:
            raise NotImplementedError(
                f"the {variant} sigmoid loss at world size {w} is not ported yet: "
                f"{DISTRIBUTED_ROADMAP_ROW}"
            )
        if loss_impl == "chunked":
            return sigmoid_loss_chunk_scan(zimg, ztxt[None], t_prime, bias, positive_chunk=0,
                                           precision=precision)
        return sigmoid_loss_block(zimg, ztxt, t_prime, bias, negative_only=False,
                                  precision=precision)

    return per_shard
