"""Microbatch split for gradient accumulation, from the JAX package's
``parallel/microbatch.py``.

JAX splits a dp-sharded global batch so that microbatch i takes the i-th
chunk of every device's resident rows (the split is layout-only, no
all-to-all). A process here holds only its own rows, so each rank splits
them itself: microbatch i is rows ``[i·c, (i+1)·c)`` of the local batch.
Over the ranks together that is exactly JAX's dp-interleaved split: rank
r's share of JAX's microbatch i is the i-th chunk of rank r's rows.
:func:`microbatch_merge` is the exact inverse, for callers that need the
rows back in order (the pipeline towers: the loss's positive pairs).
"""

from __future__ import annotations

import torch

from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_size, data_axis

__all__ = ["microbatch_split", "microbatch_merge"]


def microbatch_split(x: torch.Tensor, m: int, axis_name: str = data_axis,
                     what: str = "microbatches") -> torch.Tensor:
    """This rank's ``(B, ...) -> (m, B/m, ...)``, a view. ``what`` names the
    knob in the divisibility error (callers pass their flag name, e.g.
    "accum_steps"), which speaks of the global batch over the ranks of
    ``axis_name`` as JAX's does."""
    b = x.shape[0]
    if b % m:
        w = axis_size(axis_group(axis_name))
        raise ValueError(f"batch {b * w} must divide by mesh {axis_name}={w} x {what}={m}")
    return x.reshape(m, b // m, *x.shape[1:])


def microbatch_merge(y: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`microbatch_split`: ``(m, B/m, ...) -> (B,
    ...)``, the rows in their order before the split."""
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])
