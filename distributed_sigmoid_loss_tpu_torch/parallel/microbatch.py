"""Microbatch split for gradient accumulation, from the JAX package's
``parallel/microbatch.py``.

JAX splits a dp-sharded global batch so that microbatch i takes the i-th
chunk of every device's resident rows. A process here holds only its own
rows, one device's worth, so microbatch i is rows ``[i·c, (i+1)·c)`` of the
local batch, which is the JAX split at one device.
"""

from __future__ import annotations

import torch

__all__ = ["microbatch_split"]


def microbatch_split(x: torch.Tensor, m: int, axis_name: str = "dp",
                     what: str = "microbatches") -> torch.Tensor:
    """``(B, ...) -> (m, B/m, ...)``, a view. ``what`` names the knob in the
    divisibility error (callers pass their flag name, e.g. "accum_steps")."""
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} must divide by mesh {axis_name}=1 x {what}={m}")
    return x.reshape(m, b // m, *x.shape[1:])
