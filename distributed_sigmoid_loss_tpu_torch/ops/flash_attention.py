"""Where the fused attention kernels may run.

The long-sequence flash kernel (K7 in PERF.md) is not ported yet; only its
availability predicate is, for the towers' dispatch."""

from __future__ import annotations

import torch

__all__ = ["flash_attention_available"]


def flash_attention_available(x: torch.Tensor) -> bool:
    """True when ``x`` lives on a CUDA device, where the hand-written
    attention kernels run."""
    return x.is_cuda
