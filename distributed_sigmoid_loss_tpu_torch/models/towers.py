"""Toy linear towers: the reference test harness's stand-in encoders.

The port of the JAX package's ``models/towers.py``. Reference:
``nn.Linear(emb_dim, 2, bias=False)`` applied to seeded random inputs. Kept
as a module (:class:`LinearTower`, for train-state plumbing) and a bare
function (:func:`toy_tower_apply`, for parity tests that hand-carry one
weight through both packages).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["LinearTower", "toy_tower_apply"]


def toy_tower_apply(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ Wᵀ`` with the ``nn.Linear`` weight layout (out_dim, in_dim)."""
    return x @ weight.T


class LinearTower(nn.Module):
    """Bias-free linear projection tower, ``nn.Linear(input_dim, output_dim,
    bias=False)`` as ``proj``. JAX's flax module infers ``input_dim`` from
    its first input; here it is given. The weight ``proj.weight`` is the
    transpose of JAX's ``proj/kernel``."""

    def __init__(self, input_dim: int, output_dim: int = 2, *, device=None):
        super().__init__()
        self.proj = nn.Linear(input_dim, output_dim, bias=False, device=device)

    def forward(self, x):
        return self.proj(x)
