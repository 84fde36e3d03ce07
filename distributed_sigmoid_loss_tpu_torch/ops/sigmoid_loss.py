"""Loss-side pieces the serving path needs: the embedding normalization and
the learnable loss scalars' initial values. The sigmoid loss itself belongs
to training and is not ported yet."""

from __future__ import annotations

import math

import torch

__all__ = ["l2_normalize", "T_PRIME_INIT", "BIAS_INIT"]

# The JAX package's init_loss_params values (the SigLIP paper's Algorithm 1):
# t_prime = log 10, bias = -10.
T_PRIME_INIT = math.log(10.0)
BIAS_INIT = -10.0


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim`` with the norm clamped at ``eps``
    (``torch.nn.functional.normalize`` defaults)."""
    norm = torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)
