"""Exponential moving average of the parameters, the weights SigLIP-style
models evaluate with; ported from the JAX package's ``train/ema.py``.

The EMA is a list of tensors beside the parameters, one per parameter, same
shape, dtype and device. The decay warmup ``min(decay, (1+t)/(10+t))`` is the
TF/scenic ramp that keeps the early average from being dominated by the
random init. Where JAX builds a new tree, :func:`update_ema` updates the
list in place.
"""

from __future__ import annotations

import torch

__all__ = ["init_ema", "update_ema", "ema_decay_schedule"]


def init_ema(params) -> list[torch.Tensor]:
    """The EMA state: a detached copy of each parameter."""
    return [p.detach().clone() for p in params]


def ema_decay_schedule(step, decay: float = 0.9999) -> torch.Tensor:
    """Warmed-up decay ``min(decay, (1 + step) / (10 + step))`` as a 0-d f32
    tensor: 0.1 at step 0 rising to ``decay``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    return torch.minimum(torch.tensor(decay, dtype=torch.float32), (1.0 + step) / (10.0 + step))


@torch.no_grad()
def update_ema(ema, params, step=None, decay: float = 0.9999):
    """One EMA update, in place: ``ema = d * ema + (1 - d) * params``, with
    ``d`` from :func:`ema_decay_schedule` when ``step`` is given, else the
    constant ``decay``. The decay is cast to each leaf's dtype, so bf16 EMA
    leaves stay bf16 and compute in bf16, as in JAX. Returns ``ema``."""
    d = ema_decay_schedule(step, decay) if step is not None else torch.tensor(decay, dtype=torch.float64)
    factors = {}  # (dtype, device) -> (d, 1 - d) in that dtype
    for e, p in zip(ema, params):
        key = (e.dtype, e.device)
        if key not in factors:
            df = d.to(device=e.device, dtype=e.dtype)
            factors[key] = (df, torch.ones((), dtype=e.dtype, device=e.device) - df)
        df, rest = factors[key]
        e.mul_(df).add_(rest * p.to(e.dtype))
    return ema
