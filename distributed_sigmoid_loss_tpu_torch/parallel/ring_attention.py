"""Dense single-device attention, the core for cross-attention (the MAP
heads) and every f32 tower. Plain PyTorch, as XLA computed it in the JAX
package. Ring (sequence-parallel) attention is not ported yet."""

from __future__ import annotations

import torch

__all__ = ["dense_attention"]

_NEG_INF = -1e30


def dense_attention(q, k, v, *, causal: bool = False, scale: float | None = None):
    """q: (b, s_q, h, dh), k/v: (b, s_k, h, dh) → (b, s_q, h, dh).

    Logits come from an einsum in the input dtype, the softmax runs in f32,
    and the probabilities are cast to ``v.dtype`` for the second einsum.
    """
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
