"""Dense attention and ring attention, ported from the JAX package's
``parallel/ring_attention.py``. Plain PyTorch, as XLA computed them there
(neither is a Pallas kernel in JAX).

- :func:`dense_attention` is the core for cross-attention (the MAP heads)
  and every f32 tower.
- :func:`ring_self_attention` is sequence-parallel exact attention: each
  rank of the sequence axis holds a block of Q/K/V; K/V ride the ring W − 1
  hops while the local Q block accumulates the online softmax (o, m, l) in
  f32, so a rank's logits are s_local × s_local per step instead of S × S.
- :func:`sequence_parallel_attention` wraps either sequence-parallel core
  (ring or Ulysses) for global tensors, the towers' entry: each rank takes
  its block of the (replicated) sequence and the blocks are gathered back.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from distributed_sigmoid_loss_tpu_torch.parallel.collectives import (
    exchange,
    seq_gather,
    seq_scatter,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    sequence_axis,
)

__all__ = ["dense_attention", "ring_self_attention", "sequence_parallel_attention",
           "SP_IMPLS"]

_NEG_INF = -1e30

SP_IMPLS = ("ring", "ulysses")


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


def _block_update(o, m, l, q32, k_blk, v_blk, q_pos, k_pos, scale: float, causal: bool):
    """One online-softmax accumulation of q against a (k, v) block (JAX
    ``block_update``): logits in f32, the running max, ``corr = exp(m_old −
    m_new)``, the rescaled sums."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    return o_new, m_new, l_new


def ring_self_attention(q, k, v, *, axis_name: str = sequence_axis, causal: bool = False,
                        scale: float | None = None, checkpoint_steps: bool = True,
                        group=None) -> torch.Tensor:
    """Exact sequence-parallel attention, called by every rank of the axis
    on its own block (JAX ``ring_self_attention``).

    q, k, v: (b, s_local, h, dh), this rank's block of a sequence that is
    the rank-ordered concatenation of the blocks. ``causal`` masks by global
    position (this rank's offset is its index · s_local). K and V shift one
    hop right per step, both in one exchange; the block that arrives at step
    i came from rank (index − i) mod W. ``checkpoint_steps`` recomputes each
    step's block update in the backward instead of keeping its logits; the
    recompute does not communicate (the exchange is outside it).

    Returns (b, s_local, h, dh) in ``q.dtype``.
    """
    group = axis_group(axis_name, group)
    w, idx = axis_size(group), axis_index(group)
    b, s, h, dh = q.shape
    scale = (dh ** -0.5) if scale is None else scale
    q32 = q.float()
    o = torch.zeros((b, h, s, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    pos = torch.arange(s, device=q.device)
    k_blk, v_blk = k, v
    for i in range(w):
        src = (idx - i) % w
        args = (o, m, l, q32, k_blk, v_blk, idx * s + pos, src * s + pos, scale, causal)
        if checkpoint_steps and torch.is_grad_enabled():
            o, m, l = checkpoint(_block_update, *args, use_reentrant=False)
        else:
            o, m, l = _block_update(*args)
        if i + 1 < w:  # JAX shifts once more, unused; the port stops here
            k_blk, v_blk = exchange((k_blk, v_blk), (1, 1), axis_name, group=group)
    out = o / torch.clamp(l[..., None], min=1e-38)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def sequence_parallel_attention(q, k, v, *, impl: str = "ring", axis_name: str = sequence_axis,
                                causal: bool = False, scale: float | None = None,
                                group=None, **kw) -> torch.Tensor:
    """Global (b, S, h, dh) tensors, the same on every rank of the axis,
    through a sequence-parallel core: each rank takes its block of q, k and
    v, runs ``impl`` ("ring" or "ulysses") with the others, and the output
    blocks are gathered back (JAX ``make_ring_attention`` /
    ``make_ulysses_attention``: ``shard_map`` with ``P(None, axis)``).

    Entering takes a block (its backward gathers the cotangent blocks) and
    leaving gathers (its backward keeps this rank's block), so the gradient
    of anything computed the same on every rank from the output reaches the
    inputs once, not W times: every rank's gradient is the global one."""
    if impl == "ring":
        core = ring_self_attention
    elif impl == "ulysses":
        from distributed_sigmoid_loss_tpu_torch.parallel.ulysses_attention import (
            ulysses_self_attention as core,
        )
    else:
        raise ValueError(f"unknown sp_impl: {impl!r} (expected one of {sorted(SP_IMPLS)})")
    group = axis_group(axis_name, group)
    blocks = [seq_scatter(t, axis_name, group=group) for t in (q, k, v)]
    out = core(*blocks, axis_name=axis_name, causal=causal, scale=scale, group=group, **kw)
    return seq_gather(out, axis_name, group=group)
