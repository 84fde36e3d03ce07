"""Ulysses-style all-to-all sequence parallelism, ported from the JAX
package's ``parallel/ulysses_attention.py``.

One all-to-all re-shards q, k and v from sequence blocks to head slices,
every rank runs exact dense attention over the whole sequence for its heads,
and a second all-to-all restores the sequence blocks: two collectives
instead of W − 1 ring hops, at the cost of ``num_heads % W == 0`` and the
whole sequence's activations for the local heads. Differentiable through
:func:`~distributed_sigmoid_loss_tpu_torch.parallel.collectives.all_to_all`,
whose backward is the reverse all-to-all.
"""

from __future__ import annotations

from distributed_sigmoid_loss_tpu_torch.parallel.collectives import all_to_all
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_size, sequence_axis
from distributed_sigmoid_loss_tpu_torch.parallel.ring_attention import (
    dense_attention,
    sequence_parallel_attention,
)

__all__ = ["ulysses_self_attention", "ulysses_attention"]


def ulysses_self_attention(q, k, v, *, axis_name: str = sequence_axis, causal: bool = False,
                           scale: float | None = None, group=None):
    """Exact sequence-parallel attention by head-scatter / sequence-gather
    all-to-all, called by every rank of the axis on its own (b, s_local, h,
    dh) block (the contract of ``ring_self_attention``). Returns (b,
    s_local, h, dh). Requires ``h % axis_size == 0``."""
    group = axis_group(axis_name, group)
    w, h = axis_size(group), q.shape[2]
    if h % w != 0:
        raise ValueError(f"ulysses requires num_heads ({h}) divisible by axis size ({w})")

    def seq_to_heads(x):  # (b, s_local, h, dh) -> (b, S, h / W, dh)
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1, group=group)

    out = dense_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal,
                          scale=scale)
    return all_to_all(out, axis_name, split_axis=1, concat_axis=2, group=group)


def ulysses_attention(q, k, v, **kw):
    """Global (b, S, h, dh) tensors through :func:`ulysses_self_attention`
    (JAX ``make_ulysses_attention``)."""
    return sequence_parallel_attention(q, k, v, impl="ulysses", **kw)
