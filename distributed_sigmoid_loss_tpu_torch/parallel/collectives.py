"""Differentiable ring and gather communication over ``torch.distributed``,
ported from the JAX package's ``parallel/collectives.py``.

JAX's ``ppermute`` is a batched send/receive whose transpose is the inverse
permutation; here each exchange is a ``torch.autograd.Function`` over
``torch.distributed.batch_isend_irecv`` whose backward runs the exchange in
reverse, as the reference's ``NeighbourExchange.backward`` and
``NeighbourExchangeBidir.backward`` do (distributed_utils.py:74-77, 94-98).
The all-gather's backward is a reduce-scatter (``lax.all_gather``'s
transpose is ``psum_scatter``): ``reduce_scatter_tensor`` on NCCL, and on
gloo, which has no reduce-scatter, an ``all_reduce`` of which each rank
keeps its own slice.

An exchange with ``async_op=True`` returns a :class:`Pending` at once, with
its transfers in flight; :meth:`Pending.wait` returns the received tensors.
:func:`double_buffered_scan` issues hop k+1 that way before it computes on
hop k. Backward exchanges are synchronous.

Every function takes ``group=`` (default: the world group);
``axis_name`` is kept for signature parity with JAX
(:func:`~distributed_sigmoid_loss_tpu_torch.parallel.mesh.axis_group`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    data_axis,
)

__all__ = [
    "exchange",
    "all_to_all",
    "seq_scatter",
    "seq_gather",
    "ring_shift_right",
    "ring_shift_left",
    "neighbour_exchange",
    "neighbour_exchange_bidir",
    "double_buffered_scan",
    "fork",
    "all_gather",
    "flat_collective_",
    "Pending",
    "ring_perm_problems",
    "validate_ring_perm",
]

# Tags of the two directions, so that at W = 2, where left and right are one
# peer, the leftward and rightward payloads cannot be matched to each other.
_TAG_RIGHT, _TAG_LEFT = 1, 2


def ring_perm_problems(perm, axis_size: int) -> list:
    """Why ``perm`` is NOT a total bijection on an axis of ``axis_size``.

    A non-bijective permutation drops the payloads nobody receives: the
    broken-ring class, where the loss silently loses negative blocks.
    Returns a list of human-readable problem strings; empty = bijection.
    """
    problems = []
    try:
        pairs = [(int(s), int(d)) for s, d in perm]
    except (TypeError, ValueError):
        return [f"perm is not a sequence of (src, dst) pairs: {perm!r}"]
    oob = [p for p in pairs if not (0 <= p[0] < axis_size and 0 <= p[1] < axis_size)]
    if oob:
        problems.append(f"pairs out of range [0, {axis_size}): {oob}")
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    dup_src = sorted({s for s in srcs if srcs.count(s) > 1})
    dup_dst = sorted({d for d in dsts if dsts.count(d) > 1})
    if dup_src:
        problems.append(f"duplicate source shard(s) {dup_src} (send twice)")
    if dup_dst:
        problems.append(
            f"duplicate destination shard(s) {dup_dst} (collide; the shards "
            "nobody sends to receive ZEROS)"
        )
    if not problems and len(pairs) != axis_size:
        missing = sorted(set(range(axis_size)) - set(srcs))
        problems.append(
            f"partial permutation: only {len(pairs)}/{axis_size} shards "
            f"send (shard(s) {missing} drop their payload and their "
            "neighbors receive zeros)"
        )
    return problems


def validate_ring_perm(perm, axis_size: int, axis_name) -> None:
    """Raise a clear error naming the axis and size when ``perm`` is not a
    total bijection."""
    problems = ring_perm_problems(perm, axis_size)
    if problems:
        raise ValueError(
            f"ppermute permutation over axis {axis_name!r} (size {axis_size}) "
            "is not a bijection: " + "; ".join(problems)
        )


def _ring_perm(world_size: int, shift: int) -> list[tuple[int, int]]:
    return [(i, (i + shift) % world_size) for i in range(world_size)]


class Pending:
    """An exchange in flight: :meth:`wait` finishes its transfers and returns
    what it received (one tensor, or a tuple for the bidirectional form)."""

    def __init__(self, works, result):
        self._works, self._result = list(works), result

    def wait(self):
        for w in self._works:
            w.wait()
        self._works = []
        return self._result


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` in ``group`` (P2P ops take global ranks)."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _start(sends, recvs, group):
    """Issue ``sends`` [(tensor, group rank, tag)] and ``recvs`` [(buffer,
    group rank, tag)] as one batch, in the same order on every rank (all
    sends, then all receives); returns the work handles."""
    ops = [dist.P2POp(dist.isend, t, _peer(group, r), group, tag) for t, r, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, _peer(group, r), group, tag) for t, r, tag in recvs]
    return dist.batch_isend_irecv(ops)


def _exchange(payloads, shifts, group, box=None, axis_name=data_axis):
    """Send ``payloads[i]`` to ``rank + shifts[i]`` and receive one tensor
    of its shape from ``rank − shifts[i]``, for each i; returns the received
    tensors. With ``box`` (a list), the work handles are appended to it and
    the transfers are left in flight. ``axis_name`` names the axis in the
    ring's validation error."""
    w, r = axis_size(group), axis_index(group)
    if w == 1:  # every rank is its own neighbour
        return [p.clone(memory_format=torch.contiguous_format) for p in payloads]
    for s in shifts:
        validate_ring_perm(_ring_perm(w, s), w, axis_name)
    # One tag per payload: two payloads to one peer are never matched to
    # each other's receives.
    tags = [(_TAG_RIGHT if s > 0 else _TAG_LEFT) + 2 * i for i, s in enumerate(shifts)]
    sends = [(p.contiguous(), (r + s) % w, tag) for p, s, tag in zip(payloads, shifts, tags)]
    outs = [torch.empty_like(p, memory_format=torch.contiguous_format) for p in payloads]
    recvs = [(o, (r - s) % w, tag) for o, s, tag in zip(outs, shifts, tags)]
    works = _start(sends, recvs, group)
    if box is None:
        for wk in works:
            wk.wait()
    else:
        box.extend(works)
    return outs


class _RingShift(torch.autograd.Function):
    """Every rank sends ``x`` to ``rank + shift`` and receives from ``rank −
    shift``; the backward sends the gradient back the other way."""

    @staticmethod
    def forward(ctx, x, shift: int, group, box, axis_name):
        ctx.shift, ctx.group, ctx.axis_name = shift, group, axis_name
        return _exchange([x], [shift], group, box, axis_name)[0]

    @staticmethod
    def backward(ctx, g):
        return (_exchange([g], [-ctx.shift], ctx.group, axis_name=ctx.axis_name)[0],
                None, None, None, None)


class _BidirExchange(torch.autograd.Function):
    """``to_left`` goes to rank − 1 and ``to_right`` to rank + 1, in one
    batch; returns ``(from_right, from_left)``. The backward is the mirrored
    exchange: each received gradient goes back where its payload came
    from."""

    @staticmethod
    def forward(ctx, to_left, to_right, group, box, axis_name):
        ctx.group, ctx.axis_name = group, axis_name
        from_left, from_right = _exchange([to_right, to_left], [1, -1], group, box, axis_name)
        return from_right, from_left

    @staticmethod
    def backward(ctx, g_from_right, g_from_left):
        # g_from_right came from the right neighbour's to_left: it goes back
        # right; g_from_left goes back left.
        d_to_left, d_to_right = _exchange([g_from_right, g_from_left], [1, -1], ctx.group,
                                          axis_name=ctx.axis_name)
        return d_to_left, d_to_right, None, None, None


def _shift(x, shift: int, group, async_op: bool, axis_name=data_axis):
    box = [] if async_op else None
    out = _RingShift.apply(x, shift, group, box, axis_name)
    return Pending(box, out) if async_op else out


def ring_shift_right(x: torch.Tensor, axis_name: str = data_axis, *, group=None,
                     async_op: bool = False):
    """Every rank sends ``x`` to its right neighbour ``(i+1) % W`` and returns
    what it received from its left one. Differentiable: the backward is a
    left shift (``NeighbourExchange.backward``)."""
    return _shift(x, +1, axis_group(axis_name, group), async_op, axis_name)


def ring_shift_left(x: torch.Tensor, axis_name: str = data_axis, *, group=None,
                    async_op: bool = False):
    """Mirror of :func:`ring_shift_right`: send to ``(i-1) % W``, receive
    from the right neighbour."""
    return _shift(x, -1, axis_group(axis_name, group), async_op, axis_name)


def neighbour_exchange(x: torch.Tensor, axis_name: str = data_axis, *, to_right: bool = True,
                       group=None, async_op: bool = False):
    """One unidirectional ring hop (reference ``neighbour_exchange_with_grad``,
    distributed_utils.py:80-81)."""
    fn = ring_shift_right if to_right else ring_shift_left
    return fn(x, axis_name, group=group, async_op=async_op)


def neighbour_exchange_bidir(to_left: torch.Tensor, to_right: torch.Tensor,
                             axis_name: str = data_axis, *, group=None, async_op: bool = False):
    """Exchange with both neighbours at once; returns ``(from_right,
    from_left)`` (reference ``neighbour_exchange_bidir_with_grad``,
    distributed_utils.py:30-62, 101-106). The four transfers go out as one
    ``batch_isend_irecv``, in the same order on every rank."""
    group = axis_group(axis_name, group)
    box = [] if async_op else None
    out = _BidirExchange.apply(to_left, to_right, group, box, axis_name)
    return Pending(box, out) if async_op else out


class _Fork(torch.autograd.Function):
    """``n`` aliases of ``x`` whose gradients are summed in alias order."""

    @staticmethod
    def forward(ctx, x, n: int):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        for g in grads[1:]:
            total = total + g
        return total, None


def fork(x, n: int = 2):
    """``n`` aliases of ``x`` (or of each tensor of a tuple) for ``n``
    consumers, whose gradients are summed in the order of the aliases.

    Autograd sums a tensor's gradient contributions in the order its
    consumers' backward nodes run, which follows the order they were
    created; the overlapped ring issues each exchange before the blocks that
    the serial ring computes first. Forking every payload with a block and
    an exchange as consumers (the block's alias first) fixes that sum's
    order, so the two rings' gradients are bitwise equal."""
    if isinstance(x, tuple):
        return tuple(zip(*(_Fork.apply(t, n) for t in x)))
    return _Fork.apply(x, n)


def double_buffered_scan(issue, consume, first: Pending, acc, n_hops: int):
    """The ring loop with each transfer hidden behind the previous hop's
    compute: hop k+1 is issued before hop k is consumed.

    ``issue(payload) -> Pending`` starts the next exchange from a received
    payload; ``consume(payload, acc) -> acc`` is hop k's compute; ``first``
    is hop 1's exchange, already issued by the caller (before its own local
    compute). Each hop's transfer is waited on when its payload is first
    needed. Returns ``(last_payload, acc)``: hop ``n_hops``'s payload,
    received but not consumed, for the caller's epilogue. The accumulation
    order is the serial loop's, and each payload goes through :func:`fork`
    between its compute and its next exchange, so results are bitwise equal
    to a serial loop that forks alike.
    """
    if n_hops < 1:
        raise ValueError(f"n_hops must be >= 1, got {n_hops}")
    pending = first
    for _ in range(n_hops - 1):
        cur, nxt = fork(pending.wait())
        pending = issue(nxt)  # hop k+1 on the wire ...
        acc = consume(cur, acc)  # ... while hop k computes
    return pending.wait(), acc


class _AllGather(torch.autograd.Function):
    """(local_b, ...) -> (W, local_b, ...) stacked in rank order; the
    backward is a reduce-scatter (sum) of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if dist.get_backend(ctx.group) == "nccl":
            out = torch.empty_like(g[0])
            dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=ctx.group)
            return out, None
        g = g.clone()  # all_reduce works in place; the incoming gradient is not ours
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[axis_index(ctx.group)].clone(), None


@torch.no_grad()
def flat_collective_(tensors, op) -> None:
    """Run the in-place collective ``op(flat)`` once per dtype over a flat
    buffer of ``tensors`` and copy the result back into them: one collective
    for the 429 tensors of SigLIP-B/16, not one per tensor."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather(x: torch.Tensor, axis_name: str = data_axis, *, group=None) -> torch.Tensor:
    """``lax.all_gather``: (local_b, ...) -> (W, local_b, ...) in rank order,
    differentiable with a reduce-scatter backward. At world size 1 it is
    ``x[None]``."""
    group = axis_group(axis_name, group)
    if axis_size(group) == 1:
        return x[None]
    return _AllGather.apply(x, group)


class _Exchange(torch.autograd.Function):
    """:func:`exchange`: each payload goes ``shift`` ranks on; the backward
    sends each gradient back the way its payload came, in one batch."""

    @staticmethod
    def forward(ctx, shifts, group, axis_name, *payloads):
        ctx.shifts, ctx.group, ctx.axis_name = shifts, group, axis_name
        return tuple(_exchange(list(payloads), list(shifts), group, axis_name=axis_name))

    @staticmethod
    def backward(ctx, *grads):
        back = _exchange(list(grads), [-s for s in ctx.shifts], ctx.group,
                         axis_name=ctx.axis_name)
        return (None, None, None, *back)


def exchange(payloads, shifts, axis_name: str = data_axis, *, group=None) -> tuple:
    """Send ``payloads[i]`` ``shifts[i]`` ranks on along the axis and
    receive its counterpart from ``shifts[i]`` ranks back, all in one
    ``batch_isend_irecv``; differentiable (the backward is one batch the
    other way). Ring attention shifts K and V together this way."""
    group = axis_group(axis_name, group)
    return _Exchange.apply(tuple(shifts), group, axis_name, *payloads)


def _all_to_all(x, split_axis: int, concat_axis: int, group):
    w = axis_size(group)
    inp = torch.stack(x.chunk(w, dim=split_axis)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis: int, concat_axis: int, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g.contiguous(), concat_axis, split_axis, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, axis_name: str = data_axis, *, split_axis: int,
               concat_axis: int, group=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis_name, split_axis, concat_axis, tiled=True)``:
    ``x`` is cut into W pieces along ``split_axis``, piece j goes to rank j,
    and the pieces received are joined along ``concat_axis`` in rank order.
    Differentiable: the backward is the reverse all-to-all. The identity at
    axis size 1."""
    group = axis_group(axis_name, group)
    w = axis_size(group)
    if w == 1:
        return x
    if x.shape[split_axis] % w:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not divide "
                         f"by the {w} ranks of axis {axis_name!r}")
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def _gather_blocks(x, dim: int, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _own_block(x, dim: int, group):
    return x.chunk(axis_size(group), dim=dim)[axis_index(group)].contiguous()


class _SeqScatter(torch.autograd.Function):
    """Replicated (b, S, ...) -> this rank's (b, S/W, ...) block; the
    backward gathers every rank's cotangent block (no sum: each block of
    the input feeds one rank)."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return _own_block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.dim, ctx.group), None, None


class _SeqGather(torch.autograd.Function):
    """This rank's block -> the replicated whole, in rank order; the
    backward keeps this rank's block of the (replicated) cotangent. A plain
    all-gather's backward sums the ranks' cotangents, which would count a
    replicated computation's gradient W times."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return _gather_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.dim, ctx.group), None, None


def seq_scatter(x: torch.Tensor, axis_name: str, *, dim: int = 1, group=None) -> torch.Tensor:
    """Enter a sequence-parallel region: this rank's block of ``x`` along
    ``dim``, where ``x`` is the same on every rank of the axis. The
    counterpart of ``shard_map``'s ``P(None, axis)`` in_spec."""
    group = axis_group(axis_name, group)
    w = axis_size(group)
    if w == 1:
        return x
    if x.shape[dim] % w:
        raise ValueError(f"sequence length {x.shape[dim]} does not divide by the {w} ranks of "
                         f"axis {axis_name!r}")
    return _SeqScatter.apply(x, dim, group)


def seq_gather(x: torch.Tensor, axis_name: str, *, dim: int = 1, group=None) -> torch.Tensor:
    """Leave a sequence-parallel region: the blocks of every rank joined
    along ``dim`` (``shard_map``'s ``P(None, axis)`` out_spec)."""
    group = axis_group(axis_name, group)
    if axis_size(group) == 1:
        return x
    return _SeqGather.apply(x, dim, group)
