"""Cross-replica update sharding, ported from the JAX package's
``parallel/update_shard.py`` (Xu et al., arXiv:2004.13336): the gradient →
optimizer → new-parameter path on 1/W of each tensor per replica of the
data axis.

Three modes (``UPDATE_SHARDING_MODES``):

- ``"off"``: the replicated update of plain data parallelism.
- ``"zero1"``: the optimizer's moments of a parameter whose leading dim
  divides by W (``shape[0] % W == 0``) live as this rank's block of rows;
  gradients are averaged whole, and each rank updates its rows and
  publishes them (one all-gather).
- ``"full"``: every parameter with ``shape[0] >= W`` is sharded: its
  gradient is reduce-scattered (rows zero-padded to a multiple of W,
  :func:`psum_scatter_shard`), the optimizer runs on this rank's rows only,
  and one all-gather publishes the parameters.

JAX places these with sharding constraints and lets GSPMD emit the
collectives; here :class:`UpdateLayout` issues them, one collective per
dtype over flat buffers. The rule is JAX's (:func:`shardable`), applied to
the port's tensors: a linear layer's weight is (out, in), the transpose of
a flax kernel, and the port keeps one tensor per layer where JAX stacks
them under ``scan_layers``, so which rows shard differs from JAX's leaves;
the values do not.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    data_axis,
)

__all__ = [
    "UPDATE_SHARDING_MODES",
    "resolve_update_sharding",
    "shardable",
    "padded_rows",
    "psum_scatter_shard",
    "unpad_like",
    "ef_slot_shape",
    "shard_leaf_sizes",
    "opt_mem_bytes_per_replica",
    "UpdateLayout",
]

UPDATE_SHARDING_MODES = ("off", "zero1", "full")


def resolve_update_sharding(update_sharding: str = "", zero1: bool = False) -> str:
    """The mode from the flag and the deprecated ``zero1`` alias, with the
    JAX package's refusals."""
    if update_sharding in ("", None):
        return "zero1" if zero1 else "off"
    if update_sharding not in UPDATE_SHARDING_MODES:
        raise ValueError(
            f"update_sharding must be one of {UPDATE_SHARDING_MODES}, "
            f"got {update_sharding!r}"
        )
    if zero1 and update_sharding == "off":
        raise ValueError(
            "zero1=True contradicts update_sharding='off' — drop the "
            "deprecated zero1 flag (it is the same lever as "
            "update_sharding='zero1')"
        )
    return update_sharding


def shardable(shape, w: int, mode: str = "full") -> bool:
    """Does a tensor of ``shape`` shard its leading dim over ``w`` ranks?
    zero1: exact divisibility; full: at least one row per rank (the ragged
    tail zero-padded)."""
    if mode == "off" or w <= 1 or not shape:
        return False
    if mode == "zero1":
        return shape[0] >= w and shape[0] % w == 0
    if mode == "full":
        return shape[0] >= w
    raise ValueError(f"unknown update_sharding mode {mode!r}")


def padded_rows(dim0: int, w: int) -> int:
    """``dim0`` rounded up to a multiple of ``w``."""
    return -(-dim0 // w) * w


def _padded(x: torch.Tensor, w: int) -> torch.Tensor:
    pad = padded_rows(x.shape[0], w) - x.shape[0]
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def psum_scatter_shard(x: torch.Tensor, axis_name: str = data_axis, *, group=None):
    """This rank's block of rows of the SUM of ``x`` over the axis, rows
    zero-padded to a multiple of W first (``lax.psum_scatter``, tiled):
    ``(padded_rows / W, ...)``. Callers divide for the mean."""
    group = axis_group(axis_name, group)
    w = axis_size(group)
    x = _padded(x, w).contiguous()
    out = x.new_empty((x.shape[0] // w,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def unpad_like(tensors, refs) -> list[torch.Tensor]:
    """Padded leading dims sliced back to the reference tensors' shapes."""
    return [x[: r.shape[0]] if x.shape != r.shape else x for x, r in zip(tensors, refs)]


def ef_slot_shape(shape, n_slices: int, w: int, mode: str = "off") -> tuple:
    """JAX's global error-feedback slot of a parameter: ``(n_slices,
    *shape)``, or under full sharding ``(n_slices, padded_rows, *rest)``.
    A rank of the port holds its slice's and, under full, its rows':
    ``(padded_rows / W, *rest)``."""
    if shardable(shape, w, mode):
        return (n_slices, padded_rows(shape[0], w)) + tuple(shape[1:])
    return (n_slices,) + tuple(shape)


def shard_leaf_sizes(params, w: int, mode: str = "full") -> list[int]:
    """Elements of each tensor's update-path operand a rank owns: its padded
    1/W block where the tensor shards, else the whole tensor."""
    sizes = []
    for p in params:
        shape = tuple(p.shape)
        if shardable(shape, w, mode):
            sizes.append((padded_rows(shape[0], w) // w) * int(math.prod(shape[1:])))
        else:
            sizes.append(int(math.prod(shape)))
    return sizes


def opt_mem_bytes_per_replica(opt_state) -> int:
    """Bytes of the optimizer state's tensors held by this rank."""
    total = 0
    for field in ("mu", "nu", "v_row", "v_col", "v"):
        for t in getattr(opt_state, field, None) or ():
            total += t.numel() * t.element_size()
    return total


class UpdateLayout:
    """Which of a list of tensors (``shapes``, in parameter order) shard
    under ``mode`` over the data axis, and the collectives that move rows:
    every method is called by every rank of the axis together. ``"full"``
    over an axis of one rank is refused (JAX's refusal)."""

    def __init__(self, shapes, mode: str, axis_name: str = data_axis, group=None):
        self.mode = mode
        self.group = axis_group(axis_name, group)
        self.w, self.rank = axis_size(self.group), axis_index(self.group)
        if mode == "full" and self.w < 2:
            raise ValueError(
                "update_sharding='full' requires a dp axis of size > 1, got "
                f"{axis_name!r}={self.w}"
            )
        self.shapes = [tuple(s) for s in shapes]
        self.sharded = [shardable(s, self.w, mode) for s in self.shapes]

    def rows(self, i: int) -> int:
        return padded_rows(self.shapes[i][0], self.w) // self.w

    def local_shape(self, i: int) -> tuple:
        """Shape of tensor i's part on this rank."""
        if not self.sharded[i]:
            return self.shapes[i]
        return (self.rows(i),) + self.shapes[i][1:]

    def shard(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of tensor i (zero-padded), or ``x`` itself when
        it does not shard."""
        if not self.sharded[i]:
            return x
        n = self.rows(i)
        return _padded(x, self.w)[self.rank * n:(self.rank + 1) * n]

    def _by_dtype(self, items):
        out: dict[torch.dtype, list] = {}
        for i, t in items:
            out.setdefault(t.dtype, []).append((i, t))
        return out.values()

    @torch.no_grad()
    def gather(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Whole tensors from every rank's parts (sharded ones joined in rank
        order, the padding dropped; the others as they are): one all-gather
        per dtype."""
        out = list(parts)
        if self.w == 1:
            return out
        for group in self._by_dtype([(i, t) for i, t in enumerate(parts) if self.sharded[i]]):
            flat = torch.cat([t.reshape(-1) for _, t in group]).contiguous()
            ranks = [torch.empty_like(flat) for _ in range(self.w)]
            dist.all_gather(ranks, flat, group=self.group)
            off = 0
            for i, t in group:
                n = t.numel()
                full = torch.cat([r[off:off + n].view(t.shape) for r in ranks])
                out[i] = full[: self.shapes[i][0]]
                off += n
        return out

    @torch.no_grad()
    def publish_(self, targets: list[torch.Tensor], parts: list[torch.Tensor]) -> None:
        """Copy the whole tensors gathered from ``parts`` into ``targets``."""
        for t, full in zip(targets, self.gather(parts)):
            t.copy_(full)

    @torch.no_grad()
    def mean_grads(self, grads: list[torch.Tensor], scatter: bool) -> list[torch.Tensor]:
        """The mean over the axis of each gradient: whole (``all_reduce``),
        or with ``scatter`` this rank's rows of a sharded one (one
        ``reduce_scatter_tensor`` per dtype over the padded rows)."""
        from distributed_sigmoid_loss_tpu_torch.parallel.api import all_reduce_mean_

        out = [g.clone() for g in grads]
        whole = [g for i, g in enumerate(out) if not (scatter and self.sharded[i])]
        all_reduce_mean_(whole, self.group)
        if not scatter or self.w == 1:
            return out
        for group in self._by_dtype([(i, g) for i, g in enumerate(grads) if self.sharded[i]]):
            # Rank r's segment: every tensor's r-th block of rows, in order.
            pieces = [[] for _ in range(self.w)]
            for i, g in group:
                for r, block in enumerate(_padded(g, self.w).chunk(self.w)):
                    pieces[r].append(block.reshape(-1))
            flat = torch.cat([torch.cat(p) for p in pieces]).contiguous()
            mine = flat.new_empty(flat.numel() // self.w)
            dist.reduce_scatter_tensor(mine, flat, op=dist.ReduceOp.SUM, group=self.group)
            mine /= self.w
            off = 0
            for i, g in group:
                shape = self.local_shape(i)
                n = math.prod(shape)
                out[i] = mine[off:off + n].view(shape)
                off += n
        return out

    def norm(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole tensors the parts make up (sharded
        parts' squares summed over the axis; padding is zero)."""
        dev = parts[0].device
        sq_sharded = torch.zeros((), dtype=torch.float32, device=dev)
        sq_whole = torch.zeros((), dtype=torch.float32, device=dev)
        for i, t in enumerate(parts):
            sq = t.float().square().sum()
            if self.sharded[i]:
                sq_sharded = sq_sharded + sq
            else:
                sq_whole = sq_whole + sq
        if self.w > 1 and any(self.sharded):
            dist.all_reduce(sq_sharded, op=dist.ReduceOp.SUM, group=self.group)
        return torch.sqrt(sq_sharded + sq_whole)
