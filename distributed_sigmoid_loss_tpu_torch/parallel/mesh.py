"""Named axes over ``torch.distributed``: the port's counterpart of the JAX
package's ``parallel/mesh.py`` and of an ambient ``jax.set_mesh``.

JAX names the axes of a device mesh and lets ``shard_map`` place the
collectives. Here an axis is a process group, and a :class:`ProcessGrid`
lays the world's ranks out row-major over a shape such as ``(dp, sp)`` or
``(dcn, dp)``: every line of ranks along an axis is one group. Entered as a
context manager, the grid is ambient, and :func:`axis_group` resolves any of
its axes by name. Without a grid, the data axis is the world group and a
process without ``torch.distributed`` is a world of one, in which every
axis has one member. Each process holds its own rows.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch.distributed as dist

__all__ = [
    "data_axis", "model_axis", "sequence_axis", "dcn_axis", "pipeline_axis", "expert_axis",
    "ProcessGrid", "current_grid", "axis_group", "axis_index", "axis_size",
    "batch_group", "batch_index", "batch_size", "is_distributed",
]

# Canonical axis names (JAX parallel/mesh.py, train/compressed_step.py).
data_axis = "dp"  # batch / replica axis: the reference's "world" of DDP ranks
model_axis = "tp"  # tensor-parallel axis of the JAX towers (not used by the port)
sequence_axis = "sp"  # sequence-parallel axis of long-context attention
dcn_axis = "dcn"  # the slow cross-slice axis of compressed gradient sync
pipeline_axis = "pp"  # pipeline stages (parallel/pipeline.py)
expert_axis = "ep"  # expert parallelism (models/moe.py)

# The axes a batch's rows are split over; the ranks along any other axis
# (sp, pp, ep) hold the same rows.
_BATCH_AXES = (dcn_axis, data_axis)

# The ambient grids, innermost last. A module-level stack, not a context
# variable: autograd runs backward (and the recompute of checkpointed blocks)
# on threads of its own, which must see the grid too.
_GRIDS: list["ProcessGrid"] = []


def is_distributed() -> bool:
    """True when ``torch.distributed`` has a default process group."""
    return dist.is_available() and dist.is_initialized()


class ProcessGrid:
    """The world's ranks laid out row-major over named axes: with ``axes =
    {"dp": 2, "sp": 2}``, ranks 0 and 1 form the sp group of dp index 0.

    The sizes must multiply to the world size (1 without
    ``torch.distributed``). Every rank builds every group of every axis, in
    the same order, as ``dist.new_group`` requires, and keeps the ones it is
    a member of. ``with grid:`` makes it the ambient grid."""

    def __init__(self, axes: dict[str, int] | Sequence[tuple[str, int]]):
        items = list(axes.items()) if isinstance(axes, dict) else [tuple(a) for a in axes]
        self.names = tuple(n for n, _ in items)
        self.sizes = tuple(int(s) for _, s in items)
        if len(set(self.names)) != len(self.names) or any(s < 1 for s in self.sizes):
            raise ValueError(f"a process grid needs distinct axis names and sizes >= 1, "
                             f"got {items}")
        world = dist.get_world_size() if is_distributed() else 1
        if math.prod(self.sizes) != world:
            raise ValueError(f"process grid {dict(items)} holds {math.prod(self.sizes)} ranks, "
                             f"the world has {world}")
        rank = dist.get_rank() if is_distributed() else 0
        strides = [math.prod(self.sizes[i + 1:]) for i in range(len(self.sizes))]
        self.coords = {n: (rank // st) % s for n, st, s in zip(self.names, strides, self.sizes)}
        self._groups = {}
        for axis, (name, size) in enumerate(zip(self.names, self.sizes)):
            others = [range(s) for i, s in enumerate(self.sizes) if i != axis]
            for fixed in itertools.product(*others):
                ranks = []
                for k in range(size):
                    coord = list(fixed[:axis]) + [k] + list(fixed[axis:])
                    ranks.append(sum(c * st for c, st in zip(coord, strides)))
                group = dist.new_group(ranks) if is_distributed() else None
                if rank in ranks:
                    self._groups[name] = group
        # The batch axes together (dcn × dp), when other axes share the grid.
        batch = [i for i, n in enumerate(self.names) if n in _BATCH_AXES]
        self._batch_group = None
        if len(batch) > 1 and len(batch) < len(self.names):
            others = [range(s) if i not in batch else range(1) for i, s in enumerate(self.sizes)]
            for fixed in itertools.product(*others):
                ranks = []
                for sub in itertools.product(*(range(self.sizes[i]) for i in batch)):
                    coord = list(fixed)
                    for i, k in zip(batch, sub):
                        coord[i] = k
                    ranks.append(sum(c * st for c, st in zip(coord, strides)))
                group = dist.new_group(ranks) if is_distributed() else None
                if rank in ranks:
                    self._batch_group = group

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.sizes))

    def group(self, axis_name):
        """The process group of ``axis_name`` (None in a world of one). A
        tuple of names that covers every axis of the grid is the world."""
        if isinstance(axis_name, (tuple, list)):
            if set(axis_name) == set(self.names):
                return dist.group.WORLD if is_distributed() else None
            if len(axis_name) == 1:
                return self.group(axis_name[0])
            if set(axis_name) == {n for n in self.names if n in _BATCH_AXES}:
                return self._batch_group
            raise ValueError(f"axes {tuple(axis_name)}: the port resolves one axis of the grid "
                             f"{self.shape}, its batch axes together, or all of them together")
        if axis_name not in self._groups:
            raise ValueError(f"unknown axis {axis_name!r}: the process grid has {self.shape}")
        return self._groups[axis_name]

    def __enter__(self) -> "ProcessGrid":
        _GRIDS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _GRIDS.remove(self)


def current_grid() -> ProcessGrid | None:
    """The innermost ambient :class:`ProcessGrid`, or None."""
    return _GRIDS[-1] if _GRIDS else None


def axis_group(axis_name=data_axis, group=None):
    """The process group of ``axis_name``: ``group`` when given, else the
    ambient grid's group of that axis; without a grid, the world group for
    the data axis, and None for any axis in a world of one process."""
    if group is not None:
        return group
    grid = current_grid()
    if grid is not None:
        return grid.group(axis_name)
    if not is_distributed():
        return None
    if axis_name == data_axis or (isinstance(axis_name, (tuple, list))
                                  and tuple(axis_name) == (data_axis,)):
        return dist.group.WORLD
    raise ValueError(
        f"unknown axis {axis_name!r}: no process grid is set, so the port resolves only the "
        f"data axis {data_axis!r} (the world group); enter a ProcessGrid with that axis, or "
        "pass its process group as group="
    )


def axis_size(group=None) -> int:
    """Processes on the axis (``lax.axis_size``): 1 without a process group."""
    if group is None and not is_distributed():
        return 1
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This process's rank on the axis (``lax.axis_index``): 0 without a
    process group."""
    if group is None and not is_distributed():
        return 0
    return dist.get_rank(group)


def _batch_axes(grid: ProcessGrid) -> list[str]:
    return [n for n in grid.names if n in _BATCH_AXES]


def batch_group():
    """The process group over which a global batch's rows are split: the
    ambient grid's batch axes (dcn, dp) together, else the world (None in a
    world of one)."""
    grid = current_grid()
    if grid is None:
        return dist.group.WORLD if is_distributed() else None
    return grid.group(tuple(_batch_axes(grid)))


def batch_size() -> int:
    """How many parts a global batch's rows are split into: the product of
    the ambient grid's batch axes (dcn, dp), else the world size."""
    grid = current_grid()
    if grid is None:
        return axis_size()
    return math.prod(grid.shape[n] for n in _batch_axes(grid))


def batch_index() -> int:
    """This rank's part of a global batch: its row-major index over the
    grid's batch axes (ranks along sp share one), else its world rank."""
    grid = current_grid()
    if grid is None:
        return axis_index()
    index = 0
    for n in _batch_axes(grid):
        index = index * grid.shape[n] + grid.coords[n]
    return index
