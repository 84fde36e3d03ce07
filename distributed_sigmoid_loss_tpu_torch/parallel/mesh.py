"""The data axis over ``torch.distributed``: what the port needs of the JAX
package's ``parallel/mesh.py``.

JAX names a mesh axis and lets ``shard_map`` place the collectives; here the
data axis is a process group, the default (world) group unless the caller
passes another, and each process holds its own rows. ``axis_name`` stays in
the signatures for parity with the JAX functions: the one axis name the
port resolves is :data:`data_axis`.
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["data_axis", "axis_group", "axis_index", "axis_size", "is_distributed"]

# The batch / replica axis: the reference's "world" of DDP ranks.
data_axis = "dp"


def is_distributed() -> bool:
    """True when ``torch.distributed`` has a default process group."""
    return dist.is_available() and dist.is_initialized()


def axis_group(axis_name: str = data_axis, group=None):
    """The process group of ``axis_name``: ``group`` when given, else the
    world group (None when ``torch.distributed`` is not initialised: a
    world of one process)."""
    if group is not None:
        return group
    if axis_name != data_axis:
        raise ValueError(
            f"unknown axis {axis_name!r}: the port resolves only the data axis "
            f"{data_axis!r}; pass its process group as group="
        )
    return dist.group.WORLD if is_distributed() else None


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
