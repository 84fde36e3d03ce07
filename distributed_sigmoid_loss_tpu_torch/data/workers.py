"""Host worker-count resolution for the input pipeline (the port's copy of
the JAX package's ``data/workers.py``).

One resolver for every host-side thread pool: the worker count follows
from what the host has, instead of a static default. The train loop always
runs a prefetch thread and the main (dispatch) thread beside the pool, so
those cores are reserved. Standard library only.
"""

from __future__ import annotations

import os
import warnings

__all__ = ["RESERVED_HOST_THREADS", "default_data_workers", "resolve_data_workers"]

# Threads the train loop keeps busy outside the data worker pool: the
# data.loader.prefetch producer and the main thread (step dispatch).
RESERVED_HOST_THREADS = 2


def default_data_workers(reserve: int = RESERVED_HOST_THREADS) -> int:
    """Worker threads for host data work: ``cpu_count - reserve``, min 1.
    ``DSL_DATA_WORKERS`` overrides."""
    env = os.environ.get("DSL_DATA_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            warnings.warn(f"DSL_DATA_WORKERS={env!r} is not an int; ignoring")
    return max(1, (os.cpu_count() or 1) - reserve)


def resolve_data_workers(requested: int | None) -> int:
    """``--data-workers`` resolution: 0/None = auto-derive, else the explicit
    positive value. The resolved number is what records carry: a record that
    says "auto" is not reproducible on another host."""
    if requested:
        if requested < 0:
            raise ValueError(f"data workers must be >= 1, got {requested}")
        return requested
    return default_data_workers()
