"""Multi-process start-up, ported from the JAX package's
``parallel/multihost.py``.

JAX's ``jax.distributed.initialize`` joins the processes of a job through a
coordinator, after which every process sees every device. Here the job is a
``torch.distributed`` process group, joined through a TCP rendezvous at the
coordinator's address (``tcp://host:port``), or through ``env://`` when the
launcher (``torchrun``) set ``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK``.
The backend follows the device: NCCL for CUDA, gloo on the CPU. Each
process then holds its own rows and the commands lay the ranks out on a
``parallel.mesh.ProcessGrid``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    ProcessGrid,
    axis_group,
    axis_size,
    current_grid,
    data_axis,
    dcn_axis,
    is_distributed,
)

__all__ = ["initialize_multihost", "make_hybrid_mesh", "global_batch_for", "backend_for"]

# Set by a launcher: then a failed start must not fall back to one process,
# which would turn an N-process job into N separate trainings.
_LAUNCHER_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def backend_for(device) -> str:
    """The process group's backend for ``device``: NCCL on CUDA, gloo on the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         *, device="cuda") -> tuple[int, int]:
    """Join the job's processes; returns ``(process_index, process_count)``.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``, the processes meet at a TCP rendezvous there, and errors
    propagate. Without them, a launcher's ``env://`` variables are used when
    all are set; with none set it is the one-process no-op. An already
    initialized group is returned as it is, unless the arguments ask for
    another identity. On CUDA each process takes device ``process_index %
    device_count``."""
    explicit = coordinator_address is not None
    if explicit and (num_processes is None or process_id is None):
        raise ValueError("coordinator_address needs num_processes and process_id")
    if is_distributed():
        rank, world = dist.get_rank(), dist.get_world_size()
        if explicit and (rank, world) != (process_id, num_processes):
            raise RuntimeError(
                f"initialize_multihost: already initialized as process {rank} of {world}, "
                f"asked for {process_id} of {num_processes}"
            )
        return rank, world
    backend = backend_for(device)
    if explicit:
        init, rank, world = f"tcp://{coordinator_address}", process_id, num_processes
    else:
        present = [v for v in _LAUNCHER_ENV_VARS if os.environ.get(v)]
        if not present:
            return 0, 1
        if len(present) != len(_LAUNCHER_ENV_VARS):
            missing = sorted(set(_LAUNCHER_ENV_VARS) - set(present))
            raise RuntimeError(
                f"initialize_multihost: {', '.join(present)} set but {', '.join(missing)} "
                "not: one process of a multi-process job would train alone; set them all, "
                "or pass coordinator_address/num_processes/process_id"
            )
        init, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    return rank, world


def make_hybrid_mesh(dp_dcn: int | None = None, dp_ici: int | None = None) -> ProcessGrid:
    """The ``(dcn, dp)`` process grid over the job's processes, the slow
    (cross-host) factor outermost: the ranks ``[i·W/dcn, (i+1)·W/dcn)`` are
    slice i, as under ``--dcn-slices``. ``dp_dcn=None`` takes the number of
    hosts from the launcher's ``LOCAL_WORLD_SIZE`` (processes a host), else
    one slice; ``dp_ici=None`` takes the rest. JAX's ``tp`` factor has no
    counterpart (the port's towers are not tensor-parallel)."""
    world = axis_size()
    if dp_dcn is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
        dp_dcn = max(1, world // local) if world % local == 0 else 1
    if dp_ici is None:
        if world % dp_dcn:
            raise ValueError(f"dp_dcn = {dp_dcn} does not divide process count {world}")
        dp_ici = world // dp_dcn
    if dp_dcn * dp_ici != world:
        raise ValueError(f"dp_dcn*dp_ici = {dp_dcn * dp_ici} != process count {world}")
    return ProcessGrid({dcn_axis: dp_dcn, data_axis: dp_ici})


def global_batch_for(per_chip_batch: int, grid: ProcessGrid | None = None,
                     axis_name: str = data_axis) -> int:
    """Global batch that puts ``per_chip_batch`` examples on each rank of
    ``axis_name`` (of ``grid``, else the ambient grid or the world)."""
    grid = grid if grid is not None else current_grid()
    if grid is not None:
        return per_chip_batch * grid.shape[axis_name]
    return per_chip_batch * axis_size(axis_group(axis_name))
