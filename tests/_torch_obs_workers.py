"""Rank processes of the attribution's multi-process tests (gloo, spawned
by ``_torch_dist_worker.spawn``): each rank traces its share of a step on
tensors without storage and saves the collective bytes by kind. Imports
only torch, numpy and the port."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_worker import _init


def comm_worker(rank, world, init_file, out_dir, zi_np, zt_np):
    """Per loss variant: the loss forward and backward on this rank's rows,
    then the DDP average of (t′, bias)'s gradients; and the average alone
    of the rows' gradients (the dp gradient average of a step)."""
    from distributed_sigmoid_loss_tpu_torch.obs.attribution import static_attribution
    from distributed_sigmoid_loss_tpu_torch.parallel.api import (
        average_gradients,
        make_sharded_loss_fn,
    )

    _init(rank, world, init_file)
    try:
        local_b = zi_np.shape[0] // world
        rows = slice(rank * local_b, (rank + 1) * local_b)
        zi, zt = torch.from_numpy(zi_np[rows]), torch.from_numpy(zt_np[rows])
        out = {}
        for variant in ("all_gather", "ring"):
            loss_fn = make_sharded_loss_fn(variant=variant)

            def step(zi, zt):
                zi, zt = zi.clone().requires_grad_(True), zt.clone().requires_grad_(True)
                tp = torch.tensor(float(np.log(10.0)), requires_grad=True)
                bias = torch.tensor(-10.0, requires_grad=True)
                loss_fn({"t_prime": tp, "bias": bias}, zi, zt).backward()
                average_gradients([tp, bias])

            out[variant] = static_attribution(step, zi, zt)

        def grad_average(zi, zt):
            grads = [zi.clone(), zt.clone()]
            params = [torch.zeros_like(g).requires_grad_(True) for g in grads]
            for p, g in zip(params, grads):
                p.grad = g
            average_gradients(params)

        out["grad_average"] = static_attribution(grad_average, zi, zt)
        # Nothing went out: a real collective after the traces still lines up.
        probe = torch.tensor([float(rank)])
        dist.all_reduce(probe)
        out["probe"] = probe
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
