"""Rank processes of the port's multi-process tests (gloo, ``mp.spawn``).

Imports only torch, numpy and the port: spawned workers import this module
by name, and the JAX side of each comparison runs in the parent. Each worker
writes its results with ``torch.save`` to ``<out_dir>/rank<r>.pt``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

# Every composition of the sigmoid loss: (name, make_sharded_loss_fn kwargs).
COMPOSITIONS = {
    "allgather_fused": dict(variant="all_gather", loss_impl="fused"),
    "allgather_chunked": dict(variant="all_gather", loss_impl="chunked"),
    "ring_bidir": dict(variant="ring", bidir=True),
    "ring_unidir": dict(variant="ring", bidir=False),
    "ring_bidir_overlap": dict(variant="ring", bidir=True, ring_overlap=True),
    "ring_unidir_overlap": dict(variant="ring", bidir=False, ring_overlap=True),
}


def spawn(fn, world: int, args: tuple, tmp_path, timeout_s: float = 120.0) -> list[dict]:
    """Run ``fn(rank, world, init_file, out_dir, *args)`` in ``world`` spawned
    processes; returns each rank's saved results. A rank that raises fails
    the call; ranks still alive at ``timeout_s`` are killed and the call
    fails, so a hang costs one test, not the suite."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    init_file = os.path.join(out_dir, "rendezvous")
    ctx = mp.start_processes(fn, args=(world, init_file, out_dir, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]


def _init(rank: int, world: int, init_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)


def _tower_pipeline(loss_fn, img, txt, wi_np, wt_np):
    """The parity pipeline (reference test_distributed_sigmoid_loss.py): two
    Linear towers, L2-normalized embeddings, the loss, its backward, and
    DDP gradient averaging. Returns (loss, dwi, dwt, dt', dbias, and this
    rank's unaveraged gradients)."""
    import torch.nn.functional as F

    from distributed_sigmoid_loss_tpu_torch.parallel.api import average_gradients

    wi = torch.tensor(wi_np, requires_grad=True)
    wt = torch.tensor(wt_np, requires_grad=True)
    tp = torch.tensor(float(np.log(10.0)), requires_grad=True)
    bias = torch.tensor(-10.0, requires_grad=True)
    zimg = F.normalize(torch.from_numpy(img) @ wi.T)
    ztxt = F.normalize(torch.from_numpy(txt) @ wt.T)
    loss = loss_fn({"t_prime": tp, "bias": bias}, zimg, ztxt)
    loss.backward()
    params = [wi, wt, tp, bias]
    local = [None if p.grad is None else p.grad.clone() for p in params]
    average_gradients(params)
    return {"loss": loss.detach(), "wi": wi.grad, "wt": wt.grad, "t_prime": tp.grad,
            "bias": bias.grad, "local": local}


def loss_worker(rank, world, init_file, out_dir, img_np, txt_np, wi_np, wt_np):
    """Every composition × use_pallas on this rank's rows; then the ring
    exchanges' and the all-gather's forward and backward on rank-tagged
    payloads."""
    from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl
    from distributed_sigmoid_loss_tpu_torch.parallel import collectives as col
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_sharded_loss_fn

    _init(rank, world, init_file)
    try:
        local_b = img_np.shape[0] // world
        rows = slice(rank * local_b, (rank + 1) * local_b)
        out = {}
        for name, kw in COMPOSITIONS.items():
            for use_pallas in (False, True):
                ssl.reset_traced_loss_kernels()
                loss_fn = make_sharded_loss_fn(use_pallas=use_pallas, **kw)
                res = _tower_pipeline(loss_fn, img_np[rows], txt_np[rows], wi_np, wt_np)
                res["traced"] = list(ssl.traced_loss_kernels())
                out[f"{name}/{int(use_pallas)}"] = res

        # Exchanges: payload = rank-tagged rows, cotangent = another tag.
        x = torch.full((2, 3), float(rank), requires_grad=True)
        y = col.neighbour_exchange(x, to_right=True)
        (y * (10.0 + rank)).sum().backward()
        out["shift_right"] = {"y": y.detach(), "dx": x.grad}
        x = torch.full((2, 3), float(rank), requires_grad=True)
        y = col.ring_shift_left(x)
        (y * (10.0 + rank)).sum().backward()
        out["shift_left"] = {"y": y.detach(), "dx": x.grad}
        tl = torch.full((2,), float(rank), requires_grad=True)
        tr = torch.full((2,), 100.0 + rank, requires_grad=True)
        pending = col.neighbour_exchange_bidir(tl, tr, async_op=True)
        fr, fl = pending.wait()
        ((fr * (10.0 + rank)).sum() + (fl * (1000.0 + rank)).sum()).backward()
        out["bidir"] = {"from_right": fr.detach(), "from_left": fl.detach(),
                        "d_to_left": tl.grad, "d_to_right": tr.grad}
        x = torch.full((2,), float(rank), requires_grad=True)
        gathered = col.all_gather(x)
        weights = torch.arange(world, dtype=torch.float32)[:, None] + 10.0 * rank
        (gathered * weights).sum().backward()
        out["all_gather"] = {"gathered": gathered.detach(), "dx": x.grad}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def contrastive_worker(rank, world, init_file, out_dir, img_np, txt_np, wi_np, wt_np):
    """The softmax (CLIP/InfoNCE) family through the parity pipeline on this
    rank's rows, under both variants."""
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_sharded_loss_fn

    _init(rank, world, init_file)
    try:
        local_b = img_np.shape[0] // world
        rows = slice(rank * local_b, (rank + 1) * local_b)
        out = {variant: _tower_pipeline(make_sharded_loss_fn(variant=variant, family="softmax"),
                                        img_np[rows], txt_np[rows], wi_np, wt_np)
               for variant in ("all_gather", "ring")}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def train_worker(rank, world, init_file, out_dir, state_dict, cfg, batch, train_cfg, steps,
                 accum_steps):
    """``steps`` data-parallel train steps of the port on this rank's rows,
    from ``state_dict`` on rank 0 (the others start from other weights:
    create_train_state must broadcast rank 0's)."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    _init(rank, world, init_file)
    try:
        model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(100 + rank))
        if rank == 0:
            model.load_state_dict(state_dict, strict=True)
        state = pts.create_train_state(model, pts.make_optimizer(train_cfg))
        step = pts.make_train_step(model, cfg.loss, accum_steps=accum_steps)
        n = batch["images"].shape[0] // world
        local = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]) for k, v in batch.items()}
        metrics = []
        for _ in range(steps):
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save({"metrics": metrics, "params": model.state_dict()},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gradcache_worker(rank, world, init_file, out_dir, state_dict, cfg, batch, train_cfg,
                     accum_steps):
    """Two data-parallel steps of the port on this rank's rows from
    ``state_dict``, twice: with GradCache over ``accum_steps`` microbatches
    (``accum_negatives="global"``) and unaccumulated."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    _init(rank, world, init_file)
    try:
        n = batch["images"].shape[0] // world
        local = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]) for k, v in batch.items()}
        out = {}
        for run, kw in (("gradcache", dict(accum_steps=accum_steps, accum_negatives="global")),
                        ("unaccumulated", {})):
            model = SigLIP(cfg, device="cpu")
            model.load_state_dict(state_dict, strict=True)
            state = pts.create_train_state(model, pts.make_optimizer(train_cfg))
            step = pts.make_train_step(model, cfg.loss, **kw)
            metrics = []
            for _ in range(2):
                state, m = step(state, local)
                metrics.append({k: float(v) for k, v in m.items()})
            out[run] = {"metrics": metrics, "params": model.state_dict()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
