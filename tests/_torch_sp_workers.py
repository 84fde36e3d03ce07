"""Rank processes of the port's sequence-parallel tests (gloo, spawned by
``_torch_dist_worker.spawn``): ring and Ulysses attention, the towers with
``sequence_parallel_axis`` and the dp × sp train step.

Imports only torch, numpy and the port; the JAX side of each comparison
runs in the parent. Each worker writes ``<out_dir>/rank<r>.pt``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from _torch_dist_worker import _init


def _grad_of(fn, tensors, cot):
    """``fn(*tensors)``'s value and the gradients of ``<fn(...), cot>``."""
    leaves = [torch.from_numpy(t).requires_grad_() for t in tensors]
    out = fn(*leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def attention_worker(rank, world, init_file, out_dir, cases):
    """Each case ``(name, impl, q, k, v, cot, kwargs)``: the global
    sequence-parallel attention (``sequence_parallel_attention``) on the
    replicated tensors, its value and input gradients; for the ring also
    ``ring_self_attention`` on this rank's blocks. A case that raises
    records its message."""
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid
    from distributed_sigmoid_loss_tpu_torch.parallel.ring_attention import (
        ring_self_attention,
        sequence_parallel_attention,
    )

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"sp": world}):
            for name, impl, q, k, v, cot, kw in cases:
                try:
                    val, grads = _grad_of(
                        lambda a, b, c: sequence_parallel_attention(a, b, c, impl=impl, **kw),
                        (q, k, v), cot)
                    rec = {"out": val, "dq": grads[0], "dk": grads[1], "dv": grads[2]}
                    if impl == "ring":
                        s = q.shape[1] // world
                        blocks = [torch.from_numpy(t[:, rank * s:(rank + 1) * s]) for t in (q, k, v)]
                        rec["local"] = ring_self_attention(*blocks, **kw)
                except ValueError as e:
                    rec = {"error": str(e)}
                out[name] = rec
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def towers_worker(rank, world, init_file, out_dir, cases, step_case):
    """``cases``: ``(name, cfg, state_dict, images, tokens, c_img, c_txt)``
    with sequence-parallel towers on a grid of ``sp = world``: the model's
    embeddings and every parameter's gradient of ``<zimg, c_img> + <ztxt,
    c_txt>``. ``step_case``: ``(cfg, state_dict, batch, train_cfg, steps,
    dp)``, the train step on a ``(dp, sp)`` grid, this rank's rows those of
    its dp index."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid, batch_index
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"sp": world}):
            for name, cfg, sd, images, tokens, c_img, c_txt in cases:
                model = SigLIP(cfg, device="cpu")
                model.load_state_dict(sd, strict=True)
                zimg, ztxt, _ = model(torch.from_numpy(images), torch.from_numpy(tokens))
                ((zimg * torch.from_numpy(c_img)).sum()
                 + (ztxt * torch.from_numpy(c_txt)).sum()).backward()
                out[name] = {"zimg": zimg.detach(), "ztxt": ztxt.detach(),
                             "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                                       if p.grad is not None}}
        cfg, sd, batch, train_cfg, steps, dp = step_case
        with ProcessGrid({"dp": dp, "sp": world // dp}):
            model = SigLIP(cfg, device="cpu")
            model.load_state_dict(sd, strict=True)
            state = pts.create_train_state(model, pts.make_optimizer(train_cfg))
            step = pts.make_train_step(model, cfg.loss)
            n = batch["images"].shape[0] // dp
            r = batch_index()
            local = {k: torch.from_numpy(v[r * n:(r + 1) * n]) for k, v in batch.items()}
            metrics = []
            for _ in range(steps):
                state, m = step(state, local)
                metrics.append({k: float(v) for k, v in m.items()})
        out["step"] = {"metrics": metrics, "params": model.state_dict()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def naive_gather_worker(rank, world, init_file, out_dir, x_np):
    """The gradient through a replicated ``sum(gather(block)²)``: with
    ``seq_gather`` (its backward keeps this rank's block) and with the
    all-gather of the loss collectives (its backward sums the ranks'
    cotangents, W times the replicated gradient)."""
    from distributed_sigmoid_loss_tpu_torch.parallel import collectives as col
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"sp": world}):
            for name in ("seq", "plain"):
                x = torch.from_numpy(x_np).requires_grad_()
                block = col.seq_scatter(x, "sp")
                if name == "seq":
                    full = col.seq_gather(block, "sp")
                else:
                    full = torch.cat(col.all_gather(block, "sp").unbind(0), dim=1)
                full.square().sum().backward()
                out[name] = x.grad
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()

