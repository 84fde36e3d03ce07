"""Rank processes of the pipeline, expert-parallel and multi-process tests
(gloo, ``mp.spawn``; ``tests/_torch_dist_worker.spawn``).

Imports only torch, numpy and the port; the JAX side of each comparison
runs in the parent. Each worker writes its results with ``torch.save`` to
``<out_dir>/rank<r>.pt``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from _torch_dist_worker import _init


def _local(batch: dict, dp: int, r: int) -> dict:
    n = batch["images"].shape[0] // dp
    return {k: torch.from_numpy(v[r * n:(r + 1) * n]) for k, v in batch.items()}


def _capture_grads(state, box: list):
    """Wrap the optimizer's ``apply`` to keep the synced gradients it gets."""
    apply = state.tx.apply

    def recording(params, grads, *a, **kw):
        box.append([g.detach().clone() for g in grads])
        return apply(params, grads, *a, **kw)

    state.tx.apply = recording


def _named(model, tensors) -> dict:
    return {n: t for (n, _), t in zip(model.named_parameters(), tensors)}


def _stack(width: int, depth: int, seed: int):
    """A toy residual stack: ``depth`` layers ``x + tanh(x W + b)``."""
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(width, width, generator=g) / width ** 0.5,
             torch.randn(width, generator=g) * 0.1) for _ in range(depth)]


def _stage_fn(layers):
    def fn(x):
        for w, b in layers:
            x = x + torch.tanh(x @ w + b)
        return x
    return fn


def schedule_worker(rank, world, init_file, out_dir, lib_cases):
    """``lib_cases``: ``(name, schedule, M, checkpoint_stages)`` of the toy
    stack over ``pp = world``: outputs (gpipe) or loss (1F1B), the stage
    parameters' and the inputs' gradients."""
    from distributed_sigmoid_loss_tpu_torch.parallel import pipeline
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"pp": world}):
            for name, schedule, m, ckpt_stages in lib_cases:
                width, depth = 8, 2 * world
                layers = _stack(width, depth, seed=3)
                mine = [(w.clone().requires_grad_(), b.clone().requires_grad_())
                        for w, b in layers[rank * 2:(rank + 1) * 2]]
                params = [t for wb in mine for t in wb]
                xs = torch.randn(m, 3, width, generator=torch.Generator().manual_seed(4))
                xs.requires_grad_()
                c = torch.randn(m, 3, width, generator=torch.Generator().manual_seed(5))
                if schedule == "gpipe":
                    y = pipeline.gpipe(_stage_fn(mine), xs, params=params,
                                       checkpoint_stages=ckpt_stages)
                    value = y.detach()
                    (y * c).sum().backward()
                else:
                    loss = pipeline.one_f_one_b(
                        _stage_fn(mine), xs, lambda y: (y * c[0]).sum() + y.square().sum(),
                        params=params)
                    value = loss.detach()
                    loss.backward()
                out[name] = {"value": value, "dxs": xs.grad, "grads": [p.grad for p in params]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def pipeline_worker(rank, world, init_file, out_dir, step_cases, ckpt_cases):
    """``step_cases``: ``(name, cfg,
    state_dict, batch, train_cfg, dp, M, schedule, steps)``: the train step
    on a ``(dp, pp)`` grid, its metrics, the synced gradients of this rank's
    parameters and the parameters after. ``ckpt_cases``: ``(name, cfg,
    state_dict, batch, train_cfg, dir)``: a step at (dp, pp) = (2, 2) and a
    checkpoint, restored into a plain dp = 4 state and back onto the
    stages; with the parameters this rank's stage held before the save."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid, batch_index
    from distributed_sigmoid_loss_tpu_torch.train import checkpoint as ck
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    _init(rank, world, init_file)
    try:
        out = {}
        for name, cfg, sd, batch, train_cfg, dp, m, schedule, steps in step_cases:
            with ProcessGrid({"dp": dp, "pp": world // dp}):
                model = SigLIP(cfg, device="cpu")
                model.load_state_dict(sd, strict=True)
                state = pts.create_train_state(model, pts.make_optimizer(train_cfg),
                                               pp_axis="pp")
                box = []
                _capture_grads(state, box)
                step = pts.make_train_step(model, cfg.loss, pp_microbatches=m,
                                           pp_schedule=schedule)
                local = _local(batch, dp, batch_index())
                metrics = []
                for _ in range(steps):
                    state, met = step(state, local)
                    metrics.append({k: float(v) for k, v in met.items()})
                out[name] = {"metrics": metrics, "grads": _named(model, box[0]),
                             "params": dict(model.state_dict())}
        for name, cfg, sd, batch, train_cfg, ckpt_dir in ckpt_cases:
            path = os.path.join(ckpt_dir, name)
            with ProcessGrid({"dp": 2, "pp": 2}):
                model = SigLIP(cfg, device="cpu")
                model.load_state_dict(sd, strict=True)
                state = pts.create_train_state(model, pts.make_optimizer(train_cfg),
                                               pp_axis="pp", ema=True)
                step = pts.make_train_step(model, cfg.loss, pp_microbatches=2, ema_decay=0.9)
                state, _ = step(state, _local(batch, 2, batch_index()))
                whole = {k: v.clone() for k, v in ck.checkpoint_tensors(state).items()}
                held = {k: v.clone() for k, v in model.state_dict().items()}
                ck.save_checkpoint(path, state)
            with ProcessGrid({"dp": world}):
                plain = SigLIP(cfg, device="cpu")
                target = pts.create_train_state(plain, pts.make_optimizer(train_cfg), ema=True)
                ck.restore_checkpoint(path, target)
                restored = {k: v.clone() for k, v in ck.state_tensors(target).items()}
            with ProcessGrid({"dp": 2, "pp": 2}):  # and back onto the stages
                staged = SigLIP(cfg, device="cpu")
                back = pts.create_train_state(staged, pts.make_optimizer(train_cfg),
                                              pp_axis="pp", ema=True)
                ck.restore_checkpoint(path, back)
                again = {k: v.clone() for k, v in ck.checkpoint_tensors(back).items()}
            out[f"ckpt_{name}"] = {"whole": whole, "held": held, "restored": restored,
                                   "again": again, "step": target.step,
                                   "count": target.opt_state.count}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ep_worker(rank, world, init_file, out_dir, cases, ckpt_case):
    """``cases``: ``(name, cfg, state_dict, batch, train_cfg, dp, aux_weight)``:
    one train step on a ``(dp, ep)`` grid: its metrics, the synced gradients
    of this rank's parameters, its expert slice index. ``ckpt_case``
    (or None): ``(cfg, state_dict, batch, train_cfg, dir)``: a step at (dp,
    ep) = (2, 2), a checkpoint, and its restore into an ep = 1 state (dp =
    4)."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
        ProcessGrid,
        axis_group,
        axis_index,
        batch_index,
    )
    from distributed_sigmoid_loss_tpu_torch.train import checkpoint as ck
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    _init(rank, world, init_file)
    try:
        out = {}
        for name, cfg, sd, batch, train_cfg, dp, aux_weight in cases:
            with ProcessGrid({"dp": dp, "ep": world // dp}):
                model = SigLIP(cfg, device="cpu")
                model.load_state_dict(sd, strict=True)
                state = pts.create_train_state(model, pts.make_optimizer(train_cfg),
                                               ep_axis="ep")
                box = []
                _capture_grads(state, box)
                step = pts.make_train_step(model, cfg.loss, moe_aux_weight=aux_weight)
                state, met = step(state, _local(batch, dp, batch_index()))
                out[name] = {"metrics": {k: float(v) for k, v in met.items()},
                             "grads": _named(model, box[0]),
                             "ep_index": axis_index(axis_group("ep")),
                             "part_axes": state.part_axes}
        if ckpt_case is None:
            torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
            return
        cfg, sd, batch, train_cfg, ckpt_dir = ckpt_case
        with ProcessGrid({"dp": 2, "ep": 2}):
            model = SigLIP(cfg, device="cpu")
            model.load_state_dict(sd, strict=True)
            state = pts.create_train_state(model, pts.make_optimizer(train_cfg), ep_axis="ep")
            step = pts.make_train_step(model, cfg.loss, moe_aux_weight=0.01)
            state, _ = step(state, _local(batch, 2, batch_index()))
            whole = {k: v.clone() for k, v in ck.checkpoint_tensors(state).items()}
            ck.save_checkpoint(ckpt_dir, state)
        with ProcessGrid({"dp": world}):
            plain = SigLIP(cfg, device="cpu")
            target = pts.create_train_state(plain, pts.make_optimizer(train_cfg))
            ck.restore_checkpoint(ckpt_dir, target)
            restored = {k: v.clone() for k, v in ck.state_tensors(target).items()}
        out["ckpt"] = {"whole": whole, "restored": restored}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def coordinator_worker(rank, world, init_file, out_dir, argv):
    """``cli.main(argv + --coordinator ...)`` in a process with no process
    group: the command joins the run itself. Its exit code and metrics
    lines. (``init_file`` is unused: the rendezvous is the coordinator's.)"""
    import contextlib
    import io
    import json

    from distributed_sigmoid_loss_tpu_torch import cli

    torch.set_num_threads(1)
    stdout, stderr = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = cli.main(argv + ["--num-processes", str(world), "--process-id", str(rank)])
        out = {"rc": rc, "stderr": stderr.getvalue(),
               "lines": [json.loads(line) for line in stdout.getvalue().splitlines()
                         if line.startswith('{"step"')]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
