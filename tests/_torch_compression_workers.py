"""Rank processes of the port's compression and update-sharding tests
(gloo, spawned by ``_torch_dist_worker.spawn``). Imports only torch, numpy
and the port; the JAX side runs in the parent. Each worker writes
``<out_dir>/rank<r>.pt``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from _torch_dist_worker import _init


def axis_mean_worker(rank, world, init_file, out_dir, grads, rounds):
    """``compressed_axis_mean`` over a dcn axis of ``world`` ranks, for each
    method: without error feedback, and ``rounds`` rounds with it (this
    rank's tensors ``grads[round][rank]``, the residual carried)."""
    from distributed_sigmoid_loss_tpu_torch.parallel.compression import (
        compressed_axis_mean,
        init_error_feedback,
    )
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"dcn": world}):
            for method in ("int8", "topk"):
                mine = [torch.from_numpy(g) for g in grads[0][rank]]
                mean, none = compressed_axis_mean(mine, "dcn", None, method=method,
                                                  topk_frac=0.1)
                out[f"{method}/no_ef"] = {"mean": mean, "ef": none}
                ef = init_error_feedback(mine)
                for r in range(rounds):
                    mine = [torch.from_numpy(g) for g in grads[r][rank]]
                    mean, ef = compressed_axis_mean(mine, "dcn", ef, method=method,
                                                    topk_frac=0.1)
                    out[f"{method}/ef{r}"] = {"mean": mean, "ef": ef}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _local_rows(batch, index, parts):
    n = batch["images"].shape[0] // parts
    return {k: torch.from_numpy(v[index * n:(index + 1) * n]) for k, v in batch.items()}


def compressed_step_worker(rank, world, init_file, out_dir, runs, state_dict, cfg, batch,
                           train_cfg, steps, dcn):
    """Each run ``(name, kwargs)``: ``steps`` compressed train steps on a
    ``(dcn, dp)`` grid from ``state_dict`` (metrics, final parameters, the
    residuals' shapes, the optimizer's bytes on this rank). Then one
    gradient, compressed (int8, no error feedback) and not, of the same
    rows."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.api import all_reduce_mean_
    from distributed_sigmoid_loss_tpu_torch.parallel.compression import compressed_axis_mean
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
        ProcessGrid,
        axis_group,
        batch_index,
        batch_size,
    )
    from distributed_sigmoid_loss_tpu_torch.parallel.update_shard import (
        opt_mem_bytes_per_replica,
    )
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
    from distributed_sigmoid_loss_tpu_torch.train.compressed_step import (
        make_compressed_train_step,
        with_error_feedback,
    )

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"dcn": dcn, "dp": world // dcn}):
            local = _local_rows(batch, batch_index(), batch_size())
            for name, kw in runs:
                model = SigLIP(cfg, device="cpu")
                model.load_state_dict(state_dict, strict=True)
                mode = kw.get("update_sharding", "")
                state = pts.create_train_state(model, pts.make_optimizer(train_cfg),
                                               update_sharding=mode)
                state = with_error_feedback(state)
                step = make_compressed_train_step(
                    model, cfg.loss, **{k: v for k, v in kw.items() if k != "update_sharding"})
                metrics = []
                for _ in range(steps):
                    state, m = step(state, local)
                    metrics.append({k: float(v) for k, v in m.items()})
                out[name] = {"metrics": metrics, "params": model.state_dict(),
                             "ef": state.ef,
                             "ef_shapes": [tuple(e.shape) for e in state.ef],
                             "opt_bytes": opt_mem_bytes_per_replica(state.opt_state)}
            out["int8_full_ref"] = _int8_full_reference(state_dict, cfg, local, train_cfg,
                                                        steps)
            # One gradient of these rows: the world's f32 mean vs the dp mean
            # then the int8 dcn mean.
            model = SigLIP(cfg, device="cpu")
            model.load_state_dict(state_dict, strict=True)
            per_shard = pts.make_per_shard_loss(variant="all_gather", axis_name=("dcn", "dp"))
            zimg, ztxt, lp = model(local["images"], local["tokens"])
            per_shard(zimg, ztxt, lp["t_prime"], lp["bias"]).backward()
            grads = [p.grad.clone() for p in model.parameters()]
            exact = [g.clone() for g in grads]
            all_reduce_mean_(exact, axis_group(("dcn", "dp")))
            all_reduce_mean_(grads, axis_group("dp"))
            compressed, _ = compressed_axis_mean(grads, "dcn", None, method="int8")
            out["grads"] = {"exact": exact, "compressed": compressed}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _int8_full_reference(state_dict, cfg, local, train_cfg, steps):
    """Plain PyTorch reference of the compressed step under full update
    sharding, in the port's row layout: the gradient's f32 mean over dp,
    each tensor with ``shape[0] >= dp`` cut into dp blocks of rows
    (zero-padded to a multiple of dp) and each block int8-quantized on its
    own with its own residual (the others whole), the dequantized payloads
    averaged over dcn, then a replicated AdamW step on the whole tensors.
    Returns the final parameters, each step's ``grad_norm`` and this rank's
    residuals (its block of each sharded tensor)."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    dp_group, dcn_group = axis_group("dp"), axis_group("dcn")
    w, r, n_dcn = axis_size(dp_group), axis_index(dp_group), axis_size(dcn_group)
    model = SigLIP(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    state = pts.create_train_state(model, pts.make_optimizer(train_cfg))
    params = state.params
    per_shard = pts.make_per_shard_loss(variant="all_gather", axis_name=("dcn", "dp"))

    def blocks(g):
        if g.dim() == 0 or g.shape[0] < w:
            return [g]
        rows = -(-g.shape[0] // w)
        pad = g.new_zeros((rows * w - g.shape[0],) + tuple(g.shape[1:]))
        return list(torch.cat([g, pad]).chunk(w))

    ef = [[torch.zeros_like(b) for b in blocks(p.detach())] for p in params]
    grad_norms = []
    for _ in range(steps):
        for p in params:
            p.grad = None
        zimg, ztxt, lp = model(local["images"], local["tokens"])
        per_shard(zimg, ztxt, lp["t_prime"], lp["bias"]).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in params]
        for g in grads:
            dist.all_reduce(g, group=dp_group)
            g /= w
        synced = []
        for i, g in enumerate(grads):
            means = []
            for j, b in enumerate(blocks(g)):
                target = b + ef[i][j]
                scale = torch.clamp(target.abs().max(), min=1e-12) / torch.tensor(127.0)
                q = torch.clamp(torch.round(target / scale), -127, 127)
                ef[i][j] = target - q * scale
                qs = [torch.empty_like(q) for _ in range(n_dcn)]
                scales = [torch.empty_like(scale) for _ in range(n_dcn)]
                dist.all_gather(qs, q, group=dcn_group)
                dist.all_gather(scales, scale, group=dcn_group)
                means.append(sum(a * s for a, s in zip(qs, scales)) / n_dcn)
            synced.append(torch.cat(means)[: g.shape[0]] if len(means) > 1 else means[0])
        grad_norm, _ = state.tx.apply(params, synced, state.opt_state)
        grad_norms.append(float(grad_norm))
    mine = [e[r] if len(e) > 1 else e[0] for e in ef]
    return {"params": model.state_dict(), "grad_norm": grad_norms, "ef": mine}


def update_shard_worker(rank, world, init_file, out_dir, runs, state_dict, cfg, batch, steps,
                        ckpt_dir):
    """Each run ``(name, train_cfg, mode)``: ``steps`` regular train steps
    on a dp axis of ``world`` ranks with that update sharding (metrics,
    final parameters, moments gathered whole, the optimizer's bytes on this
    rank). The AdamW "full" run is checkpointed and restored into fresh
    states of every mode."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import batch_index, batch_size
    from distributed_sigmoid_loss_tpu_torch.parallel.update_shard import (
        opt_mem_bytes_per_replica,
    )
    from distributed_sigmoid_loss_tpu_torch.train import checkpoint as ckpt
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    _init(rank, world, init_file)
    try:
        out = {}
        local = _local_rows(batch, batch_index(), batch_size())

        def fresh(train_cfg, mode):
            model = SigLIP(cfg, device="cpu")
            model.load_state_dict(state_dict, strict=True)
            return pts.create_train_state(model, pts.make_optimizer(train_cfg),
                                          update_sharding=mode)

        for name, train_cfg, mode in runs:
            state = fresh(train_cfg, mode)
            step = pts.make_train_step(state.model, cfg.loss)
            metrics = []
            for _ in range(steps):
                state, m = step(state, local)
                metrics.append({k: float(v) for k, v in m.items()})
            whole = {k: v.detach().clone() for k, v in ckpt.checkpoint_tensors(state).items()}
            out[name] = {"metrics": metrics, "tensors": whole,
                         "opt_bytes": opt_mem_bytes_per_replica(state.opt_state)}
            if name == "adamw/full":
                path = os.path.join(ckpt_dir, "full")
                ckpt.save_checkpoint(path, state)
                # The same state written by the asynchronous saver: every
                # rank saves and waits, rank 0 writes.
                with ckpt.AsyncSaver() as saver:
                    saver.save(os.path.join(ckpt_dir, "full_async"), state)
                    saver.wait()
                    out["async_equal"] = all(
                        torch.equal(a, b) for a, b in zip(
                            torch.load(os.path.join(path, ckpt.TENSORS_FILE)).values(),
                            torch.load(os.path.join(ckpt_dir, "full_async",
                                                    ckpt.TENSORS_FILE)).values()))
                restored = {}
                for target_mode in ("off", "zero1", "full"):
                    target = fresh(train_cfg, target_mode)
                    ckpt.restore_checkpoint(path, target)
                    restored[target_mode] = {k: v.detach().clone()
                                             for k, v in ckpt.checkpoint_tensors(target).items()}
                    # ... and the restored state trains on: one more step
                    # in its own mode.
                    step = pts.make_train_step(target.model, cfg.loss)
                    target, m = step(target, local)
                    restored[target_mode + "/next_loss"] = float(m["loss"])
                out["restored"] = restored
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def cli_worker(rank, world, init_file, out_dir, runs):
    """Each run ``(name, argv)``: ``cli.main(argv)`` on every rank of the
    initialized group; its exit code and the JSON metrics lines it printed."""
    import contextlib
    import io
    import json

    from distributed_sigmoid_loss_tpu_torch import cli

    _init(rank, world, init_file)
    try:
        out = {}
        for name, argv in runs:
            stdout, stderr = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
                rc = cli.main(argv)
            out[name] = {"rc": rc, "stderr": stderr.getvalue(),
                         "lines": [json.loads(line) for line in stdout.getvalue().splitlines()
                                   if line.startswith('{"step"')]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
