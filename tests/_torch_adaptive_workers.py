"""Rank processes of the port's adaptive compression and MoE tests (gloo,
spawned by ``_torch_dist_worker.spawn``). Imports only torch, numpy and the
port; the JAX side runs in the parent. Each worker writes
``<out_dir>/rank<r>.pt``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_worker import _init


def adaptive_mean_worker(rank, world, init_file, out_dir, cases):
    """Each case ``(name, grads, scheme, codec, topk_frac)``: rounds of
    ``adaptive_axis_mean`` over a dcn axis of ``world`` ranks, this rank's
    tensors ``grads[round][rank]``, the residual carried; each round's
    means, residuals, stats and wire bytes."""
    from distributed_sigmoid_loss_tpu_torch.parallel.adaptive_compression import (
        adaptive_axis_mean,
    )
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"dcn": world}):
            for name, grads, scheme, codec, topk_frac in cases:
                ef = [torch.zeros(g.shape, dtype=torch.float32) for g in grads[0][rank]]
                live = None if codec is None else {k: torch.from_numpy(v)
                                                   for k, v in codec.items()}
                rounds = []
                for r in range(len(grads)):
                    mine = [torch.from_numpy(g) for g in grads[r][rank]]
                    mean, ef, stats, wire = adaptive_axis_mean(
                        mine, "dcn", ef, scheme, topk_frac=topk_frac, codec=live)
                    rounds.append({"mean": mean, "ef": ef, "wire": wire,
                                   "stats": {k: v.clone() for k, v in stats.items()}})
                out[name] = rounds
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _local_rows(batch, index, parts):
    n = batch["images"].shape[0] // parts
    return {k: torch.from_numpy(v[index * n:(index + 1) * n]) for k, v in batch.items()}


def adaptive_step_worker(rank, world, init_file, out_dir, runs, state_dict, cfg, batch,
                         train_cfg, steps, dcn):
    """Each run ``(name, spec)``: ``steps`` compressed train steps on a
    ``(dcn, dp)`` grid from ``state_dict``. ``spec``: the step's kwargs
    (``compression``, ``topk_frac``, accumulation, ``moe_aux_weight``), the
    state's ``update_sharding``, and either ``tables`` (one pinned table a
    step) or a controller loop (``controller``, ``bandwidth_mbps`` pinned,
    ``skew``: rank r observes a round r + 1 times slower before deciding):
    the table staged before each step is the controller's, after
    ``adopt_rank0_decision``. Under ``"learned"`` the codec trainer's codec
    is staged once it is warm. Records each step's metrics, staged table,
    stats and (learned) staged encoder, the tables each rank decided before
    adopting rank 0's, the final parameters and ``state.comp``."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.adaptive_compression import (
        CODEC_BLOCK,
        CODEC_GROUPS,
        BitController,
        CodecTrainer,
        leaf_sizes,
    )
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
        ProcessGrid,
        batch_index,
        batch_size,
    )
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
    from distributed_sigmoid_loss_tpu_torch.train.compressed_step import (
        adopt_rank0_decision,
        make_compressed_train_step,
        stage_codec,
        stage_scheme,
        with_adaptive_compression,
        with_error_feedback,
    )

    _init(rank, world, init_file)
    try:
        out = {}
        with ProcessGrid({"dcn": dcn, "dp": world // dcn}):
            local = _local_rows(batch, batch_index(), batch_size())
            for name, spec in runs:
                model = SigLIP(spec.get("cfg", cfg), device="cpu")
                model.load_state_dict(spec.get("state_dict", state_dict), strict=True)
                state = pts.create_train_state(model, pts.make_optimizer(train_cfg),
                                               update_sharding=spec.get("update_sharding", ""))
                kw = dict(spec["step"])
                adaptive = kw.get("compression") in ("adaptive", "learned")
                learned = kw.get("compression") == "learned"
                state = (with_adaptive_compression(state, learned=learned) if adaptive
                         else with_error_feedback(state))
                step = make_compressed_train_step(model, cfg.loss, **kw)
                controller = None
                if "controller" in spec:
                    controller = BitController(
                        leaf_sizes(state.ef), n_dcn=dcn, topk_frac=kw.get("topk_frac", 0.01),
                        controller=spec["controller"], learned=learned)
                    controller.override_bandwidth(spec["bandwidth_mbps"])
                trainer = CodecTrainer() if learned else None
                metrics, staged, decided, stats, codecs = [], [], [], [], []
                for i in range(steps):
                    if adaptive:
                        table = (controller.scheme if controller is not None
                                 else spec["tables"][i])
                        state = stage_scheme(state, table)
                        staged.append(np.asarray(table, dtype=np.int32).tolist())
                    if learned:
                        codecs.append(state.comp["codec_enc"].numpy().tolist())
                    state, m = step(state, local)
                    metrics.append({k: (float(v) if v.numel() == 1 else v.tolist())
                                    for k, v in m.items()})
                    if not adaptive:
                        continue
                    comp = state.comp
                    stats.append({k: comp[k].clone() for k in ("ef_ratio", "gnorm", "gvar")})
                    if controller is not None:
                        if spec.get("skew"):
                            controller.override_bandwidth(None)
                            controller.observe((rank + 1) * 0.15, m["dcn_wire_bytes"].item())
                        controller.decide(comp["ef_ratio"].numpy(),
                                          gnorm=comp["gnorm"].numpy(), gvar=comp["gvar"].numpy())
                        decided.append(controller.scheme.tolist())
                    codec = None
                    if trainer is not None:
                        new = trainer.update(comp["blockmoment"].numpy().reshape(
                            CODEC_GROUPS, CODEC_BLOCK, CODEC_BLOCK))
                        if trainer.rounds >= trainer.warmup_rounds:
                            codec = new
                    if controller is not None:
                        codec = adopt_rank0_decision(controller, "cpu", codec)
                    if codec is not None:
                        state = stage_codec(state, codec)
                out[name] = {"metrics": metrics, "staged": staged, "decided": decided,
                             "stats": stats, "codecs": codecs,
                             "params": model.state_dict(),
                             "comp": None if state.comp is None else {
                                 k: v.clone() for k, v in state.comp.items()},
                             "ef_shapes": [tuple(e.shape) for e in state.ef]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
