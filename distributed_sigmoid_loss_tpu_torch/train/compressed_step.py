"""The train step with compressed gradient sync over the dcn axis, ported
from the JAX package's ``train/compressed_step.py`` for its fixed schemes
(``compression="int8" | "topk"``).

The step runs on a ``(dcn, dp)`` process grid (``parallel/mesh.py``); the
batch's rows are split over both axes. Each rank computes its gradients
(with local accumulation, or GradCache's exact global negatives, as the
regular step), then the sync is split by link:

- the dp hop is a plain f32 mean over the dp group (under
  ``update_sharding="full"`` a reduce-scatter: each rank keeps its rows);
- the dcn hop is :func:`~distributed_sigmoid_loss_tpu_torch.parallel.compression.compressed_axis_mean`:
  int8 payloads (or top-k values and indices) all-gathered over the dcn
  group and averaged, with each member's error-feedback residual carried
  into its next step (``state.ef``, :func:`with_error_feedback`).

Gradient accumulation syncs the accumulated mean once a step, so the dcn
wire carries one gradient a step however many microbatches. The loss's
collectives run over the joint (dcn, dp) world (``variant="all_gather"``
only, as in JAX). Not ported yet: the adaptive and learned schemes
(ROADMAP.md queue A item 6.3 part 2), the pipeline and MoE compositions
(item 6.4).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from distributed_sigmoid_loss_tpu_torch.parallel.api import all_reduce_mean_, make_per_shard_loss
from distributed_sigmoid_loss_tpu_torch.parallel.compression import (
    compressed_axis_mean,
    payload_bytes,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    dcn_axis as _dcn_axis,
)
from distributed_sigmoid_loss_tpu_torch.parallel.update_shard import resolve_update_sharding
from distributed_sigmoid_loss_tpu_torch.train.train_step import (
    TrainState,
    make_batch_grads,
    resolve_loss_quant,
    step_metrics,
    validate_accum_args,
    validate_trainable_quant,
)
from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig

__all__ = ["make_compressed_train_step", "validate_compressed_step_args", "with_error_feedback"]


def with_error_feedback(state: TrainState) -> TrainState:
    """Attach zeroed error-feedback residuals to ``state`` (f32, one per
    parameter): this rank's dcn slice's, and under the state's
    ``update_sharding="full"`` only its rows of each sharded parameter (JAX
    ``ef_slot_shape``), since the step compresses the reduce-scattered
    rows."""
    layout = state.layout
    full = state.update_sharding == "full"
    state.ef = [torch.zeros(layout.local_shape(i) if full else p.shape, dtype=torch.float32,
                            device=p.device)
                for i, p in enumerate(state.params)]
    return state


def validate_compressed_step_args(
    *,
    accum_steps: int,
    accum_dtype: str | None,
    accum_negatives: str,
    pp_microbatches: int,
    zero1: bool = False,
    moe_aux_weight: float | None = None,
    gradcache_embed_dtype: str | None = None,
    compression: str = "int8",
    error_feedback: bool = True,
    topk_frac: float = 0.01,
    loss_variant: str = "all_gather",
    mesh_axis_names: tuple = ("dcn", "dp"),
    update_sharding: str = "",
):
    """The JAX package's config refusals of :func:`make_compressed_train_step`,
    word for word; returns ``(cached_accum, acc_dt)``."""
    mode = resolve_update_sharding(update_sharding, zero1)
    acc_dt = validate_accum_args(accum_steps, accum_dtype)
    if accum_negatives not in ("local", "global"):
        raise ValueError(
            f"accum_negatives must be 'local' or 'global', got {accum_negatives!r}"
        )
    cached_accum = accum_negatives == "global" and accum_steps > 1
    if gradcache_embed_dtype is not None and not cached_accum:
        raise ValueError(
            f"gradcache_embed_dtype={gradcache_embed_dtype!r} requires "
            "accum_negatives='global' with accum_steps > 1 (only the "
            "GradCache path stashes embedding tables)"
        )
    if pp_microbatches < 0:
        raise ValueError(f"pp_microbatches must be >= 0, got {pp_microbatches}")
    if pp_microbatches:
        if cached_accum:
            raise ValueError(
                "accum_negatives='global' with pp_microbatches is not "
                "supported (the pp forward is already whole-batch per "
                "accumulation step — same constraint as make_train_step)"
            )
        if mode != "off":
            raise ValueError(
                f"update_sharding={mode!r} with pp_microbatches is not "
                "supported (see make_train_step's rationale: the constrain "
                "would reshard stage-local moments dp-wise every step)"
            )
        if "pp" not in mesh_axis_names:
            raise ValueError(
                f"pp_microbatches={pp_microbatches} needs a mesh with a "
                f"'pp' axis, got {mesh_axis_names}"
            )
    if moe_aux_weight is not None and pp_microbatches:
        raise ValueError(
            "pp towers are dense (same constraint as make_train_step); "
            "moe_aux_weight requires the non-pp compressed path"
        )
    if compression not in ("int8", "topk", "adaptive", "learned"):
        raise ValueError(f"unknown compression method: {compression!r}")
    if compression == "topk" and not error_feedback:
        raise ValueError(
            "compression='topk' without error feedback silently drops "
            f"{(1 - topk_frac):.0%} of every gradient as pure bias; create "
            "the state with with_error_feedback(state, mesh)"
        )
    if compression == "adaptive" and not error_feedback:
        raise ValueError(
            "compression='adaptive' requires error feedback (its sign/topk "
            "rungs are pure bias without the residual carry, and scheme "
            "CHANGES lean on it to absorb the transition); create the state "
            "with with_adaptive_compression(state, mesh)"
        )
    if compression == "learned" and not error_feedback:
        raise ValueError(
            "compression='learned' requires error feedback (the learned "
            "rung's reconstruction bias — like every adaptive rung's "
            "truncation — is only unbiased through the residual carry); "
            "create the state with "
            "with_adaptive_compression(state, mesh, learned=True)"
        )
    if compression in ("adaptive", "learned") and pp_microbatches:
        raise ValueError(
            f"compression={compression!r} with pp_microbatches is not "
            "supported: the controller's scheme table and stats are per "
            "GLOBAL tensor, but pp shards block-stack gradients "
            "stage-locally — use the fixed int8/topk compressed path under pp"
        )
    if loss_variant != "all_gather":
        raise ValueError(
            "compressed DCN sync supports variant='all_gather' only (the ring "
            "ppermute has no joint-(dcn,dp) axis form); use make_train_step "
            "for ring training within a slice"
        )
    return cached_accum, acc_dt


def make_compressed_train_step(
    model: nn.Module,
    loss_cfg: LossConfig = LossConfig(),
    dcn_axis: str = _dcn_axis,
    error_feedback: bool = True,
    compression: str = "int8",
    topk_frac: float = 0.01,
    accum_steps: int = 1,
    accum_dtype: str | None = None,
    accum_negatives: str = "local",
    pp_microbatches: int = 0,
    moe_aux_weight: float | None = None,
    gradcache_embed_dtype: str | None = None,
):
    """Build ``step(state, batch) -> (state, metrics)``, run by every rank of
    the ambient ``(dcn, dp)`` process grid on its own rows.

    ``compression``: ``"int8"`` (4× fewer dcn bytes) or ``"topk"`` (keep the
    ``topk_frac`` largest-|g| entries of each tensor, exactly; needs error
    feedback). With ``error_feedback`` create the state with
    :func:`with_error_feedback`. The update sharding is the state's
    (``create_train_state(..., update_sharding=...)``): ``"full"``
    reduce-scatters over dp, compresses this rank's rows, and updates and
    publishes them; ``"zero1"`` shards the moments only.

    Metrics: the regular step's (:func:`~distributed_sigmoid_loss_tpu_torch.train.train_step.step_metrics`),
    plus ``ef_norm`` / ``ef_residual_norm`` (the global norm of every
    member's residual) with error feedback, ``dcn_wire_bytes`` (one member's
    dcn egress a step: its payload times the n_dcn − 1 members that receive
    it) and ``bits_per_param``.
    """
    validate_trainable_quant(model)
    cached_accum, acc_dt = validate_compressed_step_args(
        accum_steps=accum_steps, accum_dtype=accum_dtype, accum_negatives=accum_negatives,
        pp_microbatches=pp_microbatches, moe_aux_weight=moe_aux_weight,
        gradcache_embed_dtype=gradcache_embed_dtype, compression=compression,
        error_feedback=error_feedback, topk_frac=topk_frac, loss_variant=loss_cfg.variant,
    )
    if compression in ("adaptive", "learned"):
        raise NotImplementedError(
            f"compression={compression!r}: the adaptive compression ladder is not ported yet: "
            "ROADMAP.md queue A item 6.3 part 2"
        )
    if moe_aux_weight is not None:
        raise NotImplementedError(
            "moe_aux_weight: the MoE towers are not ported yet: ROADMAP.md queue A item 6.4"
        )
    if pp_microbatches:
        raise NotImplementedError(
            "pp_microbatches: the pipeline towers are not ported yet: ROADMAP.md queue A item 6.4"
        )
    axis = loss_cfg.axis_name
    per_shard = make_per_shard_loss(
        family=loss_cfg.family, variant="all_gather", axis_name=(dcn_axis, axis),
        bidir=loss_cfg.bidir, precision=loss_cfg.precision, use_pallas=loss_cfg.use_pallas,
        loss_impl=loss_cfg.loss_impl, quant=resolve_loss_quant(model, loss_cfg),
    )
    grads_of = make_batch_grads(model, per_shard, axis, accum_steps, cached_accum, acc_dt,
                                gradcache_embed_dtype)

    def wire_bytes(params, n_dcn: int, layout, full: bool) -> int:
        """One member's fixed dcn egress a step (JAX ``_fixed_wire_bytes``):
        each tensor's payload (its rows under full sharding) times the
        n_dcn − 1 members that receive it."""
        total = 0
        for i, p in enumerate(params):
            size = p.numel()
            if full and layout.sharded[i]:
                size = layout.rows(i) * (size // p.shape[0])
            total += payload_bytes(size, compression, topk_frac)
        return (n_dcn - 1) * total

    def step(state: TrainState, batch: dict):
        if error_feedback and state.ef is None:
            raise ValueError(
                "error_feedback=True but state.ef is None — create the state "
                "with with_error_feedback(state, mesh)"
            )
        dp_group, dcn_group = axis_group(axis), axis_group(dcn_axis)
        n_dcn = axis_size(dcn_group)
        params = state.params
        layout = state.layout
        full = state.update_sharding == "full"
        loss, lp, grads = grads_of(params, batch)
        # The dp hop: an f32 mean (full sharding: each rank's rows of it).
        if layout is not None:
            grads = layout.mean_grads(grads, scatter=full)
        else:
            all_reduce_mean_(grads, dp_group)
        # The dcn hop: compressed, with this member's residuals.
        grads, new_ef = compressed_axis_mean(
            grads, dcn_axis, state.ef if error_feedback else None, method=compression,
            topk_frac=topk_frac, group=dcn_group)
        loss = loss.reshape(1)
        all_reduce_mean_([loss], axis_group((dcn_axis, axis)))
        grad_norm, update_norm = state.tx.apply(params, grads, state.opt_state, layout,
                                                grads_sharded=full)
        state.step += 1
        metrics = step_metrics(loss[0], lp, grad_norm, update_norm, params)
        device = params[0].device
        if error_feedback:
            state.ef = new_ef
            # Every member's residual once: summed over dcn, and over dp for
            # the residuals of which each rank holds only its rows.
            sq = torch.zeros(2, dtype=torch.float32, device=device)
            for i, e in enumerate(new_ef):
                sq[int(full and layout.sharded[i])] += e.square().sum()
            if n_dcn > 1:
                dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=dcn_group)
            if full:
                dist.all_reduce(sq[1:], op=dist.ReduceOp.SUM, group=dp_group)
            metrics["ef_norm"] = torch.sqrt(sq.sum())
            metrics["ef_residual_norm"] = metrics["ef_norm"]
        fixed = wire_bytes(params, n_dcn, layout, full)
        n_params = sum(p.numel() for p in params)
        metrics["dcn_wire_bytes"] = torch.tensor(float(fixed), device=device)
        metrics["bits_per_param"] = torch.tensor(fixed * 8.0, device=device) / (
            (n_dcn - 1) * n_params)
        return state, metrics

    return step
