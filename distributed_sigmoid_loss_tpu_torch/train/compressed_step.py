"""The train step with compressed gradient sync over the dcn axis, ported
from the JAX package's ``train/compressed_step.py``: the fixed schemes
(``compression="int8" | "topk"``) and the adaptive ladder
(``"adaptive" | "learned"``, ``parallel/adaptive_compression.py``).

The step runs on a ``(dcn, dp)`` process grid (``parallel/mesh.py``); the
batch's rows are split over both axes. Each rank computes its gradients
(with local accumulation, or GradCache's exact global negatives, as the
regular step), then the sync is split by link:

- the dp hop is a plain f32 mean over the dp group (under
  ``update_sharding="full"`` a reduce-scatter: each rank keeps its rows);
- the dcn hop is :func:`~distributed_sigmoid_loss_tpu_torch.parallel.compression.compressed_axis_mean`:
  int8 payloads (or top-k values and indices) all-gathered over the dcn
  group and averaged, with each member's error-feedback residual carried
  into its next step (``state.ef``, :func:`with_error_feedback`); or, for
  the adaptive schemes, :func:`~distributed_sigmoid_loss_tpu_torch.parallel.adaptive_compression.adaptive_axis_mean`
  with each tensor's rung from the table in ``state.comp``
  (:func:`with_adaptive_compression`, :func:`stage_scheme`,
  :func:`stage_codec`).

The adaptive sync's tensors are the JAX params tree's leaves, in JAX's
tree order (:func:`compression_leaves`): a tower's layers stacked into one
tensor under ``scan_layers``, and a linear weight in the flax kernel's (in,
out) layout, so the scheme table, the stats and the learned rung's blocks
are JAX's. Under ``update_sharding="full"`` they are each parameter's own
rows (the port's layout, as the fixed path's), in the same order.

Gradient accumulation syncs the accumulated mean once a step, so the dcn
wire carries one gradient a step however many microbatches. The loss's
collectives run over the joint (dcn, dp) world (``variant="all_gather"``
only, as in JAX). MoE towers compose (``moe_aux_weight``, experts
replicated: expert parallelism needs the regular step, as in JAX), and so
do the pipeline towers on a ``(dcn, dp, pp)`` grid with the fixed schemes
(``pp_microbatches``; create the state with ``pp_axis="pp"``): each rank
syncs its stage's gradients over its dp and dcn groups.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from distributed_sigmoid_loss_tpu_torch.models.convert import JaxLeaf, jax_leaves
from distributed_sigmoid_loss_tpu_torch.parallel.adaptive_compression import (
    CODEC_BLOCK,
    CODEC_GROUPS,
    N_SCHEMES,
    adaptive_axis_mean,
    default_codec,
    leaf_sizes,
    table_payload_bytes,
)
from distributed_sigmoid_loss_tpu_torch.parallel.api import all_reduce_mean_, make_per_shard_loss
from distributed_sigmoid_loss_tpu_torch.parallel.compression import (
    compressed_axis_mean,
    payload_bytes,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    dcn_axis as _dcn_axis,
    is_distributed,
)
from distributed_sigmoid_loss_tpu_torch.parallel.update_shard import resolve_update_sharding
from distributed_sigmoid_loss_tpu_torch.train.train_step import (
    TrainState,
    grid_axis_names,
    make_batch_grads,
    pp_forward,
    resolve_loss_quant,
    step_metrics,
    validate_accum_args,
    validate_trainable_quant,
)
from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig

__all__ = ["make_compressed_train_step", "validate_compressed_step_args", "with_error_feedback",
           "with_adaptive_compression", "stage_scheme", "stage_codec", "compression_leaves",
           "adopt_rank0_decision"]


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


def compression_leaves(model: nn.Module, layout=None) -> list[JaxLeaf]:
    """The adaptive sync's tensors, in the order its scheme table, stats
    and ``compression_scheme_hist`` index them: the JAX params tree's leaves
    (``models.convert.jax_leaves``) sorted as ``jax.tree.leaves`` orders a
    dict tree (by key at every level). Under a ``"full"`` update-sharding
    ``layout`` each member parameter is a leaf of its own (its rows, in the
    port's layout), in that same order."""
    leaves = sorted(jax_leaves(model), key=lambda leaf: tuple(leaf.path.split("/")))
    if layout is None or layout.mode != "full":
        return leaves
    return [JaxLeaf(path=leaf.path, members=(i,), stacked=False, transposed=False)
            for leaf in leaves for i in leaf.members]


def _leaf_shape(leaf: JaxLeaf, shapes) -> tuple:
    """The shape of ``leaf`` in its own layout, from its members' shapes."""
    shape = tuple(shapes[leaf.members[0]])
    if leaf.transposed:
        shape = shape[::-1]
    return ((len(leaf.members),) + shape) if leaf.stacked else shape


def with_adaptive_compression(state: TrainState, learned: bool = False) -> TrainState:
    """Attach error feedback and the adaptive compression's carry
    ``state.comp`` (JAX's ``with_adaptive_compression``), for
    ``make_compressed_train_step(compression="adaptive" | "learned")``.

    ``state.ef``: zeroed f32 residuals, one per tensor of
    :func:`compression_leaves` in its layout. ``state.comp``: ``scheme``
    (int32[n_tensors] on the host, every tensor on int8 until
    :func:`stage_scheme`; the step reads it on the host to pick each
    tensor's rung) and the step-written stats ``gnorm``, ``gvar`` and
    ``ef_ratio`` (f32[n_tensors] on the device). ``learned=True`` adds the
    learned rung's slots: ``codec_enc`` (f32[G, B, L]) and ``codec_dec``
    (f32[G, L, B]), the DCT cold start until :func:`stage_codec`, and the
    stats ``blockmoment`` (f32[G, B, B]) and ``codec_recon_err`` (0-d). Both
    are derived state: checkpoints leave them out, and a restore resets
    their step-written parts (``train/checkpoint.py``)."""
    layout = state.layout
    full = state.update_sharding == "full"
    params = state.params
    device = params[0].device
    leaves = compression_leaves(state.model, layout)
    shapes = [layout.local_shape(i) if full else tuple(p.shape) for i, p in enumerate(params)]
    state.ef = [torch.zeros(_leaf_shape(leaf, shapes), dtype=torch.float32, device=device)
                for leaf in leaves]
    n = len(leaves)
    comp = {"scheme": torch.zeros(n, dtype=torch.int32),
            **{k: torch.zeros(n, dtype=torch.float32, device=device)
               for k in ("gnorm", "gvar", "ef_ratio")}}
    if learned:
        codec = default_codec()
        comp["codec_enc"] = torch.as_tensor(codec["enc"], device=device)
        comp["codec_dec"] = torch.as_tensor(codec["dec"], device=device)
        comp["blockmoment"] = torch.zeros((CODEC_GROUPS, CODEC_BLOCK, CODEC_BLOCK),
                                          dtype=torch.float32, device=device)
        comp["codec_recon_err"] = torch.zeros((), dtype=torch.float32, device=device)
    state.comp = comp
    return state


def stage_scheme(state: TrainState, scheme) -> TrainState:
    """Stage a scheme table (int32[n_tensors], a controller's decision) into
    ``state.comp`` for the next step. Every rank of the dcn group must stage
    the same table (:func:`adopt_rank0_decision`)."""
    if state.comp is None:
        raise ValueError(
            "state has no comp carry — create it with "
            "with_adaptive_compression(state)"
        )
    table = torch.as_tensor(np.asarray(scheme, dtype=np.int32).reshape(-1))
    if table.numel() != state.comp["scheme"].numel():
        raise ValueError(f"scheme table has {table.numel()} entries, the carry "
                         f"{state.comp['scheme'].numel()}")
    state.comp = dict(state.comp, scheme=table)
    return state


def stage_codec(state: TrainState, codec) -> TrainState:
    """Stage learned-rung weights (``{"enc": f32[G, B, L], "dec": f32[G, L,
    B]}``, a ``CodecTrainer``'s) into ``state.comp`` for the next step."""
    if state.comp is None or "codec_enc" not in state.comp:
        raise ValueError(
            "state has no codec carry — create it with "
            "with_adaptive_compression(state, learned=True)"
        )
    device = state.comp["codec_enc"].device
    state.comp = dict(state.comp,
                      codec_enc=torch.as_tensor(np.asarray(codec["enc"], np.float32),
                                                device=device),
                      codec_dec=torch.as_tensor(np.asarray(codec["dec"], np.float32),
                                                device=device))
    return state


def adopt_rank0_decision(controller, device, codec: dict | None = None) -> dict | None:
    """World rank 0's table, error budget and (with ``codec``) codec on
    every rank, in one broadcast: each rank's controller times its own steps,
    so its bandwidth estimate, and with it its table, may differ from the
    others', and members with different tables would gather payloads of
    different sizes. Sets ``controller.scheme`` and
    ``controller.last_error_budget``; returns the codec. A no-op on one
    process."""
    if not is_distributed() or dist.get_world_size() == 1:
        return codec
    parts = [np.asarray(controller.scheme, np.float64),
             np.asarray([controller.last_error_budget], np.float64)]
    if codec is not None:
        parts += [np.asarray(codec["enc"], np.float64).ravel(),
                  np.asarray(codec["dec"], np.float64).ravel()]
    flat = torch.as_tensor(np.concatenate(parts), device=device)
    dist.broadcast(flat, src=0)
    flat = flat.cpu().numpy()
    n = len(controller.scheme)
    controller.scheme = flat[:n].astype(np.int32)
    controller.last_error_budget = float(flat[n])
    if codec is None:
        return None
    enc = np.asarray(codec["enc"])
    m = enc.size
    return {"enc": flat[n + 1:n + 1 + m].astype(np.float32).reshape(enc.shape),
            "dec": flat[n + 1 + m:].astype(np.float32).reshape(np.asarray(codec["dec"]).shape)}


def _host_table(scheme: torch.Tensor) -> np.ndarray:
    """The values of the host-side scheme table. Read outside a fake mode
    that a trace (``obs/attribution.py``) has entered: the table is real
    and lives on the host, where the step picks each tensor's rung."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return scheme.numpy()


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

    ``compression``: ``"int8"`` (4× fewer dcn bytes), ``"topk"`` (keep the
    ``topk_frac`` largest-|g| entries of each tensor, exactly; needs error
    feedback), or the adaptive ladder: ``"adaptive"`` (int8, int4, sign1,
    top-k at ``topk_frac`` and at a quarter of it, per tensor by the table
    in ``state.comp``) and ``"learned"`` (the ladder with the learned rung,
    its codec in ``state.comp``). With ``error_feedback`` create the state
    with :func:`with_error_feedback`, or for the adaptive ladder
    :func:`with_adaptive_compression`. The update sharding is the state's
    (``create_train_state(..., update_sharding=...)``): ``"full"``
    reduce-scatters over dp, compresses this rank's rows, and updates and
    publishes them; ``"zero1"`` shards the moments only.

    ``moe_aux_weight`` (MoE towers, experts replicated: no ep axis here, as
    in JAX) adds that weight times the mean router aux loss to the
    objective, each rank's over its own tokens, as JAX's compressed step.

    ``pp_microbatches`` pipelines both towers over the grid's ``pp`` axis
    (fixed schemes only, as in JAX; create the state with ``pp_axis="pp"``).

    Metrics: the regular step's (:func:`~distributed_sigmoid_loss_tpu_torch.train.train_step.step_metrics`),
    plus ``ef_norm`` / ``ef_residual_norm`` (the global norm of every
    member's residual) with error feedback, ``dcn_wire_bytes`` (one member's
    dcn egress a step: its payload times the n_dcn − 1 members that receive
    it), ``bits_per_param`` and ``moe_aux`` with MoE. The adaptive ladder
    adds ``compression_scheme_hist`` (tensors on each rung this step), with
    ``"learned"`` ``codec_recon_err``, and writes the step's per-tensor
    stats into ``state.comp`` for the controller.
    """
    validate_trainable_quant(model)
    cached_accum, acc_dt = validate_compressed_step_args(
        accum_steps=accum_steps, accum_dtype=accum_dtype, accum_negatives=accum_negatives,
        pp_microbatches=pp_microbatches, moe_aux_weight=moe_aux_weight,
        gradcache_embed_dtype=gradcache_embed_dtype, compression=compression,
        error_feedback=error_feedback, topk_frac=topk_frac, loss_variant=loss_cfg.variant,
        mesh_axis_names=grid_axis_names() if pp_microbatches else (_dcn_axis, "dp"),
    )
    adaptive = compression in ("adaptive", "learned")
    learned = compression == "learned"
    axis = loss_cfg.axis_name
    per_shard = make_per_shard_loss(
        family=loss_cfg.family, variant="all_gather", axis_name=(dcn_axis, axis),
        bidir=loss_cfg.bidir, precision=loss_cfg.precision, use_pallas=loss_cfg.use_pallas,
        loss_impl=loss_cfg.loss_impl, quant=resolve_loss_quant(model, loss_cfg),
    )
    grads_of = make_batch_grads(model, per_shard, axis, accum_steps, cached_accum, acc_dt,
                                gradcache_embed_dtype, moe_aux_weight,
                                pp_forward(model, pp_microbatches))
    views = {}  # update-sharding mode -> compression_leaves

    def fixed_payload(params, layout, full: bool) -> int:
        """One member's fixed dcn payload a step (JAX ``_fixed_wire_bytes``
        before its n_dcn − 1 fan-out): each tensor's, its rows under full
        sharding."""
        total = 0
        for i, p in enumerate(params):
            size = p.numel()
            if full and layout.sharded[i]:
                size = layout.rows(i) * (size // p.shape[0])
            total += payload_bytes(size, compression, topk_frac)
        return total

    def adaptive_hop(state, grads, dcn_group, dp_group, full):
        """The adaptive dcn hop on the compression view of ``grads``; the
        means back in parameter order, the residuals and stats into the
        state. Returns ``(grads, wire_bytes, scheme_in, stats)``."""
        if state.update_sharding not in views:
            views[state.update_sharding] = compression_leaves(model, state.layout)
        leaves = views[state.update_sharding]
        comp = state.comp
        codec = {"enc": comp["codec_enc"], "dec": comp["codec_dec"]} if learned else None
        scheme_in = _host_table(comp["scheme"])
        means, new_ef, stats, wire = adaptive_axis_mean(
            [leaf.gather(grads) for leaf in leaves], dcn_axis, state.ef,
            scheme_in, topk_frac=topk_frac, codec=codec, group=dcn_group)
        if full:
            # Each member's stats are of its rows: one figure per tensor is
            # their mean over dp (JAX's pmean).
            all_reduce_mean_(list(stats.values()), dp_group)
        out = list(grads)
        for leaf, mean in zip(leaves, means):
            for i, part in zip(leaf.members, leaf.parts(mean)):
                out[i] = part.contiguous()
        state.ef = new_ef
        state.comp = dict(comp, **stats)
        return out, wire, scheme_in, stats

    def hops(state, grads, full: bool):
        """The dp hop (an f32 mean; under full sharding each rank's rows of
        it) and the compressed dcn hop, with this member's residuals:
        ``(grads, new_ef, wire, scheme_in)``, the last two the adaptive
        hop's (None for the fixed schemes)."""
        dp_group, dcn_group = axis_group(axis), axis_group(dcn_axis)
        if state.layout is not None:
            grads = state.layout.mean_grads(grads, scatter=full)
        else:
            all_reduce_mean_(grads, dp_group)
        if adaptive:
            grads, wire, scheme_in, _ = adaptive_hop(state, grads, dcn_group, dp_group, full)
            return grads, state.ef, wire, scheme_in
        grads, new_ef = compressed_axis_mean(
            grads, dcn_axis, state.ef if error_feedback else None, method=compression,
            topk_frac=topk_frac, group=dcn_group)
        return grads, new_ef, None, None

    def step(state: TrainState, batch: dict):
        if error_feedback and state.ef is None:
            raise ValueError(
                "error_feedback=True but state.ef is None — create the state "
                "with with_error_feedback(state, mesh)"
            )
        if adaptive and state.comp is None:
            raise ValueError(
                f"compression={compression!r} but state.comp is None — "
                "create the state with with_adaptive_compression(state)"
            )
        if learned and "codec_enc" not in state.comp:
            raise ValueError(
                "compression='learned' but state.comp has no codec slots — "
                "create the state with with_adaptive_compression(state, learned=True)"
            )
        dp_group, dcn_group = axis_group(axis), axis_group(dcn_axis)
        n_dcn = axis_size(dcn_group)
        params = state.params
        layout = state.layout
        full = state.update_sharding == "full"
        loss, lp, grads = grads_of(params, batch)
        grads, new_ef, wire, scheme_in = hops(state, grads, full)
        scalars = torch.stack([loss, lp["moe_aux"]]) if "moe_aux" in lp else loss.reshape(1)
        all_reduce_mean_([scalars], axis_group((dcn_axis, axis)))
        grad_norm, update_norm = state.tx.apply(params, grads, state.opt_state, layout,
                                                grads_sharded=full, part_axes=state.part_axes)
        state.step += 1
        metrics = step_metrics(scalars[0], lp, grad_norm, update_norm, params,
                               state.part_axes)
        if moe_aux_weight is not None:
            metrics["moe_aux"] = scalars[1]
        device = params[0].device
        if error_feedback:
            state.ef = new_ef
            # Every member's residual once: summed over dcn, and over dp for
            # the residuals of which each rank holds only its rows.
            if adaptive:
                rows = [full and layout.sharded[leaf.members[0]]
                        for leaf in views[state.update_sharding]]
            else:
                rows = [full and layout.sharded[i] for i in range(len(new_ef))]
            # A pipeline stage's residuals are summed over pp too (slot 2).
            staged = (state.part_axes if state.part_axes is not None and not adaptive
                      else [None] * len(new_ef))
            sq = torch.zeros(3, dtype=torch.float32, device=device)
            for e, sharded, part in zip(new_ef, rows, staged):
                sq[2 if part is not None else int(sharded)] += e.square().sum()
            if n_dcn > 1:
                dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=dcn_group)
            if full:
                dist.all_reduce(sq[1:2], op=dist.ReduceOp.SUM, group=dp_group)
            if state.part_axes is not None and axis_size(axis_group("pp")) > 1:
                dist.all_reduce(sq[2:], op=dist.ReduceOp.SUM, group=axis_group("pp"))
            metrics["ef_norm"] = torch.sqrt(sq.sum())
            metrics["ef_residual_norm"] = metrics["ef_norm"]
        if adaptive:
            payload = table_payload_bytes(leaf_sizes(state.ef), scheme_in, topk_frac)
            # The table lives on the host: count it there.
            metrics["compression_scheme_hist"] = torch.from_numpy(np.bincount(
                np.clip(scheme_in, 0, N_SCHEMES - 1), minlength=N_SCHEMES))
            if learned:
                metrics["codec_recon_err"] = state.comp["codec_recon_err"]
        else:
            payload = fixed_payload(params, layout, full)
            wire = (n_dcn - 1) * payload
        metrics["dcn_wire_bytes"] = torch.tensor(float(wire), dtype=torch.float32, device=device)
        # One member's payload bits a parameter: JAX's wire · 8 / ((n_dcn − 1)
        # · n_params), defined at n_dcn = 1 too.
        metrics["bits_per_param"] = torch.tensor(payload * 8.0 / sum(leaf_sizes(params)),
                                                 dtype=torch.float32, device=device)
        return state, metrics

    def attribution_sync(loss, aux, grads, state):
        # On a copy of the state: the adaptive hop rebinds its residuals and
        # statistics.
        hops(copy.copy(state), grads, state.update_sharding == "full")
        scalars = loss.reshape(1) if aux is None else torch.stack([loss, aux])
        all_reduce_mean_([scalars], axis_group((dcn_axis, axis)))

    # What train_step.step_attribution traces, as for the regular step: one
    # microbatch's forward and backward, and the sync.
    per_micro = accum_steps > 1 and not cached_accum
    step.attribution_parts = (
        make_batch_grads(model, per_shard, axis, 1, False, acc_dt, gradcache_embed_dtype,
                         moe_aux_weight, pp_forward(model, pp_microbatches))
        if per_micro else grads_of,
        accum_steps if per_micro else 1, attribution_sync, moe_aux_weight is not None)
    return step
