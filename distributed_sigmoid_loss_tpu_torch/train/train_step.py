"""The SigLIP train step, ported from the JAX package's
``train/train_step.py``: AdamW, Lion and Adafactor with global-norm clipping
and the three learning-rate schedules, gradient accumulation over
microbatches with the bf16-accumulator contract, GradCache (exact global
negatives under accumulation), the parameters' EMA, data parallelism over
``torch.distributed``, and the step's metrics.

Data parallelism follows DDP: every rank holds the same parameters
(:func:`create_train_state` broadcasts rank 0's), runs its own rows, and the
gradients are averaged over the ranks once per step, after accumulation
(DDP's ``no_sync`` over the microbatches), in one collective over a flat
buffer. Clipping and the optimizer then run on the averaged gradients,
identically on every rank.

The optimizers are plain tensor code that follows optax's
``chain(clip_by_global_norm(1.0), adamw(...) | lion(...) | adafactor(...))``
operation by operation, not ``torch.optim``, whose clipping, weight decay and
moment rounding differ. For AdamW:

- the schedule is read at the update count *before* the update, so with
  warmup the first update is zero;
- ``warmup_cosine`` spans its cosine over ``total_steps − warmup_steps``;
- weight decay reaches every parameter (biases, LayerNorm scales,
  ``t_prime``, ``bias``), as ``optax.adamw`` has no mask;
- clipping divides by the global norm itself, with no ``+1e-6``;
- with ``adam_mu_dtype="bfloat16"`` the update uses the unrounded new first
  moment; only the stored moment is rounded (and its decay term is taken in
  bf16, as JAX computes ``b1 * mu`` in mu's dtype).

Lion and Adafactor: see :class:`Lion` and :class:`Adafactor`; Adafactor
works on the JAX tree's leaves (``models.convert.jax_leaves``), which under
``scan_layers=True`` stack a tower's layers.

It updates the parameters, optimizer state, EMA and gradient accumulator in
place, one tensor at a time, where JAX builds new arrays.

Update sharding (``update_sharding="zero1" | "full"``,
``parallel/update_shard.py``): AdamW's and Lion's moments of a sharded
parameter are this rank's block of its rows, the update runs on those rows
and one all-gather publishes the parameters; under ``"full"`` the gradients
are reduce-scattered instead of all-reduced. Adafactor keeps its factored
statistics whole on every rank: its per-leaf RMS and row/column means reach
across a leaf's rows.

Under a ``(dp, sp)`` process grid the batch is split over dp only, and the
loss's collectives and the gradient mean run over the dp group; the ranks
of an sp group compute the same gradients. So do the ranks of an ``ep``
group (expert parallelism, ``models/moe.py``) and of a ``pp`` group
(``pp_microbatches``, ``parallel/pp_towers.py``), each holding its own part
of the parameters: its experts, or its pipeline stage's blocks
(``TrainState.part_axes``). The global norms (clipping, ``grad_norm``,
``param_norm``, ``update_ratio``) sum those parts' squares over their axis,
so they are the whole model's, as JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from distributed_sigmoid_loss_tpu_torch.models.convert import (
    JaxLeaf,
    adafactor_stats_from_jax,
    jax_leaves,
    param_list_from_jax,
)
from distributed_sigmoid_loss_tpu_torch.parallel.api import all_reduce_mean_, make_per_shard_loss
from distributed_sigmoid_loss_tpu_torch.parallel.collectives import flat_collective_
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    current_grid,
    data_axis,
)
from distributed_sigmoid_loss_tpu_torch.parallel.update_shard import (
    UPDATE_SHARDING_MODES,
    UpdateLayout,
    resolve_update_sharding,
)
from distributed_sigmoid_loss_tpu_torch.parallel.microbatch import microbatch_split
from distributed_sigmoid_loss_tpu_torch.train.ema import ema_decay_schedule, init_ema, update_ema
from distributed_sigmoid_loss_tpu_torch.utils.config import (
    LossConfig,
    TrainConfig,
    tower_quant_mode,
)

__all__ = [
    "AdamW",
    "AdamWState",
    "Lion",
    "LionState",
    "Adafactor",
    "AdafactorState",
    "run_gradcache",
    "opt_state_from_optax",
    "TrainState",
    "make_optimizer",
    "make_schedule",
    "create_train_state",
    "make_train_step",
    "make_functional_train_step",
    "train_state_tree",
    "resolve_loss_quant",
    "validate_trainable_quant",
    "validate_accum_args",
    "validate_step_args",
    "resolve_update_sharding",
    "accum_zeros",
    "accum_add",
    "accum_finish",
    "global_norm",
    "make_batch_grads",
    "step_attribution",
    "step_metrics",
    "UPDATE_SHARDING_MODES",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def make_schedule(cfg: TrainConfig) -> Callable:
    """``count -> learning rate``, in f32 as optax computes it: linear
    warmup then cosine decay (``warmup_cosine``), inverse square root
    (``rsqrt``) or constant (``constant``). ``warmup_steps=0`` means no
    warmup in every branch. ``count`` is an int or a 0-d integer tensor (the
    traced step's, :func:`make_functional_train_step`); the rate is a 0-d
    f32 tensor on the count's device, taken without a host branch on the
    count."""
    warmup, lr = cfg.warmup_steps, cfg.learning_rate
    timescale = max(warmup, 1)
    if cfg.schedule == "warmup_cosine":
        decay_steps = cfg.total_steps - warmup
        if decay_steps <= 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, got "
                f"decay_steps={decay_steps}."
            )

        def schedule(count):
            c = torch.as_tensor(count).to(torch.float32)
            t = torch.clamp(c - warmup, max=float(decay_steps))
            pi = torch.tensor(math.pi, dtype=torch.float32, device=c.device)
            rate = lr * (0.5 * (1 + torch.cos(pi * t / decay_steps)))
            if warmup:  # optax.linear_schedule(0, lr, warmup) below it
                warm = (0.0 - lr) * (1 - torch.clamp(c, 0, warmup) / warmup) + lr
                rate = torch.where(c < warmup, warm, rate)
            return rate
    elif cfg.schedule == "rsqrt":
        def schedule(count):
            c = torch.as_tensor(count).to(torch.float32)
            return torch.where(c < warmup, lr * c / timescale,
                               lr * torch.sqrt(timescale / torch.clamp(c, min=timescale)))
    elif cfg.schedule == "constant":
        def schedule(count):
            c = torch.as_tensor(count).to(torch.float32)
            if warmup > 0:
                return lr * torch.clamp(c / warmup, max=1.0)
            return torch.full_like(c, lr)
    else:
        raise ValueError(f"unknown schedule: {cfg.schedule!r}")
    return schedule


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(Σ Σ x²)`` over f32 tensors (optax ``global_norm``), from the
    per-tensor norms of one fused ``torch._foreach_norm``: equal to optax's
    sum of squares up to f32 rounding."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def partitioned_norm(parts, part_axes=None, layout: UpdateLayout | None = None) -> torch.Tensor:
    """The global norm of the whole parameters that ``parts`` are this
    rank's parts of: ``part_axes[i]`` names the axis whose ranks hold the
    other parts of tensor i (``"pp"``: the other stages' blocks, ``"ep"``:
    the other experts; None: whole), and ``layout`` the update sharding's
    rows (summed over its data axis). Each class of parts sums its squares
    over its axes; :func:`global_norm` when nothing is partitioned."""
    parts = list(parts)
    if part_axes is None:
        return global_norm(parts) if layout is None else layout.norm(parts)
    sq = torch.stack(torch._foreach_norm(parts)).float().square()
    return torch.sqrt(_partitioned_sum(sq, part_axes, layout))


def _partitioned_sum(sq: torch.Tensor, part_axes, layout: UpdateLayout | None = None):
    """Σ of the per-tensor sums ``sq`` over the whole tensors: see
    :func:`partitioned_norm`. The same collectives in the same order on
    every rank."""
    rows = [bool(layout is not None and layout.sharded[i]) for i in range(len(sq))]
    total = torch.zeros((), dtype=torch.float32, device=sq.device)
    for axis in (None, *sorted({a for a in part_axes if a is not None})):
        for sharded_rows in ((False, True) if layout is not None else (False,)):
            # The class's entries by their indices (a boolean mask's select
            # would take a data-dependent shape, which a trace cannot hold).
            index = [i for i, (a, r) in enumerate(zip(part_axes, rows))
                     if a == axis and r == sharded_rows]
            part = sq.index_select(0, torch.tensor(index, dtype=torch.long,
                                                   device=sq.device)).sum()
            if sharded_rows and layout.w > 1:
                dist.all_reduce(part, op=dist.ReduceOp.SUM, group=layout.group)
            if axis is not None and axis_size(axis_group(axis)) > 1:
                dist.all_reduce(part, op=dist.ReduceOp.SUM, group=axis_group(axis))
            total = total + part
    return total


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the update count and the moments, one
    tensor per parameter (``mu`` in ``adam_mu_dtype``, ``nu`` in f32)."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class AdamW:
    """``optax.chain(optax.clip_by_global_norm(clip), optax.adamw(schedule,
    b1, b2, eps, weight_decay=..., mu_dtype=...))`` over a list of f32
    parameters, updated in place."""

    def __init__(self, schedule, *, b1: float, b2: float, weight_decay: float,
                 mu_dtype: str | None = None, eps: float = 1e-8, clip: float = 1.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip
        self.mu_dtype = None if mu_dtype is None else _DTYPES[mu_dtype]

    def init(self, params) -> AdamWState:
        params = list(params)
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    def _leaf(self, p, g, mu, nu, bc1, bc2, step, *, nu_in_place: bool = False):
        """One parameter's update → ``(p_new, mu_new, nu_new)``, ``mu_new``
        unrounded (the update uses it; the stored moment is rounded).
        ``nu_in_place`` updates ``nu`` itself (the eager state's tensor)."""
        b1, b2 = self.b1, self.b2
        mu_new = (1 - b1) * g + mu * torch.tensor(b1, dtype=mu.dtype, device=mu.device)
        # nu stays f32: b2 * nu + (1 - b2) * g²
        nu = (nu.mul_(b2) if nu_in_place else nu * b2).add_((1 - b2) * (g * g))
        u = (mu_new / bc1.to(mu_new)) / (torch.sqrt(nu / bc2.to(nu)) + self.eps)
        return p + (u + self.weight_decay * p) * step, mu_new, nu

    @torch.no_grad()
    def apply(self, params, grads, state: AdamWState, layout: UpdateLayout | None = None,
              grads_sharded: bool = False, part_axes=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One update of ``params`` from ``grads`` (both lists, in the order of
        :meth:`init`), in place. Returns the global norms of the gradients
        (before clipping) and of the change ``p_new − p_old`` (the step's
        ``grad_norm`` and ``update_ratio`` numerator). With ``layout``, the
        sharded parameters' moments are this rank's rows (see
        :func:`_sharded_apply`); ``part_axes``: see :func:`partitioned_norm`."""
        count = state.count + 1
        bc1 = 1 - _f32(self.b1) ** count
        bc2 = 1 - _f32(self.b2) ** count
        step = -float(self.schedule(state.count))

        def leaf(i, p, g):
            new, mu_new, _ = self._leaf(p, g, state.mu[i], state.nu[i], bc1, bc2, step,
                                        nu_in_place=True)
            state.mu[i].copy_(mu_new)
            return new

        out = _sharded_apply(params, grads, leaf, self.clip, layout, grads_sharded, part_axes)
        state.count = count
        return out

    def update(self, params, grads, opt: dict):
        """:meth:`apply` as a function of tensors, for a traced step: ``opt``
        is :meth:`tree` of the state; returns ``(new_params, new_opt,
        grad_norm, update_norm)`` and writes nothing. The count, the bias
        corrections and the schedule are 0-d tensors on the device."""
        g_norm = global_norm(grads)
        count = opt["count"] + 1
        bc1 = 1 - _f32(self.b1).to(count.device) ** count
        bc2 = 1 - _f32(self.b2).to(count.device) ** count
        step = -self.schedule(opt["count"])
        new_params, mus, nus, update_sq = [], [], [], 0.0
        for p, g, mu, nu in zip(params, _clip(grads, g_norm, self.clip), opt["mu"], opt["nu"]):
            new, mu_new, nu_new = self._leaf(p, g, mu, nu, bc1, bc2, step)
            update_sq = update_sq + (new - p).square().sum()
            new_params.append(new)
            mus.append(mu_new.to(mu.dtype))
            nus.append(nu_new)
        return (new_params, {"count": count, "mu": mus, "nu": nus}, g_norm,
                torch.sqrt(update_sq))

    def tree(self, state: AdamWState, device) -> dict:
        """The state as a tree of tensors (the count a 0-d int64 on
        ``device``), the form :meth:`update` takes."""
        return {"count": torch.tensor(state.count, device=device), "mu": list(state.mu),
                "nu": list(state.nu)}


def _clip(grads, g_norm: torch.Tensor, max_norm: float) -> list[torch.Tensor]:
    """optax ``clip_by_global_norm`` without a host branch: each gradient
    divided by the global norm and scaled by ``max_norm`` where the norm is
    at least ``max_norm``, else divided and scaled by 1 (unchanged, bit for
    bit). Two multi-tensor ops, whatever the number of gradients; the
    gradients are f32, as the parameters."""
    keep = g_norm < max_norm
    return torch._foreach_mul(torch._foreach_div(list(grads), torch.where(keep, 1.0, g_norm)),
                              torch.where(keep, 1.0, max_norm))


def _sharded_apply(params, grads, leaf, clip: float, layout: UpdateLayout | None,
                   grads_sharded: bool, part_axes=None):
    """Clip ``grads`` by their global norm and run ``leaf(i, p, g) -> p_new``
    on each parameter (which updates that parameter's optimizer state in
    place); returns the gradients' global norm and the change's.

    With a ``layout``, a sharded parameter's update runs on this rank's
    rows only (``grads`` are those rows when ``grads_sharded``, else whole
    and sliced here), the norms sum the rows' squares over the data axis,
    and one all-gather per dtype publishes the new rows to every rank.
    ``part_axes``: the parameters held in parts over other axes
    (:func:`partitioned_norm`)."""
    params, grads = list(params), list(grads)
    if layout is None:
        g_norm = partitioned_norm(grads, part_axes)
        update_sq = torch.zeros((), dtype=torch.float32, device=g_norm.device)
        squares = []
        for i, (p, g) in enumerate(zip(params, _clip(grads, g_norm, clip))):
            new = leaf(i, p, g)
            if part_axes is None:
                update_sq += (new - p).square().sum()
            else:
                squares.append((new - p).square().sum())
            p.copy_(new)
        if part_axes is not None:
            update_sq = _partitioned_sum(torch.stack(squares), part_axes)
        return g_norm, torch.sqrt(update_sq)
    if not grads_sharded:
        grads = [layout.shard(i, g) for i, g in enumerate(grads)]
    g_norm = partitioned_norm(grads, part_axes, layout)
    parts, deltas = [], []
    for i, (p, g) in enumerate(zip(params, _clip(grads, g_norm, clip))):
        rows = layout.shard(i, p)
        new = leaf(i, rows, g)
        parts.append(new)
        deltas.append(new - rows)
    update_norm = partitioned_norm(deltas, part_axes, layout)
    layout.publish_(params, parts)
    return g_norm, update_norm


@dataclasses.dataclass
class LionState:
    """optax's ``ScaleByLionState``: the update count and the moment, one
    tensor per parameter in ``mu_dtype``."""

    count: int
    mu: list[torch.Tensor]


class Lion:
    """``optax.chain(optax.clip_by_global_norm(1.0), optax.lion(schedule,
    b1, b2, weight_decay=..., mu_dtype=...))`` over a list of f32
    parameters, updated in place: ``u = sign((1−b1)·g + b1·μ)`` from the old
    moment, ``μ ← (1−b2)·g + b2·μ`` stored in ``mu_dtype``, decoupled weight
    decay ``u + wd·p``, then ``−lr(count)·u``. As in JAX, ``b1·μ`` and
    ``b2·μ`` are taken in μ's dtype, b1 and b2 rounded to it first (JAX's
    weakly typed Python scalars)."""

    def __init__(self, schedule, *, b1: float, b2: float, weight_decay: float,
                 mu_dtype: str | None = None):
        self.schedule, self.b1, self.b2 = schedule, b1, b2
        self.weight_decay = weight_decay
        self.mu_dtype = None if mu_dtype is None else _DTYPES[mu_dtype]

    def init(self, params) -> LionState:
        return LionState(count=0, mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                                      for p in params])

    def _leaf(self, p, g, mu, b1, b2, step):
        """One parameter's update → ``(p_new, mu_new)``, ``b1``/``b2`` 0-d
        tensors in μ's dtype."""
        u = torch.sign((1.0 - self.b1) * g + b1 * mu)
        mu_new = (1.0 - self.b2) * g + b2 * mu
        return p + (u + self.weight_decay * p) * step, mu_new

    @torch.no_grad()
    def apply(self, params, grads, state: LionState, layout: UpdateLayout | None = None,
              grads_sharded: bool = False, part_axes=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One update in place; returns the gradients' global norm (before
        clipping) and the norm of ``p_new − p_old``, as :meth:`AdamW.apply`."""
        step = -float(self.schedule(state.count))
        betas = {}  # (dtype, device) -> (b1, b2) as 0-d tensors of that dtype

        def leaf(i, p, g):
            mu = state.mu[i]
            key = (mu.dtype, mu.device)
            if key not in betas:
                betas[key] = tuple(torch.tensor(b, dtype=mu.dtype, device=mu.device)
                                   for b in (self.b1, self.b2))
            new, mu_new = self._leaf(p, g, mu, *betas[key], step)
            mu.copy_(mu_new)
            return new

        out = _sharded_apply(params, grads, leaf, 1.0, layout, grads_sharded, part_axes)
        state.count += 1
        return out

    def update(self, params, grads, opt: dict):
        """:meth:`apply` as a function of tensors, as :meth:`AdamW.update`."""
        g_norm = global_norm(grads)
        step = -self.schedule(opt["count"])
        new_params, mus, update_sq = [], [], 0.0
        for p, g, mu in zip(params, _clip(grads, g_norm, 1.0), opt["mu"]):
            b1, b2 = (torch.tensor(b, dtype=mu.dtype, device=mu.device)
                      for b in (self.b1, self.b2))
            new, mu_new = self._leaf(p, g, mu, b1, b2, step)
            update_sq = update_sq + (new - p).square().sum()
            new_params.append(new)
            mus.append(mu_new.to(mu.dtype))
        return new_params, {"count": opt["count"] + 1, "mu": mus}, g_norm, torch.sqrt(update_sq)

    def tree(self, state: LionState, device) -> dict:
        """The state as a tree of tensors, as :meth:`AdamW.tree`."""
        return {"count": torch.tensor(state.count, device=device), "mu": list(state.mu)}


@dataclasses.dataclass
class AdafactorState:
    """optax's ``FactoredState`` per leaf of the JAX tree (``leaves``):
    factored row and column statistics where the leaf's two largest
    dimensions are both at least 128, else the full second moment (the
    unused slots are ``(1,)`` zeros, as in optax), in the JAX layout."""

    count: int
    leaves: list[JaxLeaf]
    v_row: list[torch.Tensor]
    v_col: list[torch.Tensor]
    v: list[torch.Tensor]


class Adafactor:
    """``optax.chain(optax.clip_by_global_norm(1.0),
    optax.adafactor(schedule, multiply_by_parameter_scale=False,
    weight_decay_rate=weight_decay))`` over a list of f32 parameters,
    updated in place, with optax's other defaults. Per leaf of the JAX tree,
    in optax's order:

    - the factored RMS scaling (``scale_by_factored_rms``): decay
      ``1 − (count+1)^−0.8``, ``ε₁ = 1e−30`` added to ``g²``; factored over
      the leaf's two largest dimensions (the later one on ties, as
      ``np.argsort`` orders them) when both are at least 128;
    - ``clip_by_block_rms(1.0)``: the update divided by ``max(1, rms)`` of
      the leaf;
    - the learning rate ``lr(count)``;
    - weight decay ``+ wd·p`` added after the learning-rate scaling, so it is
      ``wd·p`` per step whatever the rate;
    - the sign flip of descent.

    The leaves come from :meth:`init`: ``leaves=models.convert.jax_leaves(
    model)`` groups the port's per-layer tensors as the JAX tree stacks them
    under ``scan_layers=True`` (what :func:`create_train_state` passes); by
    default each tensor is a leaf of its own.
    """

    DECAY_RATE = 0.8
    MIN_DIM_SIZE_TO_FACTOR = 128
    EPS = 1e-30

    def __init__(self, schedule, *, weight_decay: float):
        self.schedule, self.weight_decay = schedule, weight_decay

    def factored_dims(self, shape) -> tuple[int, int] | None:
        """optax ``_factored_dims``: the two largest axes, ``(d1, d0)``, or
        None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, params, leaves: list[JaxLeaf] | None = None) -> AdafactorState:
        params = list(params)
        if leaves is None:
            leaves = [JaxLeaf(path=str(i), members=(i,), stacked=False, transposed=False)
                      for i in range(len(params))]
        state = AdafactorState(count=0, leaves=list(leaves), v_row=[], v_col=[], v=[])
        for leaf in state.leaves:
            p = leaf.gather(params)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            dims = self.factored_dims(tuple(p.shape))
            if dims is None:
                state.v_row.append(one)
                state.v_col.append(one.clone())
                state.v.append(torch.zeros_like(p, memory_format=torch.contiguous_format))
            else:
                d1, d0 = dims
                state.v_row.append(torch.zeros_like(p.sum(dim=d0)))
                state.v_col.append(torch.zeros_like(p.sum(dim=d1)))
                state.v.append(one.clone())
        return state

    def _leaf(self, g, p, v_row, v_col, v, d, lr, axis: str | None = None):
        """One leaf's update (JAX layout) → ``(p_new, v_row, v_col, v)``,
        the statistics a leaf does not use passed through. ``axis``: the
        axis whose ranks hold the leaf's other layers or experts (its block
        RMS is taken over the whole leaf)."""
        grad_sqr = g * g + self.EPS
        dims = self.factored_dims(tuple(g.shape))
        if dims is None:
            v = d * v + (1.0 - d) * grad_sqr
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = d * v_row + (1.0 - d) * grad_sqr.mean(dim=d0)
            v_col = d * v_col + (1.0 - d) * grad_sqr.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        u = u / torch.clamp(_block_rms(u, axis), min=1.0)  # block RMS at 1.0
        u = lr.to(u.device) * u
        u = -(u + self.weight_decay * p)
        return p + u, v_row, v_col, v

    @torch.no_grad()
    def apply(self, params, grads, state: AdafactorState, layout: UpdateLayout | None = None,
              grads_sharded: bool = False, part_axes=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One update in place; returns the gradients' global norm (before
        clipping) and the norm of ``p_new − p_old``, as :meth:`AdamW.apply`.
        Its statistics are whole on every rank under any ``layout``; sharded
        gradients are gathered first. A leaf held in parts over pp or ep
        (``part_axes``: a stage's layers, a rank's experts) keeps its parts'
        statistics, which are separable by layer and expert, and takes its
        block RMS over the whole leaf."""
        params, grads = list(params), list(grads)
        if layout is not None and grads_sharded:
            grads = layout.gather(grads)
        g_norm = partitioned_norm(grads, part_axes)
        grads = _clip(grads, g_norm, 1.0)
        t = _f32(state.count + 1)
        decay = 1.0 - t ** (-self.DECAY_RATE)
        lr = self.schedule(state.count)
        update_sq = torch.zeros((), dtype=torch.float32, device=g_norm.device)
        squares = []
        for i, leaf in enumerate(state.leaves):
            g, p = leaf.gather(grads), leaf.gather(params)
            axis = None if part_axes is None else part_axes[leaf.members[0]]
            new, state.v_row[i], state.v_col[i], state.v[i] = self._leaf(
                g, p, state.v_row[i], state.v_col[i], state.v[i], decay.to(g.device), lr, axis)
            if part_axes is None:
                update_sq += (new - p).square().sum()
            else:
                squares.append((new - p).square().sum())
            leaf.scatter_(params, new)
        if part_axes is not None:
            update_sq = _partitioned_sum(
                torch.stack(squares), [part_axes[leaf.members[0]] for leaf in state.leaves])
        state.count += 1
        return g_norm, torch.sqrt(update_sq)

    def update(self, params, grads, opt: dict, leaves: list[JaxLeaf]):
        """:meth:`apply` as a function of tensors, as :meth:`AdamW.update`;
        ``leaves`` are those of the state :meth:`tree` was taken from."""
        params, grads = list(params), list(grads)
        g_norm = global_norm(grads)
        grads = _clip(grads, g_norm, 1.0)
        t = (opt["count"] + 1).to(torch.float32)
        decay = 1.0 - t ** (-self.DECAY_RATE)
        lr = self.schedule(opt["count"])
        new_params = list(params)
        stats = {"v_row": [], "v_col": [], "v": []}
        update_sq = 0.0
        for i, leaf in enumerate(leaves):
            g, p = leaf.gather(grads), leaf.gather(params)
            new, *vs = self._leaf(g, p, opt["v_row"][i], opt["v_col"][i], opt["v"][i], decay, lr)
            for key, v in zip(("v_row", "v_col", "v"), vs):
                stats[key].append(v)
            update_sq = update_sq + (new - p).square().sum()
            for i_param, part in zip(leaf.members, leaf.parts(new)):
                new_params[i_param] = part.clone(memory_format=torch.contiguous_format)
        return (new_params, {"count": opt["count"] + 1, **stats}, g_norm,
                torch.sqrt(update_sq))

    def tree(self, state: AdafactorState, device) -> dict:
        """The state's tensors as a tree, as :meth:`AdamW.tree`; the leaf
        layout (``leaves``) rides along and is not a tensor of the tree."""
        return {"count": torch.tensor(state.count, device=device),
                "v_row": list(state.v_row), "v_col": list(state.v_col), "v": list(state.v)}


def _block_rms(u: torch.Tensor, axis: str | None) -> torch.Tensor:
    """``sqrt(mean(u²))`` of a leaf; with ``axis``, of the whole leaf whose
    parts the axis's ranks hold (their sums and counts all-reduced)."""
    group = None if axis is None else axis_group(axis)
    if axis is None or axis_size(group) == 1:
        return torch.sqrt(u.square().mean())
    parts = torch.stack([u.square().sum(), torch.tensor(float(u.numel()), device=u.device)])
    dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=group)
    return torch.sqrt(parts[0] / parts[1])


def make_optimizer(cfg: TrainConfig) -> AdamW | Lion | Adafactor:
    """``cfg.optimizer`` (AdamW, Lion or Adafactor) after global-norm
    clipping at 1.0, learning rate per ``cfg.schedule`` (see
    :func:`make_schedule`), as the JAX package's ``make_optimizer``."""
    schedule = make_schedule(cfg)
    if cfg.optimizer == "adamw":
        return AdamW(schedule, b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay,
                     mu_dtype=cfg.adam_mu_dtype)
    if cfg.optimizer == "lion":
        return Lion(schedule, b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay,
                    mu_dtype=cfg.adam_mu_dtype)
    if cfg.optimizer == "adafactor":
        return Adafactor(schedule, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")


def opt_state_from_optax(opt_state, tx, model: nn.Module) -> LionState | AdafactorState:
    """The port's state of a Lion or Adafactor ``tx`` (built by
    :func:`make_optimizer`) from the JAX package's optax state of the same
    optimizer over the same model's params, ``chain(clip_by_global_norm,
    lion | adafactor)``, so both packages can continue from one state at a
    step > 0. Reads the optax state's fields (``count``, ``mu``, ``v_row``,
    ``v_col``, ``v``); the tensors land on the model's device."""
    inner = opt_state[1][0]
    device = next(model.parameters()).device
    if isinstance(tx, Lion):
        mu = [t.to(device=device, dtype=tx.mu_dtype or p.dtype)
              for t, p in zip(param_list_from_jax(inner.mu, model), model.parameters())]
        return LionState(count=int(inner.count), mu=mu)
    if not isinstance(tx, Adafactor):
        raise TypeError(f"opt_state_from_optax takes Lion or Adafactor, got {type(tx).__name__}")
    leaves = jax_leaves(model)
    stats = adafactor_stats_from_jax(inner, leaves)
    return AdafactorState(count=int(inner.count), leaves=leaves,
                          **{k: [t.to(device) for t in v] for k, v in stats.items()})


def resolve_loss_quant(model: nn.Module, loss_cfg) -> str:
    """The loss's block-product quantization (JAX ``resolve_loss_quant``):
    ``"int8"`` when a tower trains through the int8 STE
    (``quant_train="int8"``) AND the streaming loss kernel is on, so
    ``quant_train`` reaches the loss's product with the same contract as
    every other STE dot; ``""`` otherwise (the plain loss has no int8 block
    product)."""
    if not getattr(loss_cfg, "use_pallas", False):
        return ""
    cfg = getattr(model, "cfg", None)
    modes = {
        tower_quant_mode(tcfg)
        for tcfg in (getattr(cfg, "vision", None), getattr(cfg, "text", None))
        if tcfg is not None
    }
    return "int8" if "int8_ste" in modes else ""


def validate_trainable_quant(model: nn.Module) -> None:
    """Refuse inference-quantized towers in training (JAX
    ``validate_trainable_quant``): ``quant="int8"`` rounds the projections'
    operands, whose gradient is zero almost everywhere, so such a tower
    would train to a standstill silently. ``quant_train="int8"`` (the STE:
    int8 forward, full-precision backward) passes."""
    cfg = getattr(model, "cfg", None)
    for tower in ("vision", "text"):
        tcfg = getattr(cfg, tower, None)
        if getattr(tcfg, "quant", ""):
            raise ValueError(
                f"{tower} tower has quant={tcfg.quant!r}: int8 quantization "
                "is inference-only (zero gradients through round); train "
                "with quant_train='int8' (STE: int8 forward, full-precision "
                "backward) or quant='' and quantize at eval/export time"
            )


def validate_accum_args(accum_steps: int, accum_dtype: str | None):
    """Shared accum contract: returns the accumulator dtype (None = param
    dtype). Refuse, don't drop: an unaccumulated step has no accumulator."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_dtype is not None and accum_steps == 1:
        raise ValueError(
            f"accum_dtype={accum_dtype!r} requires accum_steps > 1 "
            f"(got {accum_steps}); the unaccumulated step has no accumulator"
        )
    return _DTYPES[accum_dtype] if accum_dtype is not None else None


def validate_step_args(
    *,
    accum_steps: int,
    accum_dtype: str | None,
    accum_negatives: str,
    pp_microbatches: int,
    zero1: bool = False,
    moe_aux_weight: float | None = None,
    gradcache_embed_dtype: str | None = None,
    mesh_axis_names: tuple = ("dp",),
    update_sharding: str = "",
):
    """The JAX package's config-compatibility refusals for
    :func:`make_train_step`, word for word; returns ``(cached_accum,
    acc_dt)``."""
    mode = resolve_update_sharding(update_sharding, zero1)
    if accum_negatives not in ("local", "global"):
        raise ValueError(
            f"accum_negatives must be 'local' or 'global', got {accum_negatives!r}"
        )
    cached_accum = accum_negatives == "global" and accum_steps > 1
    acc_dt = validate_accum_args(accum_steps, accum_dtype)
    if gradcache_embed_dtype is not None and not cached_accum:
        raise ValueError(
            f"gradcache_embed_dtype={gradcache_embed_dtype!r} requires "
            "accum_negatives='global' with accum_steps > 1 (only the "
            "GradCache path stashes embedding tables)"
        )
    if cached_accum and pp_microbatches:
        raise ValueError(
            "accum_negatives='global' with pp_microbatches is not supported "
            "(the pp forward is already whole-batch per accumulation step)"
        )
    if pp_microbatches < 0:
        raise ValueError(f"pp_microbatches must be >= 0, got {pp_microbatches}")
    if pp_microbatches:
        if moe_aux_weight is not None:
            raise ValueError(
                "pp towers are dense (Block.apply drops sown aux losses); "
                "moe_aux_weight requires the non-pp path"
            )
        if mode != "off":
            raise ValueError(
                f"update_sharding={mode!r} with pp_microbatches is not "
                "supported"
            )
        if "pp" not in mesh_axis_names:
            raise ValueError(
                f"pp_microbatches={pp_microbatches} needs a mesh with a "
                f"'pp' axis, got {mesh_axis_names}"
            )
    return cached_accum, acc_dt


def accum_zeros(params, acc_dt):
    """Zeroed gradient accumulator in ``acc_dt`` (None = param dtype)."""
    return [torch.zeros_like(p, dtype=acc_dt or p.dtype) for p in params]


@torch.no_grad()
def accum_add(acc, grads):
    """Upcast-add-round, in place: each sum is taken in the gradient's dtype
    (f32) and rounded back into the accumulator's (the bf16-accumulator
    contract of the JAX ``accum_add``). One ``add_`` per tensor: PyTorch
    adds a bf16 tensor and an f32 one in f32 and rounds the result to bf16
    on the store. Returns ``acc``."""
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc


def accum_finish(acc, params, scale=None):
    """Back to the params' dtype, divided by ``scale`` (the microstep count)
    when given."""
    return [a.to(p.dtype) / scale if scale else a.to(p.dtype) for a, p in zip(acc, params)]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trained state), the optimizer and
    its state, the number of updates applied, the parameters' EMA (``None``
    = disabled; one tensor per parameter, ``train/ema.py``), the update
    sharding's layout (``None`` = replicated; the sharded parameters'
    moments are this rank's rows), the compressed step's error-feedback
    residuals (``None`` = none) and the adaptive compression's carry
    ``comp`` (``None`` = none; ``train.compressed_step.with_adaptive_compression``).
    ``ef`` and ``comp`` are derived state, never checkpointed.
    ``part_axes`` (``None`` = every parameter whole on every rank) names,
    for each parameter, the axis whose ranks hold its other parts: ``"pp"``
    for a pipeline stage's blocks, ``"ep"`` for sharded experts."""

    model: nn.Module
    tx: AdamW | Lion | Adafactor
    opt_state: AdamWState | LionState | AdafactorState
    step: int = 0
    ema: list[torch.Tensor] | None = None
    layout: UpdateLayout | None = None
    ef: list[torch.Tensor] | None = None
    comp: dict | None = None
    part_axes: list[str | None] | None = None

    @property
    def update_sharding(self) -> str:
        return "off" if self.layout is None else self.layout.mode

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())


def create_train_state(model: nn.Module, tx, ema: bool = False, zero1: bool = False,
                       update_sharding: str = "", axis_name: str = data_axis,
                       pp_axis: str | None = None, ep_axis: str | None = None) -> TrainState:
    """A train state over ``model``'s parameters (already initialized, on
    its device), with zeroed optimizer state, and with ``ema=True`` an EMA
    copy of the parameters (pair with ``ema_decay`` on
    :func:`make_train_step`). When ``torch.distributed`` runs more than one
    process, every rank first takes rank 0's parameters (one broadcast per
    dtype), so all start equal, as under DDP. Adafactor gets the JAX tree's
    leaves of ``model`` (``models.convert.jax_leaves``).

    ``update_sharding`` ("off" | "zero1" | "full"; ``zero1=True`` is the
    deprecated alias) lays the state out over ``axis_name``
    (:class:`~distributed_sigmoid_loss_tpu_torch.parallel.update_shard.UpdateLayout`):
    AdamW's and Lion's moments of a sharded parameter keep this rank's rows.
    The steps read the mode from the state (``state.layout``).

    After the broadcast, the model keeps its part on this rank: with
    ``pp_axis`` (JAX's ``create_train_state(..., pp_axis="pp")``, for
    ``pp_microbatches``) its pipeline stage's blocks
    (``parallel.pp_towers.keep_stage_blocks``), and with ``ep_axis`` (the
    sharding of JAX's stacked experts over its mesh's ``ep`` axis) its
    experts (``models.moe.shard_experts``; without it every rank keeps
    every expert); ``state.part_axes`` records which."""
    if axis_size() > 1:
        flat_collective_(model.parameters(), lambda flat: dist.broadcast(flat, src=0))
    part = {}
    if pp_axis is not None:
        from distributed_sigmoid_loss_tpu_torch.parallel.pp_towers import keep_stage_blocks

        keep_stage_blocks(model, pp_axis)
        part.update({n: pp_axis for n, _ in model.named_parameters()
                     if ".encoder.blocks." in n})
    if ep_axis is not None:
        from distributed_sigmoid_loss_tpu_torch.models.moe import expert_params, shard_experts

        shard_experts(model, ep_axis)
        part.update(dict.fromkeys(expert_params(model), ep_axis))
    part_axes = [part.get(n) for n, _ in model.named_parameters()] if part else None
    params = list(model.parameters())
    opt_state = (tx.init(params, leaves=jax_leaves(model)) if isinstance(tx, Adafactor)
                 else tx.init(params))
    mode = resolve_update_sharding(update_sharding, zero1)
    layout = None
    if mode != "off":
        layout = UpdateLayout([p.shape for p in params], mode, axis_name)
        for field in ("mu", "nu"):
            moments = getattr(opt_state, field, None)
            if moments is not None:
                setattr(opt_state, field, [layout.shard(i, t).clone()
                                           for i, t in enumerate(moments)])
    return TrainState(model=model, tx=tx, opt_state=opt_state,
                      ema=init_ema(params) if ema else None, layout=layout, part_axes=part_axes)


def _grads_of(params) -> list[torch.Tensor]:
    """Each parameter's ``.grad`` (zeros where the loss did not reach it:
    ``bias`` under the softmax family, as JAX's zero gradient), cleared."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    for p in params:
        p.grad = None
    return grads


def run_gradcache(model: nn.Module, micro_images, micro_tokens, island, accum_steps: int,
                  acc_dt=None, embed_dtype: str | None = None,
                  moe_aux_weight: float | None = None):
    """The GradCache recipe (Gao et al. 2021), ported from the JAX
    package's ``run_gradcache``: returns ``(loss, lp, grads)``, this rank's
    loss of the whole (M·mb) table, the loss scalars of the last microbatch
    and the gradients of that loss (f32, in ``model.parameters()`` order).
    With ``moe_aux_weight`` the gradients also carry that weight times the
    mean router aux loss (each microbatch's 1/M of it, in pass 2), and
    ``lp["moe_aux"]`` is that mean; ``loss`` leaves it out, as JAX's.

    ``micro_images`` / ``micro_tokens``: (M, mb, ...) microbatches.
    ``island(zis, zts, t_prime, bias)`` is the loss of the stacked (M, mb, d)
    tables (the per-shard loss and its collectives, on the flattened rows).

    Pass 1 embeds every microbatch under ``torch.no_grad()`` (one
    microbatch's activations live at a time), stored in ``embed_dtype``
    when given. The island runs once: the loss, dL/dZ and the direct
    t_prime/bias gradients. It reads a bf16 stash upcast to f32, so the
    loss carries the embeddings' bf16 rounding while dL/dZ stays f32, as in
    the jitted JAX step (XLA elides the bf16 round trip of the cotangents). Pass 2 re-runs each microbatch with the surrogate
    ``⟨z_m, dL/dz_m⟩`` plus the loss-parameter terms over M, whose
    gradients, summed into an ``acc_dt`` accumulator, are the gradients of
    the whole-table loss.
    """
    params = list(model.parameters())
    with torch.no_grad():
        outs = [model(micro_images[i], micro_tokens[i]) for i in range(accum_steps)]
    zis = torch.stack([zi for zi, _, _ in outs])
    zts = torch.stack([zt for _, zt, _ in outs])
    if embed_dtype is not None:
        zis, zts = zis.to(_DTYPES[embed_dtype]), zts.to(_DTYPES[embed_dtype])
    lp = {k: v.detach().clone() for k, v in outs[-1][2].items()}
    del outs
    acc = torch.promote_types(zis.dtype, torch.float32)
    leaves = [zis.to(acc).requires_grad_(), zts.to(acc).requires_grad_(),
              lp["t_prime"].clone().requires_grad_(), lp["bias"].clone().requires_grad_()]
    loss = island(*leaves)
    g_zis, g_zts, g_tp, g_bias = (
        torch.zeros_like(x) if g is None else g
        for x, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))
    )
    acc = accum_zeros(params, acc_dt)
    auxes = []
    for i in range(accum_steps):
        zi, zt, lp_ = model(micro_images[i], micro_tokens[i])
        surrogate = (zi * g_zis[i].to(zi.dtype)).sum() + (zt * g_zts[i].to(zt.dtype)).sum()
        surrogate = surrogate + (lp_["t_prime"] * g_tp + lp_["bias"] * g_bias) / accum_steps
        if moe_aux_weight is not None:
            aux = _moe_aux(lp_)
            surrogate = surrogate + moe_aux_weight * aux / accum_steps
            auxes.append(aux.detach().float())
        surrogate.backward()
        accum_add(acc, _grads_of(params))
    if auxes:
        lp["moe_aux"] = torch.stack(auxes).mean()
    return loss.detach().float(), lp, accum_finish(acc, params)


def _moe_aux(lp: dict) -> torch.Tensor:
    """The towers' mean router aux loss (``SigLIP.forward``'s
    ``lp["moe_aux"]``); JAX's refusal when the model has no MoE layer."""
    if "moe_aux" not in lp:
        raise ValueError(
            "moe_aux_weight is set but the model sowed no moe_aux_loss — "
            "enable moe_experts on the tower configs"
        )
    return lp["moe_aux"]


def make_batch_grads(model: nn.Module, per_shard: Callable, axis_name, accum_steps: int = 1,
                     cached_accum: bool = False, acc_dt=None,
                     gradcache_embed_dtype: str | None = None,
                     moe_aux_weight: float | None = None, forward=None) -> Callable:
    """``grads_of(params, batch) -> (loss, lp, grads)``: this rank's loss
    (the mean over its microbatches), the loss scalars before the update and
    its gradients (f32, in ``params`` order), before any sync. One forward
    and backward; with ``accum_steps > 1`` that many microbatches (rows
    ``[i·c, (i+1)·c)``, JAX's split over ``axis_name``) summed into an
    ``acc_dt`` accumulator by :func:`accum_add`, or with ``cached_accum``
    :func:`run_gradcache`. ``per_shard(zimg, ztxt, t_prime, bias)`` is the
    loss with its collectives. With ``moe_aux_weight`` the objective (and
    the loss returned) adds that weight times the towers' mean router aux
    loss, and ``lp["moe_aux"]`` is its mean over the microbatches.
    ``forward(images, tokens) -> (zimg, ztxt, lp)`` stands in for the
    model's forward (the pipelined towers, ``parallel/pp_towers.py``).
    Shared by the regular and the compressed step, which differ only in how
    they sync the result."""
    forward = model if forward is None else forward

    def loss_and_grads(params, images, tokens):
        for p in params:
            p.grad = None
        zimg, ztxt, lp = forward(images, tokens)
        loss = per_shard(zimg, ztxt, lp["t_prime"], lp["bias"])
        if moe_aux_weight is not None:
            loss = loss + moe_aux_weight * _moe_aux(lp)
        loss.backward()
        return (loss.detach().float(), {k: v.detach().clone() for k, v in lp.items()},
                _grads_of(params))

    def island(zis, zts, t_prime, bias):
        """The loss of the stacked (M, mb, d) tables, on the flattened rows."""
        return per_shard(zis.flatten(0, 1), zts.flatten(0, 1), t_prime, bias)

    def grads_of(params, batch: dict):
        device = params[0].device
        images = torch.as_tensor(batch["images"], device=device)
        tokens = torch.as_tensor(batch["tokens"], device=device)
        if accum_steps == 1:
            return loss_and_grads(params, images, tokens)
        micro_images = microbatch_split(images, accum_steps, axis_name, what="accum_steps")
        micro_tokens = microbatch_split(tokens, accum_steps, axis_name, what="accum_steps")
        if cached_accum:
            loss, lp, grads = run_gradcache(model, micro_images, micro_tokens, island,
                                            accum_steps, acc_dt, gradcache_embed_dtype,
                                            moe_aux_weight)
            if moe_aux_weight is not None:
                # The objective's aux term, reported as the other paths do.
                loss = loss + moe_aux_weight * lp["moe_aux"]
            return loss, lp, grads
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        acc = accum_zeros(params, acc_dt)
        auxes = []
        for i in range(accum_steps):
            loss, lp, grads = loss_and_grads(params, micro_images[i], micro_tokens[i])
            loss_sum = loss_sum + loss
            if "moe_aux" in lp:
                auxes.append(lp["moe_aux"].float())
            accum_add(acc, grads)
            del grads
        if auxes:
            lp["moe_aux"] = torch.stack(auxes).mean()
        return loss_sum / accum_steps, lp, accum_finish(acc, params, scale=accum_steps)

    return grads_of


def step_metrics(loss, lp: dict, grad_norm, update_norm, params, part_axes=None) -> dict:
    """The step's metrics: ``loss``, ``t`` (= exp(t_prime)) and ``bias``
    before the update, ``grad_norm`` (before clipping), ``param_norm`` after
    the update and ``update_ratio`` (the change's norm over ``param_norm``).
    ``part_axes``: the state's (:func:`partitioned_norm`)."""
    param_norm = partitioned_norm([p.detach() for p in params], part_axes)
    return {
        "loss": loss,
        "t": torch.exp(lp["t_prime"]),
        "bias": lp["bias"],
        "grad_norm": grad_norm,
        "param_norm": param_norm,
        "update_ratio": update_norm / (param_norm + 1e-12),
    }


def make_train_step(
    model: nn.Module,
    loss_cfg: LossConfig = LossConfig(),
    accum_steps: int = 1,
    ema_decay: float | None = None,
    moe_aux_weight: float | None = None,
    pp_microbatches: int = 0,
    accum_negatives: str = "local",
    accum_dtype: str | None = None,
    gradcache_embed_dtype: str | None = None,
    pp_schedule: str = "gpipe",
):
    """Build ``step(state, batch) -> (state, metrics)``, run by every rank of
    the default process group (one process without ``torch.distributed``).

    ``batch`` holds this rank's ``images`` (b, H, W, 3) and ``tokens`` (b, L)
    tensors, its share of the global batch; they are moved to the model's
    device. ``accum_steps > 1`` splits them into that many microbatches (rows
    ``[i·c, (i+1)·c)``, JAX's dp-interleaved split), runs forward and
    backward on each, sums their gradients into an accumulator of
    ``accum_dtype`` (default: the params' f32) by :func:`accum_add`, and
    applies their mean once. Each microbatch contrasts only against its own
    texts over the ranks (local negatives), as the JAX step does, unless
    ``accum_negatives="global"``: then :func:`run_gradcache` computes the
    exact loss of the whole batch and its gradients, every image against
    every text of every microbatch and rank, with one extra forward per
    microbatch (``gradcache_embed_dtype``: the dtype of its stashed
    embedding tables). The gradients are averaged over the ranks once, after
    accumulation.

    The update sharding is the state's (``create_train_state(...,
    update_sharding=...)``): under ``"full"`` the gradients are
    reduce-scattered and each rank updates its rows.

    ``ema_decay`` keeps the parameters' EMA in ``state.ema`` (decay warmed
    up per ``train.ema.ema_decay_schedule`` at the pre-update step), updated
    after the optimizer; create the state with ``ema=True``.

    With a bf16 accumulator the sum differs from JAX's by rounding only: JAX
    accumulates gradients already averaged over the ranks, the port each
    rank's own gradients (W times the size of its share) and averages after.

    ``metrics``: :func:`step_metrics` (``loss`` is the mean over
    microbatches and ranks), as 0-d f32 tensors on the model's device.

    Towers with ``quant_train="int8"`` train through the int8 STE, and with
    ``loss_cfg.use_pallas`` the loss's blocks take the kernel's int8 mode
    (:func:`resolve_loss_quant`); ``quant="int8"`` towers are refused
    (:func:`validate_trainable_quant`).

    ``moe_aux_weight`` (with ``moe_experts > 0`` towers) adds that weight
    times the mean router aux loss of every MoE layer to the objective, and
    the metric ``moe_aux`` (its mean over microbatches and ranks). Each rank
    takes Switch eq. 4 over its own tokens (the per-replica estimator, as
    JAX's compressed step); JAX's regular step takes it over the global
    batch, which differs at W > 1 (ROADMAP.md, deliberate differences).

    ``pp_microbatches > 0`` runs both towers' block stacks as pipeline
    stages over the ambient grid's ``pp`` axis with that many microbatches
    (each accumulation microbatch pipelined), in the ``pp_schedule``
    ("gpipe" or "1f1b", ``parallel/pipeline.py``); create the state with
    ``pp_axis="pp"``, so each rank holds its stage's blocks. Dense towers
    only, as in JAX.
    """
    validate_trainable_quant(model)
    cached_accum, acc_dt = validate_step_args(
        accum_steps=accum_steps,
        accum_dtype=accum_dtype,
        accum_negatives=accum_negatives,
        pp_microbatches=pp_microbatches,
        moe_aux_weight=moe_aux_weight,
        gradcache_embed_dtype=gradcache_embed_dtype,
        mesh_axis_names=grid_axis_names(),
    )
    forward = pp_forward(model, pp_microbatches, pp_schedule)
    per_shard = make_per_shard_loss(
        family=loss_cfg.family, variant=loss_cfg.variant, axis_name=loss_cfg.axis_name,
        bidir=loss_cfg.bidir, precision=loss_cfg.precision,
        use_pallas=loss_cfg.use_pallas, loss_impl=loss_cfg.loss_impl,
        ring_overlap=loss_cfg.ring_overlap, quant=resolve_loss_quant(model, loss_cfg),
    )
    grads_of = make_batch_grads(model, per_shard, loss_cfg.axis_name, accum_steps,
                                cached_accum, acc_dt, gradcache_embed_dtype, moe_aux_weight,
                                forward)

    def sync(loss, aux, grads, layout, full: bool):
        # DDP: one average over the data axis per step, the loss (and the
        # router aux) riding along; under full update sharding each rank
        # keeps its rows.
        scalars = loss.reshape(1) if aux is None else torch.stack([loss, aux])
        if layout is None:
            all_reduce_mean_([*grads, scalars], axis_group(loss_cfg.axis_name))
        else:
            all_reduce_mean_([scalars], axis_group(loss_cfg.axis_name))
            grads = layout.mean_grads(grads, scatter=full)
        return grads, scalars

    def step(state: TrainState, batch: dict):
        params = state.params
        layout = state.layout
        full = state.update_sharding == "full"
        loss, lp, grads = grads_of(params, batch)
        grads, scalars = sync(loss, lp.get("moe_aux"), grads, layout, full)
        grad_norm, update_norm = state.tx.apply(params, grads, state.opt_state, layout,
                                                grads_sharded=full, part_axes=state.part_axes)
        if ema_decay is not None:
            if state.ema is None:
                raise ValueError(
                    "ema_decay is set but state.ema is None — create the train "
                    "state with create_train_state(..., ema=True)"
                )
            update_ema(state.ema, params, step=state.step, decay=ema_decay)
        state.step += 1
        metrics = step_metrics(scalars[0], lp, grad_norm, update_norm, params,
                               state.part_axes)
        if moe_aux_weight is not None:
            metrics["moe_aux"] = scalars[1]
        return state, metrics

    # What step_attribution traces: one microbatch's forward and backward
    # (accum_steps of them run, alike; GradCache's whole batch at once) and
    # the sync.
    per_micro = accum_steps > 1 and not cached_accum
    step.attribution_parts = (
        make_batch_grads(model, per_shard, loss_cfg.axis_name, 1, False, acc_dt,
                         gradcache_embed_dtype, moe_aux_weight, forward)
        if per_micro else grads_of,
        accum_steps if per_micro else 1,
        lambda loss, aux, grads, state: sync(loss, aux, grads, state.layout,
                                             state.update_sharding == "full"),
        moe_aux_weight is not None)
    return step


def step_attribution(step, state: TrainState, batch: dict) -> dict | None:
    """``obs.attribution.static_attribution`` of what :func:`make_train_step`'s
    ``step`` runs on ``batch`` before the update: the microbatches' forwards
    and backwards (one traced, times ``accum_steps``) and the gradients'
    sync, the step's matrix products and collectives (the optimizer's and
    the EMA's updates are elementwise). The model runs on fake copies of its
    parameters, so the real ones and their ``.grad`` stay untouched, and
    nothing launches on the device. The compressed steps
    (``train/compressed_step.py``) carry the same parts, their sync being
    the dp hop, the compressed dcn hop and the scalars' mean. None for a
    step without these parts."""
    parts = getattr(step, "attribution_parts", None)
    if parts is None:
        return None
    from torch.nn.utils.stateless import _reparametrize_module

    from distributed_sigmoid_loss_tpu_torch.obs.attribution import static_attribution

    grads_of, times, sync, aux = parts
    model = state.model

    def fakes() -> dict:
        return {n: p.detach().clone().requires_grad_(p.requires_grad)
                for n, p in model.named_parameters()}

    def forward_backward(b):
        params = fakes()
        with _reparametrize_module(model, params):
            grads_of(list(params.values()), b)

    def synced():
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in fakes().values()]
        zero = grads[0].new_zeros(())
        sync(zero, zero if aux else None, grads, state)

    rows = len(batch["images"]) // times
    micro = {k: v[:rows] for k, v in batch.items()}
    costs = static_attribution(forward_backward, micro)
    once = static_attribution(synced)
    return {k: v * times + once[k] for k, v in costs.items()}


def grid_axis_names() -> tuple:
    """The ambient grid's axis names (JAX's ``mesh.axis_names``); ``("dp",)``
    without a grid."""
    grid = current_grid()
    return (data_axis,) if grid is None else grid.names


def pp_forward(model: nn.Module, pp_microbatches: int, pp_schedule: str = "gpipe"):
    """The forward of a step with ``pp_microbatches``: ``None`` (the model's
    own) at 0, else both towers pipelined over the grid's ``pp`` axis after
    JAX's build-time checks of the towers."""
    if not pp_microbatches:
        return None
    from distributed_sigmoid_loss_tpu_torch.parallel.pp_towers import (
        PP_SCHEDULES,
        siglip_forward_pp,
        validate_pp_tower,
    )

    if pp_schedule not in PP_SCHEDULES:
        raise ValueError(f"unknown pp_schedule {pp_schedule!r} (expected one of {PP_SCHEDULES})")
    stages = axis_size(axis_group("pp"))
    validate_pp_tower(model.cfg.vision, stages, "vision")
    validate_pp_tower(model.cfg.text, stages, "text")

    def forward(images, tokens):
        return siglip_forward_pp(model, images, tokens, num_microbatches=pp_microbatches,
                                 schedule=pp_schedule)

    return forward


def train_state_tree(state: TrainState) -> dict:
    """The tensors of ``state`` as the tree :func:`make_functional_train_step`
    takes and returns: ``params`` (name → tensor, detached, sharing the
    model's storage), ``opt_state`` (the optimizer's ``tree``), ``step`` (0-d
    int64) and, with an EMA, ``ema`` (name → tensor)."""
    names = [name for name, _ in state.model.named_parameters()]
    params = [p.detach() for p in state.model.parameters()]
    device = params[0].device
    tree = {"params": dict(zip(names, params)),
            "opt_state": state.tx.tree(state.opt_state, device),
            "step": torch.tensor(state.step, device=device)}
    if state.ema is not None:
        tree["ema"] = dict(zip(names, state.ema))
    return tree


def make_functional_train_step(model: nn.Module, tx, loss_cfg: LossConfig = LossConfig(),
                               ema_decay: float | None = None,
                               moe_aux_weight: float | None = None):
    """:func:`make_train_step`'s step as a function of tensors, for
    ``train.export.export_step``: ``step(tree, batch) -> (new_tree,
    metrics)`` over :func:`train_state_tree` trees, writing nothing, with
    the same values as the eager step (to rounding where a schedule or a
    bias correction is taken on the device instead of the host).

    How it differs from the eager step, so that ``torch.export`` can trace
    and save it: the state comes in and goes out as leaves (the count and
    the step are 0-d tensors); the gradients come from
    ``torch.autograd.grad`` on detached copies of the parameters, so no
    ``torch.no_grad`` region is needed; clipping and the schedule are taken
    with ``torch.where``; and the towers run without
    ``torch.utils.checkpoint`` under the trace (same values, more memory;
    ROADMAP.md queue C), which ``torch.export`` cannot hold.

    One batch a step (no accumulation), with ``ema_decay`` and
    ``moe_aux_weight`` (the metric ``moe_aux`` too) as the eager step takes
    them. More than one process is refused: a single-process artifact holds
    no collective.
    """
    validate_trainable_quant(model)
    if axis_size() > 1:
        raise NotImplementedError(
            f"a functional train step over {axis_size()} processes: the step's collectives "
            "(batch_isend_irecv, all_reduce) cannot be held in one process's artifact"
        )
    per_shard = make_per_shard_loss(
        family=loss_cfg.family, variant=loss_cfg.variant, axis_name=loss_cfg.axis_name,
        bidir=loss_cfg.bidir, precision=loss_cfg.precision,
        use_pallas=loss_cfg.use_pallas, loss_impl=loss_cfg.loss_impl,
        ring_overlap=loss_cfg.ring_overlap, quant=resolve_loss_quant(model, loss_cfg),
    )
    names = [name for name, _ in model.named_parameters()]
    leaves = jax_leaves(model) if isinstance(tx, Adafactor) else None

    def step(tree: dict, batch: dict):
        params = [tree["params"][n] for n in names]
        # Gradients of detached copies: the inputs stay plain tensors, so
        # the update needs no torch.no_grad region. The export's trace runs
        # with gradients off.
        with torch.enable_grad():
            req = {n: p.detach().requires_grad_() for n, p in zip(names, params)}
            zimg, ztxt, lp = torch.func.functional_call(model, req, (batch["images"],
                                                                     batch["tokens"]))
            loss = per_shard(zimg, ztxt, lp["t_prime"], lp["bias"])
            if moe_aux_weight is not None:
                loss = loss + moe_aux_weight * _moe_aux(lp)
            grads = torch.autograd.grad(loss, [req[n] for n in names], allow_unused=True,
                                        materialize_grads=True)
        loss = loss.detach().float()
        extra = {"leaves": leaves} if leaves is not None else {}
        new_params, new_opt, grad_norm, update_norm = tx.update(params, grads,
                                                                tree["opt_state"], **extra)
        out = {"params": dict(zip(names, new_params)), "opt_state": new_opt,
               "step": tree["step"] + 1}
        if ema_decay is not None:
            if "ema" not in tree:
                raise ValueError(
                    "ema_decay is set but the state has no ema — create the train "
                    "state with create_train_state(..., ema=True)"
                )
            d = ema_decay_schedule(tree["step"], ema_decay)
            ema = {}
            for n, p in zip(names, new_params):
                e = tree["ema"][n]
                df = d.to(device=e.device, dtype=e.dtype)
                ema[n] = e * df + (torch.ones((), dtype=e.dtype, device=e.device) - df) * p.to(
                    e.dtype)
            out["ema"] = ema
        param_norm = global_norm(new_params)
        metrics = {
            "loss": loss,
            "t": torch.exp(tree["params"]["t_prime"]),
            "bias": tree["params"]["bias"].clone(),
            "grad_norm": grad_norm,
            "param_norm": param_norm,
            "update_ratio": update_norm / (param_norm + 1e-12),
        }
        if moe_aux_weight is not None:
            metrics["moe_aux"] = lp["moe_aux"].detach().float()
        return out, metrics

    return step
