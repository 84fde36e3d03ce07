"""The SigLIP train step, ported from the JAX package's
``train/train_step.py``: AdamW with global-norm clipping and the three
learning-rate schedules, gradient accumulation over microbatches with the
bf16-accumulator contract, data parallelism over ``torch.distributed``, and
the step's metrics.

Data parallelism follows DDP: every rank holds the same parameters
(:func:`create_train_state` broadcasts rank 0's), runs its own rows, and the
gradients are averaged over the ranks once per step, after accumulation
(DDP's ``no_sync`` over the microbatches), in one collective over a flat
buffer. Clipping and AdamW then run on the averaged gradients, identically
on every rank.

The optimizer is plain tensor code that follows optax's
``chain(clip_by_global_norm(1.0), adamw(...))`` operation by operation, not
``torch.optim.AdamW``, whose clipping, weight decay and moment rounding differ:

- the schedule is read at the update count *before* the update, so with
  warmup the first update is zero;
- ``warmup_cosine`` spans its cosine over ``total_steps − warmup_steps``;
- weight decay reaches every parameter (biases, LayerNorm scales,
  ``t_prime``, ``bias``), as ``optax.adamw`` has no mask;
- clipping divides by the global norm itself, with no ``+1e-6``;
- with ``adam_mu_dtype="bfloat16"`` the update uses the unrounded new first
  moment; only the stored moment is rounded (and its decay term is taken in
  bf16, as JAX computes ``b1 * mu`` in mu's dtype).

It updates the parameters, moments and gradient accumulator in place, one
tensor at a time, where JAX builds new arrays.

Paths of the JAX step that are not ported raise ``NotImplementedError``
naming their ROADMAP rows: GradCache (``accum_negatives="global"``), EMA,
the MoE aux loss, pipeline microbatches, update sharding, lion and
adafactor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from distributed_sigmoid_loss_tpu_torch.parallel.api import all_reduce_mean_, make_per_shard_loss
from distributed_sigmoid_loss_tpu_torch.parallel.collectives import flat_collective_
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_size
from distributed_sigmoid_loss_tpu_torch.parallel.microbatch import microbatch_split
from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, TrainConfig

__all__ = [
    "AdamW",
    "AdamWState",
    "TrainState",
    "make_optimizer",
    "make_schedule",
    "create_train_state",
    "make_train_step",
    "validate_accum_args",
    "validate_step_args",
    "resolve_update_sharding",
    "accum_zeros",
    "accum_add",
    "accum_finish",
    "global_norm",
]

UPDATE_SHARDING_MODES = ("off", "zero1", "full")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Named in the refusals of the JAX step's paths that are not ported.
LATER_ROADMAP_ROW = "ROADMAP.md queue A item 4"


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """``count -> learning rate``, in f32 as optax computes it: linear
    warmup then cosine decay (``warmup_cosine``), inverse square root
    (``rsqrt``) or constant (``constant``). ``warmup_steps=0`` means no
    warmup in every branch."""
    warmup, lr = cfg.warmup_steps, cfg.learning_rate
    timescale = max(warmup, 1)
    if cfg.schedule == "warmup_cosine":
        decay_steps = cfg.total_steps - warmup
        if decay_steps <= 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, got "
                f"decay_steps={decay_steps}."
            )

        def schedule(count: int) -> float:
            if count < warmup:  # optax.linear_schedule(0, lr, warmup)
                frac = 1 - torch.clamp(_f32(count), 0, warmup) / warmup
                return float((0.0 - lr) * frac + lr)
            t = torch.clamp(_f32(count - warmup), max=float(decay_steps))
            cosine = 0.5 * (1 + torch.cos(_f32(math.pi) * t / decay_steps))
            return float(lr * cosine)
    elif cfg.schedule == "rsqrt":
        def schedule(count: int) -> float:
            step = _f32(count)
            if count < warmup:
                return float(lr * step / timescale)
            return float(lr * torch.sqrt(timescale / torch.clamp(step, min=timescale)))
    elif cfg.schedule == "constant":
        def schedule(count: int) -> float:
            if warmup > 0:
                return float(lr * torch.clamp(_f32(count) / warmup, max=1.0))
            return float(_f32(lr))
    else:
        raise ValueError(f"unknown schedule: {cfg.schedule!r}")
    return schedule


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(Σ Σ x²)`` over f32 tensors (optax ``global_norm``), from the
    per-tensor norms of one fused ``torch._foreach_norm``: equal to optax's
    sum of squares up to f32 rounding."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


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

    @torch.no_grad()
    def apply(self, params, grads, state: AdamWState) -> tuple[torch.Tensor, torch.Tensor]:
        """One update of ``params`` from ``grads`` (both lists, in the order of
        :meth:`init`), in place. Returns the global norms of the gradients
        (before clipping) and of the change ``p_new − p_old`` (the step's
        ``grad_norm`` and ``update_ratio`` numerator)."""
        params, grads = list(params), list(grads)
        g_norm = global_norm(grads)
        clip = not bool(g_norm < self.clip)
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - _f32(b1) ** count
        bc2 = 1 - _f32(b2) ** count
        step = -self.schedule(state.count)
        update_sq = torch.zeros((), dtype=torch.float32, device=g_norm.device)
        for i, (p, g) in enumerate(zip(params, grads)):
            if clip:
                g = (g / g_norm.to(g.dtype)) * self.clip
            mu, nu = state.mu[i], state.nu[i]
            mu_new = (1 - b1) * g + mu * torch.tensor(b1, dtype=mu.dtype, device=mu.device)
            nu.mul_(b2).add_((1 - b2) * (g * g))  # nu stays f32: b2 * nu + (1 - b2) * g²
            u = (mu_new / bc1.to(mu_new)) / (torch.sqrt(nu / bc2.to(nu)) + self.eps)
            u = (u + self.weight_decay * p) * step
            new = p + u
            update_sq += (new - p).square().sum()
            p.copy_(new)
            mu.copy_(mu_new)
        state.count = count
        return g_norm, torch.sqrt(update_sq)


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """AdamW + global-norm clipping at 1.0, learning rate per
    ``cfg.schedule`` (see :func:`make_schedule`)."""
    schedule = make_schedule(cfg)
    if cfg.optimizer != "adamw":
        if cfg.optimizer not in ("lion", "adafactor"):
            raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (adamw is): {LATER_ROADMAP_ROW}"
        )
    return AdamW(schedule, b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay,
                 mu_dtype=cfg.adam_mu_dtype)


def resolve_update_sharding(update_sharding: str = "", zero1: bool = False) -> str:
    """The mode from the flag and the deprecated ``zero1`` alias, with the
    JAX package's refusals (``parallel/update_shard.py``)."""
    if update_sharding in ("", None):
        return "zero1" if zero1 else "off"
    if update_sharding not in UPDATE_SHARDING_MODES:
        raise ValueError(
            f"update_sharding must be one of {UPDATE_SHARDING_MODES}, "
            f"got {update_sharding!r}"
        )
    if zero1 and update_sharding == "off":
        raise ValueError(
            "zero1=True contradicts update_sharding='off' — drop the "
            "deprecated zero1 flag (it is the same lever as "
            "update_sharding='zero1')"
        )
    return update_sharding


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
    its state, and the number of updates applied."""

    model: nn.Module
    tx: AdamW
    opt_state: AdamWState
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())


def create_train_state(model: nn.Module, tx: AdamW) -> TrainState:
    """A train state over ``model``'s parameters (already initialized, on
    its device), with zeroed optimizer moments. When ``torch.distributed``
    runs more than one process, every rank first takes rank 0's parameters
    (one broadcast per dtype), so all start equal, as under DDP."""
    if axis_size() > 1:
        flat_collective_(model.parameters(), lambda flat: dist.broadcast(flat, src=0))
    return TrainState(model=model, tx=tx, opt_state=tx.init(model.parameters()))


def make_train_step(
    model: nn.Module,
    loss_cfg: LossConfig = LossConfig(),
    accum_steps: int = 1,
    zero1: bool = False,
    ema_decay: float | None = None,
    moe_aux_weight: float | None = None,
    pp_microbatches: int = 0,
    accum_negatives: str = "local",
    accum_dtype: str | None = None,
    gradcache_embed_dtype: str | None = None,
    update_sharding: str = "",
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
    texts over the ranks (local negatives), as the JAX step does. The
    gradients are averaged over the ranks once, after accumulation.

    With a bf16 accumulator the sum differs from JAX's by rounding only: JAX
    accumulates gradients already averaged over the ranks, the port each
    rank's own gradients (W times the size of its share) and averages after.

    ``metrics``: ``loss`` (mean over microbatches and ranks), ``t`` (=
    exp(t_prime)) and ``bias`` before the update, ``grad_norm`` (of the
    averaged gradients, before clipping), ``param_norm`` after the update and
    ``update_ratio`` (norm of the change over ``param_norm``), as 0-d f32
    tensors on the model's device.
    """
    cached_accum, acc_dt = validate_step_args(
        accum_steps=accum_steps,
        accum_dtype=accum_dtype,
        accum_negatives=accum_negatives,
        pp_microbatches=pp_microbatches,
        zero1=zero1,
        moe_aux_weight=moe_aux_weight,
        gradcache_embed_dtype=gradcache_embed_dtype,
        update_sharding=update_sharding,
    )
    if cached_accum:
        raise NotImplementedError(
            f"accum_negatives='global' (GradCache) is not ported yet: {LATER_ROADMAP_ROW}"
        )
    if ema_decay is not None:
        raise NotImplementedError(f"ema_decay (train/ema.py) is not ported yet: {LATER_ROADMAP_ROW}")
    if moe_aux_weight is not None:
        raise NotImplementedError(
            "moe_aux_weight: the MoE towers are not ported yet: ROADMAP.md queue A item 6.4"
        )
    if pp_microbatches:
        raise NotImplementedError(
            "pp_microbatches: the pipeline towers are not ported yet: ROADMAP.md queue A item 6.4"
        )
    if resolve_update_sharding(update_sharding, zero1) != "off":
        raise NotImplementedError(
            "update_sharding / zero1: sharded updates are not ported yet: "
            "ROADMAP.md queue A item 6.3"
        )
    per_shard = make_per_shard_loss(
        family=loss_cfg.family, variant=loss_cfg.variant, axis_name=loss_cfg.axis_name,
        bidir=loss_cfg.bidir, precision=loss_cfg.precision,
        use_pallas=loss_cfg.use_pallas, loss_impl=loss_cfg.loss_impl,
        ring_overlap=loss_cfg.ring_overlap,
    )

    def loss_and_grads(params, images, tokens):
        """Forward and backward of one (micro)batch; returns the loss, the
        pre-update loss scalars and the gradients (f32, in ``params`` order)."""
        for p in params:
            p.grad = None
        zimg, ztxt, lp = model(images, tokens)
        loss = per_shard(zimg, ztxt, lp["t_prime"], lp["bias"])
        loss.backward()
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        return loss.detach().float(), {k: v.detach().clone() for k, v in lp.items()}, grads

    def step(state: TrainState, batch: dict):
        params = state.params
        device = params[0].device
        images = torch.as_tensor(batch["images"], device=device)
        tokens = torch.as_tensor(batch["tokens"], device=device)
        if accum_steps == 1:
            loss, lp, grads = loss_and_grads(params, images, tokens)
        else:
            micro_images = microbatch_split(images, accum_steps, loss_cfg.axis_name,
                                            what="accum_steps")
            micro_tokens = microbatch_split(tokens, accum_steps, loss_cfg.axis_name,
                                            what="accum_steps")
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            acc = accum_zeros(params, acc_dt)
            for i in range(accum_steps):
                loss, lp, grads = loss_and_grads(params, micro_images[i], micro_tokens[i])
                loss_sum = loss_sum + loss
                accum_add(acc, grads)
                del grads
            grads = accum_finish(acc, params, scale=accum_steps)
            loss = loss_sum / accum_steps
        # DDP: one average over the ranks per step, the loss riding along.
        loss = loss.reshape(1)
        all_reduce_mean_([*grads, loss])
        loss = loss[0]
        grad_norm, update_norm = state.tx.apply(params, grads, state.opt_state)
        state.step += 1
        param_norm = global_norm(p.detach() for p in params)
        metrics = {
            "loss": loss,
            "t": torch.exp(lp["t_prime"]),
            "bias": lp["bias"],
            "grad_norm": grad_norm,
            "param_norm": param_norm,
            "update_ratio": update_norm / (param_norm + 1e-12),
        }
        return state, metrics

    return step
