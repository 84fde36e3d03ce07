"""Pipeline parallelism over a ``pp`` axis: the GPipe and 1F1B schedules,
ported from the JAX package's ``parallel/pipeline.py``.

JAX runs one SPMD program under ``shard_map``: every stage executes every
tick, masks the warm-up and drain ticks with ``jnp.where``, and autodiff
derives the backward pipeline as the transpose of the scan. Here each stage
is a process of the axis's group:

- A stage holds its own blocks (``parallel/pp_towers.py``). It runs its
  stage function only on the ticks that carry a microbatch, so each stage
  runs each microbatch once.
- Activations move one :func:`~distributed_sigmoid_loss_tpu_torch.parallel.collectives.ring_shift_right`
  a tick over the axis, cotangents one ``ring_shift_left`` a tick the other
  way. Every rank takes part in every tick's shift, in the same order, so
  the point-to-point transfers always pair up.
- The schedule is one ``torch.autograd.Function``: its forward runs the
  forward ticks, its backward runs the backward ticks with a local
  ``torch.autograd.grad`` per microbatch and stage. So the collectives of
  the backward pipeline are issued by the schedule, in a fixed order, and
  never depend on the order in which the autograd engine reaches them.
- The last stage's outputs reach every rank of the axis (one broadcast: the
  values of JAX's masked ``psum``), and the cotangent of the stage-0 input
  reaches every rank the same way (the transpose of JAX's ``pvary``), so the
  layers before and after the block stack run and train replicated over pp.

:func:`gpipe` keeps every microbatch's graph until the backward (GPipe's
O(M) activation memory; ``checkpoint_stages`` keeps only each stage input
and runs the stage again in the backward). :func:`one_f_one_b` runs the
1F1B steady state: each tick one forward and one backward sub-tick a stage,
with a stage's graph kept only until its own backward (O(S) memory, at most
``2S − 1`` microbatches in flight). JAX's 1F1B re-runs each stage forward
under ``jax.vjp`` in the backward sub-tick; the port keeps the forward's
graph instead, so each microbatch's stage forward runs once.

:func:`pipeline_1f1b` is the 1F1B schedule as a block stack whose output
cotangent comes from outside (the towers' contrastive loss couples every
microbatch, so no loss can seed a microbatch's backward before all of them
have run forward): its forward runs the pipeline without a graph, and its
backward runs the 1F1B schedule with the output cotangents as the seeds.
The forward therefore runs twice, as under GradCache.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.collectives import (
    ring_shift_left,
    ring_shift_right,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    pipeline_axis,
)

__all__ = [
    "pipeline_axis",
    "gpipe",
    "one_f_one_b",
    "pipeline_1f1b",
    "stack_stage_params",
    "stage_layers",
]

def stack_stage_params(layer_params: dict, num_stages: int) -> dict:
    """Reshape layer-stacked tensors (each ``(depth, ...)``) to stage-major
    ``(num_stages, depth // num_stages, ...)`` — the layout of JAX's
    ``stack_stage_params``, whose row s is stage s's layers. ``depth`` must
    divide evenly into stages."""

    def reshape(leaf):
        depth = leaf.shape[0]
        if depth % num_stages:
            raise ValueError(
                f"depth {depth} does not divide into {num_stages} pipeline stages"
            )
        return leaf.reshape((num_stages, depth // num_stages) + tuple(leaf.shape[1:]))

    return {k: reshape(v) for k, v in layer_params.items()}


def stage_layers(depth: int, num_stages: int, stage: int) -> range:
    """The layers stage ``stage`` holds: the contiguous ``depth / S`` of
    :func:`stack_stage_params`'s row ``stage``."""
    if depth % num_stages:
        raise ValueError(f"depth {depth} does not divide into {num_stages} pipeline stages")
    per = depth // num_stages
    return range(stage * per, (stage + 1) * per)


def _src(group, rank: int) -> int:
    return rank if group is None or group is dist.group.WORLD else dist.get_global_rank(group, rank)


def _broadcast(x: torch.Tensor, stage: int, group) -> torch.Tensor:
    """``x`` of stage ``stage`` on every rank of the axis."""
    if axis_size(group) == 1:
        return x
    x = x.contiguous()
    dist.broadcast(x, src=_src(group, stage), group=group)
    return x


class _Schedule:
    """One stage's view of a pipeline: its stage function, its parameters,
    the axis's group and this stage's index."""

    def __init__(self, stage_fn, params, axis_name, group):
        self.stage_fn = stage_fn
        self.params = [p for p in params if p.requires_grad]
        self.axis_name = axis_name
        self.group = axis_group(axis_name, group)
        self.num_stages, self.stage = axis_size(self.group), axis_index(self.group)

    @property
    def is_last(self) -> bool:
        return self.stage == self.num_stages - 1

    def shift_right(self, x):
        if self.num_stages == 1:
            return x
        return ring_shift_right(x, self.axis_name, group=self.group)

    def shift_left(self, x):
        if self.num_stages == 1:
            return x
        return ring_shift_left(x, self.axis_name, group=self.group)

    def run(self, x_in, keep_graph: bool):
        """The stage on ``x_in`` → ``(leaf, y)``: with ``keep_graph`` the
        input as a leaf requiring grad and the output with its graph."""
        if not keep_graph:
            with torch.no_grad():
                return None, self.stage_fn(x_in)
        leaf = x_in.detach().requires_grad_()
        with torch.enable_grad():
            return leaf, self.stage_fn(leaf)

    def vjp(self, leaf, y, dy, grads):
        """Backpropagate ``dy`` from ``y`` to ``leaf`` and the stage's
        parameters; adds the parameters' gradients into ``grads`` and
        returns the input's cotangent."""
        with torch.enable_grad():
            got = torch.autograd.grad(y, [leaf, *self.params], dy, allow_unused=True)
        for acc, g in zip(grads, got[1:]):
            if g is not None:
                acc.add_(g)
        return torch.zeros_like(leaf) if got[0] is None else got[0]

    def zero_grads(self):
        return [torch.zeros_like(p) for p in self.params]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, checkpoint_stages: bool, xs, *params):
        s, n_st, m_total = sched.stage, sched.num_stages, xs.shape[0]
        act = torch.zeros_like(xs[0])
        saved, outs = {}, []
        for t in range(m_total + n_st - 1):
            received = sched.shift_right(act) if t else act
            m = t - s
            if not 0 <= m < m_total:
                act = torch.zeros_like(xs[0])
                continue
            x_in = xs[m] if s == 0 else received
            if checkpoint_stages:
                _, y = sched.run(x_in, keep_graph=False)
                saved[m] = x_in
            else:
                leaf, y = sched.run(x_in, keep_graph=True)
                saved[m] = (leaf, y)
            act = y.detach()
            if sched.is_last:
                outs.append(act)
        out = torch.stack(outs) if sched.is_last else torch.empty(
            (m_total,) + tuple(xs.shape[1:]), dtype=xs.dtype, device=xs.device)
        ctx.sched, ctx.checkpoint_stages, ctx.saved = sched, checkpoint_stages, saved
        ctx.xs_meta = (xs.shape, xs.dtype, xs.device)
        return _broadcast(out, n_st - 1, sched.group)

    @staticmethod
    def backward(ctx, g_out):
        sched, saved = ctx.sched, ctx.saved
        s, n_st = sched.stage, sched.num_stages
        shape, dtype, device = ctx.xs_meta
        m_total = shape[0]
        grads = sched.zero_grads()
        dxs = torch.zeros(shape, dtype=dtype, device=device)
        cot = torch.zeros(shape[1:], dtype=dtype, device=device)
        # The reverse schedule: stage s runs microbatch m's backward at
        # reverse tick (M − 1 − m) + (S − 1 − s), last microbatch first.
        for r in range(m_total + n_st - 1):
            received = sched.shift_left(cot) if r else cot
            m = m_total - 1 - r + (n_st - 1 - s)
            if not 0 <= m < m_total:
                cot = torch.zeros(shape[1:], dtype=dtype, device=device)
                continue
            dy = g_out[m] if sched.is_last else received
            entry = saved.pop(m)
            if ctx.checkpoint_stages:
                leaf, y = sched.run(entry, keep_graph=True)
            else:
                leaf, y = entry
            cot = sched.vjp(leaf, y, dy.to(y.dtype), grads).to(dtype)
            if s == 0:
                dxs[m] = cot
        dxs = _broadcast(dxs, 0, sched.group)
        return (None, None, dxs, *grads)


def gpipe(stage_fn: Callable[[torch.Tensor], torch.Tensor], microbatches: torch.Tensor, *,
          params: Sequence[torch.Tensor] = (), axis_name: str = pipeline_axis, group=None,
          checkpoint_stages: bool = False, stream_io: bool = False) -> torch.Tensor:
    """Run ``microbatches`` (M, mb, ...) through the S stages of the axis in
    the GPipe schedule (S + M − 1 ticks) and return the last stage's
    outputs (M, mb, ...) on every rank of the axis. Differentiable in the
    microbatches and in ``params``, this stage's parameters (those
    ``stage_fn``, ``x -> y`` with ``y.shape == x.shape``, reads).

    ``checkpoint_stages``: keep only each stage input and run the stage
    again in the backward. ``stream_io`` takes JAX's check (S | M); each
    stage process already holds only its own inputs, so it changes nothing
    else here."""
    sched = _Schedule(stage_fn, params, axis_name, group)
    if stream_io and microbatches.shape[0] % sched.num_stages:
        raise ValueError(
            f"stream_io requires stages | microbatches, got S={sched.num_stages}, "
            f"M={microbatches.shape[0]} (the M dim block-shards over pp as the home "
            f"layout; pad M or use stream_io=False)"
        )
    if not torch.is_grad_enabled():
        return _forward_only(sched, microbatches)
    return _GPipe.apply(sched, checkpoint_stages, microbatches, *sched.params)


def _run_1f1b(sched: _Schedule, xs: torch.Tensor, seed):
    """The 1F1B schedule (stage s, microbatch m, S stages, tick u):
    forward of m at u = m + s, backward of m at u = m + 2(S − 1) − s, M +
    2(S − 1) ticks. ``seed(m, y) -> (loss or None, dy)`` gives the last
    stage's cotangent of microbatch m's output. Returns ``(loss sum on the
    last stage, the parameters' gradients, the stage-0 input's cotangents
    (M, ...) on stage 0)``."""
    s, n_st, m_total = sched.stage, sched.num_stages, xs.shape[0]
    zeros = torch.zeros_like(xs[0])
    act, cot = zeros, zeros
    stash, seeds = {}, {}
    grads = sched.zero_grads()
    dxs = torch.zeros_like(xs)
    loss = torch.zeros((), dtype=torch.float32, device=xs.device)
    for u in range(m_total + 2 * (n_st - 1)):
        # -- forward sub-tick: microbatch u − s ---------------------------
        received = sched.shift_right(act) if u else act
        m_f = u - s
        act = zeros
        if 0 <= m_f < m_total:
            leaf, y = sched.run(xs[m_f] if s == 0 else received, keep_graph=True)
            stash[m_f] = (leaf, y)
            act = y.detach()
            if sched.is_last:
                loss_m, seeds[m_f] = seed(m_f, y)
                if loss_m is not None:
                    loss = loss + loss_m
        # -- backward sub-tick: microbatch u − 2(S − 1) + s ---------------
        received_cot = sched.shift_left(cot) if u else cot
        m_b = u - 2 * (n_st - 1) + s
        cot = zeros
        if 0 <= m_b < m_total:
            leaf, y = stash.pop(m_b)
            dy = seeds.pop(m_b) if sched.is_last else received_cot
            cot = sched.vjp(leaf, y, dy.to(y.dtype), grads).to(xs.dtype)
            if s == 0:
                dxs[m_b] = cot
    return loss, grads, dxs


class _OneFOneBLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, loss_fn, xs, *params):
        m_total = xs.shape[0]

        def seed(m, y):
            with torch.enable_grad():
                y_ = y.detach().requires_grad_()
                loss_m = loss_fn(y_).float() / m_total
                (dy,) = torch.autograd.grad(loss_m, [y_])
            return loss_m.detach(), dy

        loss, grads, dxs = _run_1f1b(sched, xs, seed)
        ctx.grads, ctx.dxs = grads, _broadcast(dxs, 0, sched.group)
        return _broadcast(loss, sched.num_stages - 1, sched.group)

    @staticmethod
    def backward(ctx, g):
        return (None, None, ctx.dxs * g.to(ctx.dxs.dtype), *(gp * g for gp in ctx.grads))


def one_f_one_b(stage_fn: Callable[[torch.Tensor], torch.Tensor], microbatches: torch.Tensor,
                loss_fn: Callable[[torch.Tensor], torch.Tensor], *,
                params: Sequence[torch.Tensor] = (), axis_name: str = pipeline_axis,
                group=None, stream_inputs: bool = False) -> torch.Tensor:
    """The 1F1B training schedule (JAX's ``one_f_one_b``): the mean over the
    M microbatches of ``loss_fn`` (a scalar of one last-stage output), on
    every rank of the axis. The schedule runs forward and backward
    together, so the gradients are computed here; ``backward()`` on the
    result hands them to ``params`` (this stage's parameters) and to the
    microbatches. ``stream_inputs`` takes JAX's check (S | M)."""
    sched = _Schedule(stage_fn, params, axis_name, group)
    if stream_inputs and microbatches.shape[0] % sched.num_stages:
        raise ValueError(
            f"stream_inputs requires stages | microbatches, got "
            f"S={sched.num_stages}, M={microbatches.shape[0]}"
        )
    return _OneFOneBLoss.apply(sched, loss_fn, microbatches, *sched.params)


def _forward_only(sched: _Schedule, xs: torch.Tensor) -> torch.Tensor:
    """The pipeline's forward without a graph: the last stage's outputs on
    every rank."""
    s, n_st, m_total = sched.stage, sched.num_stages, xs.shape[0]
    act = torch.zeros_like(xs[0])
    outs = []
    for t in range(m_total + n_st - 1):
        received = sched.shift_right(act) if t else act
        m = t - s
        act = torch.zeros_like(xs[0])
        if 0 <= m < m_total:
            _, act = sched.run(xs[m] if s == 0 else received, keep_graph=False)
            if sched.is_last:
                outs.append(act)
    out = torch.stack(outs) if sched.is_last else torch.empty_like(xs)
    return _broadcast(out, n_st - 1, sched.group)


class _Pipeline1F1B(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, xs, *params):
        ctx.sched = sched
        ctx.save_for_backward(xs)
        return _forward_only(sched, xs)

    @staticmethod
    def backward(ctx, g_out):
        (xs,) = ctx.saved_tensors
        sched = ctx.sched
        _, grads, dxs = _run_1f1b(sched, xs.detach(), lambda m, y: (None, g_out[m]))
        return (None, _broadcast(dxs, 0, sched.group), *grads)


def pipeline_1f1b(stage_fn: Callable[[torch.Tensor], torch.Tensor], microbatches: torch.Tensor,
                  *, params: Sequence[torch.Tensor] = (), axis_name: str = pipeline_axis,
                  group=None) -> torch.Tensor:
    """The block stack of :func:`gpipe` trained in the 1F1B schedule: the
    same outputs on every rank; the backward seeds each microbatch's 1F1B
    backward with its output cotangent (see the module docstring)."""
    sched = _Schedule(stage_fn, params, axis_name, group)
    return _Pipeline1F1B.apply(sched, microbatches, *sched.params)
