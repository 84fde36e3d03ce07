"""The trace half of the port's lint (its counterpart of the JAX package's
``analysis/jaxpr_audit.py``): the communication structure and dtype hygiene
of the real train steps, checked on a trace of one step.

JAX traces its step builders to a closed jaxpr on 8 virtual CPU devices and
walks it. The port has no jaxpr. It builds each config of the sampled
step-config product (``analysis/config_space.py``) through its real
builders at tiny shapes, inside a one-process fake process group
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once, nothing is sent), and runs one step while
``obs/attribution.trace_ops`` records every operation: the storages it
reads and writes, its results' dtypes, whether the backward ran it, and for
a collective its kind, group and peer (:class:`StepTrace`). The kernels'
wrappers take their custom ops while it records. On a card the tensors are
``FakeTensorMode``'s, without storage, so that nothing launches; on the CPU
they are real and zero-valued, ten times faster, and the ops' bodies run
their plain versions. Both reach the same operations.

Every config is traced at rank 0 of a world of :data:`TRACE_WORLD` (8, the
JAX mesh); the sample holds JAX's fifteen ``DEFAULT_STEP_CONFIGS``
(``config_space.LEGACY_CONFIGS``). A config with its own point-to-point traffic (the ring's hop paths, the
pipeline) is traced again at every rank of a world of :data:`PEER_WORLD`
(4), so that the peers of every send and receive, and every rank's sequence
of collectives, can be checked across ranks.

Rules (ids used by ``lint --disable`` and the findings):

- ``trace-ppermute-bijection``: at every hop, the sends of the ranks of a
  group form a total bijection on it, and each rank receives from the rank
  that sends to it (JAX's check, ``parallel/collectives.ring_perm_problems``).
- ``trace-collective-axis``: every collective's group is a group of an axis
  of the config's process grid (or its batch axes together, or the world).
- ``trace-double-psum``: no value is all-reduced twice over one group (the
  S-fold overcount). Two taints ride the dataflow: the groups a storage is
  invariant (replicated) over, and those it is invariant over because it was
  already reduced or gathered over them; only an all-reduce of a still
  reduced value trips the rule, and mixing with varying data clears it.
- ``trace-f64``: no float64/complex128 result anywhere.
- ``trace-chunk-checkpoint``: the chunked loss recomputes its chunks in the
  backward: every (local_b × local_b) chunk product of the forward runs
  again in the backward, or the backward runs the loss kernel's backward,
  which recomputes its tiles (the memory contract of the chunked path).
- ``trace-bf16-upcast``: (opt-in, ``check_bf16_upcast=True``) no explicit
  bf16 → f32 conversion feeding a matrix product.

JAX's ``jaxpr-weak-type`` has no counterpart: a torch tensor has no weak
type, so a Python scalar cannot leak one into a step.
"""

from __future__ import annotations

import contextlib
import dataclasses

from distributed_sigmoid_loss_tpu_torch.analysis.findings import Finding
from distributed_sigmoid_loss_tpu_torch.obs.attribution import _PRODUCTS

__all__ = [
    "TRACE_RULES",
    "TRACE_WORLD",
    "PEER_WORLD",
    "StepTrace",
    "fake_process_group",
    "one_thread",
    "trace_step_config",
    "step_config_traces",
    "peer_traces",
    "audit_trace",
    "audit_peer_traces",
    "audit_default_step_configs",
]

TRACE_RULES = (
    "trace-ppermute-bijection",
    "trace-collective-axis",
    "trace-double-psum",
    "trace-f64",
    "trace-chunk-checkpoint",
    "trace-bf16-upcast",
)

TRACE_WORLD = 8
PEER_WORLD = 4

_KERNEL_LOSS_BWD = "dsl_torch_port::streaming_loss_bwd"
_WIDE = {"torch.float64", "torch.complex128"}
_GATHERS = frozenset({"all_gather"})


@dataclasses.dataclass
class StepTrace:
    """One traced step (or callable) at one rank.

    ``ops``: the :class:`~distributed_sigmoid_loss_tpu_torch.obs.attribution.TraceOp`
    list. ``groups``: name -> global ranks of the groups this rank may use
    (each grid axis, the batch axes together, the world). ``roots``: input
    leaf name -> storage before the step; ``final``: state leaf name ->
    storage after it. ``costs``: ``obs.attribution.trace_costs``.
    ``checks``: the rules this config arms (``expect_chunk_block``,
    ``check_bf16_upcast``, ``ef``, ``codec``, ``update_shard_axis``,
    ``check_state_drop``)."""

    label: str
    rank: int
    world: int
    ops: list
    groups: dict
    roots: dict
    final: dict
    costs: dict
    checks: dict = dataclasses.field(default_factory=dict)

    def bound(self) -> frozenset:
        """The rank tuples of every group this rank may use."""
        return frozenset(self.groups.values())


@contextlib.contextmanager
def fake_process_group(world: int, rank: int):
    """A one-process ``torch.distributed`` world of ``world`` ranks in which
    this process is ``rank``: the fake backend, whose collectives return at
    once and send nothing. Refuses to stack on an initialized group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the trace makes its own "
                           "fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_thread():
    """Run with one intra-op thread: a trace's tensors are tiny, and a pool
    of threads per process only contends with the other processes of the
    host."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _leaves(obj, prefix: str, out: dict) -> dict:
    """name -> tensor for every tensor in a tree of dicts, lists, tuples and
    objects with attributes."""
    import torch

    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _leaves(v, f"{prefix}/{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _leaves(v, f"{prefix}/{i}", out)
    elif hasattr(obj, "__dict__") and not callable(obj):
        for k, v in vars(obj).items():
            _leaves(v, f"{prefix}/{k}", out)
    return out


def _state_leaves(state) -> dict:
    """name -> tensor of a train state: ``params/<name>``, ``opt/...``,
    ``ef/<i>``, ``comp/<key>``."""
    out = {f"params/{n}": p for n, p in state.model.named_parameters()}
    _leaves(state.opt_state, "opt", out)
    if getattr(state, "ef", None) is not None:
        _leaves(list(state.ef), "ef", out)
    if getattr(state, "comp", None) is not None:
        _leaves(dict(state.comp), "comp", out)
    return out


# ---------------------------------------------------------------------------
# The step configs, built through the real builders at JAX's tiny shapes.
# ---------------------------------------------------------------------------


def _grid_axes(cfg, world: int) -> dict:
    """JAX's mesh allocation: (dcn?, dp, pp?) with dcn and pp fixed at 2
    (the tiny towers have depth 2) and dp taking the rest."""
    axes = {}
    fixed = 1
    if cfg.compression:
        axes["dcn"] = 2
        fixed *= 2
    axes["dp"] = 0
    if cfg.pp:
        axes["pp"] = 2
        fixed *= 2
    axes["dp"] = max(world // fixed, 1)
    return axes


def _model_config(cfg):
    from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

    mcfg = SigLIPConfig.tiny_test()
    tower = {}
    if cfg.use_pallas:
        # A lane-aligned embedding, so that the loss kernel's op (not its
        # plain fallback) is what the trace sees, as in JAX.
        tower["embed_dim"] = 128
    if cfg.quant_train:
        tower["quant_train"] = cfg.quant_train
    if cfg.pp:
        tower["scan_layers"] = True
    vision = dataclasses.replace(mcfg.vision, **tower)
    text = dataclasses.replace(mcfg.text, **tower)
    if cfg.moe:
        vision = dataclasses.replace(vision, moe_experts=4)
        text = dataclasses.replace(text, moe_experts=4, moe_num_selected=2)
    return dataclasses.replace(mcfg, vision=vision, text=text)


def _local_batch(cfg) -> int:
    """JAX's per-microstep quantum (the kernel's row contract) times the
    microbatch splits: this rank's rows."""
    quantum = 32 if (cfg.use_pallas and cfg.quant_train) else (8 if cfg.use_pallas else 2)
    return quantum * (2 if cfg.accum else 1) * (2 if cfg.pp else 1)


def _fake_mode(fake: bool):
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()


def trace_step_config(label: str, cfg, world: int = TRACE_WORLD, rank: int = 0,
                      device: str = "cpu", fake: bool | None = None) -> StepTrace:
    """One step of ``cfg`` (a ``config_space.StepConfig``) at ``rank`` of a
    fake world of ``world`` ranks, through the port's builders, recorded by
    ``obs.attribution.trace_ops``.

    ``fake`` (default: off the CPU) makes the model, its state and its batch
    tensors without storage (``FakeTensorMode``), so that nothing launches
    on a card. On the CPU they are real and zero-valued, which runs the same
    operations ten times faster; the collectives of the fake group leave
    their outputs unwritten, and the values do not matter to a trace."""
    import torch
    import torch.distributed as dist

    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.obs.attribution import trace_costs, trace_ops
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid
    from distributed_sigmoid_loss_tpu_torch.train import compressed_step as cs
    from distributed_sigmoid_loss_tpu_torch.train import train_step as ts
    from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, TrainConfig

    fake = device != "cpu" if fake is None else fake
    mcfg = _model_config(cfg)
    local_b = _local_batch(cfg)
    accum_steps = 2 if cfg.accum else 1
    pp_microbatches = 2 if cfg.pp else 0
    moe_aux = 0.01 if cfg.moe else None
    loss_cfg = LossConfig(variant=cfg.variant, family=cfg.family, loss_impl=cfg.loss_impl,
                          ring_overlap=cfg.ring_overlap, use_pallas=cfg.use_pallas)
    checks: dict = {}
    if cfg.loss_impl == "chunked":
        checks["expect_chunk_block"] = (local_b // accum_steps, local_b // accum_steps)
    if cfg.error_feedback:
        checks["ef"] = True
    if cfg.compression == "learned":
        checks["codec"] = True
    if cfg.update_sharding == "full":
        checks["update_shard_axis"] = "dp"
    with one_thread(), fake_process_group(world, rank), \
            ProcessGrid(_grid_axes(cfg, world)) as grid:
        groups = {name: tuple(dist.get_process_group_ranks(grid.group(name)))
                  for name in grid.names}
        batch_axes = tuple(n for n in grid.names if n in ("dcn", "dp"))
        if len(batch_axes) > 1 and len(batch_axes) < len(grid.names):
            groups["+".join(batch_axes)] = tuple(
                dist.get_process_group_ranks(grid.group(batch_axes)))
        groups["world"] = tuple(range(world))
        # Built on the meta device (no initializer runs: values do not
        # matter to a trace), then given storage on ``device``.
        model = SigLIP(mcfg, device="meta")
        with _fake_mode(fake), torch.no_grad():
            model = model.to_empty(device=device)
            if not fake:
                for t in [*model.parameters(), *model.buffers()]:
                    t.zero_()
        with _fake_mode(fake):
            tx = ts.make_optimizer(TrainConfig(warmup_steps=1, total_steps=10))
            state = ts.create_train_state(model, tx, update_sharding=cfg.update_sharding,
                                          pp_axis="pp" if cfg.pp else None)
            if cfg.compression in ("adaptive", "learned"):
                state = cs.with_adaptive_compression(state, learned=cfg.compression == "learned")
            elif cfg.error_feedback:
                state = cs.with_error_feedback(state)
            v, t = mcfg.vision, mcfg.text
            batch = {"images": torch.zeros((local_b, v.image_size, v.image_size, 3),
                                           device=device),
                     "tokens": torch.zeros((local_b, t.context_length), dtype=torch.int32,
                                           device=device)}
            if cfg.compression:
                step = cs.make_compressed_train_step(
                    model, loss_cfg, compression=cfg.compression,
                    error_feedback=cfg.error_feedback, accum_steps=accum_steps,
                    accum_negatives=cfg.accum_negatives, pp_microbatches=pp_microbatches,
                    moe_aux_weight=moe_aux)
            else:
                step = ts.make_train_step(
                    model, loss_cfg, accum_steps=accum_steps, moe_aux_weight=moe_aux,
                    pp_microbatches=pp_microbatches, accum_negatives=cfg.accum_negatives)
        if state.comp is not None:
            # The scheme table lives on the host, where the step reads it;
            # every rung is some tensor's, so the trace holds every rung's
            # path, as JAX's switch holds every branch.
            rungs = cs.N_SCHEMES if cfg.compression == "learned" else cs.N_SCHEMES - 1
            state.comp = dict(state.comp, scheme=torch.arange(
                len(state.comp["scheme"]), dtype=torch.int32) % rungs)
        with _fake_mode(fake), trace_ops() as tally:
            roots = {k: tally.sid(t) for k, t in _state_leaves(state).items()
                     if k != "comp/scheme"}
            roots.update({f"batch/{k}": tally.sid(t) for k, t in batch.items()})
            state, _metrics = step(state, batch)
            final = {k: tally.sid(t) for k, t in _state_leaves(state).items()
                     if k != "comp/scheme"}
    return StepTrace(label=label, rank=rank, world=world, ops=list(tally.ops), groups=groups,
                     roots=roots, final=final, costs=trace_costs(tally), checks=checks)


# Memo of the deterministic step-config traces: (device, world) -> label ->
# StepTrace, filled per label, so that the audit, obs/attribution and
# obs/regress pay each trace once, and the full product only for the labels
# the tier-1 sample lacks. Host-side; no step reads it.
_STEP_CONFIG_CACHE: dict = {}


def _sample(full_product: bool) -> dict:
    from distributed_sigmoid_loss_tpu_torch.analysis.config_space import (
        full_product_sample,
        tier1_sample,
    )

    return full_product_sample() if full_product else tier1_sample()


def step_config_traces(n_devices: int | None = None, full_product: bool = False,
                       device: str = "cpu") -> dict:
    """label -> :class:`StepTrace` at rank 0 of a fake world of
    ``n_devices`` (default :data:`TRACE_WORLD`) for the sampled step-config
    product (``config_space.tier1_sample``, or ``full_product_sample``),
    memoized per label."""
    world = n_devices or TRACE_WORLD
    if world < 4 or world % 2:
        raise RuntimeError(f"the trace audit needs an even world of >= 4 ranks to cover the "
                           f"sampled step configs (got {world})")
    cache = _STEP_CONFIG_CACHE.setdefault((device, world), {})
    sample = _sample(full_product)
    for label, cfg in sample.items():
        if label not in cache:
            cache[label] = trace_step_config(label, cfg, world, 0, device)
    return {label: cache[label] for label in sample}


def _has_peers(cfg) -> bool:
    """The configs traced at every rank: the pipeline, and the ring's hop
    paths (serial, overlapped, the kernel's block in the overlapped hop, the
    softmax ring) without the tower, accumulation or update-sharding axes,
    which leave the hops as they are."""
    return cfg.pp or (cfg.variant == "ring" and not (
        cfg.quant_train or cfg.accum or cfg.moe or cfg.update_sharding)
        and (cfg.ring_overlap or not cfg.use_pallas))


def peer_traces(full_product: bool = False, device: str = "cpu") -> dict:
    """label -> [StepTrace at each rank of a fake world of :data:`PEER_WORLD`]
    for the sampled configs :func:`_has_peers` picks, memoized per label."""
    cache = _STEP_CONFIG_CACHE.setdefault((device, "peers"), {})
    out = {}
    for label, cfg in _sample(full_product).items():
        if not _has_peers(cfg):
            continue
        if label not in cache:
            cache[label] = [trace_step_config(label, cfg, PEER_WORLD, r, device)
                            for r in range(PEER_WORLD)]
        out[label] = cache[label]
    return out


# ---------------------------------------------------------------------------
# Dataflow over a trace.
# ---------------------------------------------------------------------------


def dependencies(trace: StepTrace) -> tuple[dict, list]:
    """Forward dependence of every storage on the trace's roots: ``(deps,
    names)``, ``deps`` storage -> bitmask over ``names`` (the root leaf
    names) after the whole trace. A write takes the union of what its op
    reads (an overwrite reads nothing of its target); a receive takes what
    the last send on its group carried (one SPMD program: the peer sent the
    same data); a storage no root reaches has none."""
    names = list(trace.roots)
    deps = {sid: 1 << i for i, sid in enumerate(trace.roots.values())}
    last_send: dict = {}
    for op in trace.ops:
        if op.kind == "recv":
            d = last_send.get(op.group, 0)
        else:
            d = 0
            for s in op.reads:
                d |= deps.get(s, 0)
        if op.name == "c10d::send":
            last_send[op.group] = d
        for s in op.writes:
            deps[s] = d
    return deps, names


def _mask(names: list, pred) -> int:
    m = 0
    for i, n in enumerate(names):
        if pred(n):
            m |= 1 << i
    return m


# ---------------------------------------------------------------------------
# The rules.
# ---------------------------------------------------------------------------


class _Auditor:
    """Deduplicated findings of one trace."""

    def __init__(self, label: str):
        self.label = label
        self.findings: list[Finding] = []
        self._seen: set = set()

    def add(self, rule: str, detail: str) -> None:
        key = (rule, detail)
        if key not in self._seen:
            self._seen.add(key)
            self.findings.append(Finding(rule, self.label, detail))


def _group_name(trace: StepTrace, ranks) -> str:
    for name, g in trace.groups.items():
        if g == ranks:
            return name
    return str(list(ranks))


def invariance(trace: StepTrace, on_collective=None) -> dict:
    """The (invariant-over, reduced-over) taint of every storage: frozensets
    of group rank tuples. A root is varying; an op's results take the meet
    of what it reads (invariant only where every operand is; an op reading
    nothing, such as a fill or a factory, is invariant over every group); an
    all-reduce or all-gather over G adds G to both, a broadcast to the
    first; a reduce-scatter or all-to-all result varies; a receive keeps
    what the last send on its group carried. ``on_collective(i, op,
    taints)`` sees each collective with its operands' taints before it
    applies."""
    bound = trace.bound()
    varying = (frozenset(), frozenset())
    env: dict = {}
    last_send: dict = {}

    def get(s):
        return env.get(s, varying)

    def meet(sids, partial=()):
        inv, red = None, frozenset()
        for s in sids:
            # A part of a storage (a rank's rows, taken at an offset the trace
            # cannot tell from a constant) is unknown, so varying.
            i, r = varying if s in partial else get(s)
            inv = i if inv is None else inv & i
            red = red | r
        if inv is None:
            inv = bound
        return inv, red & inv

    for i, op in enumerate(trace.ops):
        if op.kind is None and not op.name.startswith("c10d::"):
            t = meet(op.reads, op.partial)
            for s in op.writes:
                env[s] = t
            continue
        if on_collective is not None:
            on_collective(i, op, [varying if s in op.partial else get(s) for s in op.reads])
        g = frozenset({op.group}) if op.group is not None else frozenset()
        if op.kind == "psum" or op.kind in _GATHERS:
            inv, red = meet(op.reads, op.partial)
            for s in op.writes:
                env[s] = (inv | g, (red | g) & (inv | g))
        elif op.name == "c10d::broadcast_":
            inv, red = meet(op.reads, op.partial)
            for s in op.writes:
                env[s] = (inv | g, red)
        elif op.name == "c10d::send":
            last_send[op.group] = meet(op.reads, op.partial)
        elif op.kind == "recv":
            for s in op.writes:
                env[s] = last_send.get(op.group, varying)
        else:
            for s in op.writes:
                env[s] = varying
    return env


def _check_collective_axes(trace: StepTrace, aud: _Auditor) -> None:
    bound = trace.bound()
    for op in trace.ops:
        if op.group is not None and op.group not in bound:
            aud.add("trace-collective-axis",
                    f"{op.name} over ranks {list(op.group)}, which is no group of the config's "
                    f"grid (groups: {sorted(trace.groups)}) — the collective resolves against a "
                    "foreign group, and its peers wait on one this config never makes")


def _check_double_psum(trace: StepTrace, aud: _Auditor) -> None:
    def visit(i, op, taints):
        if op.kind != "psum":
            return
        for _inv, red in taints:
            if op.group in red:
                aud.add("trace-double-psum",
                        f"{op.name} over {_group_name(trace, op.group)} of a value already "
                        "reduced or gathered over it — every rank contributes the identical "
                        "reduced value, so the result is W times the intended sum (the "
                        "overcount class)")

    invariance(trace, visit)


def _check_f64(trace: StepTrace, aud: _Auditor) -> None:
    for op in trace.ops:
        for dt in op.dtypes:
            if str(dt) in _WIDE:
                aud.add("trace-f64",
                        f"{op.name} produces a {dt} value — a silent f64 promotion; the card "
                        "runs f64 at a fraction of its f32 rate and the parity gates assume f32")


def _check_chunk_checkpoint(trace: StepTrace, aud: _Auditor) -> None:
    block = tuple(trace.checks["expect_chunk_block"])
    fwd = bwd = 0
    kernel_bwd = False
    for op in trace.ops:
        if op.name == _KERNEL_LOSS_BWD and op.backward:
            kernel_bwd = True
        if op.name in _PRODUCTS and any(tuple(sh[-2:]) == block and len(sh) == 2
                                        for sh in op.shapes):
            if op.backward:
                bwd += 1
            else:
                fwd += 1
    if kernel_bwd or (fwd and bwd >= fwd):
        return
    aud.add("trace-chunk-checkpoint",
            f"the backward recomputes {bwd} of the forward's {fwd} {block[0]}×{block[1]} chunk "
            "products and runs no loss-kernel backward — the chunked loss's backward keeps "
            "every chunk's logits instead of recomputing them, the (local_b, W·local_b) "
            "memory the chunked path exists to avoid")


def _check_bf16_upcasts(trace: StepTrace, aud: _Auditor) -> None:
    made_by = {}
    for op in trace.ops:
        if op.name in _PRODUCTS:
            for s in op.reads:
                src = made_by.get(s)
                if src is not None:
                    aud.add("trace-bf16-upcast",
                            f"{op.name} consumes an explicitly f32-upcast bf16 tensor — the "
                            "product runs at the f32 rate; keep its operands bf16 and "
                            "accumulate in f32")
        for s in op.writes:
            made_by.pop(s, None)
        if (op.name == "aten::_to_copy" and [str(d) for d in op.in_dtypes[:1]] == ["torch.bfloat16"]
                and [str(d) for d in op.dtypes[:1]] == ["torch.float32"]
                and any(len(sh) and _numel(sh) > 1 for sh in op.shapes)):
            for s in op.writes:
                made_by[s] = op


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def audit_trace(trace: StepTrace) -> list[Finding]:
    """The single-rank rules (axis, double-psum, f64, and the chunk and
    upcast checks where armed) over one trace."""
    aud = _Auditor(trace.label)
    _check_collective_axes(trace, aud)
    _check_double_psum(trace, aud)
    _check_f64(trace, aud)
    if trace.checks.get("expect_chunk_block"):
        _check_chunk_checkpoint(trace, aud)
    if trace.checks.get("check_bf16_upcast"):
        _check_bf16_upcasts(trace, aud)
    return aud.findings


def _p2p(trace: StepTrace) -> list:
    """(op, group) of each send and receive, in order."""
    return [op for op in trace.ops if op.name in ("c10d::send", "c10d::recv_")]


def audit_peer_traces(traces: list) -> list[Finding]:
    """``trace-ppermute-bijection`` over the traces of one config at every
    rank of its world: per group, the k-th sends of its ranks form a total
    bijection on it, and each rank's k-th receive comes from the rank whose
    k-th send goes to it."""
    from distributed_sigmoid_loss_tpu_torch.parallel.collectives import ring_perm_problems

    aud = _Auditor(traces[0].label)
    by_rank = {t.rank: t for t in traces}
    groups = {op.group for t in traces for op in _p2p(t)}
    for g in sorted(groups):
        if not all(r in by_rank for r in g):
            continue
        sends = {r: [op.peer for op in _p2p(by_rank[r]) if op.group == g
                     and op.name == "c10d::send"] for r in g}
        recvs = {r: [op.peer for op in _p2p(by_rank[r]) if op.group == g
                     and op.name == "c10d::recv_"] for r in g}
        hops = max(len(v) for v in sends.values())
        local = {r: i for i, r in enumerate(g)}
        name = _group_name(traces[0], g)
        for k in range(hops):
            perm = [(local[r], local.get(sends[r][k], -1)) for r in g if k < len(sends[r])]
            for problem in ring_perm_problems(perm, len(g)):
                aud.add("trace-ppermute-bijection",
                        f"hop {k} over {name} (size {len(g)}): {problem}")
            for r in g:
                if k >= len(recvs[r]):
                    continue
                src = recvs[r][k]
                if src not in sends or k >= len(sends[src]) or sends[src][k] != r:
                    aud.add("trace-ppermute-bijection",
                            f"hop {k} over {name}: rank {r} receives from rank {src}, which "
                            "does not send to it at that hop — the receive waits forever or "
                            "takes another hop's payload")
    return aud.findings


def audit_default_step_configs(n_devices: int | None = None, full_product: bool = False,
                               device: str = "cpu") -> list[Finding]:
    """The tier-1 (or ``full_product``) entry point: the trace rules and the
    shard-flow rules over every sampled config's rank-0 trace, and the peer
    rules over the multi-rank traces of the configs with peers."""
    from distributed_sigmoid_loss_tpu_torch.analysis.shard_flow import (
        audit_shard_flow,
        audit_shard_flow_ranks,
    )

    findings: list[Finding] = []
    for trace in step_config_traces(n_devices, full_product, device).values():
        findings.extend(audit_trace(trace))
        findings.extend(audit_shard_flow(trace))
    for traces in peer_traces(full_product, device).values():
        findings.extend(audit_peer_traces(traces))
        findings.extend(audit_shard_flow_ranks(traces))
    return findings
