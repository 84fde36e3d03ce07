"""Sharding and state dataflow rules over the step traces (the port's
counterpart of the JAX package's ``analysis/shard_flow.py``, with JAX's six
rules under ``trace-`` ids).

They read the traces of ``analysis/trace_audit.py``: its invariance walk
(the groups a storage is replicated over, and those it was reduced or
gathered over) and its forward dependence of every storage on the step's
input leaves.

- ``trace-redundant-gather``: an all-gather whose operand is already
  replicated over the gathered group (more than a scalar's 8 bytes): W
  identical blocks of wire traffic and memory for data every rank holds.
- ``trace-state-drop``: a carried state leaf (an optimizer moment, an
  error-feedback residual, an adaptive statistic) that the step reads,
  combining it with other data, whose slot after the step still holds the
  untouched input: state the step maintains and then discards (JAX's
  scan-carry drop; the port's state is its train state's tensors).
- ``trace-collective-order``: across the ranks of one config's traces, the
  members of every group issue the same sequence of collectives on it, and
  each rank's sends to a peer match that peer's receives from it, in order
  and size — ranks that disagree wait on each other forever (the multihost
  hang class). Compared over the pipeline's and the ring's traces at every
  rank; the lattice has no expert-parallel axis (JAX's neither).
- ``trace-ef-threaded``: with error feedback, every residual after the step
  depends on step data beyond the residuals (the gradients): none is
  dropped, re-zeroed or passed through.
- ``trace-codec-threaded``: with the learned rung, the codec statistics the
  host trainer reads depend on step data beyond the codec operands, and
  some updated parameter depends on the codec operands (the decode reaches
  the update).
- ``trace-gather-placement``: under ``update_sharding="full"``, nothing
  produced by the reduce-scatter over the shard axis is all-gathered over it
  before the optimizer's first write: the update runs on the shard and only
  the updated parameters are published.
"""

from __future__ import annotations

from distributed_sigmoid_loss_tpu_torch.analysis.findings import Finding
from distributed_sigmoid_loss_tpu_torch.analysis.trace_audit import (
    _GATHERS,
    StepTrace,
    _Auditor,
    _group_name,
    _mask,
    dependencies,
    invariance,
)

__all__ = ["SHARD_FLOW_RULES", "audit_shard_flow", "audit_shard_flow_ranks"]

SHARD_FLOW_RULES = (
    "trace-redundant-gather",
    "trace-state-drop",
    "trace-collective-order",
    "trace-ef-threaded",
    "trace-codec-threaded",
    "trace-gather-placement",
)

# Carried state: what a step reads and must write back. The codec operands
# (host-trained, read-only in the step) and the parameters (checked by the
# update itself) are inputs, not carries.
_CARRIED = ("opt/", "ef/", "comp/")
_CODEC_IN = ("comp/codec_enc", "comp/codec_dec")
_CODEC_STATS = ("comp/blockmoment", "comp/codec_recon_err")


def _check_redundant_gathers(trace: StepTrace, aud: _Auditor) -> None:
    def visit(i, op, taints):
        # A scalar's gather (at most 8 bytes) is bookkeeping, as in JAX.
        if op.kind not in _GATHERS or op.nbytes <= 8:
            return
        for inv, _red in taints:
            if op.group in inv:
                aud.add("trace-redundant-gather",
                        f"{op.name} over {_group_name(trace, op.group)} of a value already "
                        "replicated over it — every rank contributes an identical copy, so the "
                        "gather moves W identical blocks for data each rank holds; drop it (or "
                        "shard the producer)")

    invariance(trace, visit)


def _is_carried(name: str) -> bool:
    return name.startswith(_CARRIED) and name not in _CODEC_IN and name != "comp/scheme"


def _check_state_drops(trace: StepTrace, aud: _Auditor, deps: dict, names: list) -> None:
    written = {s for op in trace.ops for s in op.writes}
    made = [deps.get(s, 0) for s in written]
    for name, s0 in trace.roots.items():
        if not _is_carried(name):
            continue
        bit = 1 << names.index(name)
        combined = any(d & bit and d & ~bit for d in made)
        s1 = trace.final.get(name)
        if combined and s1 == s0 and s0 not in written:
            aud.add("trace-state-drop",
                    f"state leaf {name} is read and combined with step data, but its slot after "
                    "the step still holds the untouched input — state the step maintains and "
                    "then discards; write the update back or stop carrying it")


def _check_ef_threading(trace: StepTrace, aud: _Auditor, deps: dict, names: list) -> None:
    ef_in = _mask(names, lambda n: n.startswith("ef/"))
    outs = sorted((n, s) for n, s in trace.final.items() if n.startswith("ef/"))
    if not outs:
        aud.add("trace-ef-threaded",
                "the step runs with error feedback but leaves no residual in the state — the "
                "carry is dropped")
    for name, s in outs:
        d = deps.get(s, 0)
        if not d:
            aud.add("trace-ef-threaded",
                    f"residual {name} after the step depends on no step input — the carried "
                    "residual is dropped or re-zeroed instead of accumulating this round's "
                    "compression error")
        elif not d & ~ef_in:
            aud.add("trace-ef-threaded",
                    f"residual {name} after the step depends only on the incoming residuals — "
                    "passed through un-updated; the compressed hop's error is discarded")


def _check_codec_threading(trace: StepTrace, aud: _Auditor, deps: dict, names: list) -> None:
    codec_in = _mask(names, lambda n: n in _CODEC_IN)
    for name in _CODEC_STATS:
        s = trace.final.get(name)
        if s is None:
            aud.add("trace-codec-threaded",
                    f"codec statistic {name} is missing from the state after the step — the "
                    "host trainer has nothing to read")
            continue
        d = deps.get(s, 0)
        if not d:
            aud.add("trace-codec-threaded",
                    f"codec statistic {name} depends on no step input — a constant; the host "
                    "trainer averages noise and the learned rung freezes at its cold start")
        elif not d & ~codec_in:
            aud.add("trace-codec-threaded",
                    f"codec statistic {name} depends only on the codec operands — not on this "
                    "round's gradients")
    params = [s for n, s in trace.final.items() if n.startswith("params/")]
    if codec_in and not any(deps.get(s, 0) & codec_in for s in params):
        aud.add("trace-codec-threaded",
                "no updated parameter depends on the codec operands (codec_enc/codec_dec) — "
                "the learned rung's decode never reaches the update")


def _check_gather_placement(trace: StepTrace, aud: _Auditor) -> None:
    axis = trace.groups.get(trace.checks["update_shard_axis"])
    state = {s for n, s in trace.roots.items() if n.startswith(("opt/", "params/"))}
    tainted: set = set()
    for op in trace.ops:
        if op.group is None and state.intersection(op.writes):
            return  # the optimizer's first write: the update has begun
        if op.kind == "psum_scatter" and op.group == axis:
            tainted.update(op.writes)
            continue
        if op.kind in _GATHERS and op.group == axis and tainted.intersection(op.reads):
            aud.add("trace-gather-placement",
                    f"{op.name} over {_group_name(trace, axis)} of a value produced by the "
                    "reduce-scatter over it, before the update — the 1/W update shard is "
                    "re-replicated, undoing the sharding and paying a gather per gradient that "
                    "the one publish of the updated parameters exists to avoid")
            continue
        if tainted.intersection(op.reads):
            tainted.update(op.writes)


def audit_shard_flow(trace: StepTrace) -> list[Finding]:
    """The single-trace shard-flow rules over one rank's trace (the
    ef/codec/gather-placement checks where its config arms them)."""
    aud = _Auditor(trace.label)
    _check_redundant_gathers(trace, aud)
    deps, names = dependencies(trace)
    if trace.checks.get("check_state_drop", True):
        _check_state_drops(trace, aud, deps, names)
    if trace.checks.get("ef"):
        _check_ef_threading(trace, aud, deps, names)
    if trace.checks.get("codec"):
        _check_codec_threading(trace, aud, deps, names)
    if trace.checks.get("update_shard_axis"):
        _check_gather_placement(trace, aud)
    return aud.findings


def audit_shard_flow_ranks(traces: list) -> list[Finding]:
    """``trace-collective-order`` over the traces of one config at every
    rank of its world."""
    aud = _Auditor(traces[0].label)
    by_rank = {t.rank: t for t in traces}
    seqs: dict = {}
    p2p: dict = {}
    for t in traces:
        for op in t.ops:
            if op.group is None:
                continue
            if op.name == "c10d::send":
                p2p.setdefault(("send", t.rank, op.peer), []).append(op.nbytes)
            elif op.name == "c10d::recv_":
                p2p.setdefault(("recv", op.peer, t.rank), []).append(op.nbytes)
            else:
                seqs.setdefault(op.group, {}).setdefault(t.rank, []).append(
                    (op.name, op.nbytes))
    for group, per_rank in sorted(seqs.items()):
        members = [r for r in group if r in by_rank]
        if len(members) < len(group):
            continue
        shapes = {tuple(per_rank.get(r, ())) for r in members}
        if len(shapes) > 1:
            lens = ", ".join(f"rank {r}: {len(per_rank.get(r, ()))}" for r in members)
            aud.add("trace-collective-order",
                    f"the ranks of {_group_name(traces[0], group)} issue different collective "
                    f"sequences on it ({lens} ops) — ranks that disagree enter mismatched "
                    "collectives and wait on each other forever")
    for (what, src, dst), sizes in sorted(p2p.items()):
        if what != "send" or src not in by_rank or dst not in by_rank:
            continue
        got = p2p.get(("recv", src, dst), [])
        if got != sizes:
            aud.add("trace-collective-order",
                    f"rank {src} sends {len(sizes)} payload(s) to rank {dst}, which receives "
                    f"{len(got)} from it (sizes {sizes} vs {got}) — the unmatched transfer "
                    "waits forever")
    for (what, src, dst), sizes in sorted(p2p.items()):
        if what == "recv" and src in by_rank and dst in by_rank \
                and ("send", src, dst) not in p2p:
            aud.add("trace-collective-order",
                    f"rank {dst} receives {len(sizes)} payload(s) from rank {src}, which sends "
                    "it none — the receive waits forever")
    return aud.findings
