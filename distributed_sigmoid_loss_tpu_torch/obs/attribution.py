"""Static step attribution: FLOPs, bytes and collective traffic from the
program, not the device (the port of the JAX package's
``obs/attribution.py``).

:func:`static_attribution` runs ``fn(*args)`` once under
``FakeTensorMode``: every tensor is a shape without storage, so nothing runs
on a device, no kernel launches and no collective goes out (the process
group's operations take their fake versions). A dispatch mode watches it:

- the flop counter's formulas (``torch.utils.flop_counter``) count the
  matrix products and convolutions (2·B·M·N·K), the backward's included. The hand-written
  kernels are custom ops, which a tensor without storage reaches as such
  (``ops._cuda.take_op``); each has a formula (:data:`KERNEL_FLOPS`,
  registered with ``register_flop_formula``) that counts what the JAX
  package's walk counts for the ``pallas_call`` it replaces: the body's
  products times the grid, padded tiles included. ``torch._int_mm`` (the
  int8 products) gets one too; the flop counter has none.
- a tally of the process group's operations by kind, per device, with the
  JAX package's wire conventions for a collective whose per-shard operand is
  ``s`` bytes over a group of ``W``:

  ==================  =====================  ==============================
  kind                bytes per device       the port's operations
  ==================  =====================  ==============================
  all_gather          ``(W-1)·s``            all_gather, _allgather_base
  ppermute            ``s``                  send (the ring's hops)
  psum                ``2·s·(W-1)/W``        allreduce
  psum_scatter        ``s·(W-1)/W``          reduce_scatter (``s`` the full
                                             operand)
  all_to_all          ``s·(W-1)/W``          alltoall, broadcast
  ==================  =====================  ==============================

  A group of one sends nothing, as an axis of one does in JAX.

``bytes_est`` sums every operation's operand and result bytes: a
fusion-ignorant upper bound on memory traffic, reported but not fed into
``mfu_est``.

The same mode records a step trace when asked (:func:`trace_ops`): each
operation as a :class:`TraceOp`, with the storages it reads and writes, its
results' dtypes and shapes, whether the backward ran it, and for a
collective its kind, its group's ranks and its peer. The lint's trace
rules (``analysis/trace_audit.py``, ``analysis/shard_flow.py``) read it, and
:func:`step_config_attribution` sums the same trace's costs over the
sampled step configs.

:func:`roofline_estimate` turns (flops, comm bytes) into per-resource time
bounds on a card of :data:`CHIP_SPECS` and ``mfu_est``, the MFU the
program's arithmetic-to-traffic ratio permits there: a ceiling, not a
prediction. The default card is the H100 the port targets, so the estimate
exists on hosts without one.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

__all__ = [
    "TraceOp",
    "trace_ops",
    "trace_costs",
    "step_config_attribution",
    "CHIP_SPECS",
    "DEFAULT_CHIP",
    "COLLECTIVE_KINDS",
    "KERNEL_FLOPS",
    "static_attribution",
    "roofline_estimate",
    "metrics_line_fields",
]

# torch.cuda.get_device_name -> (peak dense bf16 TFLOP/s, HBM GB/s, NVLink
# GB/s per direction): spec-sheet peaks.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0, 450.0),
}

DEFAULT_CHIP = "NVIDIA H100 80GB HBM3"

COLLECTIVE_KINDS = (
    "all_gather", "ppermute", "psum", "psum_scatter", "all_to_all",
)

# Wire-bytes factor as a function of the group size W, per kind (JAX's).
_WIRE_FACTORS = {
    "all_gather": lambda w: w - 1,
    "ppermute": lambda w: 1.0,
    "psum": lambda w: 2.0 * (w - 1) / w,
    "psum_scatter": lambda w: (w - 1) / w,
    "all_to_all": lambda w: (w - 1) / w,
}

# Process-group operation -> (kind, the argument holding its operand, the
# argument holding its process group).
_C10D_KINDS = {
    "allreduce_": ("psum", 0, 1),
    "allgather_": ("all_gather", 1, 2),
    "_allgather_base_": ("all_gather", 1, 2),
    "reduce_scatter_": ("psum_scatter", 1, 2),
    "_reduce_scatter_base_": ("psum_scatter", 1, 2),
    "alltoall_": ("all_to_all", 1, 2),
    "alltoall_base_": ("all_to_all", 1, 2),
    "send": ("ppermute", 0, 1),
    "broadcast_": ("all_to_all", 0, 1),
}


# -- the kernels' FLOP formulas -------------------------------------------------
#
# Each counts the products of the JAX pallas_call(s) the custom op replaces,
# times its grid: K1 two products a head over (s, s) pairs, K2 and K3 five
# (the probabilities again, dv, dp, dq, dk); K7 pads s to a multiple of 128
# and its backward runs a dK/dV pass of four products and a dQ pass of three;
# K4 one product a tile, K5 and K6 two each (the logits again and the
# gradient). The int8 modes count as the f32 ones.


def _pad128(s: int) -> int:
    return (s + 127) // 128 * 128


def short_attention_fwd_flops(q_shape) -> int:
    b, s, h, dh = q_shape
    return 4 * b * s * s * h * dh


def short_attention_bwd_flops(q_shape) -> int:
    b, s, h, dh = q_shape
    return 10 * b * s * s * h * dh


def flash_attention_fwd_flops(q_shape) -> int:
    b, s, h, dh = q_shape
    return 4 * b * h * _pad128(s) ** 2 * dh


def flash_attention_bwd_dkv_flops(q_shape) -> int:
    b, s, h, dh = q_shape
    return 8 * b * h * _pad128(s) ** 2 * dh


def flash_attention_bwd_dq_flops(q_shape) -> int:
    b, s, h, dh = q_shape
    return 6 * b * h * _pad128(s) ** 2 * dh


def sigmoid_loss_fwd_flops(zimg_shape, ztxt_shape) -> int:
    (b, d), n = zimg_shape, ztxt_shape[0]
    return 2 * b * n * d


def sigmoid_loss_bwd_img_flops(zimg_shape, ztxt_shape) -> int:
    (b, d), n = zimg_shape, ztxt_shape[0]
    return 4 * b * n * d


def sigmoid_loss_bwd_txt_flops(zimg_shape, ztxt_shape) -> int:
    (b, d), n = zimg_shape, ztxt_shape[0]
    return 4 * b * n * d


def _rows(shape) -> int:
    return math.prod(shape[:-1])


# Custom op name (dsl_torch_port::<name>) -> flops(*args of the op).
KERNEL_FLOPS = {
    "short_attention_fwd": lambda q, *_: short_attention_fwd_flops(q.shape),
    "short_attention_bwd": lambda q, *_: short_attention_bwd_flops(q.shape),
    "flash_attention_fwd": lambda q, *_: flash_attention_fwd_flops(q.shape),
    "flash_attention_bwd": lambda q, *_: (flash_attention_bwd_dkv_flops(q.shape)
                                          + flash_attention_bwd_dq_flops(q.shape)),
    "streaming_loss_fwd": lambda zi, zt, *_: sigmoid_loss_fwd_flops(zi.shape, zt.shape),
    "streaming_loss_bwd": lambda zi, zt, *_: (sigmoid_loss_bwd_img_flops(zi.shape, zt.shape)
                                              + sigmoid_loss_bwd_txt_flops(zi.shape, zt.shape)),
    # JAX's int8 products are dot_generals: 2·rows·K·out.
    "int8_linear": lambda x, w, *_: 2 * _rows(x.shape) * x.shape[-1] * w.shape[0],
    "int8_expert_matmul": lambda x, w, *_: 2 * _rows(x.shape) * x.shape[-1] * w.shape[-1],
}

_REGISTERED = False


def _register_kernel_flop_formulas() -> None:
    """Register :data:`KERNEL_FLOPS` for the kernels' custom ops, and
    ``2·m·n·k`` for ``torch._int_mm``, with the flop counter (once; imports
    the ops modules, which define the custom ops)."""
    global _REGISTERED
    if _REGISTERED:
        return
    import torch
    from torch.utils.flop_counter import register_flop_formula

    import distributed_sigmoid_loss_tpu_torch.ops.flash_attention  # noqa: F401
    import distributed_sigmoid_loss_tpu_torch.ops.quant  # noqa: F401
    import distributed_sigmoid_loss_tpu_torch.ops.short_attention  # noqa: F401
    import distributed_sigmoid_loss_tpu_torch.ops.streaming_sigmoid_loss  # noqa: F401

    def raw(formula):
        def count(*args, out_val=None, **kwargs):
            return formula(*args)
        return count

    for name, formula in KERNEL_FLOPS.items():
        register_flop_formula(getattr(torch.ops.dsl_torch_port, name), get_raw=True)(raw(formula))

    @register_flop_formula(torch.ops.aten._int_mm)
    def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]

    _REGISTERED = True


# -- the walk -----------------------------------------------------------------


class TraceOp(NamedTuple):
    """One operation of a step trace. Storages are small integers, one per
    storage the trace met (views share their base's).

    ``reads``: the storages whose values the operation reads; ``writes``:
    the storages it writes (its results, and arguments written in place).
    ``dtypes``: its results' (``torch.dtype``); for the products and
    conversions, ``shapes`` (its results') and ``in_dtypes`` (its tensor
    operands'), else empty. ``backward``: the autograd engine ran it. For a process-group
    operation, ``kind`` (a key of :data:`COLLECTIVE_KINDS`, or ``"recv"``),
    ``group`` (the global ranks of its group), ``peer`` (the global rank a
    send goes to or a receive comes from) and ``nbytes`` (its operand's
    bytes); else None, None, None, 0. ``partial``: the read storages of
    which it reads only a part (a slice or a row of a view). ``flops``: its
    count by the flop counter's formulas."""

    name: str
    reads: tuple
    writes: tuple
    dtypes: tuple
    shapes: tuple
    in_dtypes: tuple
    backward: bool
    kind: str | None = None
    group: tuple | None = None
    peer: int | None = None
    nbytes: int = 0
    partial: tuple = ()
    flops: int = 0


# The matrix products, and the operations whose results' shapes and
# operands' dtypes a trace records (the products, which the lint's chunk and
# upcast rules read, and the conversions).
_PRODUCTS = frozenset({
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
    "aten::_int_mm",
})
_SHAPED = _PRODUCTS | {"aten::_to_copy"}

# Operations that overwrite their written argument without reading it.
_OVERWRITES = frozenset({
    "aten::copy_", "aten::zero_", "aten::fill_", "aten::uniform_", "aten::normal_",
    "aten::random_", "aten::bernoulli_", "aten::exponential_", "aten::set_",
})

# Process-group operation -> (argument indices it reads, indices it writes).
_C10D_IO = {
    "allreduce_": ((0,), (0,)),
    "allgather_": ((1,), (0,)),
    "_allgather_base_": ((1,), (0,)),
    "reduce_scatter_": ((1,), (0,)),
    "_reduce_scatter_base_": ((1,), (0,)),
    "alltoall_": ((1,), (0,)),
    "alltoall_base_": ((1,), (0,)),
    "send": ((0,), ()),
    "recv_": ((), (0,)),
    "broadcast_": ((0,), (0,)),
}


def _tensor_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(obj) -> int:
    from torch._C._distributed_c10d import ProcessGroup

    try:
        return ProcessGroup.unbox(obj).size()
    except Exception:
        return 1


def _tensors(x) -> list:
    from torch import Tensor

    if isinstance(x, Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _group_ranks(obj) -> tuple:
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup

    return tuple(dist.get_process_group_ranks(ProcessGroup.unbox(obj)))


def _tally_mode(record: bool = False):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    _PRIM_DEVICE = torch.ops.prim.device.default
    _roles: dict = {}

    class _Tally(TorchDispatchMode):
        """FLOPs by the flop counter's formulas, collective bytes by kind,
        and every operation's operand and result bytes, passing each
        operation on unchanged (``FlopCounterMode``'s count without its
        per-module tracking, which would double the host time)."""

        # A recording trace makes the kernels' wrappers take their custom
        # ops on any tensor (ops._cuda.take_op): on the CPU their bodies run
        # the plain versions, and the trace sees the op a card would run.
        takes_ops = record

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.comm = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
            self.bytes_est = 0.0
            # The step trace: its operations, and every tensor met (held, so
            # that no storage is freed and its id reused while it records).
            self.ops = [] if record else None
            self.storages: dict = {}
            self._held: list = []

        def sid(self, t) -> int:
            """The trace's integer of ``t``'s storage."""
            key = t.untyped_storage()._cdata
            got = self.storages.get(key)
            if got is None:
                got = self.storages[key] = len(self.storages)
                self._held.append(t)
            return got

        def _sids(self, ts) -> tuple[tuple, tuple]:
            """The storages of ``ts``, and those of which they hold a part."""
            sids, part = [], []
            for t in ts:
                storage = t.untyped_storage()
                key = storage._cdata
                got = self.storages.get(key)
                if got is None:
                    got = self.storages[key] = len(self.storages)
                    self._held.append(t)
                sids.append(got)
                if t.numel() * t.element_size() < storage.nbytes():
                    part.append(got)
            return tuple(sids), tuple(part)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func is _PRIM_DEVICE:
                return out
            packet = func._overloadpacket
            formula = flop_registry.get(packet)
            flops = 0
            if formula is not None:
                flops = formula(*args, **kwargs, out_val=out)
                self.flops += flops
            name = func._schema.name
            if name.startswith("c10d::"):
                op = name[len("c10d::"):]
                kind = _C10D_KINDS.get(op)
                nbytes = 0
                if kind is not None:
                    which, operand, group = kind
                    nbytes = _tensor_bytes(args[operand])
                    w = _group_size(args[group])
                    if w > 1:
                        self.comm[which] += _WIRE_FACTORS[which](w) * nbytes
                if self.ops is not None and op in _C10D_IO:
                    self._record_c10d(name, op, args, kind, nbytes)
                return out
            self.bytes_est += _tensor_bytes(list(args)) + _tensor_bytes(out)
            if self.ops is not None:
                self._record(func, name, args, kwargs, out, flops)
            return out

        def _record(self, func, name, args, kwargs, out, flops) -> None:
            roles = _roles.get(func)
            if roles is None:
                # Per argument: (index, name, written, read), once per op.
                roles = _roles[func] = [
                    (i, a.name, w, not w or not (name in _OVERWRITES or a.name.startswith("out")))
                    for i, a in enumerate(func._schema.arguments)
                    for w in [a.alias_info is not None and a.alias_info.is_write]]
            written, reads = [], []
            n_args = len(args)
            for i, arg_name, write, read in roles:
                val = args[i] if i < n_args else kwargs.get(arg_name)
                if val is None or isinstance(val, (int, float, bool, str)):
                    continue
                ts = _tensors(val)
                if not ts:
                    continue
                if write:
                    written += ts
                if read:
                    reads += ts
            results = _tensors(out)
            read_sids, partial = self._sids(reads)
            out_sids = self._sids(results)[0]
            if written:
                out_sids = tuple(dict.fromkeys(self._sids(written)[0] + out_sids))
            self.ops.append(TraceOp(
                name, read_sids, out_sids,
                tuple(t.dtype for t in results),
                tuple(tuple(t.shape) for t in results) if name in _SHAPED else (),
                tuple(t.dtype for t in reads) if name in _SHAPED else (),
                torch._C._current_autograd_node() is not None,
                None, None, None, 0, partial, int(flops),
            ))

        def _record_c10d(self, name, op, args, kind, nbytes) -> None:
            read_at, write_at = _C10D_IO[op]
            group = _group_ranks(args[kind[2]] if kind else args[1])
            peer = None
            if op in ("send", "recv_"):
                peer = group[args[2]]
                nbytes = _tensor_bytes(args[0])
            reads, partial = self._sids([t for i in read_at for t in _tensors(args[i])])
            self.ops.append(TraceOp(
                name=name,
                reads=reads,
                partial=partial,
                writes=self._sids([t for i in write_at for t in _tensors(args[i])])[0],
                dtypes=(), shapes=(), in_dtypes=(),
                backward=torch._C._current_autograd_node() is not None,
                kind=kind[0] if kind else ("recv" if op == "recv_" else None),
                group=group, peer=peer, nbytes=nbytes,
            ))

    return _Tally()


def static_attribution(fn, *args) -> dict:
    """Run ``fn(*args)`` under ``FakeTensorMode`` (real tensors among the
    arguments, or reached from them, such as a module's parameters, become
    fake on first use; no kernel launches, no collective goes out) and
    return ``{"flops_est", "bytes_est", "comm_bytes_total",
    "comm_bytes_<kind>" for each of COLLECTIVE_KINDS}``, per device, as the
    JAX package's ``jaxpr_costs`` does. Gradients that ``fn``'s backward
    leaves in ``.grad`` are fake: the caller hands it fake leaves (see
    ``train.train_step.attribution_fn``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _register_kernel_flop_formulas()
    tally = _tally_mode()
    with FakeTensorMode(allow_non_fake_inputs=True), tally:
        fn(*args)
    return trace_costs(tally)


@contextlib.contextmanager
def trace_ops():
    """Record a step trace: inside ``with trace_ops() as tally:`` every
    operation dispatched is tallied (as :func:`static_attribution` does) and
    recorded in ``tally.ops`` as a :class:`TraceOp`; ``tally.sid(t)`` is a
    tensor's storage in the trace. The kernels' wrappers take their custom
    ops meanwhile (``ops._cuda.take_op``), so the trace holds the ops a card
    runs on any device: run it under ``FakeTensorMode`` on a card, so that
    nothing launches, and on real tensors on the CPU, where the ops' bodies
    run the plain versions. :func:`trace_costs` sums the costs."""
    _register_kernel_flop_formulas()
    tally = _tally_mode(record=True)
    with tally:
        yield tally


def trace_costs(tally) -> dict:
    """``static_attribution``'s dict of a finished tally."""
    out = {
        "flops_est": float(tally.flops),
        "bytes_est": float(tally.bytes_est),
        "comm_bytes_total": float(sum(tally.comm.values())),
    }
    for kind in COLLECTIVE_KINDS:
        out[f"comm_bytes_{kind}"] = float(tally.comm[kind])
    return out


def roofline_estimate(
    flops: float,
    comm_bytes_total: float,
    bytes_accessed: float | None = None,
    device_kind: str | None = None,
) -> dict:
    """Per-resource step-time lower bounds on card ``device_kind`` (default
    :data:`DEFAULT_CHIP`), the limiting resource, and ``mfu_est``: the MFU
    the program's arithmetic-to-traffic ratio permits there, an upper bound
    on the measured one (overlap, dispatch and kernel overheads only lower
    it)."""
    kind = device_kind if device_kind in CHIP_SPECS else DEFAULT_CHIP
    tflops, hbm_gbps, link_gbps = CHIP_SPECS[kind]
    compute_s = flops / (tflops * 1e12)
    comm_s = comm_bytes_total / (link_gbps * 1e9)
    mem_s = (bytes_accessed or 0.0) / (hbm_gbps * 1e9)
    terms = {"compute": compute_s, "comm": comm_s, "memory": mem_s}
    t_bound = max(terms.values())
    bound = max(terms, key=terms.get) if t_bound > 0 else "compute"
    mfu_est = (compute_s / t_bound) if t_bound > 0 else 0.0
    return {
        "mfu_est": round(mfu_est, 3),
        "bound": bound,
        "est_step_ms_lower_bound": round(t_bound * 1e3, 3),
        "roofline_chip": kind,
    }


def step_config_attribution(
    n_devices: int | None = None,
    labels=None,
    device_kind: str | None = None,
    device: str = "cpu",
) -> dict:
    """Static attribution of the step configs the lint already traces
    (``analysis/trace_audit.step_config_traces``: the real builders, one step
    in a fake world of ``n_devices``, default 8): label -> the trace's costs
    (:func:`trace_costs`) and :func:`roofline_estimate` on card
    ``device_kind``, for ``labels`` (default: the whole tier-1 sample)."""
    from distributed_sigmoid_loss_tpu_torch.analysis.trace_audit import step_config_traces

    traces = step_config_traces(n_devices, device=device)
    want = set(labels) if labels is not None else set(traces)
    out = {}
    for label, trace in traces.items():
        if label not in want:
            continue
        costs = dict(trace.costs)
        costs.update(roofline_estimate(costs["flops_est"], costs["comm_bytes_total"],
                                       device_kind=device_kind))
        out[label] = costs
    return out


def metrics_line_fields(costs: dict, device_kind: str | None = None) -> dict:
    """The two attribution scalars every train metrics line carries:
    ``mfu_est`` (the roofline ceiling on the card) and ``comm_bytes_total``
    (per-device wire bytes a step)."""
    est = roofline_estimate(
        costs["flops_est"], costs["comm_bytes_total"], device_kind=device_kind
    )
    return {
        "mfu_est": est["mfu_est"],
        "comm_bytes_total": float(costs["comm_bytes_total"]),
    }
