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

:func:`roofline_estimate` turns (flops, comm bytes) into per-resource time
bounds on a card of :data:`CHIP_SPECS` and ``mfu_est``, the MFU the
program's arithmetic-to-traffic ratio permits there: a ceiling, not a
prediction. The default card is the H100 the port targets, so the estimate
exists on hosts without one.
"""

from __future__ import annotations

import math

__all__ = [
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


def _tensor_bytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


def _group_size(obj) -> int:
    from torch._C._distributed_c10d import ProcessGroup

    try:
        return ProcessGroup.unbox(obj).size()
    except Exception:
        return 1


def _tally_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Tally(TorchDispatchMode):
        """FLOPs by the flop counter's formulas, collective bytes by kind,
        and every operation's operand and result bytes, passing each
        operation on unchanged (``FlopCounterMode``'s count without its
        per-module tracking, which would double the host time)."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.comm = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
            self.bytes_est = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            name = func._schema.name
            if name.startswith("c10d::"):
                kind = _C10D_KINDS.get(name[len("c10d::"):])
                if kind is not None:
                    which, operand, group = kind
                    w = _group_size(args[group])
                    if w > 1:
                        self.comm[which] += _WIRE_FACTORS[which](w) * _tensor_bytes(args[operand])
                return out
            self.bytes_est += _tensor_bytes(list(args)) + _tensor_bytes(
                out if isinstance(out, (list, tuple)) else [out])
            return out

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
