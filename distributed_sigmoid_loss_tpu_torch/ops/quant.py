"""Dynamic int8 quantized projections, inference and straight-through
training: the port of ``distributed_sigmoid_loss_tpu/ops/quant.py``.

One recipe, shared with the loss's int8 mode
(``ops/streaming_sigmoid_loss.py``):

- :func:`quantize_int8` — symmetric int8 along an axis: the scale is the
  abs-max over the axis (floored at 1e-12) divided by 127 in f32, and the
  codes are ``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
  ±127.
- :func:`int8_dot_general` — the ``nn.Dense`` pattern of JAX's
  ``int8_dot_general`` (:106): activations ``x`` (..., K) quantized per row,
  the weight (out, K) per output channel, an exact int32 product, then
  ``(f32(acc) · x_scale) · w_scale`` in that order, cast to the output dtype.
- :func:`int8_linear` — the Dense layer the towers call: that product, then
  the bias added in the output dtype (flax's Dense adds its bias after the
  dot), as one custom op (``dsl_torch_port::int8_linear``), so selective
  checkpointing keeps its one output under ``save_hot`` and never runs its
  quantization again in the backward.
- :class:`Int8DenseSTE` — the straight-through estimator of JAX's
  ``int8_dot_general_ste`` (:184-233): the forward is :func:`int8_linear`
  bit for bit, the backward exactly ``F.linear``'s gradient on the saved
  full-precision operands.

The int8 × int8 → int32 product is ``torch._int_mm``, as JAX leaves it to
XLA outside any Pallas kernel; on a CUDA tensor it needs more than 16 rows
and both widths a multiple of 8, which :func:`int8_matmul` checks and
refuses rather than pads. :func:`sign_sketch` and :func:`sign_sketch_scores`
(JAX's :159 and :167) are host numpy, the 1-bit coarse gear of the ANN tier
(``serve/ann.py``). :func:`int8_expert_matmul` (JAX's :83) runs the MoE
layer's batched expert products in int8, one ``torch._int_mm`` an expert,
and :class:`Int8ExpertMatmulSTE` (JAX's :236) is its straight-through twin.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = [
    "quantize_int8",
    "int8_matmul",
    "int8_product",
    "int8_dot_general",
    "int8_linear",
    "Int8DenseSTE",
    "int8_expert_matmul",
    "Int8ExpertMatmulSTE",
    "int_mm_calls",
    "reset_int_mm_calls",
    "sign_sketch",
    "sign_sketch_scores",
]

# Symmetric int8: [-127, 127], -128 unused, so dequantizing is one multiply.
_QMAX = 127.0
# Abs-max floor: an all-zero row quantizes to zeros with a harmless scale.
_EPS = 1e-12

_count_lock = threading.Lock()
_int_mm_calls = 0


def int_mm_calls() -> int:
    """int8 products (:func:`int8_matmul`) since :func:`reset_int_mm_calls`:
    a training step's forward projections plus those the backward's
    recompute runs again."""
    return _int_mm_calls


def reset_int_mm_calls() -> None:
    global _int_mm_calls
    with _count_lock:
        _int_mm_calls = 0


def quantize_int8(x: torch.Tensor, axis: int):
    """Symmetric int8 quantization of ``x`` along ``axis`` → ``(q, scale)``:
    ``q`` int8 and ``scale`` f32 keeping ``axis`` as a size-1 dim, with
    ``q · scale ≈ x``."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=axis, keepdim=True), _EPS) / _QMAX
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``a · bᵀ`` of int8 rows a (m, k) and b (n, k)."""
    if a.is_cuda and not isinstance(a, FakeTensor) and (
            a.shape[0] <= 16 or a.shape[1] % 8 or b.shape[0] % 8):
        raise ValueError(
            f"int8 product of ({a.shape[0]}, {a.shape[1]}) by ({b.shape[0]}, {b.shape[1]})ᵀ: "
            "torch._int_mm on a CUDA device takes more than 16 rows and widths that are "
            "multiples of 8"
        )
    global _int_mm_calls
    with _count_lock:
        _int_mm_calls += 1
    return torch._int_mm(a.contiguous(), b.contiguous().t())


def int8_product(xq, xs, wq, ws, out_dtype) -> torch.Tensor:
    """The dequantized product of quantized rows: xq (..., K) int8 with
    scales xs (..., 1), wq (out, K) with ws (out, 1) → ``(f32(xq·wqᵀ) · xs) ·
    ws`` cast to ``out_dtype``, shape (..., out)."""
    rows = xq.reshape(-1, xq.shape[-1])
    n = rows.shape[0]
    if rows.is_cuda and not isinstance(rows, FakeTensor) and n < _INT_MM_MIN_ROWS:
        # torch._int_mm on a card takes more than 16 rows: zero rows quantize
        # to zeros and add nothing to the product. A tensor without storage
        # (a trace) keeps the product's own rows, as JAX counts it.
        rows = torch.cat([rows, rows.new_zeros(_INT_MM_MIN_ROWS - n, rows.shape[1])])
    acc = int8_matmul(rows, wq)[:n]
    out = (acc.float() * xs.reshape(-1, 1)) * ws.reshape(1, -1)
    return out.to(out_dtype).reshape(xq.shape[:-1] + (wq.shape[0],))


def int8_dot_general(x: torch.Tensor, weight: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ weightᵀ`` in dynamic int8: x (..., K) quantized per row,
    ``weight`` (out, K) per output channel, the product in int32, dequantized
    as ``(f32(acc) · x_scale) · w_scale`` and cast to ``out_dtype`` (default:
    the promoted dtype of x and weight, as ``lax.dot_general``)."""
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, weight.dtype)
    xq, xs = quantize_int8(x, axis=-1)
    wq, ws = quantize_int8(weight, axis=1)
    return int8_product(xq, xs, wq, ws, out_dtype)


@torch.library.custom_op("dsl_torch_port::int8_linear", mutates_args=())
def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax ``Dense`` with the int8 dot: x, weight (out, K) and bias already
    in the layer's dtype; :func:`int8_dot_general` cast to that dtype, then
    ``+ bias`` in it. Inference only: it has no gradient (train through
    :class:`Int8DenseSTE`)."""
    return int8_dot_general(x, weight, x.dtype) + bias


@int8_linear.register_fake
def _(x, weight, bias):
    return x.new_empty(x.shape[:-1] + (weight.shape[0],))


class _LinearGrad(torch.autograd.Function):
    """The STE's saving half: it saves the full-precision x and weight and
    returns a placeholder of the output's shape (a broadcast zero, no
    memory), whose cotangent is the layer's; its backward is ``F.linear``'s
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return x.new_zeros(()).expand(x.shape[:-1] + (weight.shape[0],))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g @ weight) if ctx.needs_input_grad[0] else None
        dw = (g2.t() @ x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        db = g2.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db


class _Int8Value(torch.autograd.Function):
    """The STE's product half: the value is :func:`int8_linear` of the
    operands (taken without gradient), the cotangent passes to the
    placeholder unchanged. It saves nothing."""

    @staticmethod
    def forward(ctx, placeholder, x, weight, bias):
        return int8_linear(x, weight, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return g, None, None, None


class Int8DenseSTE:
    """Trainable int8 Dense: the forward is :func:`int8_linear`, the backward
    ``F.linear``'s gradient on the saved full-precision x and weight (JAX's
    ``int8_dot_general_ste``: the gradient the unquantized layer would give
    for the same cotangent).

    Saving the operands and running the product are two autograd functions,
    the save first. A custom function's tensors are saved once its forward
    has returned, so with one function the early stop of non-reentrant
    checkpointing could only come after the product, and ``save_hot``'s
    recompute ran the MLP's ``wo`` product again although nothing reads it.
    Split, the recompute stops at the save, as JAX's remat does."""

    @staticmethod
    def apply(x, weight, bias):
        placeholder = _LinearGrad.apply(x, weight, bias)
        return _Int8Value.apply(placeholder, x.detach(), weight.detach(), bias.detach())


# The smallest row count torch._int_mm takes on a CUDA device.
_INT_MM_MIN_ROWS = 17


@torch.library.custom_op("dsl_torch_port::int8_expert_matmul", mutates_args=())
def _int8_expert_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    e, k, m = w.shape
    xq, xs = quantize_int8(x, axis=-1)            # xs (E, ..., 1)
    wq, ws = quantize_int8(w, axis=1)             # ws (E, 1, M)
    rows = xq.reshape(e, -1, k)
    n = rows.shape[1]
    if x.is_cuda and n < _INT_MM_MIN_ROWS:
        # Zero rows quantize to zeros and add nothing to the product.
        rows = torch.cat([rows, rows.new_zeros(e, _INT_MM_MIN_ROWS - n, k)], dim=1)
    acc = torch.stack([int8_matmul(rows[i], wq[i].t()) for i in range(e)])[:, :n]
    acc = acc.reshape(x.shape[:-1] + (m,))
    ws_b = ws.reshape((e,) + (1,) * (x.dim() - 2) + (m,))
    return (acc.float() * xs * ws_b).to(out_dtype)


@_int8_expert_matmul.register_fake
def _(x, w, out_dtype):
    return x.new_empty(x.shape[:-1] + (w.shape[-1],), dtype=out_dtype)


def int8_expert_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    """Batched-expert int8 product ``(E, ..., K) @ (E, K, M) -> (E, ...,
    M)`` (JAX's ``int8_expert_matmul``, the MoE layer's ``encd,edh->ench`` and
    ``ench,ehd->encd``): activations quantized per row over K, the weight
    per (expert, output channel), an exact int32 product per expert
    (:func:`int8_matmul`), then ``f32(acc) · x_scale · w_scale`` cast to
    ``out_dtype``. Zero rows (unused capacity slots) come out exactly zero.
    One custom op, so selective checkpointing keeps its output alone. On a
    CUDA tensor an expert's rows are padded with zero rows up to the 17
    ``torch._int_mm`` needs. Inference only: train through
    :class:`Int8ExpertMatmulSTE`."""
    return _int8_expert_matmul(x, w, out_dtype)


class Int8ExpertMatmulSTE(torch.autograd.Function):
    """Trainable expert product (JAX's ``int8_expert_matmul_ste``): the
    forward is :func:`int8_expert_matmul`, the backward the gradient of the
    unquantized batched product taken in f32 (the cotangent cast to f32),
    each gradient cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return int8_expert_matmul(x, w, out_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        e, k, m = w.shape
        g32 = g.float().reshape(e, -1, m)
        x32 = x.float().reshape(e, -1, k)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(g32, w.float().transpose(1, 2)).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(x32.transpose(1, 2), g32).to(w.dtype)
        return dx, dw, None


# Binary sign sketches: the 1-bit coarse gear of the serving ANN tier. For
# L2-normalized rows the sign-agreement count (d - 2·hamming) is a monotone
# proxy for the dot product, good enough to prune and never to rank
# (serve/ann.py re-ranks the survivors exactly). Host numpy: the coarse scan
# runs where the index lives.
_POPCOUNT = np.array([bin(v).count("1") for v in range(256)], dtype=np.uint8)


def sign_sketch(x) -> np.ndarray:
    """(n, d) float rows → (n, ceil(d/8)) packed sign bits (bit = row >= 0)."""
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"sign_sketch expects (n, d) rows, got {x.shape}")
    return np.packbits(x >= 0.0, axis=1)


def sign_sketch_scores(qbits: np.ndarray, cbits: np.ndarray, dim: int) -> np.ndarray:
    """Coarse scores (q, n) between packed query and corpus sketches: the
    sign-agreement count ``d - 2·hamming``. ``dim`` is the unpacked width
    (the pad bits past it add the same count to every score of a query row,
    so they are left in)."""
    xor = np.bitwise_xor(qbits[:, None, :], cbits[None, :, :])  # (q, n, B)
    hamming = _POPCOUNT[xor].sum(axis=-1, dtype=np.int32)
    return (dim - 2 * hamming).astype(np.float32)
