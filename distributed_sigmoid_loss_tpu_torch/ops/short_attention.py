"""Fused short-sequence multi-head self-attention forward: a CUDA kernel for
the towers, with its plain PyTorch version beside it.

Replaces the Pallas TPU kernel
``distributed_sigmoid_loss_tpu/ops/pallas_short_attention.py::
_short_attention_fwd`` (body ``_fwd_kernel``). It computes, per (batch row,
head), ``softmax(q·kᵀ·scale [causal mask]) · v``: dots on the activation-dtype
inputs with f32 accumulation, f32 scale and softmax, ``p`` rounded to the
activation dtype before ``p·v``, output in the input dtype.

Bound on an H100: memory. At ViT-B/16 vision, b=128 (s=196, h=12, dh=64),
q, k, v and out are 4·128·196·768·2 B ≈ 154 MB, ≈ 46 µs at the datasheet's
3.35 TB/s, while the two products are 15.1 GFLOP, ≈ 15 µs at 989 TFLOP/s.
The kernel (``csrc/short_attention.cu``) therefore reads q/k/v once, in the
towers' native (b, s, h·dh) layout with no transposes, writes out once, and
keeps every O(s²) intermediate in shared memory: one block per (64-row q
tile, head, batch row) holds the head's K and V, tensor-core products feed an
f32 softmax in each warp's shared strip. Only the backward (K2) and the
long-sequence flash kernel (K7) remain to be ported.

On a CPU tensor :func:`short_self_attention` runs the plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributed_sigmoid_loss_tpu_torch.ops import _cuda

__all__ = [
    "short_self_attention",
    "short_self_attention_plain",
    "short_attention_fits",
    "short_attention_smem_bytes",
    "SMEM_BUDGET_BYTES",
    "MAX_HEAD_DIM",
    "launches",
    "reset_launches",
]

_NEG_INF = -1e30

# Shared memory one Hopper block may use (232,448 bytes, H100 and H200).
SMEM_BUDGET_BYTES = 227 * 1024
# The kernel keeps a 16-row strip of q in registers as head_dim/16 MMA tiles.
MAX_HEAD_DIM = 128

_WARPS, _ROWS_PER_WARP = 4, 16

_count_lock = threading.Lock()
_launches = 0


def launches() -> int:
    """Kernel launches since the last :func:`reset_launches` (plain-version
    calls on CPU tensors are not launches)."""
    return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def short_attention_smem_bytes(s: int, head_dim: int) -> int:
    """Dynamic shared memory of one kernel block: K and V of one head (bf16,
    rows padded to 16, row stride head_dim_pad + 8) plus four warps' f32
    16-row logits strips. Mirrors ``geometry()`` in the CUDA source."""
    s_pad, dh_pad = _round_up(s, 16), _round_up(head_dim, 16)
    ld_s = max(s_pad, dh_pad) + 4
    return 2 * s_pad * (dh_pad + 8) * 2 + _WARPS * _ROWS_PER_WARP * ld_s * 4


def short_attention_fits(s: int, width: int, dtype_bytes: int, num_heads: int) -> bool:
    """True when the kernel takes this shape: bf16 activations, head_dim at
    most :data:`MAX_HEAD_DIM`, and one block's shared memory within the
    227 KB Hopper budget. B/16 (s=196 and 64, dh=64) and L/14 (s=256) fit;
    s=1024 at dh=64 does not."""
    head_dim = width // num_heads
    return (
        dtype_bytes == 2
        and head_dim <= MAX_HEAD_DIM
        and short_attention_smem_bytes(s, head_dim) <= SMEM_BUDGET_BYTES
    )


def short_self_attention_plain(q, k, v, causal: bool = False, scale: float | None = None):
    """The kernel's function in plain PyTorch, with the same rounding points.
    q/k/v: (b, s, h, dh) → (b, s, h, dh) in q's dtype."""
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    # Activation-dtype inputs, f32 accumulation: the products of two bf16
    # values are exact in f32, so upcasting first is the same contraction.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _cuda.load("short_attention")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.short_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
        lib.short_attention_fwd.restype = ctypes.c_int
        lib.short_attention_smem_bytes.argtypes = [i, i]
        lib.short_attention_smem_bytes.restype = ctypes.c_longlong
        lib.short_attention_occupancy.argtypes = [i, i]
        lib.short_attention_occupancy.restype = ctypes.c_int
        lib.short_attention_error_string.argtypes = [i]
        lib.short_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def short_self_attention(q, k, v, causal: bool = False, scale: float | None = None):
    """Fused self-attention forward for short sequences: (b, s, h, dh) → same.

    CPU tensors run :func:`short_self_attention_plain`. CUDA tensors must be
    contiguous bf16 of one shape that :func:`short_attention_fits`; they run
    the kernel, or this raises. Forward only: the backward kernel is not
    ported, so a call that would need gradients raises.
    """
    if q.device.type == "cpu":
        return short_self_attention_plain(q, k, v, causal, scale)
    if not q.is_cuda:
        raise ValueError(f"short_self_attention: unsupported device {q.device}")
    b, s, h, dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(
                f"short_self_attention: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                f"differs from q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.dtype != torch.bfloat16:
        raise TypeError(f"short_self_attention kernel takes bfloat16, got {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("short_self_attention kernel takes contiguous q, k, v")
    if not short_attention_fits(s, h * dh, 2, h):
        raise ValueError(f"short_self_attention: s={s}, h={h}, dh={dh} does not fit the kernel")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "short_self_attention backward (K2) is not ported yet; call under "
            "torch.inference_mode() or torch.no_grad()"
        )
    scale = (dh ** -0.5) if scale is None else scale
    width = h * dh
    vec = int(
        dh % 8 == 0 and width % 8 == 0
        and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    )
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, dh, float(scale), int(bool(causal)), vec, stream,
        )
    if err != 0:
        msg = lib.short_attention_error_string(err).decode()
        raise RuntimeError(f"short_attention_fwd launch failed: CUDA error {err} ({msg})")
    global _launches
    with _count_lock:
        _launches += 1
    return out
