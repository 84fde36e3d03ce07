"""Blockwise (flash) self-attention, K7: a forward and a two-pass backward
(dK/dV, then dQ) as CUDA kernels for the bf16 self-attention that the short
kernel (K1) cannot hold in shared memory, with their plain PyTorch versions
beside them, joined by one ``torch.autograd.Function``.

Replaces the Pallas TPU kernel that
``distributed_sigmoid_loss_tpu/ops/flash_attention.py:flash_self_attention``
(:72) calls at :110, the library kernel
``jax.experimental.pallas.ops.tpu.flash_attention``, with its rounding
points per key block:

- forward (``_flash_attention_kernel_single_batch``): f32 logits ``q·kᵀ``
  times ``scale``; per key block a running row maximum ``m`` and sum ``l``;
  ``p = exp(s − m)`` unnormalised and rounded to the activation dtype before
  ``p·v``; the accumulator rescaled by ``α·l/l'`` and the block's ``p·v``
  added times ``1/l'``; the output cast at the end; ``m`` and ``l`` saved.
  A sequence of one key block takes the upstream single-step body, which
  normalises ``p`` before the cast. Kernel: ``csrc/flash_attention.cu``.
- backward (``_flash_attention_bwd``): ``di = rowsum(f32(out) · f32(do))`` of
  the rounded output, ``p = exp(s − m) · (1/l)``, ``dv = Σ bf16(p)ᵀ·do``,
  ``dp = do·vᵀ``, ``ds = (dp − di) · p · scale``, ``dk = Σ bf16(ds)ᵀ·q`` (the
  dK/dV kernel, ``_flash_attention_dkv_kernel``) and ``dq = Σ bf16(ds)·k``
  (the dQ kernel, ``_flash_attention_dq_kernel``). Kernels:
  ``csrc/flash_attention_bwd.cu`` (the dK/dV launch is preceded by a small
  di pass and counted with it).

Where JAX pads the sequence to a multiple of 128 and masks the padding by
segment ids, the kernels mask the ragged tail by index and make no padded
copies: padded keys contribute exactly 0 in both, and padded query rows are
never computed. The rounding depends on the key block, and the kernels'
block (:data:`BLOCK_K`, 64 keys) is not JAX's (128, 256 or 512), so the
plain versions take ``block_k``: JAX's own block (:func:`default_block_k`)
by default, as the CPU path runs them, or :data:`BLOCK_K` for a tight
comparison with a kernel. At 64 keys the plain versions stay within one bf16
ulp (output) and two (gradients) of JAX's kernel.

The forward is registered as the custom op
``dsl_torch_port::flash_attention_fwd`` (:data:`FLASH_CORE_OP`) returning
``(out, stats)``, with ``stats`` the row statistics ``m`` and ``l``
(b, h, 2, s) in f32 in place of a log-sum-exp, so the backward normalises as
JAX does. Selective checkpointing keeps both outputs under ``save_hot``
(``models/transformer.py``) and never launches the forward again. The
two-pass backward is the custom op ``dsl_torch_port::flash_attention_bwd``.
Both have fake versions, so ``torch.export`` records them in an artifact
(``train/export.py``) and the artifact's replay launches the kernels.

On CPU tensors :func:`flash_self_attention` runs the plain forward and, in
the backward, the plain backward. On CUDA tensors it launches the kernels
or raises: bf16, contiguous, a head dim that is a multiple of 8 up to
:data:`MAX_HEAD_DIM` (``ValueError`` otherwise, on either device). f32 CUDA
tensors run the f32 kernels of ``ops/attention_f32.py`` in K7's role (their
forward with the row statistics, then their dK/dV and dQ passes), counted
by :func:`launches` as K7's.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributed_sigmoid_loss_tpu_torch.ops import _cuda, attention_f32
from distributed_sigmoid_loss_tpu_torch.ops.short_attention import _resolve_scale, _vec

__all__ = [
    "flash_attention_available",
    "flash_self_attention",
    "flash_self_attention_plain",
    "flash_self_attention_bwd",
    "flash_self_attention_bwd_plain",
    "flash_attention_bwd_dkv_plain",
    "flash_attention_bwd_dq_plain",
    "FlashSelfAttention",
    "FLASH_CORE_OP",
    "default_block_k",
    "flash_attention_smem_bytes",
    "flash_attention_bwd_smem_bytes",
    "BLOCK_K",
    "MAX_HEAD_DIM",
    "launches",
    "reset_launches",
]

# The kernels' streamed tile: the forward's 64-key rounding block, and the
# backward kernels' 64-row query (dK/dV) or key (dQ) tiles. The backward's
# rounding points do not depend on its tiles (p is normalised by the
# forward's final l); only the order of its f32 sums does.
BLOCK_K = 64
# Head dims the kernels take: multiples of 8 up to 128 (16-byte rows, and a
# 16-row strip of q as head_dim/16 MMA steps).
MAX_HEAD_DIM = 128

# JAX's padding multiple and key blocks (ops/flash_attention.py:_pad_len,
# _block_size), kept to round where JAX rounds.
_SEQ_MULTIPLE = 128

_count_lock = threading.Lock()
_launches = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}


def flash_attention_available(x: torch.Tensor) -> bool:
    """True when ``x`` lives on a CUDA device, where the hand-written
    attention kernels run."""
    return x.is_cuda


def launches() -> dict[str, int]:
    """K7 kernel calls since the last :func:`reset_launches`: ``fwd``,
    ``bwd_dkv`` (the di pass and the dK/dV kernel, one call) and ``bwd_dq``.
    Plain-version calls on CPU tensors are not launches."""
    with _count_lock:
        return dict(_launches)


def reset_launches() -> None:
    with _count_lock:
        _launches.update(fwd=0, bwd_dkv=0, bwd_dq=0)


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


def _pad_len(s: int) -> int:
    return (s + _SEQ_MULTIPLE - 1) // _SEQ_MULTIPLE * _SEQ_MULTIPLE


def _block_size(s_pad: int) -> int:
    return next(b for b in (512, 256, 128) if s_pad % b == 0)


def default_block_k(s: int) -> int:
    """JAX's key block for a sequence of ``s``: the largest of 512, 256 and
    128 dividing ``s`` padded to a multiple of 128."""
    return _block_size(_pad_len(s))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def flash_attention_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one forward block of the body this head dim
    takes. The warpgroup body (head dims 64 and 128): 1,024 bytes of
    alignment slack, the 128-row Q tile, a ring of 64-row K or V tiles (8 at
    dh=64, 4 at 128) and their full and empty barriers plus Q's, 8 bytes
    each. The mma.sync body (other head dims): the 64-row Q tile and two
    stages of 64-row K and V tiles, bf16 at row stride head_dim_pad + 8.
    Mirrors ``flash_attention_fwd_smem_bytes`` in ``flash_attention.cu``."""
    if head_dim in (64, 128):
        stages = 8 if head_dim == 64 else 4
        return 1024 + 128 * head_dim * 2 + stages * BLOCK_K * head_dim * 2 + (2 * stages + 1) * 8
    return (BLOCK_K + 4 * BLOCK_K) * (_round_up(head_dim, 16) + 8) * 2


def flash_attention_bwd_smem_bytes(head_dim: int, which: str) -> int:
    """Dynamic shared memory of one block of the backward kernel ``which``
    (``"dkv"`` or ``"dq"``) of the body this head dim takes. The warpgroup
    bodies (head dims 64 and 128): 1,024 bytes of alignment slack, two
    resident 128-row tiles (dkv: K, V; dq: Q, dO), four stages of two
    streamed 64-row tiles (dkv: Q, dO; dq: K, V), dkv's four stages of three
    f32 row statistics, and the stages' full and empty barriers plus the
    resident tiles', 8 bytes each. The mma.sync bodies (other head dims),
    either kernel: two resident and two stages of two streamed 64-row tiles
    at row stride head_dim_pad + 8, and two stages of three f32 row
    statistics. Mirrors ``flash_attention_bwd_smem_bytes`` in
    ``flash_attention_bwd.cu``."""
    if which not in ("dkv", "dq"):
        raise ValueError(f"which={which!r}; expected 'dkv' or 'dq'")
    if head_dim in (64, 128):
        stages = 4
        tiles = 2 * 2 * BLOCK_K * head_dim * 2 + stages * 2 * BLOCK_K * head_dim * 2
        row_stats = stages * 3 * BLOCK_K * 4 if which == "dkv" else 0
        return 1024 + tiles + row_stats + (2 * stages + 1) * 8
    return 6 * BLOCK_K * (_round_up(head_dim, 16) + 8) * 2 + 2 * 3 * BLOCK_K * 4


def _check_head_dim(fn: str, head_dim: int) -> None:
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"{fn}: head_dim={head_dim}; the flash kernels take a multiple of 8 "
            f"up to {MAX_HEAD_DIM}"
        )


def _heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(b, s, h, dh) → (b, h, s, dh) in ``dtype``."""
    return t.transpose(1, 2).to(dtype)


def _causal_mask(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``x`` (..., rows, cols) with keys after their query set to -inf."""
    return x.masked_fill(cols[None, :] > rows[:, None], float("-inf"))


def flash_self_attention_plain(q, k, v, causal: bool = False, scale: float | None = None,
                               block_k: int | None = None):
    """K7's forward in plain PyTorch, key block by key block of ``block_k``
    (default: JAX's, :func:`default_block_k`), at the upstream kernel's
    rounding points. q/k/v: (b, s, h, dh) → ``(out, stats)``: out (b, s, h,
    dh) in q's dtype; stats (b, h, 2, s) f32, the row maxima ``m`` then the
    row sums ``l`` of ``exp(s − m)``."""
    scale = _resolve_scale(q, scale)
    b, s, h, dh = q.shape
    block = default_block_k(s) if block_k is None else int(block_k)
    acc = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh = _heads(q, acc), _heads(k, acc), _heads(v, acc)
    rows = torch.arange(s, device=q.device)
    n_blocks = -(-s // block)
    m = torch.full((b, h, s, 1), float("-inf"), dtype=acc, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=acc, device=q.device)
    o = torch.zeros((b, h, s, dh), dtype=acc, device=q.device)
    for j in range(n_blocks):
        k0, k1 = j * block, min((j + 1) * block, s)
        x = torch.matmul(qh, kh[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            x = _causal_mask(x, rows, torch.arange(k0, k1, device=q.device))
        m_next = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        p = torch.exp(x - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        if n_blocks == 1:  # the upstream single-step body: p normalised first
            p = p / l_next
            o = torch.matmul(p.to(v.dtype).to(acc), vh)
            m, l = m_next, l_next
            break
        r = torch.where(l_next == 0, torch.ones_like(l_next), 1.0 / l_next)
        o_next = o * (l_corr * r) + torch.matmul(p.to(v.dtype).to(acc), vh[:, :, k0:k1]) * r
        if causal:
            # Rows before the block's first key skip it (upstream
            # below_or_on_diag with equal query and key blocks).
            run = (rows >= k0)[:, None]
            m_next, l_next = torch.where(run, m_next, m), torch.where(run, l_next, l)
            o_next = torch.where(run, o_next, o)
        m, l, o = m_next, l_next, o_next
    out = o.to(q.dtype).transpose(1, 2).contiguous()
    stats = torch.cat([m, l], dim=-1).transpose(-1, -2).float().contiguous()
    return out, stats


def flash_attention_bwd_dkv_plain(q, k, v, out, do, stats, causal: bool = False,
                                  scale: float | None = None, block_k: int | None = None):
    """The dK/dV pass in plain PyTorch, query block by query block of
    ``block_k`` (default: JAX's), at ``_flash_attention_dkv_kernel``'s
    rounding points. q/k/v/out/do: (b, s, h, dh); stats: (b, h, 2, s) from
    the forward → ``(dk, dv, di)``, dk and dv (b, s, h, dh) in k's and v's
    dtypes, di (b, h, s) f32 for the dQ pass."""
    scale = _resolve_scale(q, scale)
    b, s, h, dh = q.shape
    block = default_block_k(s) if block_k is None else int(block_k)
    acc = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh, doh = _heads(q, acc), _heads(k, acc), _heads(v, acc), _heads(do, acc)
    di = (_heads(out, acc) * doh).sum(dim=-1)
    m, inv_l = stats[:, :, 0, :, None].to(acc), 1.0 / stats[:, :, 1, :, None].to(acc)
    cols = torch.arange(s, device=q.device)
    dk = torch.zeros((b, h, s, dh), dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(-(-s // block)):
        r0, r1 = i * block, min((i + 1) * block, s)
        x = torch.matmul(qh[:, :, r0:r1], kh.transpose(-1, -2)) * scale
        if causal:
            x = _causal_mask(x, torch.arange(r0, r1, device=q.device), cols)
        p = torch.exp(x - m[:, :, r0:r1]) * inv_l[:, :, r0:r1]
        dv += torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), doh[:, :, r0:r1])
        dp = torch.matmul(doh[:, :, r0:r1], vh.transpose(-1, -2))
        ds = (dp - di[:, :, r0:r1, None]) * p * scale
        dk += torch.matmul(ds.to(do.dtype).to(acc).transpose(-1, -2), qh[:, :, r0:r1])
    return (dk.to(k.dtype).transpose(1, 2).contiguous(),
            dv.to(v.dtype).transpose(1, 2).contiguous(), di.float())


def flash_attention_bwd_dq_plain(q, k, v, do, stats, di, causal: bool = False,
                                 scale: float | None = None, block_k: int | None = None):
    """The dQ pass in plain PyTorch, key block by key block of ``block_k``
    (default: JAX's), at ``_flash_attention_dq_kernel``'s rounding points;
    ``di`` is the dK/dV pass's. → dq (b, s, h, dh) in q's dtype."""
    scale = _resolve_scale(q, scale)
    b, s, h, dh = q.shape
    block = default_block_k(s) if block_k is None else int(block_k)
    acc = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh, doh = _heads(q, acc), _heads(k, acc), _heads(v, acc), _heads(do, acc)
    m, inv_l = stats[:, :, 0, :, None].to(acc), 1.0 / stats[:, :, 1, :, None].to(acc)
    di = di[..., None].to(acc)
    rows = torch.arange(s, device=q.device)
    dq = torch.zeros((b, h, s, dh), dtype=acc, device=q.device)
    for j in range(-(-s // block)):
        k0, k1 = j * block, min((j + 1) * block, s)
        x = torch.matmul(qh, kh[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            x = _causal_mask(x, rows, torch.arange(k0, k1, device=q.device))
        p = torch.exp(x - m) * inv_l
        dp = torch.matmul(doh, vh[:, :, k0:k1].transpose(-1, -2))
        ds = (dp - di) * p * scale
        dq += torch.matmul(ds.to(k.dtype).to(acc), kh[:, :, k0:k1])
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_self_attention_bwd_plain(q, k, v, out, do, stats, causal: bool = False,
                                   scale: float | None = None, block_k: int | None = None):
    """Both backward passes in plain PyTorch → (dq, dk, dv), each
    (b, s, h, dh)."""
    dk, dv, di = flash_attention_bwd_dkv_plain(q, k, v, out, do, stats, causal, scale, block_k)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, stats, di, causal, scale, block_k)
    return dq, dk, dv


def _library(name: str) -> ctypes.CDLL:
    lib = _cuda.load(name)
    if getattr(lib, "_typed", False):
        return lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_attention":
        lib.flash_attention_fwd.argtypes = [p] * 5 + [i, i, i, i, f, i, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_fwd_smem_bytes.argtypes = [i]
        lib.flash_attention_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_fwd_occupancy.argtypes = [i]
        lib.flash_attention_fwd_occupancy.restype = i
        lib.flash_attention_fwd_body.argtypes = [i, i]
        lib.flash_attention_fwd_body.restype = i
        lib.flash_attention_fwd_error_string.argtypes = [i]
        lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
    else:
        lib.flash_attention_bwd_dkv.argtypes = [p] * 9 + [i, i, i, i, f, i, i, p]
        lib.flash_attention_bwd_dkv.restype = i
        lib.flash_attention_bwd_dq.argtypes = [p] * 7 + [i, i, i, i, f, i, i, p]
        lib.flash_attention_bwd_dq.restype = i
        lib.flash_attention_bwd_smem_bytes.argtypes = [i, i]
        lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_bwd_occupancy.argtypes = [i, i]
        lib.flash_attention_bwd_occupancy.restype = i
        lib.flash_attention_bwd_body.argtypes = [i, i, i]
        lib.flash_attention_bwd_body.restype = i
        lib.flash_attention_bwd_error_string.argtypes = [i]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    lib._typed = True
    return lib


def _check_cuda(fn: str, q, others) -> None:
    """What the kernels take: CUDA, one shape, device and dtype (bf16; f32
    goes to ``attention_f32``), contiguous, a head dim that is a multiple of
    8 up to 128."""
    if q.dtype == torch.float32:
        attention_f32.check_cuda(fn, q, others)
        _check_head_dim(fn, q.shape[-1])
        return
    if not q.is_cuda:
        raise ValueError(f"{fn}: unsupported device {q.device}")
    for name, t in others:
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(
                f"{fn}: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                f"differs from q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{fn} kernel takes bfloat16, got {q.dtype}")
    if not q.is_contiguous() or not all(t.is_contiguous() for _, t in others):
        raise ValueError(f"{fn} kernel takes contiguous tensors")
    _check_head_dim(fn, q.shape[-1])


def _raise_on(err: int, what: str, error_string) -> None:
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _launch_fwd(q, k, v, causal: bool, scale: float):
    """Launch the K7 forward on checked CUDA tensors → new (out, stats)."""
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    stats = torch.empty((b, h, 2, s), dtype=torch.float32, device=q.device)
    lib = _library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), stats.data_ptr(),
            b, s, h, dh, float(scale), int(bool(causal)), _vec(dh, h * dh, (q, k, v, out)), stream,
        )
    _raise_on(err, "flash_attention_fwd", lib.flash_attention_fwd_error_string)
    _count("fwd")
    return out, stats


def _launch_bwd_dkv(q, k, v, out, do, stats, causal: bool, scale: float):
    """Launch the di pass and the K7 dK/dV kernel on checked CUDA tensors →
    new (dk, dv, di)."""
    b, s, h, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    vec = _vec(dh, h * dh, (q, k, v, out, do, dk, dv))
    lib = _library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            stats.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, dh, float(scale), int(bool(causal)), vec, stream,
        )
    _raise_on(err, "flash_attention_bwd_dkv", lib.flash_attention_bwd_error_string)
    _count("bwd_dkv")
    return dk, dv, di


def _launch_bwd_dq(q, k, v, do, stats, di, causal: bool, scale: float):
    """Launch the K7 dQ kernel on checked CUDA tensors → new dq."""
    b, s, h, dh = q.shape
    dq = torch.empty_like(q)
    lib = _library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(),
            di.data_ptr(), dq.data_ptr(), b, s, h, dh, float(scale), int(bool(causal)),
            _vec(dh, h * dh, (q, k, v, do, dq)), stream,
        )
    _raise_on(err, "flash_attention_bwd_dq", lib.flash_attention_bwd_error_string)
    _count("bwd_dq")
    return dq


def _check_stats(fn: str, q, stats) -> None:
    b, s, h, _ = q.shape
    if tuple(stats.shape) != (b, h, 2, s) or stats.dtype != torch.float32 \
            or stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"{fn}: statistics {tuple(stats.shape)} {stats.dtype} on "
                         f"{stats.device}, expected contiguous float32 {(b, h, 2, s)} on {q.device}")


def _forward(q, k, v, causal: bool, scale: float):
    # The module attributes are looked up per call, so a caller may swap the
    # plain version in for a kernel-vs-plain comparison on the card.
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, causal, scale)
    _check_cuda("flash_self_attention", q, (("k", k), ("v", v)))
    if q.dtype == torch.float32:
        out, stats = attention_f32.launch_fwd(q, k, v, causal, scale, with_stats=True)
        _count("fwd")
        return out, stats
    return _launch_fwd(q, k, v, causal, scale)


@torch.library.custom_op("dsl_torch_port::flash_attention_fwd", mutates_args=())
def _flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in _forward(q, k, v, causal, scale))


@_flash_attention_fwd_op.register_fake
def _(q, k, v, causal, scale):
    b, s, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, 2, s), dtype=torch.float32))


# K7's forward as selective checkpointing sees it (``attn_core``).
FLASH_CORE_OP = torch.ops.dsl_torch_port.flash_attention_fwd.default


def flash_self_attention_bwd(q, k, v, out, do, stats, causal: bool = False,
                             scale: float | None = None):
    """The gradients (dq, dk, dv) of :func:`flash_self_attention` at output
    gradient ``do``, from the forward's ``out`` and ``stats``: the dK/dV
    pass, then the dQ pass. CPU tensors run the plain versions (JAX's
    blocks); CUDA tensors run the kernels, or this raises."""
    scale = _resolve_scale(q, scale)
    if _cuda.take_op(q):  # the op, which a trace records
        return _flash_attention_bwd_op(q, k, v, out, do, stats, bool(causal), scale)
    return _backward(q, k, v, out, do, stats, bool(causal), scale)


def _backward(q, k, v, out, do, stats, causal: bool, scale: float):
    if q.device.type == "cpu":
        return flash_self_attention_bwd_plain(q, k, v, out, do, stats, causal, scale)
    do = do.contiguous()
    _check_cuda("flash_self_attention_bwd", q, (("k", k), ("v", v), ("out", out), ("do", do)))
    _check_stats("flash_self_attention_bwd", q, stats)
    if q.dtype == torch.float32:
        dk, dv, di = attention_f32.launch_bwd_dkv(q, k, v, out, do, stats, causal, scale)
        _count("bwd_dkv")
        dq = attention_f32.launch_bwd_dq(q, k, v, do, stats, di, causal, scale)
        _count("bwd_dq")
        return dq, dk, dv
    dk, dv, di = _launch_bwd_dkv(q, k, v, out, do, stats, causal, scale)
    dq = _launch_bwd_dq(q, k, v, do, stats, di, causal, scale)
    return dq, dk, dv


@torch.library.custom_op("dsl_torch_port::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, do: torch.Tensor, stats: torch.Tensor,
                            causal: bool, scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in _backward(q, k, v, out, do, stats, causal, scale))


@_flash_attention_bwd_op.register_fake
def _(q, k, v, out, do, stats, causal, scale):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))


class FlashSelfAttention(torch.autograd.Function):
    """K7's forward and its two-pass backward as one autograd node. The
    forward saves (q, k, v, out, stats), as the upstream ``custom_vjp``
    saves its residuals."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, stats = _flash_attention_fwd_op(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_self_attention_bwd(q, k, v, out, do, stats, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_self_attention(q, k, v, *, causal: bool = False, scale: float | None = None):
    """Drop-in for ``dense_attention`` (JAX ``flash_self_attention``, :72):
    self-attention (b, s, h, dh) → (b, s, h, dh), with K7's two-pass backward
    under autograd.

    CPU tensors run :func:`flash_self_attention_plain` at JAX's blocks. CUDA
    tensors must be contiguous bf16 or f32 of one shape; they run the
    kernels, or this raises. A head dim that is not a multiple of 8 up to
    :data:`MAX_HEAD_DIM` raises ``ValueError`` on either device. A call that
    needs no gradient (serving) skips the autograd node and the custom op's
    dispatch, except while ``torch.export`` traces it or its tensors are
    fake (``_cuda.take_op``).
    """
    _check_head_dim("flash_self_attention", q.shape[-1])
    scale = _resolve_scale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashSelfAttention.apply(q, k, v, bool(causal), scale)
    if _cuda.take_op(q):
        return _flash_attention_fwd_op(q, k, v, bool(causal), scale)[0]
    return _forward(q, k, v, bool(causal), scale)[0]
