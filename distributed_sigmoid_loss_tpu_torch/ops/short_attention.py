"""Fused short-sequence multi-head self-attention, forward (K1) and its two
backwards (K2, K3): CUDA kernels for the towers, with their plain PyTorch
versions beside them, joined by one ``torch.autograd.Function``.

Replaces the Pallas TPU kernels of
``distributed_sigmoid_loss_tpu/ops/pallas_short_attention.py``:

- K1, ``_short_attention_fwd`` (body ``_fwd_kernel``): per (batch row,
  head), ``softmax(q·kᵀ·scale [causal mask]) · v``, dots on the
  activation-dtype inputs with f32 accumulation, f32 scale and softmax, ``p``
  rounded to the activation dtype before ``p·v``, output in the input dtype.
  Kernel: ``csrc/short_attention.cu``.
- K2, ``_short_attention_bwd`` (body ``_bwd_kernel``): dq, dk, dv by
  recompute from the saved (q, k, v), as the JAX ``custom_vjp`` saves them:
  f32 ``p``, ``dv = bf16(p)ᵀ·do``, f32 ``dp = do·vᵀ``,
  ``ds = bf16(p ⊙ (dp − rowsum(dp ⊙ p)) · scale)``, ``dq = ds·k``,
  ``dk = dsᵀ·q``. Kernel: ``csrc/short_attention_bwd.cu`` (two launches; the
  second recomputes the logits and dp), with two bodies picked by shape
  (:func:`short_attention_bwd_body`): the warpgroup body (wgmma fed by TMA)
  at head dim 64, 16-byte rows and s_pad <= 256 (B/16's vision and text
  lengths, L/14's), the wmma body at every other shape K1 takes.
- K3, the same call with the body ``_bwd_kernel_batched``: K2's function at
  K2's rounding points, the chain computed once and each of the five products
  issued once. Kernel: ``csrc/short_attention_bwd_batched.cu``, one launch
  per backward call, one block per (batch row, head), with two bodies picked
  by shape (:func:`short_attention_bwd_batched_body`): the warpgroup body
  (wgmma fed by TMA, a producer warpgroup forming the logits, dp, ds and dq
  per 64-row query tile, two consumers accumulating dv and dk for every
  key) at head dim 64, 16-byte rows and s_pad <= 256 (every dh-64 shape K3
  takes), and the ``mma.sync`` kernels at the others (head dims 72 and 20,
  rows not 16-byte aligned). Selected by :func:`set_bwd_batch_heads`
  (default off, as in JAX) or ``batch_heads=``; it takes what JAX's K3 takes
  where the card's shared memory holds it
  (:func:`short_attention_bwd_batched_fits`: s <= 250 at width 768 / 12
  heads, 212 at 1,024 / 16, 208 at 1,152 / 16) and raises ``ValueError``
  beyond, with no fallback to K2.

All three are memory-bound on an H100 (the sources' header notes give the
reckoning). Self-attention too long for them goes to the flash kernel, K7
(``ops/flash_attention.py``).

f32 activations take JAX's f32 fit (:func:`short_attention_fits` and
:func:`short_attention_bwd_batched_fits` at ``dtype_bytes=4``) and, on the
card, the f32 kernels of ``ops/attention_f32.py``: their forward in the K1
role, their backward in the K2 or K3 role (after a forward for the output
and row statistics, since this autograd node saves only q, k and v), counted
by :func:`launches`, :func:`bwd_launches` and :func:`bwd_batched_launches`
as those roles.

The forward is registered as the custom op ``dsl_torch_port::short_attention_fwd``
(:data:`ATTN_CORE_OP`), so selective activation checkpointing can recognise
the attention core by op and keep its output instead of launching K1 again in
the backward (``models/transformer.py``, ``remat_policy="save_hot"``). The
backward, K2 or K3, is the custom op ``dsl_torch_port::short_attention_bwd``.
Both have fake versions, so ``torch.export`` records them in an artifact
(``train/export.py``) and the artifact's replay launches (and counts) the
kernels, and a static attribution on tensors without storage
(``obs/attribution.py``) counts their FLOPs and launches nothing.

On CPU tensors :func:`short_self_attention` runs the plain forward and, in
the backward, the plain backward (never autograd through the plain forward).
On CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributed_sigmoid_loss_tpu_torch.ops import _cuda, attention_f32

__all__ = [
    "short_self_attention",
    "short_self_attention_plain",
    "short_self_attention_bwd",
    "short_self_attention_bwd_plain",
    "short_self_attention_bwd_batched_plain",
    "ShortSelfAttention",
    "ATTN_CORE_OP",
    "short_attention_fits",
    "short_attention_smem_bytes",
    "short_attention_bwd_smem_bytes",
    "short_attention_bwd_body",
    "short_attention_bwd_wgmma_smem_bytes",
    "short_attention_bwd_batched_smem_bytes",
    "short_attention_bwd_batched_body",
    "short_attention_bwd_batched_wgmma_smem_bytes",
    "short_attention_bwd_batched_fits",
    "set_bwd_batch_heads",
    "traced_bwd_batch_heads",
    "reset_traced_bwd_batch_heads",
    "SMEM_BUDGET_BYTES",
    "SHORT_ATTENTION_MAX_SEQ",
    "MAX_HEAD_DIM",
    "launches",
    "bwd_launches",
    "bwd_batched_launches",
    "bwd_batched_in_place_launches",
    "bwd_batched_wgmma_launches",
    "reset_launches",
]

_NEG_INF = -1e30

# Shared memory one Hopper block may use (232,448 bytes, H100 and H200).
SMEM_BUDGET_BYTES = 227 * 1024
# The kernels keep a 16-row strip of q (or k) in registers as head_dim/16 MMA tiles.
MAX_HEAD_DIM = 128

_WARPS, _ROWS_PER_WARP = 4, 16

# JAX's fit of the fused kernels (ops/pallas_short_attention.py): a sequence
# envelope and a VMEM budget, 70% of 16 MiB.
SHORT_ATTENTION_MAX_SEQ = 1024
_VMEM_BUDGET_BYTES = 16 * 1024 * 1024 * 0.7

_count_lock = threading.Lock()
_launches = {"fwd": 0, "bwd": 0, "bwd_batched": 0, "bwd_batched_in_place": 0,
             "bwd_batched_wgmma": 0}

# The process default for ``batch_heads=None`` call sites (the towers):
# False = the per-head backward K2, True = the head-batched K3.
_DEFAULT_BATCH_HEADS = False

# Every backward choice that actually ran in this process.
_TRACED_BWD_BATCH_HEADS: set[bool] = set()


def launches() -> int:
    """K1 kernel launches since the last :func:`reset_launches` (plain-version
    calls on CPU tensors are not launches)."""
    return _launches["fwd"]


def bwd_launches() -> int:
    """K2 kernel calls since the last :func:`reset_launches`. One call is the
    two launches of ``short_attention_bwd`` (dq, then dk/dv), counted once."""
    return _launches["bwd"]


def bwd_batched_launches() -> int:
    """K3 kernel launches since the last :func:`reset_launches`."""
    return _launches["bwd_batched"]


def bwd_batched_in_place_launches() -> int:
    """Those of the K3 launches since the last :func:`reset_launches` that
    ran its in-place ``mma.sync`` kernel (s_pad > 208 where the warpgroup
    body does not run, see :func:`_k3_variant`)."""
    return _launches["bwd_batched_in_place"]


def bwd_batched_wgmma_launches() -> int:
    """Those of the K3 launches since the last :func:`reset_launches` that
    ran its warpgroup body (:func:`short_attention_bwd_batched_body`)."""
    return _launches["bwd_batched_wgmma"]


def reset_launches() -> None:
    with _count_lock:
        _launches.update(fwd=0, bwd=0, bwd_batched=0, bwd_batched_in_place=0,
                         bwd_batched_wgmma=0)


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


def set_bwd_batch_heads(enabled: bool) -> None:
    """Set the process default for ``batch_heads=None`` call sites (the
    towers), as the JAX package's switch does: ``True`` selects the
    head-batched backward K3, ``False`` the per-head K2. Read when a backward
    runs; :func:`traced_bwd_batch_heads` reports what actually did."""
    global _DEFAULT_BATCH_HEADS
    _DEFAULT_BATCH_HEADS = bool(enabled)


def traced_bwd_batch_heads() -> tuple[bool, ...]:
    """Distinct backward choices that ran so far, sorted: ``()`` when no
    fused short-attention backward has run in this process, ``(False,)`` /
    ``(True,)`` when every one was the per-head / the head-batched backward,
    ``(False, True)`` when both ran."""
    return tuple(sorted(_TRACED_BWD_BATCH_HEADS))


def reset_traced_bwd_batch_heads() -> None:
    """Clear the record (test isolation)."""
    _TRACED_BWD_BATCH_HEADS.clear()


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def short_attention_smem_bytes(s: int, head_dim: int) -> int:
    """Dynamic shared memory of one K1 block of the body a call with
    16-byte rows takes. Head dim 64 up to s_pad = 256 (the warpgroup body):
    1,024 bytes of alignment slack, K and V over 64, 208 or 256 rows of 128
    bytes, and one 64-row q tile. Otherwise (the mma.sync bodies): K and V
    of one head in bf16 at row stride head_dim_pad + 8, over every key tile
    the body reads (64 or 208 rows for the one-pass body, s rounded up to 64
    for the two-pass body), and four warps' 16-row q tiles at the same
    stride. Mirrors ``geometry()`` and ``wgmma_smem_bytes()`` in
    ``short_attention.cu``."""
    s_pad, dh_pad = _round_up(s, 16), _round_up(head_dim, 16)
    if head_dim == 64 and s_pad <= 256:
        rows = 64 if s_pad <= 64 else 208 if s_pad <= 208 else 256
        return 1024 + (2 * rows + 64) * 128
    rows = 64 if s_pad <= 64 else 208 if s_pad <= 208 else _round_up(s, 64)
    return (2 * rows + _WARPS * _ROWS_PER_WARP) * (dh_pad + 8) * 2


def _k1_dispatch_limit_bytes(s: int, head_dim: int) -> int:
    """The K1/K7 dispatch limit for bf16, in the units it was set in: the
    footprint of the earlier K1 design (K and V of one head plus four warps'
    f32 16-row logits strips), which set where the towers leave K1 for K7
    (s <= 416 at width 768 / 12 heads, 368 at 1,152 / 16). The kernel's own
    footprint is smaller now; the boundary stays where it was until it is
    moved on purpose (ROADMAP.md queue C, "K1 vs K7 for mid-length
    sequences")."""
    s_pad, dh_pad = _round_up(s, 16), _round_up(head_dim, 16)
    return 2 * s_pad * (dh_pad + 8) * 2 + _WARPS * _ROWS_PER_WARP * (max(s_pad, dh_pad) + 4) * 4


def short_attention_bwd_smem_bytes(s: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of either kernel of K2's wmma body
    (the dispatch term of :func:`short_attention_fits`, whichever body a
    call then takes): two of the head's (s, head_dim) operands in bf16 (rows padded to 16, row stride
    head_dim_pad + 8), four warp regions (the larger of 16 staged rows of two
    operands, four 16×16 scratch tiles, or 16 f32 output rows; rounded up to
    128 bytes) and three f32 row statistics per query. Mirrors ``geometry()``
    in ``short_attention_bwd.cu``."""
    s_pad, dh_pad = _round_up(s, 16), _round_up(head_dim, 16)
    ld_kv = dh_pad + 8
    staged = 2 * _ROWS_PER_WARP * ld_kv * 2
    scratch = 2 * 256 * 4 + 2 * 256 * 2
    out = _ROWS_PER_WARP * (dh_pad + 4) * 4
    warp = _round_up(max(staged, scratch, out), 128)
    return 2 * s_pad * ld_kv * 2 + _WARPS * warp + 3 * s_pad * 4


def short_attention_bwd_body(s: int, head_dim: int, vec: int = 1) -> int:
    """The K2 body a bf16 call takes, decided before launch from the shape:
    1 = the warpgroup body (wgmma fed by TMA: head dim 64, rows 16-byte
    aligned (``vec``, see :func:`_vec`), s_pad <= 256), 0 = the wmma body
    (every other shape K1 takes). Mirrors ``short_attention_bwd_body`` in
    ``short_attention_bwd.cu``."""
    return int(head_dim == 64 and bool(vec) and 1 <= s and _round_up(s, 16) <= 256)


def short_attention_bwd_wgmma_smem_bytes(s: int, which: str) -> int:
    """Dynamic shared memory of one block of the K2 warpgroup body's
    ``"dq"`` or ``"dkdv"`` kernel at length s (0 where that body does not
    run). dQ: 1,024 bytes of alignment slack, K and V over the 64, 256 or
    256 rows that hold the N = 64, 208 or 256 keys of its products, and per
    warpgroup (one at N = 64, else two) a 64-row Q and dO tile and its
    parked f32 p (N/2 floats a thread), then three or two 8-byte barriers.
    dK/dV: the slack, Q and dO over s rounded up to 64 rows, one 64-row K
    and V tile, three f32 statistics a row and one barrier. Mirrors
    ``short_attention_bwd_wgmma_smem_bytes`` in the source. Not a term of
    :func:`short_attention_fits`: the wmma body's footprint is."""
    if not short_attention_bwd_body(s, 64):
        return 0
    if which == "dq":
        n = _wgmma_keys(s)
        groups = 1 if n == 64 else 2
        return 1024 + 2 * _round_up(n, 64) * 128 + groups * (2 * 64 * 128 + n // 2 * 128 * 4) \
            + (1 + groups) * 8
    if which == "dkdv":
        rows = _round_up(s, 64)
        return 1024 + 2 * rows * 128 + 2 * 64 * 128 + 3 * rows * 4 + 8
    raise ValueError(f"which must be 'dq' or 'dkdv', got {which!r}")


def _k3_variant(s: int, head_dim: int) -> tuple[int, int]:
    """(variant, bytes) of the K3 kernel this bf16 shape takes, mirroring
    ``variant()`` in ``short_attention_bwd_batched.cu``: 1 = the two-array
    kernel (s_pad <= 208: bf16(p) and ds, (s_pad × s_pad) each, and two
    (s_pad × dh_pad) operands), 2 = the in-place kernel (s_pad in [144,
    256]: one (s_pad × s_pad) array, three operands and three f32 row
    statistics), 0 = none; bytes of dynamic shared memory, 0 for none."""
    if s < 1 or not 1 <= head_dim <= MAX_HEAD_DIM:
        return 0, 0
    s_pad, dh_pad = _round_up(s, 16), _round_up(head_dim, 16)
    two = 2 * s_pad * s_pad * 2 + 2 * s_pad * dh_pad * 2
    if s_pad <= 208 and two <= SMEM_BUDGET_BYTES:
        return 1, two
    one = s_pad * s_pad * 2 + 3 * s_pad * dh_pad * 2 + 3 * s_pad * 4
    if 144 <= s_pad <= 256 and one <= SMEM_BUDGET_BYTES:
        return 2, one
    return 0, 0


def short_attention_bwd_batched_smem_bytes(s: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of K3's ``mma.sync`` kernel at this
    bf16 shape, the fit's term (0 where no variant of the kernel takes it).
    Mirrors ``short_attention_bwd_batched_smem_bytes`` in the source; the
    warpgroup body's is :func:`short_attention_bwd_batched_wgmma_smem_bytes`."""
    return _k3_variant(s, head_dim)[1]


def _wgmma_keys(s: int) -> int:
    """Keys N of the K2 and K3 warpgroup bodies' products at length s (64,
    208 or 256), 0 past s_pad = 256."""
    s_pad = _round_up(s, 16)
    if s < 1 or s_pad > 256:
        return 0
    return 64 if s_pad <= 64 else 208 if s_pad <= 208 else 256


def short_attention_bwd_batched_body(s: int, head_dim: int, vec: int = 1) -> int:
    """The K3 body a bf16 call takes, decided before launch from the shape:
    1 = the warpgroup body (wgmma fed by TMA: head dim 64, rows 16-byte
    aligned (``vec``, see :func:`_vec`), s_pad <= 256), 0 = the ``mma.sync``
    kernels (:func:`_k3_variant`'s two-array or in-place kernel). Not a term
    of :func:`short_attention_bwd_batched_fits`. Mirrors
    ``short_attention_bwd_batched_body`` in the source."""
    return int(head_dim == 64 and bool(vec) and _wgmma_keys(s) > 0
               and _k3_variant(s, head_dim)[0] != 0)


def short_attention_bwd_batched_wgmma_smem_bytes(s: int) -> int:
    """Dynamic shared memory of one block of K3's warpgroup body at length s
    (0 where that body does not run), by the keys N of its products: 1,024
    bytes of alignment slack; K and V over 64 or 256 rows of 128 bytes; one
    stage (N = 64) or two of a 64-row Q and dO tile; the bf16(p) and ds
    panels, one or four of 64 × 64; the producer's parked f32 p, N/2 floats
    a thread; five or six 8-byte barriers. Mirrors
    ``short_attention_bwd_batched_wgmma_smem_bytes`` in the source."""
    n = _wgmma_keys(s)
    if not n:
        return 0
    rows = _round_up(n, 64)
    stages = 1 if n == 64 else 2
    box = 64 * 128
    return (1024 + 2 * rows * 128 + stages * 2 * box + 2 * (rows // 64) * box
            + n // 2 * 128 * 4 + (4 + stages) * 8)


def short_attention_bwd_batched_fits(s: int, width: int, num_heads: int,
                                     dtype_bytes: int) -> bool:
    """Whether K3 takes this shape: JAX's VMEM predicate (the seven (s,
    width) blocks in ``dtype_bytes`` plus three f32 (s, s) chains per head
    within 70% of 16 MiB) and the card's own fit: in bf16 a variant of the
    K3 kernel (:func:`short_attention_bwd_batched_smem_bytes`), in f32 the
    f32 kernels' head dim. JAX's predicate decides at B/16 and at the three
    widths of JAX's limits (s <= 250 at 768 / 12 heads, 212 at 1,024 / 16,
    208 at 1,152 / 16); L/14's s = 256 is refused by both."""
    head_dim = width // num_heads
    jax_fits = (7 * s * width * dtype_bytes + 3 * num_heads * s * s * 4
                <= _VMEM_BUDGET_BYTES)
    if dtype_bytes == 4:
        return jax_fits and 1 <= head_dim <= attention_f32.MAX_HEAD_DIM
    return jax_fits and _k3_variant(s, head_dim)[0] != 0


def short_attention_fits(s: int, width: int, dtype_bytes: int, num_heads: int) -> bool:
    """True when the fused short kernel takes this shape. bf16: head_dim at
    most :data:`MAX_HEAD_DIM`, one block of K1 and of K2 within the 227 KB
    Hopper budget, and the K1/K7 dispatch limit
    (:func:`_k1_dispatch_limit_bytes`: s <= 416 at width 768 / 12 heads, 368
    at 1,152 / 16; B/16's s=196 and 64 and L/14's s=256 fit; s=1024 at dh=64
    does not: K7 takes it). f32: JAX's own predicate (s <= 1,024 and
    the backward's seven (s, width) blocks plus three f32 (s, s) chains
    within its VMEM budget), since the f32 kernels tile the sequence and take
    every length; head_dim at most 128."""
    head_dim = width // num_heads
    if dtype_bytes == 4:
        return (
            s <= SHORT_ATTENTION_MAX_SEQ
            and 7 * s * width * 4 + 3 * s * s * 4 <= _VMEM_BUDGET_BYTES
            and 1 <= head_dim <= attention_f32.MAX_HEAD_DIM
        )
    return (
        dtype_bytes == 2
        and head_dim <= MAX_HEAD_DIM
        and max(_k1_dispatch_limit_bytes(s, head_dim),
                short_attention_smem_bytes(s, head_dim),
                short_attention_bwd_smem_bytes(s, head_dim)) <= SMEM_BUDGET_BYTES
    )


def _resolve_scale(q, scale):
    return (q.shape[-1] ** -0.5) if scale is None else float(scale)


def _probs(qf, kf, scale: float, causal: bool):
    """f32 (or wider) softmax probabilities (b, h, s_q, s_k) from upcast q, k."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        s = qf.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=qf.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    return torch.softmax(logits, dim=-1)


def short_self_attention_plain(q, k, v, causal: bool = False, scale: float | None = None):
    """K1's function in plain PyTorch, with the same rounding points.
    q/k/v: (b, s, h, dh) → (b, s, h, dh) in q's dtype."""
    scale = _resolve_scale(q, scale)
    # Activation-dtype inputs, f32 accumulation: the products of two bf16
    # values are exact in f32, so upcasting first is the same contraction.
    acc = torch.promote_types(q.dtype, torch.float32)
    p = _probs(q.to(acc), k.to(acc), scale, causal)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def short_self_attention_bwd_plain(q, k, v, do, causal: bool = False,
                                   scale: float | None = None):
    """K2's function in plain PyTorch, at ``_bwd_kernel``'s rounding points:
    p in f32 from f32 logits; ``p_lo = p`` rounded to the activation dtype
    feeds dv; dp in f32; the rowsum over the f32 p; ds rounded to the
    activation dtype before dq and dk; outputs in q's dtype.
    q/k/v/do: (b, s, h, dh) → (dq, dk, dv), each (b, s, h, dh)."""
    scale = _resolve_scale(q, scale)
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = (t.to(acc) for t in (q, k, v))
    dof = do.to(v.dtype).to(acc)
    p = _probs(qf, kf, scale, causal)
    p_lo = p.to(v.dtype).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_lo, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = ((p * (dp - (dp * p).sum(dim=-1, keepdim=True))) * scale).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def short_self_attention_bwd_batched_plain(q, k, v, do, causal: bool = False,
                                           scale: float | None = None):
    """K3's function in plain PyTorch, as ``_bwd_kernel_batched`` writes it:
    the heads as a batch dimension, (b, h, s, dh), and each of the five
    products one batched matmul, at K2's rounding points (f32 logits,
    softmax and chain; ``p`` and ``ds`` rounded to the activation dtype
    before their products; outputs in q's dtype).
    q/k/v/do: (b, s, h, dh) → (dq, dk, dv), each (b, s, h, dh)."""
    scale = _resolve_scale(q, scale)
    acc = torch.promote_types(q.dtype, torch.float32)

    def heads(t):  # (b, s, h, dh) -> (b, h, s, dh)
        return t.transpose(1, 2).to(acc)

    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(do.to(v.dtype))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale  # (b, h, s_q, s_k)
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p_lo = p.to(v.dtype).to(acc)
    dv = torch.matmul(p_lo.transpose(-1, -2), doh)  # pᵀ @ do
    dp = torch.matmul(doh, vh.transpose(-1, -2))  # do @ vᵀ
    ds = ((p * (dp - (dp * p).sum(dim=-1, keepdim=True))) * scale).to(q.dtype).to(acc)
    dq = torch.matmul(ds, kh)  # ds @ k
    dk = torch.matmul(ds.transpose(-1, -2), qh)  # dsᵀ @ q
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def _library(name: str) -> ctypes.CDLL:
    lib = _cuda.load(name)
    if getattr(lib, "_typed", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "short_attention":
        lib.short_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
        lib.short_attention_fwd.restype = i
        lib.short_attention_smem_bytes.argtypes = [i, i]
        lib.short_attention_smem_bytes.restype = ctypes.c_longlong
        lib.short_attention_occupancy.argtypes = [i, i]
        lib.short_attention_occupancy.restype = i
        lib.short_attention_row_keys.argtypes = [i, i, i]
        lib.short_attention_row_keys.restype = i
        lib.short_attention_body.argtypes = [i, i, i]
        lib.short_attention_body.restype = i
        lib.short_attention_error_string.argtypes = [i]
        lib.short_attention_error_string.restype = ctypes.c_char_p
    elif name == "short_attention_bwd_batched":
        lib.short_attention_bwd_batched.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_float, i, i, p]
        lib.short_attention_bwd_batched.restype = i
        lib.short_attention_bwd_batched_smem_bytes.argtypes = [i, i]
        lib.short_attention_bwd_batched_smem_bytes.restype = ctypes.c_longlong
        lib.short_attention_bwd_batched_variant.argtypes = [i, i]
        lib.short_attention_bwd_batched_variant.restype = i
        lib.short_attention_bwd_batched_occupancy.argtypes = [i, i]
        lib.short_attention_bwd_batched_occupancy.restype = i
        lib.short_attention_bwd_batched_body.argtypes = [i, i, i]
        lib.short_attention_bwd_batched_body.restype = i
        lib.short_attention_bwd_batched_wgmma_smem_bytes.argtypes = [i]
        lib.short_attention_bwd_batched_wgmma_smem_bytes.restype = ctypes.c_longlong
        lib.short_attention_bwd_batched_error_string.argtypes = [i]
        lib.short_attention_bwd_batched_error_string.restype = ctypes.c_char_p
    else:
        lib.short_attention_bwd.argtypes = [p] * 8 + [i, i, i, i, ctypes.c_float, i, i, p]
        lib.short_attention_bwd.restype = i
        lib.short_attention_bwd_probe.argtypes = [p] * 9 + [i, i, i, ctypes.c_float, i, p]
        lib.short_attention_bwd_probe.restype = i
        lib.short_attention_bwd_smem_bytes.argtypes = [i, i]
        lib.short_attention_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.short_attention_bwd_wgmma_smem_bytes.argtypes = [i, i]
        lib.short_attention_bwd_wgmma_smem_bytes.restype = ctypes.c_longlong
        lib.short_attention_bwd_body.argtypes = [i, i, i]
        lib.short_attention_bwd_body.restype = i
        lib.short_attention_bwd_occupancy.argtypes = [i, i, i, i]
        lib.short_attention_bwd_occupancy.restype = i
        lib.short_attention_bwd_error_string.argtypes = [i]
        lib.short_attention_bwd_error_string.restype = ctypes.c_char_p
    lib._typed = True
    return lib


def _check_cuda(fn: str, q, others) -> None:
    """What the kernels take: CUDA, one shape, device and dtype (bf16; f32
    goes to ``attention_f32``), contiguous, a shape that
    :func:`short_attention_fits`."""
    if q.dtype == torch.float32:
        attention_f32.check_cuda(fn, q, others)
        b, s, h, dh = q.shape
        if not short_attention_fits(s, h * dh, 4, h):
            raise ValueError(f"{fn}: s={s}, h={h}, dh={dh} does not fit the kernel in f32")
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
    b, s, h, dh = q.shape
    if not short_attention_fits(s, h * dh, 2, h):
        raise ValueError(f"{fn}: s={s}, h={h}, dh={dh} does not fit the kernel")


def _vec(dh: int, width: int, tensors) -> int:
    """1 when every row is a whole number of 16-byte chunks (the kernels'
    asynchronous 16-byte copies and paired stores), else 0 (element-wise)."""
    return int(dh % 8 == 0 and width % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch_fwd(q, k, v, causal: bool, scale: float):
    """Launch K1 on checked CUDA tensors; returns the new output."""
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    vec = _vec(dh, h * dh, (q, k, v, out))
    lib = _library("short_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, dh, float(scale), int(bool(causal)), vec, stream,
        )
    if err != 0:
        msg = lib.short_attention_error_string(err).decode()
        raise RuntimeError(f"short_attention_fwd launch failed: CUDA error {err} ({msg})")
    _count("fwd")
    return out


def _launch_bwd(q, k, v, do, causal: bool, scale: float):
    """Launch K2 on checked CUDA tensors; returns new (dq, dk, dv)."""
    b, s, h, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    stats = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
    vec = _vec(dh, h * dh, (q, k, v, do, dq, dk, dv))
    lib = _library("short_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, s, h, dh, float(scale), int(bool(causal)), vec, stream,
        )
    if err != 0:
        msg = lib.short_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"short_attention_bwd launch failed: CUDA error {err} ({msg})")
    _count("bwd")
    return dq, dk, dv


def _launch_bwd_probe(q, k, v, do, causal: bool, scale: float):
    """K2's warpgroup body on checked bf16 CUDA tensors of a shape it takes,
    also returning what each of its two kernels computed for every (query,
    key) pair below s: ``(dq, dk, dv, probe)`` with ``probe`` (4, b, h, s,
    s) f32, planes p and ds (before the bf16 rounding) from the dQ kernel
    (0, 2) and from the dK/dV kernel (1, 3). For checks that the two agree
    bit for bit; not counted as a launch."""
    _check_cuda("short_attention_bwd_probe", q, (("k", k), ("v", v), ("do", do)))
    b, s, h, dh = q.shape
    if not short_attention_bwd_body(s, dh, _vec(dh, h * dh, (q, k, v, do))):
        raise ValueError(f"K2's warpgroup body does not take s={s}, dh={dh}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    stats = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
    probe = torch.zeros((4, b, h, s, s), dtype=torch.float32, device=q.device)
    lib = _library("short_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_bwd_probe(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), probe.data_ptr(),
            b, s, h, float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        msg = lib.short_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"short_attention_bwd_probe launch failed: CUDA error {err} ({msg})")
    return dq, dk, dv, probe


def _launch_bwd_batched(q, k, v, do, causal: bool, scale: float):
    """Launch K3 on checked CUDA tensors; returns new (dq, dk, dv)."""
    b, s, h, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    vec = _vec(dh, h * dh, (q, k, v, do, dq, dk, dv))
    lib = _library("short_attention_bwd_batched")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_bwd_batched(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, dh, float(scale), int(bool(causal)), vec, stream,
        )
    if err != 0:
        msg = lib.short_attention_bwd_batched_error_string(err).decode()
        raise RuntimeError(f"short_attention_bwd_batched launch failed: CUDA error {err} ({msg})")
    _count("bwd_batched")
    if short_attention_bwd_batched_body(s, dh, vec):
        _count("bwd_batched_wgmma")
    elif _k3_variant(s, dh)[0] == 2:
        _count("bwd_batched_in_place")
    return dq, dk, dv


def _forward(q, k, v, causal: bool, scale: float):
    # The module attributes are looked up per call, so a caller may swap the
    # plain version in for a kernel-vs-plain comparison on the card.
    if q.device.type == "cpu":
        return short_self_attention_plain(q, k, v, causal, scale)
    _check_cuda("short_self_attention", q, (("k", k), ("v", v)))
    if q.dtype == torch.float32:
        out, _ = attention_f32.launch_fwd(q, k, v, causal, scale, with_stats=False)
        _count("fwd")
        return out
    return _launch_fwd(q, k, v, causal, scale)


@torch.library.custom_op("dsl_torch_port::short_attention_fwd", mutates_args=())
def _short_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool, scale: float) -> torch.Tensor:
    return _forward(q, k, v, causal, scale).contiguous()


@_short_attention_fwd_op.register_fake
def _(q, k, v, causal, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# The attention core as selective checkpointing sees it (``attn_core``).
ATTN_CORE_OP = torch.ops.dsl_torch_port.short_attention_fwd.default


def short_self_attention_bwd(q, k, v, do, causal: bool = False, scale: float | None = None,
                             batch_heads: bool | None = None):
    """The gradients (dq, dk, dv) of :func:`short_self_attention` at output
    gradient ``do``, all (b, s, h, dh): by K2 (per head), or by K3 (head
    batched) when ``batch_heads`` is true (None: the process default of
    :func:`set_bwd_batch_heads`). Records the choice in
    :func:`traced_bwd_batch_heads`; K3 raises ``ValueError`` where
    :func:`short_attention_bwd_batched_fits` is false, as JAX does.

    CPU tensors run the plain version of the chosen kernel. CUDA tensors must
    be bf16 or f32 of one shape that :func:`short_attention_fits`; they run
    the kernel (f32: the f32 backward in the chosen role), or this raises.
    """
    scale = _resolve_scale(q, scale)
    batch_heads = _DEFAULT_BATCH_HEADS if batch_heads is None else bool(batch_heads)
    _TRACED_BWD_BATCH_HEADS.add(batch_heads)
    b, s, h, dh = q.shape
    if batch_heads and not short_attention_bwd_batched_fits(s, h * dh, h, q.element_size()):
        raise ValueError(
            f"batch_heads backward does not fit shared memory at s={s}, "
            f"width={h * dh}, h={h}; use the per-head loop"
        )
    if _cuda.take_op(q):  # the op, which a trace records
        return _short_attention_bwd_op(q, k, v, do, bool(causal), float(scale), batch_heads)
    return _backward(q, k, v, do, bool(causal), float(scale), batch_heads)


def _backward(q, k, v, do, causal: bool, scale: float, batch_heads: bool):
    if q.device.type == "cpu":
        if batch_heads:
            return short_self_attention_bwd_batched_plain(q, k, v, do, causal, scale)
        return short_self_attention_bwd_plain(q, k, v, do, causal, scale)
    do = do.contiguous()
    _check_cuda("short_self_attention_bwd", q, (("k", k), ("v", v), ("do", do)))
    if q.dtype == torch.float32:
        # The f32 backward reads the output and row statistics, which this
        # node did not save: one forward for them, then the two passes.
        out, stats = attention_f32.launch_fwd(q, k, v, causal, scale, with_stats=True)
        dk, dv, di = attention_f32.launch_bwd_dkv(q, k, v, out, do, stats, causal, scale)
        dq = attention_f32.launch_bwd_dq(q, k, v, do, stats, di, causal, scale)
        _count("bwd_batched" if batch_heads else "bwd")
        return dq, dk, dv
    if batch_heads:
        return _launch_bwd_batched(q, k, v, do, causal, scale)
    return _launch_bwd(q, k, v, do, causal, scale)


@torch.library.custom_op("dsl_torch_port::short_attention_bwd", mutates_args=())
def _short_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, causal: bool, scale: float,
                            batch_heads: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in _backward(q, k, v, do, causal, scale, batch_heads))


@_short_attention_bwd_op.register_fake
def _(q, k, v, do, causal, scale, batch_heads):
    return tuple(torch.empty_like(q, memory_format=torch.contiguous_format) for _ in range(3))


class ShortSelfAttention(torch.autograd.Function):
    """K1 forward and the K2 or K3 backward as one autograd node. The
    forward saves (q, k, v), as the JAX ``custom_vjp`` does; the backward
    recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, batch_heads: bool | None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.batch_heads = causal, scale, batch_heads
        return _short_attention_fwd_op(q, k, v, causal, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = short_self_attention_bwd(q, k, v, do, ctx.causal, ctx.scale,
                                              ctx.batch_heads)
        return dq, dk, dv, None, None, None


def short_self_attention(q, k, v, causal: bool = False, scale: float | None = None,
                         batch_heads: bool | None = None):
    """Fused self-attention for short sequences: (b, s, h, dh) → same, with
    the K2 backward under autograd, or K3 when ``batch_heads`` is true (None:
    the process default of :func:`set_bwd_batch_heads`, read when the
    backward runs).

    CPU tensors run :func:`short_self_attention_plain` (and, backward,
    :func:`short_self_attention_bwd_plain`). CUDA tensors must be contiguous
    bf16 or f32 of one shape that :func:`short_attention_fits`; they run the
    kernels, or this raises. A call that needs no gradient (serving) skips
    the autograd node and the custom op's dispatch, whose host time would
    exceed K1's own at the text tower's shape, except while ``torch.export``
    traces it or its tensors are fake (``_cuda.take_op``): then it is the
    op.
    """
    scale = _resolve_scale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return ShortSelfAttention.apply(q, k, v, bool(causal), scale, batch_heads)
    if _cuda.take_op(q):
        return _short_attention_fwd_op(q, k, v, bool(causal), scale)
    return _forward(q, k, v, bool(causal), scale)
