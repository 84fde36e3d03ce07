"""The f32 attention kernels (``csrc/attention_f32.cu``): one forward and one
two-pass backward that play, for f32 activations, the roles of K1, K2, K3
and K7. Both form every product in split f32 on the tensor cores (each f32
operand as two TF32 parts, three TF32 products summed in f32;
:func:`split_f32_matmul` emulates them): the forward on ``wgmma``, walking
the keys :func:`fwd_keys` at a time with the online softmax in registers,
the backward on ``mma.sync``. Outputs stay within 1e-4 of the largest
magnitude of the IEEE-f32 plain versions.

In f32 nothing is rounded to a narrower type between the products, so JAX's
K1 and K7 compute one function and K2, K3 and K7's backward another (the
source's header gives both). ``ops/short_attention.py`` and
``ops/flash_attention.py`` call these launchers for f32 CUDA tensors where
JAX runs those kernels in f32, and count each call under the role it
plays there; the plain version of each role is that module's own plain
function run in f32. :func:`launches` counts each kernel here at its own
launch, whatever the role: the K2/K3 role runs the forward again (for the
output and statistics it did not save) before its two passes. Nothing here
falls back: a tensor the kernels do not take raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributed_sigmoid_loss_tpu_torch.ops import _cuda

__all__ = ["launch_fwd", "launch_bwd_dkv", "launch_bwd_dq", "check_cuda", "smem_bytes",
           "BWD_ROWS", "fwd_groups", "fwd_keys", "blocks_per_sm_by_smem",
           "bwd_vec", "tf32_round", "split_f32_matmul", "launches", "reset_launches",
           "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
# Rows of the other side that the backward kernels stream a stage.
BWD_ROWS = 32


def fwd_groups(seq_len: int) -> int:
    """Warpgroups of 64 query rows in a block of the forward: two share
    each chunk's split, one where it holds every row (``seq_len <= 64``).
    Mirrors ``fwd_groups`` in the source, which picks the instantiation
    before launch."""
    return 1 if seq_len <= 64 else 2


def fwd_keys(head_dim: int) -> int:
    """Keys of the forward's chunk: 64 up to head dim 64, else 32 (the
    planes of 64 would not fit beside Q's). A last chunk with at most 16 or
    32 live keys runs at that width. Mirrors ``fwd_keys`` in the source."""
    return 64 if head_dim <= 64 else 32


_count_lock = threading.Lock()
_launches = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}


def launches() -> dict[str, int]:
    """Launches of each f32 kernel since :func:`reset_launches`: ``fwd``,
    ``bwd_dkv`` (the di pass and the dK/dV kernel, one call) and ``bwd_dq``."""
    with _count_lock:
        return dict(_launches)


def reset_launches() -> None:
    with _count_lock:
        _launches.update(fwd=0, bwd_dkv=0, bwd_dq=0)


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


def _library() -> ctypes.CDLL:
    lib = _cuda.load("attention_f32")
    if getattr(lib, "_typed", False):
        return lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attention_f32_fwd.argtypes = [p] * 5 + [i, i, i, i, f, i, p]
    lib.attention_f32_fwd.restype = i
    lib.attention_f32_bwd_dkv.argtypes = [p] * 9 + [i, i, i, i, f, i, p]
    lib.attention_f32_bwd_dkv.restype = i
    lib.attention_f32_bwd_dq.argtypes = [p] * 7 + [i, i, i, i, f, i, p]
    lib.attention_f32_bwd_dq.restype = i
    lib.attention_f32_smem_bytes.argtypes = [i, i, i]
    lib.attention_f32_smem_bytes.restype = ctypes.c_longlong
    lib.attention_f32_occupancy.argtypes = [i, i, i]
    lib.attention_f32_occupancy.restype = i
    lib.attention_f32_error_string.argtypes = [i]
    lib.attention_f32_error_string.restype = ctypes.c_char_p
    lib._typed = True
    return lib


def smem_bytes(head_dim: int, which: int, seq_len: int | None = None) -> int:
    """Dynamic shared memory of one block of the forward (``which`` 0),
    dK/dV (1) or dQ (2). The forward, with ``P = ceil(head_dim / 32)``
    panels of 128 bytes a row: TF32 hi and lo planes of the block's
    ``64 * fwd_groups(seq_len)`` query rows (``seq_len`` None: the larger
    block, two warpgroups), of a chunk's :func:`fwd_keys` keys and of its
    values transposed (``32 * P`` rows a 32-key panel); the chunk's f32 K
    and V rows; and 1 KB to align the planes. The backward (any
    ``seq_len``): 64 resident rows of two tensors and a two-stage ring of
    :data:`BWD_ROWS` rows of two, f32 at row stride ``round16(head_dim) +
    4``; dK/dV adds the ring's row statistics (m, l, di). Mirrors
    ``attention_f32_smem_bytes``."""
    dh16 = -(-head_dim // 16) * 16
    if which == 0:
        panels = -(-head_dim // 32)
        groups = 2 if seq_len is None else fwd_groups(seq_len)
        return 2 * groups * panels * 64 * 128 + 6 * panels * fwd_keys(head_dim) * 128 + 1024
    rows = (2 * 64 + 4 * BWD_ROWS) * (dh16 + 4)
    return 4 * (rows + 6 * BWD_ROWS if which == 1 else rows)


# Shared memory of one H100 SM (228 KB), and what each block reserves.
SM_SMEM_BYTES, BLOCK_RESERVED_SMEM_BYTES = 228 * 1024, 1024


def blocks_per_sm_by_smem(head_dim: int, which: int, seq_len: int | None = None) -> int:
    """Blocks of a kernel (``which`` and ``seq_len`` as in :func:`smem_bytes`)
    one SM holds by shared memory alone; registers may hold fewer
    (``chip_smoke.py`` prints the card's own count,
    ``attention_f32_occupancy``)."""
    return SM_SMEM_BYTES // (smem_bytes(head_dim, which, seq_len) + BLOCK_RESERVED_SMEM_BYTES)


def bwd_vec(head_dim: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernels copy rows 16 bytes at a time (else 4):
    ``head_dim % 4 == 0`` and every tensor 16-byte aligned (the forward's
    q, k, v; the backward's q, k, v, do). Mirrors ``bwd_vec`` in the source;
    both copies give bitwise the same result."""
    return head_dim % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: to 10
    explicit significand bits, nearest with ties away from zero, by the int32
    bits (the low 13 bits cleared). Used by the tests to emulate the
    kernels' split products on the CPU."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_f32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernels form it on the tensor cores: each f32
    operand split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, and the
    products lo·hi, hi·lo, then hi·hi summed in f32 (``terms=3``);
    ``terms=1`` is plain TF32 (hi·hi alone). Each TF32 product is exact in
    f32. A NaN's hi is NaN, as in the kernels' ``split`` (``tf32_round``
    alone turns the card's NaN into −0). Used by the tests only."""
    a_hi, b_hi = (torch.where(torch.isnan(x), x, tf32_round(x)) for x in (a, b))
    hi = a_hi @ b_hi
    if terms == 1:
        return hi
    return (tf32_round(a - a_hi) @ b_hi + a_hi @ tf32_round(b - b_hi)) + hi


def check_cuda(fn: str, q, others) -> None:
    """What the kernels take: CUDA f32 tensors of one shape and device,
    contiguous, head dim at most :data:`MAX_HEAD_DIM`."""
    for name, t in others:
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(
                f"{fn}: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                f"differs from q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if not q.is_cuda or q.dtype != torch.float32:
        raise ValueError(f"{fn}: the f32 kernels take float32 CUDA tensors, got {q.dtype} "
                         f"on {q.device}")
    if not q.is_contiguous() or not all(t.is_contiguous() for _, t in others):
        raise ValueError(f"{fn} kernel takes contiguous tensors")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head_dim={q.shape[-1]}; the f32 kernels take 1 to "
                         f"{MAX_HEAD_DIM}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.attention_f32_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_fwd(q, k, v, causal: bool, scale: float, with_stats: bool):
    """The forward on checked tensors → ``(out, stats)``: out (b, s, h, dh);
    stats (b, h, 2, s) f32, the row maxima then the row sums, or None."""
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    stats = torch.empty((b, h, 2, s), dtype=torch.float32, device=q.device) if with_stats \
        else None
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.attention_f32_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            stats.data_ptr() if with_stats else None, b, s, h, dh, float(scale),
            int(bool(causal)), _stream(q),
        )
    _raise_on(lib, err, "attention_f32_fwd")
    _count("fwd")
    return out, stats


def launch_bwd_dkv(q, k, v, out, do, stats, causal: bool, scale: float):
    """The di pass and the dK/dV kernel → ``(dk, dv, di)``."""
    b, s, h, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.attention_f32_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            stats.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, dh, float(scale), int(bool(causal)), _stream(q),
        )
    _raise_on(lib, err, "attention_f32_bwd_dkv")
    _count("bwd_dkv")
    return dk, dv, di


def launch_bwd_dq(q, k, v, do, stats, di, causal: bool, scale: float):
    """The dQ kernel → dq."""
    b, s, h, dh = q.shape
    dq = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.attention_f32_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(),
            di.data_ptr(), dq.data_ptr(), b, s, h, dh, float(scale), int(bool(causal)),
            _stream(q),
        )
    _raise_on(lib, err, "attention_f32_bwd_dq")
    _count("bwd_dq")
    return dq
