"""The streaming sigmoid-loss block: the summed loss of one (b × n) logits
block without ever holding the logits, forward (K4) and backward (K5, K6):
CUDA kernels with their plain PyTorch versions beside them, joined by one
``torch.autograd.Function``.

Replaces the Pallas TPU kernels of
``distributed_sigmoid_loss_tpu/ops/pallas_sigmoid_loss.py``. With ``t =
exp(t′)``, ``raw = zimg·ztxtᵀ`` and ``logit = raw·t + bias``, labels +1 where
``col == row + pos_offset`` and −1 elsewhere:

- K4, ``_fwd`` (body ``_fwd_kernel``): ``Σ softplus(−label·logit)``.
- K5, ``_bwd`` pass 1 (body ``_bwd_img_kernel``): ``dl = g·(−label·σ(−label·logit))``,
  ``dzimg = t·dl·ztxt``, ``dt′ = t·Σ dl·raw``, ``dbias = Σ dl``.
- K6, ``_bwd`` pass 2 (body ``_bwd_txt_kernel``): ``dztxt = t·dlᵀ·zimg``.

Kernels: ``csrc/sigmoid_loss.cu``. As in the JAX kernel the product is f32
on the f32-cast embeddings whatever ``precision`` the caller's loss names,
the backward recomputes every logit tile from the saved embeddings, and the
gradients come back in the inputs' dtypes. Every product (K4's logits, K5's
and K6's logits again and their gradient products) runs in split f32 on the
tensor cores, each operand as two TF32 parts and three TF32 products summed
in f32 (``ops/attention_f32.split_f32_matmul`` emulates them), the logits
summed 32 columns at a time and those sums added in IEEE f32: the loss
within the plain version's rtol 1e-5, the gradients within 1e-4 of the
largest magnitude.

``quant="int8"`` is the int8 mode (JAX ``_tile_raw_int8``, K4 int8): each
embedding row is quantized once per call (``ops/quant.quantize_int8``,
axis 1) and ``raw = (f32(ziq·ztqᵀ) · zis) · zts``, the exact int32 product
(int8 tensor-core products in every kernel) dequantized by two separately
rounded multiplies. K5/K6 recompute dlogits at
that raw (dt′ sums ``dl·raw`` at it too), but dzimg and dztxt are the
full-precision products ``t·dl·ztxt`` and ``t·dlᵀ·zimg``: the
straight-through contract. Its launches are counted apart from the f32 ones.

On CPU tensors the functions run the plain versions. On CUDA tensors they
launch the kernels or raise. :func:`streaming_block_loss_sum` takes every
shape in f32 (the kernels mask ragged b, n and d). The dispatch the
distributed variants call, :func:`streaming_block_loss_or_none`, is JAX's:
a block that fails :func:`pallas_compatible` (the TPU kernel's tiling) gets
``None`` and ``"xla"`` in :func:`traced_loss_kernels`, and the caller
computes it with its plain block at the loss's ``precision``, as JAX's
callers do.

K4 and the K5/K6 pair are the custom ops ``dsl_torch_port::streaming_loss_fwd``
and ``dsl_torch_port::streaming_loss_bwd``, with fake versions, so
``torch.export`` records them in an artifact (``train/export.py``).
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch.autograd.function import once_differentiable

from distributed_sigmoid_loss_tpu_torch.ops import _cuda
from distributed_sigmoid_loss_tpu_torch.ops.quant import int8_product, quantize_int8

__all__ = [
    "streaming_block_loss_sum",
    "streaming_block_loss_or_none",
    "streaming_loss_fwd_plain",
    "streaming_loss_bwd_img_plain",
    "streaming_loss_bwd_txt_plain",
    "pallas_compatible",
    "StreamingBlockLossSum",
    "traced_loss_kernels",
    "reset_traced_loss_kernels",
    "launches",
    "reset_launches",
    "fwd_partials",
    "fwd_smem_bytes",
    "fwd_layout",
    "bwd_smem_bytes",
    "bwd_layout",
    "NEGATIVE_ONLY_OFFSET",
    "DEFAULT_TILE_B",
    "DEFAULT_TILE_N",
]

# Positive-diagonal offset that matches no column: every label is -1 (ring
# hops after the first, the non-positive chunks of the chunk scan).
NEGATIVE_ONLY_OFFSET = -(2 ** 24)

# The TPU kernel's default tiles (JAX ops/pallas_sigmoid_loss.py), which its
# dispatch checks a block against.
DEFAULT_TILE_B = 128
DEFAULT_TILE_N = 256

# Mirrors of the kernels' tiling (csrc/sigmoid_loss.cu): K4's 128 × 128
# tiles (a persistent grid walks them, one block an SM in the f32 mode, two
# in the int8 mode, whose ring has three stages); K5/K6's 128 owned rows,
# 64-row tiles of the other operand, the widest slice of gradient columns
# one block keeps, the 32 columns of a logit step,
# the 32 tile rows of a gradient step (at a row stride of 260 floats), the
# stages of the cp.async ring and the largest cluster of slices that share
# the logits. (How many blocks share K5/K6's other operand depends on the
# card's SM count: the library reports it, sigmoid_loss_bwd_splits.)
_FWD_TILE, _FWD_STAGES_INT8 = 128, 3
_BWD_ROWS, _BWD_TILE, _MAX_SLICE, _STEP_COLS, _GRAD_ROWS = 128, 64, 256, 32, 32
_STAGES, _MAX_CLUSTER = 4, 8

_count_lock = threading.Lock()
_KERNELS = ("fwd", "bwd_img", "bwd_txt", "fwd_int8", "bwd_img_int8", "bwd_txt_int8")
_launches = dict.fromkeys(_KERNELS, 0)

# Every loss-kernel choice the dispatch made in this process, as JAX records
# them: "streaming" / "streaming_int8" when a block took the kernel, "xla"
# when a block failed pallas_compatible and went to the caller's plain path.
_TRACED_LOSS_KERNELS: set[str] = set()


def launches() -> dict:
    """Kernel calls since the last :func:`reset_launches`: ``{"fwd": K4,
    "bwd_img": K5, "bwd_txt": K6}`` in f32 and ``"fwd_int8"``,
    ``"bwd_img_int8"``, ``"bwd_txt_int8"`` in the int8 mode. One call is the
    kernel and the fixed-order sum of its partials, counted once;
    plain-version calls on CPU tensors are not launches."""
    with _count_lock:
        return dict(_launches)


def reset_launches() -> None:
    with _count_lock:
        _launches.update(dict.fromkeys(_KERNELS, 0))


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


def traced_loss_kernels() -> tuple[str, ...]:
    """Distinct loss-kernel choices made so far, sorted: ``()`` when no
    block went through :func:`streaming_block_loss_or_none`;
    ``("streaming",)`` / ``("streaming_int8",)`` when every one took the
    kernel; a tuple holding ``"xla"`` when a block's shape fell back."""
    return tuple(sorted(_TRACED_LOSS_KERNELS))


def reset_traced_loss_kernels() -> None:
    """Clear the record (test isolation)."""
    _TRACED_LOSS_KERNELS.clear()


def _ceil_div(x: int, m: int) -> int:
    return -(-x // m)


def pallas_compatible(b: int, n: int, d: int, tile_b: int = DEFAULT_TILE_B,
                      tile_n: int = DEFAULT_TILE_N, quant: bool = False) -> bool:
    """The TPU kernel's tiling constraints (JAX ``pallas_compatible``): tiles
    clamped to the block must divide it, ``d % 128 == 0``, and the tiles be
    a multiple of 8 rows in f32, 32 in int8."""
    tb, tn = min(tile_b, b), min(tile_n, n)
    sub = 32 if quant else 8
    return b % tb == 0 and n % tn == 0 and d % 128 == 0 and tb % sub == 0 and tn % sub == 0


def fwd_partials(b: int, n: int) -> int:
    """K4's partials, one a 128 × 128 tile (mirrors
    ``sigmoid_loss_fwd_partials``)."""
    return _ceil_div(b, _FWD_TILE) * _ceil_div(n, _FWD_TILE)


def fwd_layout(d: int) -> tuple[int, int | None]:
    """K4's steps a tile at width ``d``: 32 columns a step in the f32 mode,
    128 in the int8 mode (None where the int8 mode refuses d, d % 16)."""
    return _ceil_div(d, _STEP_COLS), (_ceil_div(d, 4 * _STEP_COLS) if d % 16 == 0 else None)


def fwd_smem_bytes(quant: bool = False) -> int:
    """Dynamic shared memory of one K4 block, the same at every width: the
    cp.async ring's stages of a step (the tile's 128 zimg and 128 ztxt rows:
    f32, four stages of 32 columns at a row stride of 36 floats; int8, three
    of 128-byte rows) and, in the f32 mode, two sets of the TF32 hi and lo
    planes of the ztxt rows (128 bytes a row), with 1 KB of alignment slack
    (mirrors ``sigmoid_loss_fwd_smem_bytes``). One f32 block fits an SM, two
    int8 blocks do."""
    rows = 2 * _FWD_TILE
    if quant:
        return 1024 + _FWD_STAGES_INT8 * rows * 128
    return 1024 + 4 * _FWD_TILE * 128 + _STAGES * rows * (_STEP_COLS + 4) * 4


def bwd_layout(d: int) -> tuple[int, int, int, int]:
    """K5/K6's layout at width ``d`` in the f32 mode: (slices of the
    gradient columns over grid.y, columns a slice, blocks of the cluster
    that share the logits, steps of the ring a tile for the cluster member
    with the most: its share of the 32-column logit steps, then the two
    gradient steps). Mirrors ``bwd_slices``, ``bwd_slice`` and
    ``bwd_cluster``."""
    slices = _ceil_div(d, _MAX_SLICE)
    cluster = slices if slices <= _MAX_CLUSTER else 1
    steps = _ceil_div(_ceil_div(d, _STEP_COLS), cluster) + _BWD_TILE // _GRAD_ROWS
    return slices, _ceil_div(_ceil_div(d, slices), 32) * 32, cluster, steps


def bwd_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one K5/K6 block at width ``d``: the TF32 hi
    and lo planes of the wgmma B operands (a gradient step's 256 slice
    columns and a logit step's 64 tile rows, 128 bytes each), the ring's
    stages of 32 × 260 floats (which also hold a logit step's 192 rows of 36)
    and 1 KB of alignment slack. The gradient rows and dlogits live in
    registers, so it does not grow with ``d`` (mirrors ``bwd_smem_bytes`` in
    the source)."""
    if d < 1:
        return 0
    stage = _GRAD_ROWS * (_MAX_SLICE + 4)
    planes = 2 * 128 * (_MAX_SLICE + _BWD_TILE)
    return 1024 + planes + 4 * _STAGES * stage


# --- the plain versions -------------------------------------------------------


def _check_ieee(t: torch.Tensor) -> None:
    if t.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the plain streaming loss needs IEEE f32 products, but TF32 is on "
            f"(float32 matmul precision {torch.get_float32_matmul_precision()!r}); "
            "set torch.backends.cuda.matmul.allow_tf32 = False"
        )


def _raw(zimg, ztxt, quant: str):
    """The logit block's product: f32 on the f32-cast embeddings, or in the
    int8 mode ``(f32(ziq·ztqᵀ) · zis) · zts``, the exact int32 product of the
    rows quantized once, dequantized image scale first (``int8_product``)."""
    if quant:
        ziq, zis = quantize_int8(zimg, axis=1)
        ztq, zts = quantize_int8(ztxt, axis=1)
        return int8_product(ziq, zis, ztq, zts, torch.float32)
    _check_ieee(zimg)
    return zimg.float() @ ztxt.float().T


def _logits(zimg, ztxt, t_prime, bias, quant: str = ""):
    """(raw, logits, t): the f32 product of the f32-cast embeddings (or the
    int8 mode's raw), then ``raw·t + bias`` rounded as JAX rounds it."""
    raw = _raw(zimg, ztxt, quant)
    t = torch.exp(t_prime.float())
    return raw, raw * t + bias.float(), t


def _labels(b: int, n: int, pos_offset: int, device) -> torch.Tensor:
    rows = torch.arange(b, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    return torch.where(cols == rows + int(pos_offset), 1.0, -1.0)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(−|x|))``, no threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _dlogits(zimg, ztxt, t_prime, bias, pos_offset, g, quant=""):
    raw, logits, t = _logits(zimg, ztxt, t_prime, bias, quant)
    labels = _labels(raw.shape[0], raw.shape[1], pos_offset, raw.device)
    x = labels * logits
    return g.float() * (-labels * torch.sigmoid(-x)), raw, t


def streaming_loss_fwd_plain(zimg, ztxt, t_prime, bias, pos_offset: int = 0,
                             quant: str = "") -> torch.Tensor:
    """K4's function: the f32 sum of ``softplus(−label·logit)`` over the
    block (``quant="int8"``: at the int8 mode's raw)."""
    _, logits, _ = _logits(zimg, ztxt, t_prime, bias, quant)
    labels = _labels(logits.shape[0], logits.shape[1], pos_offset, logits.device)
    return _softplus(-labels * logits).sum()


def streaming_loss_bwd_img_plain(zimg, ztxt, t_prime, bias, pos_offset: int, g,
                                 quant: str = ""):
    """K5's function at upstream gradient ``g``: ``(dzimg, dt′, dbias)`` in
    f32. In the int8 mode dl and dt′ are at the int8 raw and dzimg is the
    product with the full-precision ztxt."""
    dl, raw, t = _dlogits(zimg, ztxt, t_prime, bias, pos_offset, g, quant)
    _check_ieee(zimg)
    return (dl @ ztxt.float()) * t, (dl * raw).sum() * t, dl.sum()


def streaming_loss_bwd_txt_plain(zimg, ztxt, t_prime, bias, pos_offset: int, g,
                                 quant: str = ""):
    """K6's function at upstream gradient ``g``: ``dztxt`` in f32 (in the
    int8 mode, dl at the int8 raw against the full-precision zimg)."""
    dl, _, t = _dlogits(zimg, ztxt, t_prime, bias, pos_offset, g, quant)
    _check_ieee(zimg)
    return (dl.T @ zimg.float()) * t


# --- the kernels ---------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _cuda.load("sigmoid_loss")
    if getattr(lib, "_typed", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sigmoid_loss_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p]
    lib.sigmoid_loss_fwd.restype = i
    lib.sigmoid_loss_bwd_img.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p, p, p]
    lib.sigmoid_loss_bwd_img.restype = i
    lib.sigmoid_loss_bwd_txt.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p, p]
    lib.sigmoid_loss_bwd_txt.restype = i
    lib.sigmoid_loss_fwd_int8.argtypes = [p] * 6 + [i, i, i, i, p, p, p]
    lib.sigmoid_loss_fwd_int8.restype = i
    lib.sigmoid_loss_bwd_img_int8.argtypes = [p] * 8 + [i, i, i, i, i, p, p, p, p]
    lib.sigmoid_loss_bwd_img_int8.restype = i
    lib.sigmoid_loss_bwd_txt_int8.argtypes = [p] * 8 + [i, i, i, i, i, p, p, p]
    lib.sigmoid_loss_bwd_txt_int8.restype = i
    lib.sigmoid_loss_fwd_partials.argtypes = [i, i]
    lib.sigmoid_loss_fwd_partials.restype = ctypes.c_longlong
    lib.sigmoid_loss_fwd_smem_bytes.argtypes = [i]
    lib.sigmoid_loss_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.sigmoid_loss_bwd_scratch_floats.argtypes = [i, i, i, i]
    lib.sigmoid_loss_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.sigmoid_loss_bwd_splits.argtypes = [i, i, i]
    lib.sigmoid_loss_bwd_splits.restype = i
    lib.sigmoid_loss_bwd_smem_bytes.argtypes = [i]
    lib.sigmoid_loss_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.sigmoid_loss_occupancy.argtypes = [i, i]
    lib.sigmoid_loss_occupancy.restype = i
    lib.sigmoid_loss_error_string.argtypes = [i]
    lib.sigmoid_loss_error_string.restype = ctypes.c_char_p
    lib._typed = True
    return lib


def _cuda_args(fn: str, zimg, ztxt, *scalars):
    """What the kernels take: 2-D embeddings of one width and one-element
    scalars, all on one CUDA device, in a floating dtype; returns them as
    contiguous f32 (the kernels' operand type, as JAX casts them)."""
    device = zimg.device
    if zimg.dim() != 2 or ztxt.dim() != 2 or zimg.shape[1] != ztxt.shape[1]:
        raise ValueError(f"{fn}: zimg {tuple(zimg.shape)} and ztxt {tuple(ztxt.shape)} "
                         "must be (b, d) and (n, d)")
    if zimg.shape[0] < 1 or ztxt.shape[0] < 1 or zimg.shape[1] < 1:
        raise ValueError(f"{fn}: empty block {tuple(zimg.shape)} x {tuple(ztxt.shape)}")
    for name, t in (("zimg", zimg), ("ztxt", ztxt)) + tuple(("scalar", s) for s in scalars):
        if t.device != device:
            raise ValueError(f"{fn}: {name} on {t.device}, zimg on {device}")
        if not t.is_floating_point():
            raise TypeError(f"{fn}: {name} has dtype {t.dtype}")
    for s in scalars:
        if s.numel() != 1:
            raise ValueError(f"{fn}: scalar argument of shape {tuple(s.shape)}")
    return [t.float().contiguous() for t in (zimg, ztxt, *scalars)]


def _vec(*tensors) -> int:
    """1 when every row is a whole number of aligned 16-byte chunks (the
    kernels' float4 loads), else 0 (element-wise loads)."""
    return int(tensors[0].shape[1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.sigmoid_loss_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _launch_fwd(zimg, ztxt, t_prime, bias, pos_offset: int) -> torch.Tensor:
    zimg, ztxt, t_prime, bias = _cuda_args("streaming_loss_fwd", zimg, ztxt, t_prime, bias)
    (b, d), n = zimg.shape, ztxt.shape[0]
    partials = torch.empty(fwd_partials(b, n), dtype=torch.float32, device=zimg.device)
    out = torch.empty((), dtype=torch.float32, device=zimg.device)
    lib = _library()
    with torch.cuda.device(zimg.device):
        err = lib.sigmoid_loss_fwd(
            zimg.data_ptr(), ztxt.data_ptr(), t_prime.data_ptr(), bias.data_ptr(),
            b, n, d, int(pos_offset), _vec(zimg, ztxt), partials.data_ptr(), out.data_ptr(),
            _stream(zimg.device),
        )
    _raise(lib, "sigmoid_loss_fwd", err)
    _count("fwd")
    return out


def _launch_bwd_img(zimg, ztxt, t_prime, bias, pos_offset: int, g):
    zimg, ztxt, t_prime, bias, g = _cuda_args("streaming_loss_bwd_img", zimg, ztxt,
                                              t_prime, bias, g)
    (b, d), n = zimg.shape, ztxt.shape[0]
    dzimg = torch.empty((b, d), dtype=torch.float32, device=zimg.device)
    out2 = torch.empty(2, dtype=torch.float32, device=zimg.device)
    lib = _library()
    with torch.cuda.device(zimg.device):
        scratch = torch.empty(lib.sigmoid_loss_bwd_scratch_floats(b, n, d, 1),
                              dtype=torch.float32, device=zimg.device)
        err = lib.sigmoid_loss_bwd_img(
            zimg.data_ptr(), ztxt.data_ptr(), t_prime.data_ptr(), bias.data_ptr(), g.data_ptr(),
            b, n, d, int(pos_offset), _vec(zimg, ztxt, dzimg), dzimg.data_ptr(),
            scratch.data_ptr(), out2.data_ptr(), _stream(zimg.device),
        )
    _raise(lib, "sigmoid_loss_bwd_img", err)
    _count("bwd_img")
    return dzimg, out2[0], out2[1]


def _launch_bwd_txt(zimg, ztxt, t_prime, bias, pos_offset: int, g):
    zimg, ztxt, t_prime, bias, g = _cuda_args("streaming_loss_bwd_txt", zimg, ztxt,
                                              t_prime, bias, g)
    (b, d), n = zimg.shape, ztxt.shape[0]
    dztxt = torch.empty((n, d), dtype=torch.float32, device=zimg.device)
    lib = _library()
    with torch.cuda.device(zimg.device):
        scratch = torch.empty(lib.sigmoid_loss_bwd_scratch_floats(n, b, d, 0),
                              dtype=torch.float32, device=zimg.device)
        err = lib.sigmoid_loss_bwd_txt(
            zimg.data_ptr(), ztxt.data_ptr(), t_prime.data_ptr(), bias.data_ptr(), g.data_ptr(),
            b, n, d, int(pos_offset), _vec(zimg, ztxt, dztxt), dztxt.data_ptr(),
            scratch.data_ptr(), _stream(zimg.device),
        )
    _raise(lib, "sigmoid_loss_bwd_txt", err)
    _count("bwd_txt")
    return dztxt


def _int8_operands(fn: str, zimg, ztxt):
    """The int8 mode's operands on the card: each embedding row quantized
    once (contiguous int8 rows, f32 scales), d a multiple of 16."""
    if zimg.shape[1] % 16:
        raise ValueError(f"{fn}: the int8 mode takes d % 16 == 0, got d={zimg.shape[1]}")
    ziq, zis = quantize_int8(zimg, axis=1)
    ztq, zts = quantize_int8(ztxt, axis=1)
    return ziq.contiguous(), zis.contiguous(), ztq.contiguous(), zts.contiguous()


def _launch_fwd_int8(zimg, ztxt, t_prime, bias, pos_offset: int) -> torch.Tensor:
    zimg, ztxt, t_prime, bias = _cuda_args("streaming_loss_fwd_int8", zimg, ztxt, t_prime, bias)
    ziq, zis, ztq, zts = _int8_operands("streaming_loss_fwd_int8", zimg, ztxt)
    (b, d), n = zimg.shape, ztxt.shape[0]
    partials = torch.empty(fwd_partials(b, n), dtype=torch.float32, device=zimg.device)
    out = torch.empty((), dtype=torch.float32, device=zimg.device)
    lib = _library()
    with torch.cuda.device(zimg.device):
        err = lib.sigmoid_loss_fwd_int8(
            ziq.data_ptr(), zis.data_ptr(), ztq.data_ptr(), zts.data_ptr(), t_prime.data_ptr(),
            bias.data_ptr(), b, n, d, int(pos_offset), partials.data_ptr(), out.data_ptr(),
            _stream(zimg.device),
        )
    _raise(lib, "sigmoid_loss_fwd_int8", err)
    _count("fwd_int8")
    return out


def _launch_bwd_img_int8(zimg, ztxt, t_prime, bias, pos_offset: int, g, quantized):
    """K5 in the int8 mode on checked f32 tensors and their quantized rows
    (:func:`_int8_operands`) → ``(dzimg, dt′, dbias)``."""
    (b, d), n = zimg.shape, ztxt.shape[0]
    dzimg = torch.empty((b, d), dtype=torch.float32, device=zimg.device)
    out2 = torch.empty(2, dtype=torch.float32, device=zimg.device)
    lib = _library()
    with torch.cuda.device(zimg.device):
        scratch = torch.empty(lib.sigmoid_loss_bwd_scratch_floats(b, n, d, 1),
                              dtype=torch.float32, device=zimg.device)
        err = lib.sigmoid_loss_bwd_img_int8(
            *(t.data_ptr() for t in quantized), ztxt.data_ptr(), t_prime.data_ptr(),
            bias.data_ptr(), g.data_ptr(), b, n, d, int(pos_offset), _vec(ztxt, dzimg),
            dzimg.data_ptr(), scratch.data_ptr(), out2.data_ptr(), _stream(zimg.device),
        )
    _raise(lib, "sigmoid_loss_bwd_img_int8", err)
    _count("bwd_img_int8")
    return dzimg, out2[0], out2[1]


def _launch_bwd_txt_int8(zimg, ztxt, t_prime, bias, pos_offset: int, g, quantized):
    """K6 in the int8 mode on checked f32 tensors and their quantized rows
    → dztxt."""
    (b, d), n = zimg.shape, ztxt.shape[0]
    dztxt = torch.empty((n, d), dtype=torch.float32, device=zimg.device)
    lib = _library()
    with torch.cuda.device(zimg.device):
        scratch = torch.empty(lib.sigmoid_loss_bwd_scratch_floats(n, b, d, 0),
                              dtype=torch.float32, device=zimg.device)
        err = lib.sigmoid_loss_bwd_txt_int8(
            *(t.data_ptr() for t in quantized), zimg.data_ptr(), t_prime.data_ptr(),
            bias.data_ptr(), g.data_ptr(), b, n, d, int(pos_offset), _vec(zimg, dztxt),
            dztxt.data_ptr(), scratch.data_ptr(), _stream(zimg.device),
        )
    _raise(lib, "sigmoid_loss_bwd_txt_int8", err)
    _count("bwd_txt_int8")
    return dztxt


def _launch_bwd_int8(zimg, ztxt, t_prime, bias, pos_offset: int, g):
    """K5 then K6 in the int8 mode, sharing one quantization of the rows:
    ``(dzimg, dt′, dbias, dztxt)`` in f32."""
    zimg, ztxt, t_prime, bias, g = _cuda_args("streaming_loss_bwd_int8", zimg, ztxt,
                                              t_prime, bias, g)
    quantized = _int8_operands("streaming_loss_bwd_int8", zimg, ztxt)
    dzimg, dtp, dbias = _launch_bwd_img_int8(zimg, ztxt, t_prime, bias, pos_offset, g, quantized)
    return dzimg, dtp, dbias, _launch_bwd_txt_int8(zimg, ztxt, t_prime, bias, pos_offset, g,
                                                   quantized)


# The module attributes are looked up per call, so a caller may swap a plain
# version in for a kernel-vs-plain comparison on the card.
def _fwd(zimg, ztxt, t_prime, bias, pos_offset, quant=""):
    if zimg.device.type == "cpu":
        return streaming_loss_fwd_plain(zimg, ztxt, t_prime, bias, pos_offset, quant)
    if quant:
        return _launch_fwd_int8(zimg, ztxt, t_prime, bias, pos_offset)
    return _launch_fwd(zimg, ztxt, t_prime, bias, pos_offset)


def _bwd(zimg, ztxt, t_prime, bias, pos_offset, g, quant=""):
    """K5 and K6 → ``(dzimg, dt′, dbias, dztxt)`` in f32."""
    if zimg.device.type == "cpu":
        dzimg, dtp, dbias = streaming_loss_bwd_img_plain(zimg, ztxt, t_prime, bias,
                                                         pos_offset, g, quant)
        dztxt = streaming_loss_bwd_txt_plain(zimg, ztxt, t_prime, bias, pos_offset, g, quant)
        return dzimg, dtp, dbias, dztxt
    if quant:
        return _launch_bwd_int8(zimg, ztxt, t_prime, bias, pos_offset, g)
    dzimg, dtp, dbias = _launch_bwd_img(zimg, ztxt, t_prime, bias, pos_offset, g)
    return dzimg, dtp, dbias, _launch_bwd_txt(zimg, ztxt, t_prime, bias, pos_offset, g)


@torch.library.custom_op("dsl_torch_port::streaming_loss_fwd", mutates_args=())
def _streaming_loss_fwd_op(zimg: torch.Tensor, ztxt: torch.Tensor, t_prime: torch.Tensor,
                           bias: torch.Tensor, pos_offset: int, quant: str) -> torch.Tensor:
    """K4 as a custom op (a fake version beside it), so ``torch.export``
    records it and an artifact's replay launches it."""
    return _fwd(zimg, ztxt, t_prime, bias, pos_offset, quant).float()


@_streaming_loss_fwd_op.register_fake
def _(zimg, ztxt, t_prime, bias, pos_offset, quant):
    return zimg.new_empty((), dtype=torch.float32)


@torch.library.custom_op("dsl_torch_port::streaming_loss_bwd", mutates_args=())
def _streaming_loss_bwd_op(zimg: torch.Tensor, ztxt: torch.Tensor, t_prime: torch.Tensor,
                           bias: torch.Tensor, pos_offset: int, g: torch.Tensor, quant: str
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 then K6 as one custom op → ``(dzimg, dztxt, [dt′, dbias])``, f32."""
    dzimg, dtp, dbias, dztxt = _bwd(zimg, ztxt, t_prime, bias, pos_offset, g, quant)
    return (dzimg.float().contiguous(), dztxt.float().contiguous(),
            torch.stack([dtp.reshape(()), dbias.reshape(())]).float())


@_streaming_loss_bwd_op.register_fake
def _(zimg, ztxt, t_prime, bias, pos_offset, g, quant):
    return (zimg.new_empty(zimg.shape, dtype=torch.float32),
            ztxt.new_empty(ztxt.shape, dtype=torch.float32),
            zimg.new_empty((2,), dtype=torch.float32))


class StreamingBlockLossSum(torch.autograd.Function):
    """K4 forward, K5 then K6 backward, as one autograd node, in f32 or the
    int8 mode. The forward saves only the embeddings and the scalars, as the
    JAX ``custom_vjp`` does; the backward recomputes the logits from them.
    Both launch the kernels directly, and through their custom ops only
    while ``torch.export`` traces them or their tensors are fake
    (``_cuda.take_op``; the op's dispatch is host time an eager step need
    not pay)."""

    @staticmethod
    def forward(ctx, zimg, ztxt, t_prime, bias, pos_offset: int, quant: str = ""):
        ctx.save_for_backward(zimg, ztxt, t_prime, bias)
        ctx.pos_offset, ctx.quant = pos_offset, quant
        if _cuda.take_op(zimg):
            return _streaming_loss_fwd_op(zimg, ztxt, t_prime, bias, pos_offset, quant)
        return _fwd(zimg, ztxt, t_prime, bias, pos_offset, quant)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        zimg, ztxt, t_prime, bias = ctx.saved_tensors
        if _cuda.take_op(zimg):
            dzimg, dztxt, dscalars = _streaming_loss_bwd_op(zimg, ztxt, t_prime, bias,
                                                            ctx.pos_offset, g, ctx.quant)
            dtp, dbias = dscalars[0], dscalars[1]
        else:
            dzimg, dtp, dbias, dztxt = _bwd(zimg, ztxt, t_prime, bias, ctx.pos_offset, g,
                                            ctx.quant)
        return (
            dzimg.to(zimg.dtype),
            dztxt.to(ztxt.dtype),
            dtp.reshape(t_prime.shape).to(t_prime.dtype),
            dbias.reshape(bias.shape).to(bias.dtype),
            None,
            None,
        )


def _check_quant(quant: str) -> None:
    if quant not in ("", "int8"):
        raise ValueError(f"unknown loss quant: {quant!r}")


def streaming_block_loss_sum(zimg, ztxt, t_prime, bias, pos_offset: int = 0, quant: str = ""):
    """SUM of ``-log_sigmoid(labels · (exp(t_prime)·raw + bias))`` over the
    (b × n) block, positives on ``col == row + pos_offset`` (pass
    :data:`NEGATIVE_ONLY_OFFSET` for an all-negatives block), as an f32 0-d
    tensor; ``raw`` is the f32 product of the f32-cast embeddings, or the
    int8 mode's (``quant="int8"``). Unnormalized: divide by the local batch
    outside. Differentiable in the embeddings, ``t_prime`` and ``bias`` (K5,
    K6). Takes any shape in f32; the int8 kernels take d % 16 == 0."""
    _check_quant(quant)
    return StreamingBlockLossSum.apply(zimg, ztxt, t_prime, bias, int(pos_offset), quant)


def streaming_block_loss_or_none(zimg, ztxt, t_prime, bias, pos_offset, *, quant: str = "",
                                 normalize: bool = True):
    """JAX's dispatch for the distributed variants: the streaming block loss
    when the block passes :func:`pallas_compatible` (recorded as
    ``"streaming"`` or ``"streaming_int8"``), else ``None`` (recorded as
    ``"xla"``) for the caller to compute its plain block at the loss's
    ``precision``. ``normalize=True`` returns the per-image-normalized block
    loss (the fused and ring call sites), ``normalize=False`` the raw block
    sum (what the chunk scan accumulates)."""
    _check_quant(quant)
    (b, d), n = zimg.shape, ztxt.shape[0]
    if not pallas_compatible(b, n, d, quant=bool(quant)):
        _TRACED_LOSS_KERNELS.add("xla")
        return None
    _TRACED_LOSS_KERNELS.add("streaming_int8" if quant else "streaming")
    total = streaming_block_loss_sum(zimg, ztxt, t_prime, bias, pos_offset, quant)
    return total / b if normalize else total
