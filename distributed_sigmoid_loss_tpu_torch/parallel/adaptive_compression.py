"""Adaptive per-tensor dcn compression with a bandwidth-aware bit controller,
ported from the JAX package's ``parallel/adaptive_compression.py``.

``parallel/compression.py`` fixes one scheme for every tensor (int8 or
top-k). Here the scheme is a per-tensor choice from a ladder of wire
formats, made again every sync round: int8, packed int4, sign and norm
(1-bit SGD), top-k at two fractions, and a learned linear autoencoder whose
weights are trained on the host. The split follows JAX's:

- On the device (:func:`adaptive_axis_mean`): each tensor's rung, picked by
  the int32 table, compresses it; one all-gather per payload dtype (int8,
  uint8, f32, int32) carries every tensor's payload over the dcn group, and
  each member decompresses and averages. JAX traces all six branches into
  a ``lax.switch`` per tensor; the port reads the table on the host and
  runs the chosen branch. Every member must hold the same table, or the
  gathered buffers differ in size (the train command broadcasts world rank
  0's decision, ``train.compressed_step.adopt_rank0_decision``).
- On the host (:class:`BitController`, :class:`CodecTrainer`): numpy only,
  copied from JAX with their arithmetic unchanged. The controller folds
  timed rounds into a bandwidth EWMA and narrows tensors until the
  estimated egress fits the budget; the trainer re-solves the learned
  rung's codec from the step's block moments.

Error feedback is required: the sign and top-k rungs are pure bias without
the residual carry. ``dcn_wire_bytes`` is one member's dcn egress a round,
``(n_dcn − 1) · Σ payload(scheme_i)``. Plain PyTorch: the JAX package
computes all of it outside any Pallas kernel.

Rounding follows JAX's: ``round`` half to even, int4 clipped to ±7, the
variance with ddof 0, sign1's scale ``mean(|x|)`` with bits ``x >= 0``, and
every divisor a 0-d tensor on the operand's device (CUDA divides by a
Python number through its reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.compression import (
    _EPS,
    _gather,
    dequantize_tensor_int8,
    densify_topk,
    quantize_tensor_int8,
    sparsify_topk,
    topk_count,
    topk_payload_mean,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_size, dcn_axis

__all__ = [
    "SCHEME_INT8",
    "SCHEME_INT4",
    "SCHEME_SIGN1",
    "SCHEME_TOPK",
    "SCHEME_TOPK_LOW",
    "SCHEME_LEARNED",
    "N_SCHEMES",
    "SCHEME_NAMES",
    "SCHEME_DISTORTION",
    "CODEC_BLOCK",
    "CODEC_LATENT",
    "CODEC_GROUPS",
    "quantize_tensor_int4",
    "pack_int4",
    "unpack_int4",
    "pack_signs",
    "unpack_signs",
    "codec_group",
    "dct_matrix",
    "default_codec",
    "payload_bytes_table",
    "table_payload_bytes",
    "leaf_sizes",
    "codec_blocks",
    "adaptive_axis_mean",
    "CodecTrainer",
    "BitController",
]

# Scheme codes: the int32 values of the controller's per-tensor table, in
# the nominal wide → narrow order at topk_frac = 1%.
SCHEME_INT8 = 0      # 1 B/param + one f32 scale
SCHEME_INT4 = 1      # 0.5 B/param packed nibbles + scale
SCHEME_SIGN1 = 2     # 1 bit/param + mean-|g| scale (1-bit SGD)
SCHEME_TOPK = 3      # 8 B per kept entry at topk_frac
SCHEME_TOPK_LOW = 4  # top-k at topk_frac / 4
SCHEME_LEARNED = 5   # learned linear autoencoder latents as int8
N_SCHEMES = 6
SCHEME_NAMES = ("int8", "int4", "sign1", "topk", "topk_low", "learned")

# Nominal relative squared reconstruction error of each rung (the budgeted
# controller's distortion prior), indexed by scheme code (JAX's values).
SCHEME_DISTORTION = (1e-4, 4e-3, 0.45, 0.80, 0.95, 0.08)

# The learned rung: blocks of CODEC_BLOCK consecutive values, each encoded
# to CODEC_LATENT latents; one codec per group (0: ndim >= 2, 1: the rest).
CODEC_BLOCK = 64
CODEC_LATENT = 16
CODEC_GROUPS = 2

_Q4MAX = 7.0
_QMAX = 127.0


def _full(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=x.device)


def quantize_tensor_int4(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int4: ``(q, scale)``, q in [-7, 7] as int8 and
    the scale ``max(max|t|, 1e-12) / 7`` in f32, as JAX computes them."""
    x = t.float()
    scale = torch.clamp(x.abs().max(), min=_EPS) / _full(x, _Q4MAX)
    q = torch.clamp(torch.round(x / scale), -_Q4MAX, _Q4MAX).to(torch.int8)
    return q, scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] two to a byte: flat int8[ceil(n/2)], the even
    index in the low nibble, the odd one in the high (two's complement; an
    odd size pads one zero nibble). Bitwise JAX's."""
    flat = q.reshape(-1).to(torch.int32)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.reshape(-1, 2)
    packed = (pairs[:, 0] & 0x0F) | ((pairs[:, 1] & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor, size: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4` over the last dim: (..., m) packed →
    (..., size) int8 values in [-7, 7]."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    hi = p >> 4
    return torch.stack([lo, hi], dim=-1).flatten(-2)[..., :size].to(torch.int8)


_BIT_WEIGHTS = 1 << np.arange(8)


def pack_signs(t: torch.Tensor) -> torch.Tensor:
    """Sign bits of ``t`` eight to a byte: flat uint8[ceil(n/8)], bit k of
    byte j set where ``t.ravel()[8j + k] >= 0``."""
    bits = (t.reshape(-1) >= 0).to(torch.int32)
    pad = (-bits.numel()) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    weights = torch.as_tensor(_BIT_WEIGHTS, dtype=torch.int32, device=t.device)
    return (bits.reshape(-1, 8) * weights).sum(dim=-1).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, size: int) -> torch.Tensor:
    """Inverse of :func:`pack_signs` over the last dim: (..., m) → (...,
    size) f32 of ±1."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    flat = bits.flatten(-2)[..., :size]
    return 2.0 * flat.float() - 1.0


def payload_bytes_table(size: int, topk_frac: float = 0.01) -> np.ndarray:
    """One member's wire payload in bytes under each scheme, for a tensor of
    ``size`` entries: int64[N_SCHEMES] (JAX's table: scales 4 B, a top-k
    entry 8 B, the learned rung CODEC_LATENT int8 latents a block plus one
    scale)."""
    n_blocks = (size + CODEC_BLOCK - 1) // CODEC_BLOCK
    return np.array(
        [
            size + 4,
            (size + 1) // 2 + 4,
            (size + 7) // 8 + 4,
            8 * topk_count(size, topk_frac),
            8 * topk_count(size, topk_frac / 4.0),
            CODEC_LATENT * n_blocks + 4,
        ],
        dtype=np.int64,
    )


def table_payload_bytes(sizes, scheme, topk_frac: float = 0.01) -> int:
    """One member's payload in bytes for tensors of ``sizes`` on the rungs of
    ``scheme`` (codes clipped to [0, N_SCHEMES)): the controller's cost
    model, and ``dcn_wire_bytes`` / (n_dcn − 1)."""
    codes = np.clip(np.asarray(scheme, dtype=np.int64).reshape(-1), 0, N_SCHEMES - 1)
    return sum(int(payload_bytes_table(s, topk_frac)[c]) for s, c in zip(sizes, codes))


def codec_group(shape) -> int:
    """Codec group of a tensor shape: 0 for matrices (ndim >= 2), 1 for
    vectors and scalars."""
    return 0 if len(shape) >= 2 else 1


def dct_matrix(block: int = CODEC_BLOCK) -> np.ndarray:
    """Orthonormal DCT-II basis, f32[block, block] (rows are the basis
    vectors): the codec's cold start."""
    k = np.arange(block, dtype=np.float64)
    basis = np.cos(np.pi * (2.0 * k[None, :] + 1.0) * k[:, None] / (2 * block))
    basis[0] *= 1.0 / np.sqrt(2.0)
    return (basis * np.sqrt(2.0 / block)).astype(np.float32)


def default_codec(latent: int = CODEC_LATENT) -> dict:
    """Cold-start codec weights ``{"enc": f32[G, B, L], "dec": f32[G, L,
    B]}``: the first ``latent`` DCT rows and their transpose, both groups
    alike."""
    rows = dct_matrix()[:latent]
    enc = np.repeat(rows.T[None], CODEC_GROUPS, axis=0)
    dec = np.repeat(rows[None], CODEC_GROUPS, axis=0)
    return {"enc": enc.copy(), "dec": dec.copy()}


def leaf_sizes(tensors) -> list:
    """Entries of each tensor (or shape), in the order the scheme table
    indexes them (a 0-d tensor counts 1)."""
    sizes = []
    for t in tensors:
        shape = tuple(getattr(t, "shape", t))
        sizes.append(int(np.prod(shape)) if shape else 1)
    return sizes


def codec_blocks(target: torch.Tensor) -> torch.Tensor:
    """``target`` flattened in its own element order and zero-padded into
    ``(n_blocks, CODEC_BLOCK)`` f32: the learned rung's and the block
    moment's view."""
    x = target.float().reshape(-1)
    pad = (-x.numel()) % CODEC_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, CODEC_BLOCK)


class _Wire:
    """The round's payload, one flat buffer per dtype: each tensor's parts
    appended in table order, gathered once per dtype over the group."""

    DTYPES = (torch.int8, torch.uint8, torch.float32, torch.int32)

    def __init__(self):
        self.parts = {d: [] for d in self.DTYPES}
        self.sizes = {d: 0 for d in self.DTYPES}

    def put(self, x: torch.Tensor) -> tuple[torch.dtype, int, int]:
        x = x.reshape(-1)
        where = (x.dtype, self.sizes[x.dtype], x.numel())
        self.parts[x.dtype].append(x)
        self.sizes[x.dtype] += x.numel()
        return where

    def gather(self, group) -> dict:
        out = {}
        for d, parts in self.parts.items():
            if parts:
                out[d] = _gather(torch.cat(parts), group)
        return out


def _encode(target: torch.Tensor, scheme: int, wire: _Wire, topk_frac: float, enc, dec):
    """This member's half of ``scheme`` on one tensor: its payload parts put
    on the wire (their places returned) and ``sent``, what the others will
    decode from them (for the residual)."""
    size = target.numel()
    if scheme == SCHEME_INT8:
        q, s = quantize_tensor_int8(target)
        return (wire.put(q), wire.put(s)), dequantize_tensor_int8(q, s)
    if scheme == SCHEME_INT4:
        q, s = quantize_tensor_int4(target)
        return (wire.put(pack_int4(q)), wire.put(s)), q.float() * s
    if scheme == SCHEME_SIGN1:
        x = target.float()
        scale = x.abs().mean()
        packed = pack_signs(x)
        sent = (unpack_signs(packed, size) * scale).reshape(target.shape)
        return (wire.put(packed), wire.put(scale)), sent
    if scheme in (SCHEME_TOPK, SCHEME_TOPK_LOW):
        frac = topk_frac if scheme == SCHEME_TOPK else topk_frac / 4.0
        vals, idx = sparsify_topk(target, topk_count(size, frac))
        sent = densify_topk(vals, idx, size).reshape(target.shape)
        return (wire.put(vals), wire.put(idx)), sent
    # SCHEME_LEARNED: encode blocks, int8 latents on the wire; the decode is
    # linear, so the members' mean is decoded once from the latents' mean.
    z = codec_blocks(target) @ enc
    scale = torch.clamp(z.abs().max(), min=_EPS) / _full(z, _QMAX)
    q = torch.clamp(torch.round(z / scale), -_QMAX, _QMAX).to(torch.int8)
    sent = ((q.float() * scale) @ dec).reshape(-1)[:size].reshape(target.shape)
    return (wire.put(q), wire.put(scale)), sent


def _decode_mean(gathered: dict, places, scheme: int, shape, n: int, dec) -> torch.Tensor:
    """The f32 mean of the n members' payloads of one tensor."""
    (d1, o1, l1), (d2, o2, l2) = places
    first, second = gathered[d1][:, o1:o1 + l1], gathered[d2][:, o2:o2 + l2]
    size = int(np.prod(shape)) if shape else 1
    if scheme == SCHEME_INT8:
        mean = (first.float() * second).sum(dim=0) / n
    elif scheme == SCHEME_INT4:
        mean = (unpack_int4(first, size).float() * second).sum(dim=0) / n
    elif scheme == SCHEME_SIGN1:
        mean = (unpack_signs(first, size) * second).sum(dim=0) / n
    elif scheme in (SCHEME_TOPK, SCHEME_TOPK_LOW):
        mean = topk_payload_mean(first, second, size)
    else:
        mean_z = (first.float().reshape(n, -1, CODEC_LATENT) * second.reshape(n, 1, 1)).sum(
            dim=0) / n
        mean = (mean_z @ dec).reshape(-1)[:size]
    return mean.reshape(shape)


@torch.no_grad()
def adaptive_axis_mean(tensors, axis_name: str = dcn_axis, ef=None, scheme=None, *,
                       topk_frac: float = 0.01, codec=None, group=None):
    """Mean of ``tensors`` over ``axis_name`` with a per-tensor adaptive
    wire; every rank of the axis calls it with its own contribution and
    residuals.

    ``ef``: this member's residuals (same shapes, f32); required.
    ``scheme``: the int32 table, one code per tensor (codes outside [0, 6)
    are clipped), the same on every member. ``codec``: the learned rung's
    weights, ``{"enc": f32[G, B, L], "dec": f32[G, L, B]}`` tensors on the
    tensors' device; None uses :func:`default_codec` and leaves out the
    codec's two stats.

    Returns ``(means, new_ef, stats, wire_bytes)``:

    - ``means`` in each tensor's dtype, the same on every member;
    - ``stats``: ``gnorm``, ``gvar`` and ``ef_ratio`` (f32[n_tensors], each
      tensor's gradient norm, variance and residual-to-gradient norm ratio
      before this round), and with a ``codec`` ``blockmoment`` (f32[G, B,
      B], each group's second moment of the compression targets' blocks)
      and ``codec_recon_err`` (0-d, the mean relative reconstruction error
      of the tensors on the learned rung, 0 when none are): all averaged
      over the axis in one all-reduce;
    - ``wire_bytes``: one member's egress this round (a Python float, the
      controller's own cost model).
    """
    if ef is None:
        raise ValueError(
            "adaptive compression requires error feedback (the sign/topk "
            "rungs are pure bias without it); create the state with "
            "with_adaptive_compression(state)"
        )
    group = axis_group(axis_name, group)
    n = axis_size(group)
    tensors = list(tensors)
    if not tensors:
        raise ValueError("adaptive_axis_mean needs at least one tensor")
    device = tensors[0].device
    table = np.clip(np.asarray(scheme, dtype=np.int64).reshape(-1), 0, N_SCHEMES - 1)
    if table.size != len(tensors):
        raise ValueError(f"scheme table has {table.size} entries for {len(tensors)} tensors")
    live_codec = codec is not None
    if not live_codec:
        codec = {k: torch.as_tensor(v, device=device) for k, v in default_codec().items()}
    enc, dec = codec["enc"], codec["dec"]

    g32s = [t.float() for t in tensors]
    res = [e.float() for e in ef]
    gnorm = torch.stack(torch._foreach_norm(g32s))
    res_norm = torch.stack(torch._foreach_norm(res))
    gvar = torch.stack([torch.var(g, unbiased=False) if g.numel() else g.new_zeros(())
                        for g in g32s])
    ef_ratio = res_norm / (gnorm + _EPS)

    wire = _Wire()
    places, sent, targets = [], [], []
    moment = torch.zeros((CODEC_GROUPS, CODEC_BLOCK, CODEC_BLOCK), dtype=torch.float32,
                         device=device)
    block_count = [0] * CODEC_GROUPS
    recon = []
    for i, (g, r) in enumerate(zip(g32s, res)):
        target = g + r
        grp = codec_group(tensors[i].shape)
        p, s = _encode(target, int(table[i]), wire, topk_frac, enc[grp], dec[grp])
        places.append(p)
        sent.append(s)
        targets.append(target)
        if live_codec:
            blocks = codec_blocks(target)
            moment[grp] += blocks.T @ blocks
            block_count[grp] += blocks.shape[0]
            if table[i] == SCHEME_LEARNED:
                recon.append(torch.linalg.vector_norm(target - s)
                             / (torch.linalg.vector_norm(target) + _EPS))
    gathered = wire.gather(group)
    means = [_decode_mean(gathered, p, int(table[i]), tuple(t.shape), n,
                          dec[codec_group(t.shape)]).to(t.dtype)
             for i, (t, p) in enumerate(zip(tensors, places))]
    new_ef = [tgt - s for tgt, s in zip(targets, sent)]

    # The controller's inputs, averaged over the axis in one all-reduce.
    parts = [gnorm, gvar, ef_ratio]
    if live_codec:
        for grp in range(CODEC_GROUPS):
            moment[grp] /= max(block_count[grp], 1)
        on_learned = float(np.sum(table == SCHEME_LEARNED))
        recon_sum = torch.stack(recon).sum() if recon else moment.new_zeros(())
        parts += [moment.reshape(-1), (recon_sum / max(on_learned, 1.0)).reshape(1)]
    flat = torch.cat(parts)
    if n > 1:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= n
    k = len(tensors)
    stats = {"gnorm": flat[:k], "gvar": flat[k:2 * k], "ef_ratio": flat[2 * k:3 * k]}
    if live_codec:
        m = CODEC_GROUPS * CODEC_BLOCK * CODEC_BLOCK
        stats["blockmoment"] = flat[3 * k:3 * k + m].reshape(CODEC_GROUPS, CODEC_BLOCK,
                                                            CODEC_BLOCK)
        stats["codec_recon_err"] = flat[3 * k + m]
    payload = table_payload_bytes(leaf_sizes(tensors), table, topk_frac)
    return means, new_ef, stats, float((n - 1) * payload)


class CodecTrainer:
    """Host-side online trainer of the learned rung's linear autoencoder
    (JAX's, numpy only, arithmetic unchanged): each round folds the step's
    ``blockmoment`` into a moment EWMA and, after ``warmup_rounds``
    observations, re-solves the optimal linear codec in closed form (the
    top-``latent`` eigenvectors of each group's block covariance, signs
    canonicalized so the largest component is positive). Cold start is the
    DCT basis (:func:`default_codec`); a non-finite moment is skipped."""

    def __init__(self, *, latent: int = CODEC_LATENT, alpha: float = 0.2,
                 warmup_rounds: int = 2):
        self.latent = int(latent)
        self.alpha = float(alpha)
        self.warmup_rounds = int(warmup_rounds)
        self.rounds = 0
        self.moment: np.ndarray | None = None       # (G, B, B) EWMA
        self._codec = default_codec(self.latent)

    def codec(self) -> dict:
        """Current weights: ``{"enc": f32[G, B, L], "dec": f32[G, L, B]}``."""
        return {k: v.copy() for k, v in self._codec.items()}

    def update(self, blockmoment) -> dict:
        """Fold one observed ``blockmoment`` (G, B, B) in; return the
        (possibly re-solved) codec weights."""
        m = np.asarray(blockmoment, dtype=np.float64)
        if m.shape != (CODEC_GROUPS, CODEC_BLOCK, CODEC_BLOCK):
            raise ValueError(
                "blockmoment must be "
                f"{(CODEC_GROUPS, CODEC_BLOCK, CODEC_BLOCK)}, got {m.shape}"
            )
        if not np.all(np.isfinite(m)):
            return self.codec()                      # skip poisoned rounds
        if self.moment is None:
            self.moment = m
        else:
            self.moment = self.alpha * m + (1.0 - self.alpha) * self.moment
        self.rounds += 1
        if self.rounds < self.warmup_rounds:
            return self.codec()
        enc = np.empty((CODEC_GROUPS, CODEC_BLOCK, self.latent), np.float32)
        dec = np.empty((CODEC_GROUPS, self.latent, CODEC_BLOCK), np.float32)
        for g in range(CODEC_GROUPS):
            sym = 0.5 * (self.moment[g] + self.moment[g].T)
            _, vecs = np.linalg.eigh(sym)            # ascending eigenvalues
            top = vecs[:, ::-1][:, : self.latent]    # (B, L), descending
            flip = np.sign(top[np.abs(top).argmax(axis=0),
                               np.arange(self.latent)])
            top = top * np.where(flip == 0, 1.0, flip)
            enc[g] = top.astype(np.float32)
            dec[g] = top.T.astype(np.float32)
        self._codec = {"enc": enc, "dec": dec}
        return self.codec()


class BitController:
    """Host-side per-tensor scheme selection under a bandwidth budget (JAX's,
    numpy only, arithmetic unchanged).

    Each sync round the training loop calls :meth:`observe` with the timed
    round and its ``dcn_wire_bytes`` (the bandwidth EWMA), then
    :meth:`decide` with the step's per-tensor stats for the next table,
    recomputed from scratch so tensors widen again when bandwidth recovers.

    - ``"greedy"``: every tensor starts at its widest rung (the ladder is
      each tensor's ``payload_bytes_table`` sorted descending); while the
      estimated egress ``(n_dcn − 1) · Σ payload`` exceeds ``min(bw_est,
      dcn_budget_mbps) · sync_budget_s``, narrow the not-yet-narrowest tensor
      with the lowest residual-to-gradient ratio one rung (ties: lowest
      index).
    - ``"budgeted"``: each candidate narrowing scored by estimated added
      error per byte saved, ``(D[next] − D[cur]) · gnorm² · (1 + ef_ratio)``
      over the bytes it saves (``D`` = :data:`SCHEME_DISTORTION`); while over
      budget, take the cheapest (ties: lowest index). ``last_error_budget``
      is the spent share.

    ``learned=True`` adds the learned rung to every ladder.
    ``override_bandwidth`` pins the EWMA (tests and drills).
    """

    def __init__(self, sizes, *, n_dcn: int, topk_frac: float = 0.01,
                 dcn_budget_mbps: float | None = None, alpha: float = 0.3,
                 sync_budget_s: float = 0.1, controller: str = "greedy",
                 learned: bool = False):
        if n_dcn < 2:
            raise ValueError(f"BitController needs n_dcn >= 2, got {n_dcn}")
        if controller not in ("greedy", "budgeted"):
            raise ValueError(
                f"controller must be 'greedy' or 'budgeted', got {controller!r}"
            )
        self.sizes = [int(s) for s in sizes]
        self.n_dcn = int(n_dcn)
        self.topk_frac = float(topk_frac)
        self.dcn_budget_mbps = (
            None if dcn_budget_mbps is None else float(dcn_budget_mbps)
        )
        self.alpha = float(alpha)
        self.sync_budget_s = float(sync_budget_s)
        self.mode = controller
        self.learned = bool(learned)
        self.last_error_budget = 0.0
        self.tables = np.stack(
            [payload_bytes_table(s, topk_frac) for s in self.sizes]
        )                                            # (n_tensors, N_SCHEMES)
        # Wide→narrow rung order per tensor, by actual payload bytes, over
        # the ALLOWED schemes only (learned rung gated by ``learned=``).
        cols = np.array(
            [c for c in range(N_SCHEMES)
             if self.learned or c != SCHEME_LEARNED],
            dtype=np.int64,
        )
        self.ladders = cols[
            np.argsort(-self.tables[:, cols], axis=1, kind="stable")
        ]                                            # (n_tensors, n_allowed)
        self.bw_est_mbps: float | None = None
        self._overridden = False
        self.scheme = self.ladders[:, 0].astype(np.int32)          # widest

    def observe(self, duration_s: float, wire_bytes: float) -> None:
        """Fold one timed sync round into the bandwidth EWMA."""
        if self._overridden or duration_s <= 0 or wire_bytes <= 0:
            return
        inst = float(wire_bytes) * 8.0 / float(duration_s) / 1e6
        if self.bw_est_mbps is None:
            self.bw_est_mbps = inst
        else:
            self.bw_est_mbps = (
                self.alpha * inst + (1.0 - self.alpha) * self.bw_est_mbps
            )

    def override_bandwidth(self, mbps: float | None) -> None:
        """Pin (or, with None, release) the bandwidth estimate — test hook."""
        self._overridden = mbps is not None
        self.bw_est_mbps = None if mbps is None else float(mbps)

    def bytes_allowed(self) -> float:
        caps = [
            c for c in (self.bw_est_mbps, self.dcn_budget_mbps)
            if c is not None
        ]
        if not caps:
            return float("inf")
        return min(caps) * 1e6 / 8.0 * self.sync_budget_s

    def _egress(self, rung: np.ndarray) -> int:
        payload = self.tables[
            np.arange(len(self.sizes)),
            self.ladders[np.arange(len(self.sizes)), rung],
        ]
        return int((self.n_dcn - 1) * payload.sum())

    def decide(self, ef_ratio=None, gnorm=None, gvar=None) -> np.ndarray:
        """Next per-tensor scheme table (int32[n_tensors]).

        ``gnorm``/``gvar`` feed the budgeted policy's loss-impact weights
        (ignored by greedy); omitted stats degrade to uniform weights, so
        the first round — before the step has emitted anything — is safe.
        """
        n = len(self.sizes)
        n_rungs = self.ladders.shape[1]
        ef_ratio = (
            np.zeros(n) if ef_ratio is None
            else np.asarray(ef_ratio, dtype=np.float64)
        )
        gnorm = (
            np.ones(n) if gnorm is None
            else np.asarray(gnorm, dtype=np.float64)
        )
        allowed = self.bytes_allowed()
        rung = np.zeros(n, dtype=np.int64)           # all-widest start
        dist_ = np.asarray(SCHEME_DISTORTION, dtype=np.float64)
        weight = np.square(gnorm) * (1.0 + ef_ratio)
        if not np.all(np.isfinite(weight)) or weight.sum() <= 0:
            weight = np.ones(n)
        if self.mode == "greedy":
            # Narrowing order: lowest EF ratio first, index as tie-break —
            # fixed for the round (the ratio measures the CURRENT schemes,
            # not the candidates, so re-sorting mid-descent would be noise,
            # not signal).
            order = sorted(range(n), key=lambda i: (ef_ratio[i], i))
            while self._egress(rung) > allowed:
                movable = [i for i in order if rung[i] < n_rungs - 1]
                if not movable:
                    break
                rung[movable[0]] += 1
        else:
            # Budgeted: knapsack greedy on estimated error per byte saved.
            while self._egress(rung) > allowed:
                best, best_key = -1, None
                for i in range(n):
                    if rung[i] >= n_rungs - 1:
                        continue
                    cur = self.ladders[i, rung[i]]
                    nxt = self.ladders[i, rung[i] + 1]
                    dbytes = (self.n_dcn - 1) * max(
                        int(self.tables[i, cur]) - int(self.tables[i, nxt]),
                        1,
                    )
                    derr = max(dist_[nxt] - dist_[cur], 0.0) * weight[i]
                    key = (derr / dbytes, i)
                    if best_key is None or key < best_key:
                        best, best_key = i, key
                if best < 0:
                    break
                rung[best] += 1
        self.scheme = self.ladders[np.arange(n), rung].astype(np.int32)
        spent = float(np.sum(dist_[self.scheme] * weight))
        self.last_error_budget = spent / float(weight.sum() + 1e-12)
        return self.scheme
