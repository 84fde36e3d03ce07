"""The f32 attention kernels' split-f32 (3xTF32) design, on the CPU.

The CUDA kernels of ``csrc/attention_f32.cu`` run only on the card
(``chip_smoke.py`` holds them against the plain versions there). Here the
Python mirror of their shared-memory layout is held to the tables the source
states, and their numeric design is pinned by emulation, with the products
formed as the kernels form them on the tensor cores
(``attention_f32.split_f32_matmul``: each f32 operand split into two TF32
parts, three TF32 products summed in f32): the forward walking the keys in
the kernel's chunks with the online softmax and its (m, l) convention, and
the backward's five products from those statistics, at B/16's head, at K7's
length and at head dims 20 and 128, against the plain f32 versions and
against JAX's ``_short_attention_fwd`` / ``_short_attention_bwd`` in f32 in
the Pallas interpreter.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops.pallas_short_attention import (
    _short_attention_bwd,
    _short_attention_fwd,
)
from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa

SOURCE = Path(af.__file__).resolve().parents[1] / "csrc" / "attention_f32.cu"


def _stated_table(header: str) -> dict[int, tuple[int, ...]]:
    """The source header's table under the line that holds ``header``: dh →
    the row's other numbers, up to the first line that is not a row."""
    lines = SOURCE.read_text().splitlines()
    start = next(i for i, line in enumerate(lines) if header in line)
    table = {}
    for line in lines[start + 1:]:
        row = re.fullmatch(r"//\s+([\d,]+(?:\s+[\d,]+)+)\s*", line)
        if row is None:
            break
        dh, *rest = (int(x.replace(",", "")) for x in row.group(1).split())
        table[dh] = tuple(rest)
    return table


def _stated_layout() -> dict[int, tuple[int, ...]]:
    """The backward's table: dh → (dK/dV bytes, blocks, dQ bytes, blocks)."""
    return _stated_table("dK/dV bytes  blocks  dQ bytes  blocks")


def _stated_fwd_layout() -> dict[int, tuple[int, ...]]:
    """The forward's table: dh → (bytes, blocks at s <= 64: one warpgroup a
    block; bytes, blocks at s > 64: two)."""
    return _stated_table("forward bytes, s <= 64  blocks  s > 64  blocks")


@pytest.mark.parametrize("dh", [20, 64, 72, 128])
def test_fwd_smem_mirror_matches_the_layout_the_source_states(dh):
    short_bytes, short_blocks, nbytes, blocks = _stated_fwd_layout()[dh]
    for s in (1, 64):
        assert af.smem_bytes(dh, 0, s) == short_bytes
        assert af.blocks_per_sm_by_smem(dh, 0, s) == short_blocks
    for s in (65, 196, 1024, None):
        assert af.smem_bytes(dh, 0, s) == nbytes
        assert af.blocks_per_sm_by_smem(dh, 0, s) == blocks


@pytest.mark.parametrize("dh", [20, 64, 72, 128])
def test_smem_mirror_matches_the_layout_the_source_states(dh):
    dkv, dkv_blocks, dq, dq_blocks = _stated_layout()[dh]
    assert af.smem_bytes(dh, 1) == dkv
    assert af.smem_bytes(dh, 2) == dq
    assert af.blocks_per_sm_by_smem(dh, 1) == dkv_blocks
    assert af.blocks_per_sm_by_smem(dh, 2) == dq_blocks


@pytest.mark.parametrize("which", [0, 1, 2])
def test_every_head_dim_fits_one_block(which):
    for dh in range(1, af.MAX_HEAD_DIM + 1):
        assert af.smem_bytes(dh, which) <= sa.SMEM_BUDGET_BYTES, (dh, which)
    # Three blocks an SM at the B/16 head (dh = 64), one at dh = 128.
    if which:
        assert af.blocks_per_sm_by_smem(64, which) >= 3
        assert af.blocks_per_sm_by_smem(128, which) >= 1


def test_copy_width():
    t = torch.zeros(64 * 5)
    assert af.bwd_vec(64, t, t)
    assert not af.bwd_vec(18, t, t)  # rows of 72 bytes are not 16-byte aligned
    assert not af.bwd_vec(64, t, t[1:])  # a misaligned tensor


def test_tf32_round_is_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32 keeps 10 explicit significand bits
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 0.0, -0.0, float("inf")], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 0.0, -0.0,
                         float("inf")], dtype=torch.float32)
    got = af.tf32_round(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    r = af.tf32_round(torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                                       .astype(np.float32)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


def test_split_recovers_f32_to_22_bits():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    hi = af.tf32_round(x)
    lo = af.tf32_round(x - hi)
    # x - hi is exact in f32; rounding it to TF32 costs at most 2^-11 of it,
    # and |x - hi| <= 2^-11 |x|.
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def test_split_keeps_a_nan():
    """The card's NaN (0x7FFFFFFF) rounds to −0 by the bits alone (the
    carry reaches the sign); the split products keep it a NaN, as an f32
    product does, so a NaN embedding gives a NaN loss through K4–K6."""
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
    assert torch.equal(af.tf32_round(nan).view(torch.int32),
                       torch.tensor([-2 ** 31], dtype=torch.int32))
    a = torch.ones(2, 4)
    a[0, 1] = nan[0]
    b = torch.ones(4, 3)
    for terms in (1, 3):
        got = af.split_f32_matmul(a, b, terms=terms)
        assert torch.isnan(got[0]).all() and torch.equal(got[1], torch.full((3,), 4.0))


def _emulated_fwd(q, k, v, causal, terms):
    """The forward as the card's kernel forms it: per block of
    ``64 * fwd_groups(s)`` query rows, the keys it sees (causal: up to its last
    row) in chunks of ``fwd_keys(dh)`` (a last chunk runs at 16 or 32 keys
    where no more are live; the width does not change the sums), x = q·kᵀ
    and oc = p·v in split f32 (``terms`` 3) or plain TF32
    (1), the online softmax: x·scale masked to −inf, m the running max,
    p = exp(x·scale − m), o = o·alpha + oc, l = l·alpha + Σ p, out = o·(1/l).
    (b, s, h, dh) f32 → (out, stats (b, h, 2, s) = (m, l))."""
    b, s, h, dh = q.shape
    scale = dh ** -0.5
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    rows = torch.arange(s)
    out = torch.empty(b, h, s, dh)
    m_all, l_all = torch.empty(b, h, s), torch.empty(b, h, s)
    step = 64 * af.fwd_groups(s)
    for q0 in range(0, s, step):
        qb, rb = qh[:, :, q0:q0 + step], rows[q0:q0 + step]
        kend = min(s, q0 + step) if causal else s
        keys = af.fwd_keys(dh)
        chunks = -(-kend // keys)
        m = torch.full((b, h, len(rb), 1), float("-inf"))
        l = torch.zeros((b, h, len(rb), 1))
        o = torch.zeros((b, h, len(rb), dh))
        for j in range(chunks):
            k0 = j * keys
            k1 = min(s, k0 + keys)
            x = af.split_f32_matmul(qb.contiguous(), kh[:, :, k0:k1].transpose(-1, -2)
                                    .contiguous(), terms) * scale
            if causal:
                x = x.masked_fill(torch.arange(k0, k1)[None, :] > rb[:, None], float("-inf"))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            mu = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
            alpha = torch.exp(m - mu)
            p = torch.exp(x - mu)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + af.split_f32_matmul(p.contiguous(), vh[:, :, k0:k1].contiguous(),
                                                terms)
            m = m_new
        out[:, :, q0:q0 + step] = o * torch.where(l > 0, 1.0 / l, torch.zeros(()))
        m_all[:, :, q0:q0 + step], l_all[:, :, q0:q0 + step] = m[..., 0], l[..., 0]
    return out.permute(0, 2, 1, 3).contiguous(), torch.stack([m_all, l_all], dim=2)


def _emulated_bwd(q, k, v, do, causal, terms, fwd=None):
    """The backward as the card's kernels form it: (out, m, l) from the f32
    forward (``fwd``: an ``(out, stats)`` pair, else the f32 plain
    version's), di = rowsum(out ⊙ do), then the five products in split f32
    (``terms`` 3) or plain TF32 (1), p = exp(x·scale − m)·(1/l) masked to 0,
    ds = p·(dp − di)·scale. (b, s, h, dh) f32 → (dq, dk, dv)."""
    b, s, h, dh = q.shape
    scale = dh ** -0.5
    out, stats = fwd if fwd is not None else fa.flash_self_attention_plain(
        q, k, v, causal, scale, fa.BLOCK_K)
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    m, inv_l = stats[:, :, 0, :, None], 1.0 / stats[:, :, 1, :, None]
    di = (out * do).sum(-1).permute(0, 2, 1)[..., None]

    def mm(a, c):
        return af.split_f32_matmul(a.contiguous(), c.contiguous(), terms)

    x = mm(qh, kh.transpose(-1, -2))
    live = torch.ones(s, s, dtype=torch.bool)
    if causal:
        live = torch.tril(live)
    p = torch.where(live, torch.exp(x * scale - m) * inv_l, torch.zeros(()))
    dp = mm(doh, vh.transpose(-1, -2))
    ds = p * (dp - di) * scale
    dv, dk, dq = mm(p.transpose(-1, -2), doh), mm(ds.transpose(-1, -2), qh), mm(ds, kh)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _err_of_max(got, ref):
    return [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]


# (b, s, h, dh): B/16's head (s = 196: three full 64-row tiles and a ragged
# fourth) and K7's length (s = 1,024 at the B/16-512 shape).
CASES = [((2, 196, 2, 64), False), ((2, 196, 2, 64), True), ((1, 1024, 1, 64), False)]
# Split f32 against the f32 plain version: a tenth of the kernels' contract
# (1e-4 of the largest magnitude). What split f32 drops is ~2^-22 (2.4e-7) of
# each product term; with f32 sums in other orders the error stays near 1e-6
# of the largest magnitude.
SPLIT_VS_PLAIN = 1e-5
# Against JAX's f32 kernel in the Pallas interpreter: the contract itself.
SPLIT_VS_JAX = 1e-4


@pytest.mark.parametrize("shape,causal", CASES)
def test_split_f32_backward_matches_plain_f32(shape, causal):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape, 0))
    ref = sa.short_self_attention_bwd_plain(q, k, v, do, causal)
    got = _emulated_bwd(q, k, v, do, causal, terms=3)
    errs = _err_of_max(got, ref)
    # For the record: plain TF32 (one product) at the same inputs.
    errs_1x = _err_of_max(_emulated_bwd(q, k, v, do, causal, terms=1), ref)
    print(f"\nsplit-f32 backward {shape} causal={causal}: (dq, dk, dv) error of the "
          f"largest magnitude, 3xTF32 {errs}, 1xTF32 {errs_1x}")
    for name, e in zip(("dq", "dk", "dv"), errs):
        assert e <= SPLIT_VS_PLAIN, (name, e)


@pytest.mark.parametrize("shape,causal", CASES)
def test_split_f32_backward_matches_jax_f32_kernel(shape, causal):
    q, k, v, do = _inputs(shape, 0)
    ref = _short_attention_bwd(causal, None, True, False,
                               tuple(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(do))
    ref = [torch.from_numpy(np.array(x)) for x in ref]
    got = _emulated_bwd(*(torch.from_numpy(x) for x in (q, k, v, do)), causal, terms=3)
    for name, e in zip(("dq", "dk", "dv"), _err_of_max(got, ref)):
        assert e <= SPLIT_VS_JAX, (name, e)


# The forward's cases: the backward's, and head dims 20 (one 32-column
# panel, causal and ragged) and 128 (four panels).
FWD_CASES = CASES + [((2, 50, 3, 20), True), ((1, 196, 2, 128), False)]


@pytest.mark.parametrize("shape,causal", FWD_CASES)
def test_split_f32_forward_matches_plain_f32(shape, causal):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(shape, 0))
    scale = shape[-1] ** -0.5
    out, stats = _emulated_fwd(q, k, v, causal, terms=3)
    ref = sa.short_self_attention_plain(q, k, v, causal)
    ref7, ref_stats = fa.flash_self_attention_plain(q, k, v, causal, scale)
    err, err7 = _err_of_max([out, out], [ref, ref7])
    err_1x = _err_of_max([_emulated_fwd(q, k, v, causal, terms=1)[0]], [ref])[0]
    print(f"\nsplit-f32 forward {shape} causal={causal}: out error of the largest magnitude, "
          f"3xTF32 {err} (K7's plain version {err7}), 1xTF32 {err_1x}")
    assert err <= SPLIT_VS_PLAIN and err7 <= SPLIT_VS_PLAIN
    # The statistics the backward reads: the row max of the scaled logits
    # and the row sum of exp(x·scale − m).
    assert torch.allclose(stats[:, :, 0], ref_stats[:, :, 0], rtol=0, atol=1e-5)
    assert torch.allclose(stats[:, :, 1], ref_stats[:, :, 1], rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape,causal", FWD_CASES)
def test_split_f32_forward_matches_jax_f32_kernel(shape, causal):
    q, k, v, _ = _inputs(shape, 0)
    ref, _ = _short_attention_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, None, True)
    out, _ = _emulated_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal, terms=3)
    err = _err_of_max([out], [torch.from_numpy(np.array(ref))])[0]
    assert err <= SPLIT_VS_JAX, err


@pytest.mark.parametrize("shape,causal", CASES)
def test_split_f32_backward_from_the_forwards_statistics(shape, causal):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape, 0))
    ref = sa.short_self_attention_bwd_plain(q, k, v, do, causal)
    fwd = _emulated_fwd(q, k, v, causal, terms=3)
    for name, e in zip(("dq", "dk", "dv"),
                       _err_of_max(_emulated_bwd(q, k, v, do, causal, 3, fwd), ref)):
        assert e <= SPLIT_VS_PLAIN, (name, e)
