"""K3's warpgroup body (``csrc/short_attention_bwd_batched.cu``), on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version and against K2 there). Here the Python mirror of its
shape choice and shared-memory layout is held to the table the source
states, the in-place dispatch to the instantiations a shape reaches, and its
order of sums is pinned by emulation: per 64-row query tile, the logits, the
softmax as the producer forms it (exp2 with the max and 1/sum, p parked in
f32), dp, D and ds, dq from the tile, and dv and dk accumulated in f32 over
the query tiles from the tile's bf16(p) and ds. The emulation is held to
``short_self_attention_bwd_batched_plain`` and to JAX's
``_short_attention_bwd`` with ``batch_heads=True`` in the Pallas interpreter.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops.pallas_short_attention import _short_attention_bwd
from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa

SOURCE = Path(sa.__file__).resolve().parents[1] / "csrc" / "short_attention_bwd_batched.cu"
LOG2E = 1.4426950408889634


def _stated_layout() -> dict[int, tuple[int, int, int]]:
    """The source header's table: keys N → (warpgroups, bytes, blocks an SM)."""
    lines = SOURCE.read_text().splitlines()
    start = next(i for i, line in enumerate(lines) if "keys  warpgroups     bytes  blocks" in line)
    table = {}
    for line in lines[start + 1:]:
        row = re.fullmatch(r"//\s+([\d,]+(?:\s+[\d,]+)+)\s*", line)
        if row is None:
            break
        n, *rest = (int(x.replace(",", "")) for x in row.group(1).split())
        table[n] = tuple(rest)
    return table


@pytest.mark.parametrize("s,keys", [(50, 64), (64, 64), (77, 208), (196, 208), (200, 208),
                                    (212, 256), (225, 256), (250, 256)])
def test_body_and_smem_mirror_match_the_layout_the_source_states(s, keys):
    groups, nbytes, blocks = _stated_layout()[keys]
    assert sa.short_attention_bwd_batched_body(s, 64, 1) == 1
    assert sa.short_attention_bwd_batched_wgmma_smem_bytes(s) == nbytes
    assert nbytes <= sa.SMEM_BUDGET_BYTES
    assert af.SM_SMEM_BYTES // (nbytes + af.BLOCK_RESERVED_SMEM_BYTES) == blocks
    assert groups == (1 if keys == 64 else 3)


@pytest.mark.parametrize("s,dh,vec", [(208, 72, 1), (50, 20, 0), (240, 20, 0), (196, 64, 0),
                                      (250, 64, 0), (64, 32, 1), (257, 64, 1)])
def test_other_shapes_take_the_mma_sync_kernels(s, dh, vec):
    assert sa.short_attention_bwd_batched_body(s, dh, vec) == 0
    if s > 256:
        assert sa.short_attention_bwd_batched_wgmma_smem_bytes(s) == 0


@pytest.mark.parametrize("width,heads", [(768, 12), (1024, 16)])
def test_every_dh64_shape_k3_takes_has_the_warpgroup_body(width, heads):
    taken = [s for s in range(1, 300) if sa.short_attention_bwd_batched_fits(s, width, heads, 2)]
    assert taken[0] == 1 and taken[-1] == (250 if width == 768 else 212)
    assert all(sa.short_attention_bwd_batched_body(s, 64, 1) for s in taken)


def test_in_place_dispatch_lists_every_instantiation_a_shape_reaches():
    """The source instantiates the in-place kernel only at (key tiles, head-dim
    tiles) that some shape without the warpgroup body reaches; none is missing."""
    reached = set()
    for dh in range(1, sa.MAX_HEAD_DIM + 1):
        for s in range(1, 257):
            if sa._k3_variant(s, dh)[0] == 2:
                reached.add(((s + 15) // 16, 8 if (dh + 15) // 16 * 16 <= 64 else 16))
    text = SOURCE.read_text()
    listed = set()
    for macro, nt in re.findall(r"(SABB_IN(?:8|16)?)\((\d+), BODY\)", text):
        dts = {"SABB_IN8": (8,), "SABB_IN16": (16,), "SABB_IN": (8, 16)}[macro]
        listed |= {(int(nt), dt) for dt in dts}
    assert reached <= listed
    assert reached == {(12, 16), (13, 16), (14, 8), (14, 16), (15, 8), (16, 8)}


def test_k3_warpgroup_counter_stays_zero_on_cpu():
    sa.reset_launches()
    q = torch.zeros(1, 196, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    sa.short_self_attention(q, q, q, batch_heads=True).float().sum().backward()
    assert sa.bwd_batched_wgmma_launches() == sa.bwd_batched_launches() == 0


def _emulated_k3(q, k, v, do, causal):
    """The warpgroup body's arithmetic in plain PyTorch, f32 on bf16 inputs,
    (b, s, h, 64) → (dq, dk, dv) in bf16: per 64-row query tile, x = q·kᵀ,
    p = 2^(x·scale·log2e − max·scale·log2e)·(1/sum) (masked keys 0), dp =
    do·vᵀ, D = Σ p·dp, ds = bf16((p·(dp − D))·scale), dq = ds·k; dv += bf16(p)ᵀ·do
    and dk += dsᵀ·q in f32 over the tiles."""
    b, s, h, dh = q.shape
    scale = dh ** -0.5
    sl = scale * LOG2E
    qh, kh, vh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    dq = torch.zeros(b, h, s, dh)
    dk = torch.zeros(b, h, s, dh)
    dv = torch.zeros(b, h, s, dh)
    keys = torch.arange(s)
    for q0 in range(0, s, 64):
        rows = torch.arange(q0, min(q0 + 64, s))
        qt, dot = qh[:, :, rows], doh[:, :, rows]
        x = qt @ kh.transpose(-1, -2)
        if causal:
            x = torch.where(keys[None, :] <= rows[:, None], x, torch.tensor(float("-inf")))
        m = x.amax(dim=-1, keepdim=True)
        e = torch.exp2(x * sl - m * sl)
        p = e * (1.0 / e.sum(dim=-1, keepdim=True))  # parked in f32
        dp = dot @ vh.transpose(-1, -2)
        d = (p * dp).sum(dim=-1, keepdim=True)
        ds = ((p * (dp - d)) * scale).to(torch.bfloat16).float()
        dq[:, :, rows] = ds @ kh
        dv += p.to(torch.bfloat16).float().transpose(-1, -2) @ dot
        dk += ds.transpose(-1, -2) @ qt
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16) for t in (dq, dk, dv))


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("b,s,h,dh,causal", [(2, 196, 2, 64, False), (2, 196, 2, 64, True),
                                             (1, 250, 2, 64, False), (2, 64, 2, 64, False)])
def test_emulated_order_of_sums_matches_plain_k3_and_pallas_batched_kernel(b, s, h, dh, causal):
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(4)]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays)
    got = _emulated_k3(q, k, v, do, causal)
    plain = sa.short_self_attention_bwd_batched_plain(q, k, v, do, causal)
    ref = _short_attention_bwd(causal, None, True, True,
                               tuple(jnp.asarray(x, jnp.bfloat16) for x in arrays[:3]),
                               jnp.asarray(arrays[3], jnp.bfloat16))
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        r = np.asarray(r.astype(jnp.float32))
        g = g.float().numpy()
        assert np.isfinite(g).all()
        # Both sides round p and ds to bf16 after f32 sums in other orders and
        # each gradient to bf16: one bf16 ulp at the gradient's largest magnitude.
        np.testing.assert_allclose(g, p.float().numpy(), rtol=0, atol=_bf16_ulp(r), err_msg=name)
        np.testing.assert_allclose(g, r, rtol=0, atol=_bf16_ulp(r), err_msg=name)
