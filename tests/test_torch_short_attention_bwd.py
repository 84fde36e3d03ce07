"""The port's short-attention backward (K2) vs the JAX package, on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
the plain version there). Here ``short_self_attention_bwd_plain`` is held to
the JAX ``_short_attention_bwd`` running ``_bwd_kernel`` in the Pallas
interpreter on the same numpy inputs, and the autograd Function around K1
and K2 is checked on CPU tensors, where it runs both plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops.pallas_short_attention import _short_attention_bwd
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa

# (b, s, h, dh): s=64 is the text tower's length, s=50 is ragged like
# ViT-B/16's 196 (not a multiple of 16); dh 16 and 24 (24 is not a multiple
# of 16 either). At head dim 64, the edges of the card's warpgroup body: one
# 64-key tile (s=64), one row past it (s=65, a second tile of one row) and
# its longest length (s=256, L/14's).
SHAPES = [(2, 64, 2, 16), (1, 50, 3, 24), (1, 64, 2, 64), (1, 65, 2, 64), (1, 256, 1, 64)]


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype) for _ in range(4)]


def _jax_bwd(q, k, v, do, causal, jdtype):
    out = _short_attention_bwd(
        causal, None, True, False,
        tuple(jnp.asarray(x, jdtype) for x in (q, k, v)), jnp.asarray(do, jdtype),
    )
    return [np.asarray(x.astype(jnp.float32)) for x in out]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,dh", SHAPES)
def test_plain_bwd_matches_pallas_kernel_f32(b, s, h, dh, causal):
    q, k, v, do = _inputs(0, (b, s, h, dh), np.float32)
    ref = _jax_bwd(q, k, v, do, causal, jnp.float32)
    got = sa.short_self_attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, do)), causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32
        # f32 on both sides; only the order of the f32 sums differs
        # (observed: at most 6e-7 absolute).
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6, err_msg=name)


# bf16: both sides round p (for dv) and ds (for dq, dk) to bf16 after f32
# sums taken in different orders, so a p or ds can land one bf16 ulp apart,
# and the outputs are rounded to bf16: two bf16 ulps at each gradient's
# largest magnitude, 2^(floor(log2 max) - 6) (observed: at most a quarter of
# one ulp).
BF16_ULPS = 2


def _bf16_ulp(x) -> float:
    return 2.0 ** (float(np.floor(np.log2(np.abs(x).max()))) - 7)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,dh", SHAPES)
def test_plain_bwd_matches_pallas_kernel_bf16(b, s, h, dh, causal):
    q, k, v, do = (x.astype(np.float32) for x in _inputs(1, (b, s, h, dh), np.float32))
    ref = _jax_bwd(q, k, v, do, causal, jnp.bfloat16)
    got = sa.short_self_attention_bwd_plain(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)), causal
    )
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=BF16_ULPS * _bf16_ulp(r), err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_gradcheck_float64(causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 2, 3, dtype=torch.float64, generator=g, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: sa.short_self_attention(a, b, c, causal), (q, k, v)
    )


def test_autograd_backward_is_the_plain_bwd_not_autograd_of_the_forward():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(2, (1, 20, 2, 8), np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sa.short_self_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    ref = sa.short_self_attention_bwd_plain(q, k, v, do, causal=True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_bwd_launch_counter_stays_zero_on_cpu():
    sa.reset_launches()
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in _inputs(3, (1, 16, 2, 8), np.float32)[:3]]
    sa.short_self_attention(*leaves).float().sum().backward()
    sa.short_self_attention_bwd(*(t.detach() for t in leaves), leaves[0].detach(), causal=True)
    assert sa.launches() == 0 and sa.bwd_launches() == 0


def test_bwd_smem_fits_every_shape_the_forward_takes():
    # One K2 block at B/16 vision: Q and dO (208 rows × 72, bf16), four
    # 4608-byte warp regions (16 staged rows of two operands) and three f32
    # statistics per padded query row.
    assert sa.short_attention_bwd_smem_bytes(196, 64) == 2 * 208 * 72 * 2 + 4 * 4608 + 3 * 208 * 4
    for s, dh in ((196, 64), (64, 64), (256, 64), (256, 72), (256, 128), (16, 128)):
        assert sa.short_attention_bwd_smem_bytes(s, dh) <= sa.SMEM_BUDGET_BYTES
    assert sa.short_attention_fits(256, 1152, 2, 16)


# The body each (s, dh, 16-byte rows) takes on the card, as the source
# decides it before launch: B/16 vision and text and L/14 (and a ragged
# s=200) the warpgroup body; one past its range, other head dims and rows
# that are not 16-byte aligned the wmma body.
@pytest.mark.parametrize("s,dh,vec,body", [
    (196, 64, 1, 1), (64, 64, 1, 1), (256, 64, 1, 1), (200, 64, 1, 1), (1, 64, 1, 1),
    (257, 64, 1, 0), (196, 64, 0, 0), (256, 72, 1, 0), (196, 128, 1, 0), (50, 20, 0, 0),
    (416, 64, 1, 0),
])
def test_bwd_body_choice(s, dh, vec, body):
    assert sa.short_attention_bwd_body(s, dh, vec) == body


def test_bwd_wgmma_smem_mirrors_the_layout_and_fits():
    # B/16 vision: the dQ kernel holds K and V over 256 rows of 128 bytes,
    # and per warpgroup (two) a Q and a dO tile and 104 parked f32 of p a
    # thread; the dK/dV kernel Q and dO over 256 rows, one 64-row K and V
    # tile and three f32 statistics a row; each with 1,024 bytes of
    # alignment slack and 8-byte barriers (dQ: K/V and one per warpgroup;
    # dK/dV: one).
    assert sa.short_attention_bwd_wgmma_smem_bytes(196, "dq") == \
        1024 + 2 * 256 * 128 + 2 * (2 * 64 * 128 + 104 * 128 * 4) + 3 * 8
    assert sa.short_attention_bwd_wgmma_smem_bytes(196, "dkdv") == \
        1024 + 2 * 256 * 128 + 2 * 64 * 128 + 3 * 256 * 4 + 8
    # Text: one warpgroup, 64 keys.
    assert sa.short_attention_bwd_wgmma_smem_bytes(64, "dq") == \
        1024 + 2 * 64 * 128 + (2 * 64 * 128 + 32 * 128 * 4) + 2 * 8
    for s in range(1, 257):
        for which in ("dq", "dkdv"):
            assert 0 < sa.short_attention_bwd_wgmma_smem_bytes(s, which) <= sa.SMEM_BUDGET_BYTES
    assert sa.short_attention_bwd_wgmma_smem_bytes(257, "dq") == 0
    with pytest.raises(ValueError):
        sa.short_attention_bwd_wgmma_smem_bytes(64, "dk")


@pytest.mark.parametrize("width,heads", [(768, 12), (1024, 16), (1152, 16), (60, 3)])
def test_every_shape_k1_takes_has_a_k2_body(width, heads):
    """Wherever the towers send bf16 attention to K1, K2 has a body whose
    block fits the card: the warpgroup body's two kernels, or the wmma
    body's (whose footprint stays the dispatch term it was)."""
    dh = width // heads
    taken = [s for s in range(1, 1025) if sa.short_attention_fits(s, width, 2, heads)]
    assert taken and taken == list(range(1, len(taken) + 1))
    for s in taken:
        for vec in (0, 1) if dh % 8 == 0 else (0,):
            if sa.short_attention_bwd_body(s, dh, vec):
                assert max(sa.short_attention_bwd_wgmma_smem_bytes(s, w)
                           for w in ("dq", "dkdv")) <= sa.SMEM_BUDGET_BYTES
            else:
                assert sa.short_attention_bwd_smem_bytes(s, dh) <= sa.SMEM_BUDGET_BYTES
