"""The port's fused short-attention module and dense attention vs the JAX
package, on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there). Here the port's ``short_self_attention`` takes its
plain PyTorch version, which is held to the JAX Pallas kernel run in
interpret mode on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops import pallas_short_attention as jsa
from distributed_sigmoid_loss_tpu.ops.pallas_short_attention import (
    short_self_attention as jax_short_self_attention,
)
from distributed_sigmoid_loss_tpu.parallel.ring_attention import (
    dense_attention as jax_dense_attention,
)
from distributed_sigmoid_loss_tpu_torch.ops import attention_f32
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa
from distributed_sigmoid_loss_tpu_torch.parallel.ring_attention import dense_attention

# The JAX package's kernel cases: (b, s, h, dh, causal) — s=196 is the
# ViT-B/16 shape (not tile-aligned), s=64 the text-tower shape.
CASES = [
    (2, 196, 4, 32, False),
    (2, 64, 4, 32, False),
    (1, 128, 2, 32, True),
]

# bf16: both sides take the same bf16 inputs and f32 logits, but round p to
# bf16 after sums taken in different orders, so a p can land one bf16 ulp
# (2^-8 relative) apart, and the outputs are rounded to bf16 (|out| < 2, so
# one output ulp is at most 2^-7). Two output ulps: 1.6e-2.
BF16_ATOL = 1.6e-2


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,s,h,dh,causal", CASES)
def test_plain_matches_pallas_kernel_f32(b, s, h, dh, causal):
    q, k, v = _qkv(0, (b, s, h, dh))
    ref = jax_short_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, True
    )
    out = sa.short_self_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal
    )
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("b,s,h,dh,causal", CASES)
def test_plain_matches_pallas_kernel_bf16(b, s, h, dh, causal):
    q, k, v = _qkv(1, (b, s, h, dh))
    ref = jax_short_self_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal, None, True
    )
    out = sa.short_self_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), causal
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=BF16_ATOL
    )


def test_short_attention_fits_hopper_budget():
    # B/16 vision and text, L/14, so400m (dh=72) fit in 227 KB of shared memory.
    assert sa.short_attention_fits(196, 768, 2, 12)
    assert sa.short_attention_fits(64, 768, 2, 12)
    assert sa.short_attention_fits(256, 1024, 2, 16)
    assert sa.short_attention_fits(256, 1152, 2, 16)
    # s=1024 at dh=64 does not, nor does a head dim past the kernel's 128.
    assert not sa.short_attention_fits(1024, 768, 2, 12)
    assert not sa.short_attention_fits(64, 1024, 2, 4)
    # f32 takes JAX's own fit (the f32 kernels tile the sequence): B/16
    # vision fits, s=512 at width 768 is past JAX's VMEM budget.
    assert sa.short_attention_fits(196, 768, 4, 12)
    assert not sa.short_attention_fits(512, 768, 4, 12)
    # One block's footprint at B/16 vision (the warpgroup body): alignment
    # slack, K and V (208 rows of 128 bytes) and one 64-row q tile; no
    # logits in shared memory, so three blocks fit an SM. At dh=72 (the
    # mma.sync body): K, V (208 rows × 88, bf16) and four warps' 16-row q
    # tiles at the same stride.
    assert sa.short_attention_smem_bytes(196, 64) == 1024 + (2 * 208 + 64) * 128
    assert 3 * sa.short_attention_smem_bytes(196, 64) <= sa.SMEM_BUDGET_BYTES
    assert sa.short_attention_smem_bytes(196, 72) == (2 * 208 + 4 * 16) * 88 * 2
    # L/14's s=256 at dh=64 is the warpgroup body's longest row (256 keys);
    # at dh=72 it takes the two-pass body (rows rounded up to 64).
    assert sa.short_attention_smem_bytes(256, 64) == 1024 + (2 * 256 + 64) * 128
    assert sa.short_attention_smem_bytes(256, 72) == (2 * 256 + 4 * 16) * 88 * 2


def test_launch_counter_stays_zero_on_cpu():
    sa.reset_launches()
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(2, (1, 16, 2, 8)))
    sa.short_self_attention(q, k, v)
    sa.short_self_attention(q, k, v, causal=True)
    assert sa.launches() == 0


def test_f32_kernel_counters_stay_zero_on_cpu():
    """f32 CPU tensors take the plain versions: neither the roles' counters
    nor the f32 kernels' own count a launch, forward or backward."""
    sa.reset_launches()
    attention_f32.reset_launches()
    leaves = [torch.from_numpy(x).requires_grad_() for x in _qkv(3, (1, 16, 2, 8))]
    for batch_heads in (False, True):
        sa.short_self_attention(*leaves, batch_heads=batch_heads).sum().backward()
    assert sa.launches() == sa.bwd_launches() == sa.bwd_batched_launches() == 0
    assert attention_f32.launches() == {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}


@pytest.mark.parametrize("s_q,s_k,causal", [(16, 16, False), (16, 16, True), (1, 12, False), (5, 12, True)])
def test_dense_attention_matches_jax(s_q, s_k, causal):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, s_q, 3, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, s_k, 3, 8)).astype(np.float32) for _ in range(2))
    ref = jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    out = dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# --- f32: JAX's fit and dispatch ---------------------------------------------------

@pytest.mark.parametrize("s,width,heads", [
    (64, 768, 12), (196, 768, 12), (300, 768, 12), (400, 768, 12), (576, 768, 12),
    (1024, 768, 12), (256, 1024, 16), (729, 1152, 16), (1024, 128, 2), (1100, 128, 2),
])
def test_f32_fit_is_jaxs(s, width, heads):
    """f32 takes JAX's own K1 fit (s <= 1,024 and its VMEM budget): the f32
    kernels tile the sequence, so the card takes every length JAX does."""
    assert sa.short_attention_fits(s, width, 4, heads) == jsa.short_attention_fits(s, width, 4)


@pytest.mark.parametrize("s,expect", [(196, "K1"), (512, "K7")])
@pytest.mark.parametrize("batch_heads", [False, True])
def test_f32_flash_dispatch_follows_jaxs_choice(monkeypatch, s, expect, batch_heads):
    """An f32 layer with ``attn_impl="flash"`` at width 768 / 12 heads takes
    K1 where JAX's f32 fit holds (s = 196) and K7 past it (s = 512), with
    K2 or K3 as K1's backward by the switch, as JAX's dispatch does."""
    from distributed_sigmoid_loss_tpu_torch.models import transformer
    from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa

    assert jsa.short_attention_fits(s, 768, 4) == (expect == "K1")
    monkeypatch.setattr(fa, "flash_attention_available", lambda x: True)
    taken = []
    for module, name, tag in ((sa, "short_self_attention_bwd", "K3" if batch_heads else "K2"),
                              (sa, "short_self_attention", "K1"),
                              (fa, "flash_self_attention", "K7")):
        real = getattr(module, name)

        def spy(*a, _real=real, _tag=tag, **kw):
            taken.append(_tag)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    sa.set_bwd_batch_heads(batch_heads)
    try:
        attn = transformer.Attention(768, 12, torch.float32, attn_impl="flash", device="cpu",
                                     generator=torch.Generator().manual_seed(0))
        x = torch.randn(1, s, 768, generator=torch.Generator().manual_seed(1), requires_grad=True)
        attn(x).sum().backward()
    finally:
        sa.set_bwd_batch_heads(False)
    assert taken == ([expect, "K3" if batch_heads else "K2"] if expect == "K1" else ["K7"])
