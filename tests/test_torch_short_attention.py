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

from distributed_sigmoid_loss_tpu.ops.pallas_short_attention import (
    short_self_attention as jax_short_self_attention,
)
from distributed_sigmoid_loss_tpu.parallel.ring_attention import (
    dense_attention as jax_dense_attention,
)
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
    # s=1024 at dh=64 does not; nor does an f32 activation (bf16-only kernel)
    # or a head dim past the kernel's 128.
    assert not sa.short_attention_fits(1024, 768, 2, 12)
    assert not sa.short_attention_fits(196, 768, 4, 12)
    assert not sa.short_attention_fits(64, 1024, 2, 4)
    # One block's footprint at B/16 vision: K, V (208 rows × 72, bf16) and
    # four 16 × 212 f32 strips.
    assert sa.short_attention_smem_bytes(196, 64) == 2 * 208 * 72 * 2 + 4 * 16 * 212 * 4
    assert sa.short_attention_smem_bytes(196, 64) <= sa.SMEM_BUDGET_BYTES


def test_launch_counter_stays_zero_on_cpu():
    sa.reset_launches()
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(2, (1, 16, 2, 8)))
    sa.short_self_attention(q, k, v)
    sa.short_self_attention(q, k, v, causal=True)
    assert sa.launches() == 0


@pytest.mark.parametrize("s_q,s_k,causal", [(16, 16, False), (16, 16, True), (1, 12, False), (5, 12, True)])
def test_dense_attention_matches_jax(s_q, s_k, causal):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, s_q, 3, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, s_k, 3, 8)).astype(np.float32) for _ in range(2))
    ref = jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    out = dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
