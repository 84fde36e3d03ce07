"""The port's head-batched short-attention backward (K3) vs the JAX package,
on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version and against K2 there). Here
``short_self_attention_bwd_batched_plain`` is held to the JAX
``_short_attention_bwd`` running ``_bwd_kernel_batched`` in the Pallas
interpreter, in the JAX test's cases (``tests/test_pallas_short_attention.py``)
on the same numpy inputs, and to the port's plain K2; the switch, the record
of what ran, the fit predicate and the autograd path are checked on CPU
tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops.pallas_short_attention import _short_attention_bwd
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa

# The JAX test's cases (b, s, h, dh, causal): s=196 is the ViT-B/16 length
# (ragged), s=64 the text tower's, and a causal one; plus a causal ragged
# case at dh 24 (not a multiple of 16).
CASES = [(2, 196, 4, 32, False), (2, 64, 4, 32, False), (1, 128, 2, 32, True),
         (1, 50, 3, 24, True)]


@pytest.fixture(autouse=True)
def _default_backward():
    """Each test starts and ends with the per-head default and an empty
    record."""
    sa.set_bwd_batch_heads(False)
    sa.reset_traced_bwd_batch_heads()
    yield
    sa.set_bwd_batch_heads(False)
    sa.reset_traced_bwd_batch_heads()


def _inputs(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype) for _ in range(4)]


def _jax_batched_bwd(q, k, v, do, causal, jdtype):
    out = _short_attention_bwd(
        causal, None, True, True,
        tuple(jnp.asarray(x, jdtype) for x in (q, k, v)), jnp.asarray(do, jdtype),
    )
    return [np.asarray(x.astype(jnp.float32)) for x in out]


def _port(fn, arrays, causal, dtype=torch.float32):
    return fn(*(torch.from_numpy(x).to(dtype) for x in arrays), causal)


@pytest.mark.parametrize("b,s,h,dh,causal", CASES)
def test_plain_k3_matches_pallas_batched_kernel_f32(b, s, h, dh, causal):
    arrays = _inputs(0, (b, s, h, dh))
    ref = _jax_batched_bwd(*arrays, causal, jnp.float32)
    got = _port(sa.short_self_attention_bwd_batched_plain, arrays, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32 and g.shape == (b, s, h, dh)
        # The JAX test's tolerance for this kernel (observed: at most 1.5e-6).
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=5e-4, err_msg=name)


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("b,s,h,dh,causal", CASES)
def test_plain_k3_matches_pallas_batched_kernel_bf16(b, s, h, dh, causal):
    arrays = _inputs(1, (b, s, h, dh))
    ref = _jax_batched_bwd(*arrays, causal, jnp.bfloat16)
    got = _port(sa.short_self_attention_bwd_batched_plain, arrays, causal, torch.bfloat16)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16
        # Both round p and ds to bf16 after f32 sums in different orders and
        # the outputs to bf16: within one bf16 ulp of the gradient's scale.
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=_bf16_ulp(r), err_msg=name)


@pytest.mark.parametrize("b,s,h,dh,causal", CASES)
def test_plain_k3_matches_plain_k2(b, s, h, dh, causal):
    arrays = _inputs(2, (b, s, h, dh))
    k3 = _port(sa.short_self_attention_bwd_batched_plain, arrays, causal)
    k2 = _port(sa.short_self_attention_bwd_plain, arrays, causal)
    for name, a, c in zip(("dq", "dk", "dv"), k3, k2):
        # The JAX test's tolerance between its two backward kernels.
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_k3_autograd_gradcheck_float64(causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 2, 3, dtype=torch.float64, generator=g, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: sa.short_self_attention(a, b, c, causal, batch_heads=True), (q, k, v)
    )
    assert sa.traced_bwd_batch_heads() == (True,)


def test_set_bwd_batch_heads_selects_k3_and_the_record_shows_the_backward_that_ran():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(3, (1, 20, 2, 8)))

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(sa.short_self_attention(*leaves, causal=True), leaves, do)

    assert sa.traced_bwd_batch_heads() == ()
    per_head = grads()
    assert sa.traced_bwd_batch_heads() == (False,)
    sa.set_bwd_batch_heads(True)
    sa.reset_traced_bwd_batch_heads()
    batched = grads()
    assert sa.traced_bwd_batch_heads() == (True,)
    for g, r in zip(batched, sa.short_self_attention_bwd_batched_plain(q, k, v, do, True)):
        assert torch.equal(g, r)
    # An explicit choice wins over the default; both are recorded.
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(sa.short_self_attention(*leaves, causal=True, batch_heads=False),
                        leaves, do)
    assert sa.traced_bwd_batch_heads() == (False, True)
    for g, r in zip(batched, per_head):
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=2 ** -6)


def test_k3_fits_b16_and_refuses_beyond_its_shared_memory():
    # One K3 block at B/16: bf16(p) and ds (208² bf16 each) and two
    # (208 × 64) operands; the text tower's 64² and two (64 × 64).
    assert sa.short_attention_bwd_batched_smem_bytes(196, 64) == 2 * 208 * 208 * 2 + 2 * 208 * 64 * 2
    assert sa.short_attention_bwd_batched_smem_bytes(64, 64) == 32_768
    assert sa.short_attention_bwd_batched_fits(196, 768, 12, 2)
    assert sa.short_attention_bwd_batched_fits(64, 768, 12, 2)
    assert not sa.short_attention_bwd_batched_fits(256, 768, 12, 2)  # L/14: s > 208
    assert not sa.short_attention_bwd_batched_fits(196, 1536, 12, 2)  # dh 128 at s=196
    assert not sa.short_attention_bwd_batched_fits(1024, 1024, 16, 2)
    q = torch.zeros(1, 256, 2, 8, requires_grad=True)
    with pytest.raises(ValueError, match="batch_heads backward does not fit"):
        sa.short_self_attention(q, q, q, batch_heads=True).sum().backward()
    # Nothing falls back to K2: the refusal is the record's only entry.
    assert sa.traced_bwd_batch_heads() == (True,)


def test_k3_launch_counter_stays_zero_on_cpu():
    sa.reset_launches()
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in _inputs(4, (1, 16, 2, 8))[:3]]
    sa.short_self_attention(*leaves, batch_heads=True).float().sum().backward()
    assert sa.launches() == sa.bwd_launches() == sa.bwd_batched_launches() == 0
