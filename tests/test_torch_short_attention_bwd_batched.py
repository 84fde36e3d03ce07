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

from distributed_sigmoid_loss_tpu.ops import pallas_short_attention as jsa
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
    assert not sa.short_attention_bwd_batched_fits(256, 768, 12, 2)  # L/14: JAX refuses too
    # dh 128 at s=196: JAX's VMEM takes it, the card's shared memory does not.
    assert not sa.short_attention_bwd_batched_fits(196, 1536, 12, 2)
    assert not sa.short_attention_bwd_batched_fits(1024, 1024, 16, 2)
    # bf16 s = 272 is past the in-place kernel's 256 rows, whatever JAX's
    # budget (f32 follows JAX's own fit: its kernels tile the sequence).
    q = torch.zeros(1, 272, 2, 8, dtype=torch.bfloat16, requires_grad=True)
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
    assert sa.bwd_batched_in_place_launches() == 0


# --- K3 at JAX's lengths -------------------------------------------------------

@pytest.mark.parametrize("width,heads,limit", [(768, 12, 250), (1024, 16, 212), (1152, 16, 208)])
def test_k3_fit_equals_jaxs_at_its_longest_lengths(width, heads, limit):
    """In bf16, the port's K3 takes exactly what JAX's takes at the three
    widths of JAX's limits, s in [190, 260]: JAX's VMEM predicate decides,
    and the card's shared memory (the two-array kernel to s_pad = 208, the
    in-place one beyond) holds every length it takes."""
    for s in range(190, 261):
        want = jsa.short_attention_bwd_batched_fits(s, width, heads, 2)
        assert sa.short_attention_bwd_batched_fits(s, width, heads, 2) == want, s
        assert want == (s <= limit), s
    dh = width // heads
    assert sa.short_attention_bwd_batched_smem_bytes(limit, dh) <= sa.SMEM_BUDGET_BYTES
    # B/16's s = 196 keeps the two-array kernel; s = 225 and 250 the in-place one.
    assert sa._k3_variant(196, 64)[0] == 1 and sa._k3_variant(225, 64)[0] == 2


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_plain_k3_at_s250_matches_pallas_batched_kernel(dtype):
    arrays = _inputs(5, (1, 250, 2, 16))
    jdtype, tdtype = (jnp.float32, torch.float32) if dtype == np.float32 else \
        (jnp.bfloat16, torch.bfloat16)
    ref = _jax_batched_bwd(*arrays, False, jdtype)
    got = _port(sa.short_self_attention_bwd_batched_plain, arrays, False, tdtype)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        atol = 5e-4 if dtype == np.float32 else _bf16_ulp(r)
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=atol, err_msg=name)


def test_f32_k3_fit_is_jaxs():
    """In f32 the port's K3 role runs the f32 kernels, which tile the
    sequence: the fit is JAX's own, B/16's s = 196 in (9.7 MB of JAX's 11.7)
    and s = 230 at width 768 out."""
    for s in (64, 196, 212, 220, 230, 256):
        for width, heads in ((768, 12), (1024, 16), (1152, 16)):
            assert sa.short_attention_bwd_batched_fits(s, width, heads, 4) == \
                jsa.short_attention_bwd_batched_fits(s, width, heads, 4), (s, width)
    assert sa.short_attention_bwd_batched_fits(196, 768, 12, 4)
    assert not sa.short_attention_bwd_batched_fits(230, 768, 12, 4)
    q = torch.zeros(1, 230, 12, 64, requires_grad=True)
    with pytest.raises(ValueError, match="batch_heads backward does not fit"):
        sa.short_self_attention(q, q, q, batch_heads=True).sum().backward()
