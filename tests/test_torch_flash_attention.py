"""The port's flash attention (K7) vs the JAX package, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each against
its plain version there). Here the plain forward and backward are held to
the JAX ``flash_self_attention``, which runs the upstream Pallas TPU kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``) in the Pallas
interpreter (``pltpu.force_tpu_interpret_mode``), on the same numpy inputs:
f32 at rtol 1e-4, bf16 within one bf16 ulp of the largest magnitude. The
autograd node is held to autograd through ``dense_attention``; the towers'
dispatch and the ``save_hot`` policy are checked on CPU tensors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_sigmoid_loss_tpu.ops.flash_attention import flash_self_attention as jax_flash
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, transformer
from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa
from distributed_sigmoid_loss_tpu_torch.ops import sigmoid_loss as psl
from distributed_sigmoid_loss_tpu_torch.parallel import ring_attention
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

# (s, head_dim, causal, dtype), b=1, h=2: s=300 (three of JAX's 128-key
# blocks, the last ragged) in every combination of causal or not and dh 64
# (B/16, L/14) or 72 (So400m); s=128 and 196 (one key block of 128 and of
# 256) causal and not, at both head dims and in both dtypes. The custom
# scale is the last case's. Few cases: each compiles the Pallas interpreter.
CASES = [
    (128, 64, False, "float32"), (128, 72, True, "bfloat16"),
    (196, 72, False, "bfloat16"), (196, 64, True, "float32"),
    (300, 64, False, "bfloat16"), (300, 72, False, "float32"),
    (300, 64, True, "float32"), (300, 72, True, "bfloat16"),
]
CUSTOM_SCALE = 0.3
# The plain versions at the kernels' key block against JAX's kernel at its
# own, in bf16 ulps of each result's largest magnitude.
K7_BLOCK_ULPS = 2
IDS = [f"s{s}-dh{dh}-{'causal' if c else 'full'}-{dt}" for s, dh, c, dt in CASES]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scale(case):
    return CUSTOM_SCALE if case == CASES[-1] else None


def _inputs(case):
    s, dh, _, _ = case
    rng = np.random.default_rng(CASES.index(case))
    return [rng.standard_normal((1, s, 2, dh)).astype(np.float32) for _ in range(4)]


def _jax_result(case, dtype=None):
    """JAX's flash kernel in the interpreter: (out, dq, dk, dv) as f32 numpy,
    the gradients at output gradient ``do``; inputs in the case's dtype, or
    in ``dtype`` where given."""
    return _jax_result_in(case, dtype or case[3])


@functools.lru_cache(maxsize=None)
def _jax_result_in(case, dtype):
    _, _, causal, _ = case
    q, k, v, do = (jnp.asarray(x, jnp.dtype(dtype)) for x in _inputs(case))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda q, k, v: jax_flash(q, k, v, causal=causal, scale=_scale(case)), q, k, v)
        grads = vjp(do)
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (out, *grads))


def _port_tensors(case, dtype=None):
    return [torch.from_numpy(x).to(_TORCH[dtype or case[3]]) for x in _inputs(case)]


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _assert_close(got: torch.Tensor, ref: np.ndarray, dtype: str, name: str) -> None:
    assert got.dtype == _TORCH[dtype] and got.shape == ref.shape, name
    if dtype == "float32":
        # Observed: at most 5e-7 of the largest magnitude.
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5, err_msg=name)
    else:
        # Both round p (and ds) to bf16 after f32 sums in other orders, and
        # round the result to bf16 (observed: at most 0.12 ulp).
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= _bf16_ulp(ref), (name, err, _bf16_ulp(ref))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_jax_flash_kernel(case):
    _, _, causal, dtype = case
    q, k, v, _ = _port_tensors(case)
    out, stats = fa.flash_self_attention_plain(q, k, v, causal, _scale(case))
    _assert_close(out, _jax_result(case)[0], dtype, "out")
    assert stats.dtype == torch.float32 and stats.shape == (1, 2, 2, q.shape[1])
    assert torch.isfinite(stats).all() and (stats[:, :, 1] >= 1).all()  # l >= exp(m - m)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_flash_kernel(case):
    _, _, causal, dtype = case
    q, k, v, do = _port_tensors(case)
    out, stats = fa.flash_self_attention_plain(q, k, v, causal, _scale(case))
    grads = fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, causal, _scale(case))
    for name, g, r in zip(("dq", "dk", "dv"), grads, _jax_result(case)[1:]):
        _assert_close(g, r, dtype, name)


@pytest.mark.parametrize("case", CASES, ids=[i.rsplit("-", 1)[0] for i in IDS])
def test_plain_at_the_kernels_block_matches_jax_flash_kernel_in_bf16(case):
    """The plain versions at the kernels' key block (``fa.BLOCK_K``), which
    ``chip_smoke.py`` holds the card's kernels to, against JAX's kernel at
    its own block (128 or 256 here), every case in bf16. The two round the
    unnormalised exp(s − m) to bf16 against other running maxima, and JAX
    normalises first where one block covers the sequence: within two bf16
    ulps of each result's largest magnitude (observed: the output one ulp,
    the gradients two)."""
    _, _, causal, _ = case
    q, k, v, do = _port_tensors(case, "bfloat16")
    out, stats = fa.flash_self_attention_plain(q, k, v, causal, _scale(case), fa.BLOCK_K)
    grads = fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, causal, _scale(case),
                                              fa.BLOCK_K)
    for name, g, r in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          _jax_result(case, "bfloat16")):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        err = np.abs(g.float().numpy() - r).max()
        assert err <= K7_BLOCK_ULPS * _bf16_ulp(r), (name, err, _bf16_ulp(r))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_k", [None, 64, 50])
def test_autograd_node_matches_dense_autograd(causal, block_k, monkeypatch):
    """The autograd node on CPU tensors (plain forward, plain two-pass
    backward) against autograd through ``dense_attention``, f32, at JAX's
    block and at other key blocks (ragged last block included); the
    algorithm's result does not depend on the block."""
    if block_k is not None:
        plain_fwd, plain_bwd = fa.flash_self_attention_plain, fa.flash_self_attention_bwd_plain
        monkeypatch.setattr(fa, "flash_self_attention_plain",
                            functools.partial(plain_fwd, block_k=block_k))
        monkeypatch.setattr(fa, "flash_self_attention_bwd_plain",
                            functools.partial(plain_bwd, block_k=block_k))
    rng = np.random.default_rng(7)
    leaves = [torch.tensor(rng.standard_normal((2, 150, 3, 16)), dtype=torch.float32,
                           requires_grad=True) for _ in range(3)]
    do = torch.tensor(rng.standard_normal((2, 150, 3, 16)), dtype=torch.float32)
    out = fa.flash_self_attention(*leaves, causal=causal)
    ref = ring_attention.dense_attention(*leaves, causal=causal)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for g, r in zip(torch.autograd.grad(out, leaves, do), torch.autograd.grad(ref, leaves, do)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
    assert fa.launches() == {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}  # plain versions only


@pytest.mark.parametrize("head_dim", [4, 20, 136])
def test_head_dims_the_kernels_do_not_take_are_refused(head_dim):
    q = torch.zeros(1, 16, 2, head_dim)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_self_attention(q, q, q)


def test_block_sizes_and_shared_memory():
    # JAX's blocks: s padded to 128, then the largest of 512/256/128 dividing it.
    assert [fa.default_block_k(s) for s in (64, 196, 300, 729, 1000, 1024, 4096)] == \
        [128, 256, 128, 256, 512, 512, 512]
    # One block of either pass at the head dims the kernels take stays far
    # inside the 227 KB Hopper budget. The forward's warpgroup body (dh 64
    # and 128): alignment slack, the 128-row Q tile, a ring of 64-row K or V
    # tiles (8 at dh=64, 4 at 128) and 2·stages + 1 barriers; two blocks per
    # SM at dh=64. The mma.sync body (other head dims) is unchanged.
    assert fa.flash_attention_smem_bytes(64) == 1024 + 128 * 128 + 8 * 64 * 128 + 17 * 8
    assert 2 * fa.flash_attention_smem_bytes(64) <= sa.SMEM_BUDGET_BYTES
    assert fa.flash_attention_smem_bytes(128) == 1024 + 128 * 256 + 4 * 64 * 256 + 9 * 8
    assert fa.flash_attention_smem_bytes(72) == 5 * 64 * 88 * 2
    assert fa.flash_attention_smem_bytes(128) <= sa.SMEM_BUDGET_BYTES // 2
    # The backward's warpgroup bodies (dh 64 and 128), one block per SM:
    # alignment slack, two resident 128-row tiles, four stages of two
    # streamed 64-row tiles, dK/dV's four stages of three f32 row statistics
    # (64 rows each), and 2·stages + 1 barriers. The mma.sync bodies (dh=72)
    # keep one layout for both kernels.
    for dh in (64, 128):
        tiles = 2 * 128 * dh * 2 + 4 * 2 * 64 * dh * 2
        assert fa.flash_attention_bwd_smem_bytes(dh, "dq") == 1024 + tiles + 9 * 8
        assert fa.flash_attention_bwd_smem_bytes(dh, "dkv") == 1024 + tiles + 4 * 3 * 64 * 4 + 9 * 8
    assert fa.flash_attention_bwd_smem_bytes(64, "dkv") == 102_472
    assert fa.flash_attention_bwd_smem_bytes(128, "dkv") == 200_776
    assert fa.flash_attention_bwd_smem_bytes(72, "dkv") == \
        fa.flash_attention_bwd_smem_bytes(72, "dq") == 69_120
    for dh in (64, 72, 128):
        for which in ("dkv", "dq"):
            assert fa.flash_attention_bwd_smem_bytes(dh, which) <= sa.SMEM_BUDGET_BYTES
    with pytest.raises(ValueError, match="dkv"):
        fa.flash_attention_bwd_smem_bytes(64, "dk")


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_backward_does_not_round_by_the_block(causal, head_dim):
    """The backward normalises p by the forward's final l, so its rounding
    points (bf16(p), bf16(ds)) do not depend on the block: the plain dK/dV
    and dQ passes at blocks of 64 and 128 and at JAX's (256 at s = 200, a
    ragged last block each) differ only in the order of their f32 sums.
    Each gradient within one bf16 ulp of its largest magnitude, di bitwise
    (it takes no block). This is what lets the kernels tile 128 rows."""
    rng = np.random.default_rng(200 + head_dim + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 200, 2, head_dim)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    out, stats = fa.flash_self_attention_plain(q, k, v, causal)
    results = {}
    for block in (fa.BLOCK_K, 2 * fa.BLOCK_K, fa.default_block_k(200)):
        dk, dv, di = fa.flash_attention_bwd_dkv_plain(q, k, v, out, do, stats, causal,
                                                      block_k=block)
        dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, stats, di, causal, block_k=block)
        results[block] = {"dk": dk, "dv": dv, "dq": dq, "di": di}
    assert sorted(results) == [64, 128, 256]
    ref = results[fa.BLOCK_K]
    for block in (128, 256):
        assert torch.equal(results[block]["di"], ref["di"]), block
        for name in ("dk", "dv", "dq"):
            got, want = results[block][name], ref[name]
            assert got.dtype == torch.bfloat16 and got.shape == want.shape, (block, name)
            err = np.abs(got.float().numpy() - want.float().numpy()).max()
            assert err <= _bf16_ulp(want.float().numpy()), (block, name, err)


# --- the towers' dispatch ----------------------------------------------------

def _spy(monkeypatch):
    """Record which attention core each call took."""
    taken = []
    for module, name, tag in ((sa, "short_self_attention", "K1"),
                              (fa, "flash_self_attention", "K7"),
                              (ring_attention, "dense_attention", "dense")):
        real = getattr(module, name)

        def spy(*a, _real=real, _tag=tag, **kw):
            taken.append(_tag)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    return taken


@pytest.mark.parametrize("impl,dtype,s,cross,expect", [
    ("auto", torch.bfloat16, 1024, False, "K7"),   # beyond K1's fit at dh=64
    ("auto", torch.bfloat16, 196, False, "K1"),    # within it
    ("auto", torch.bfloat16, 1024, True, "dense"),  # cross-attention
    ("auto", torch.float32, 1024, False, "dense"),  # f32 under "auto"
    ("flash", torch.bfloat16, 1024, False, "K7"),
    ("flash", torch.float32, 300, False, "K1"),     # within JAX's f32 fit of K1
    ("flash", torch.float32, 1100, False, "K7"),    # past it (s > 1,024)
], ids=["bf16-long", "bf16-short", "cross", "f32-auto", "flash-long", "flash-f32",
        "flash-f32-long"])
def test_attention_dispatch(monkeypatch, impl, dtype, s, cross, expect):
    monkeypatch.setattr(fa, "flash_attention_available", lambda x: True)
    taken = _spy(monkeypatch)
    attn = transformer.Attention(128, 2, dtype, attn_impl=impl, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, s, 128, generator=torch.Generator().manual_seed(1)).to(dtype)
    with torch.no_grad():
        y = attn(x[:, :4], x) if cross else attn(x)
    assert taken == [expect]
    assert torch.isfinite(y.float()).all()


# --- save_hot -----------------------------------------------------------------

@pytest.mark.parametrize("policy,forwards", [("save_hot", 4), ("nothing", 8)])
def test_flash_forward_runs_once_per_layer_under_save_hot(monkeypatch, policy, forwards):
    """Both tiny bf16 towers forced onto K7 (2 layers each): under
    ``save_hot`` the backward keeps K7's (out, stats) and never runs its
    forward again; ``nothing`` recomputes it."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_self_attention_plain", "fwd"),
                      ("flash_self_attention_bwd_plain", "bwd")):
        real = getattr(fa, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa, name, counted)
    monkeypatch.setattr(fa, "flash_attention_available", lambda x: True)
    monkeypatch.setattr(sa, "short_attention_fits", lambda *a: False)
    cfg = pc.SigLIPConfig.tiny_test()
    tower = dict(dtype="bfloat16", remat=True, remat_policy=policy)
    cfg = pc.SigLIPConfig(vision=dataclasses.replace(cfg.vision, **tower),
                          text=dataclasses.replace(cfg.text, **tower))
    model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((3, 16, 16, 3)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.text.vocab_size, (3, 8)))
    zi, zt, lp = model(images, tokens)
    psl.sigmoid_loss(zi, zt, lp["t_prime"], lp["bias"]).backward()
    assert calls == {"fwd": forwards, "bwd": 4}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.parametrize("width,heads,k1_max", [(768, 12, 416), (1152, 16, 368)],
                         ids=["w768", "w1152"])
def test_k1_fit_boundary_is_unchanged(monkeypatch, width, heads, k1_max):
    """The towers' dispatch sends bf16 self-attention to K1 up to s = 416 at
    width 768 / 12 heads and 368 at 1,152 / 16 (dh = 72), and to K7 one
    past it, as before K1 stopped keeping its logits in shared memory: the
    boundary is a dispatch limit now, not the kernel's own footprint."""
    monkeypatch.setattr(fa, "flash_attention_available", lambda x: True)
    taken = _spy(monkeypatch)
    attn = transformer.Attention(width, heads, torch.bfloat16, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    for s in (k1_max, k1_max + 1):
        x = torch.randn(1, s, width, generator=torch.Generator().manual_seed(s))
        with torch.no_grad():
            assert torch.isfinite(attn(x.to(torch.bfloat16)).float()).all()
    assert taken == ["K1", "K7"]
    head_dim = width // heads
    assert sa.short_attention_smem_bytes(k1_max + 1, head_dim) < sa.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("s", [432, 576, 1024])
def test_k1_and_k7_plain_versions_agree_past_k1s_fit(s):
    """For s in (425, 1024] at width 768 JAX runs K1 (its VMEM holds it) and
    the port K7 (K1's 227 KB block does not): the same function at other
    rounding points (K1 rounds the normalised p to bf16, K7 the unnormalised
    exp(s − m) of each key block). Each output is rounded to bf16 once, so
    the two differ by bf16 rounding steps: within two ulps of the output's
    largest magnitude (observed: one ulp at s = 576 and 1,024, an eighth of
    one at 432)."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, 2, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    k1 = sa.short_self_attention_plain(q, k, v)
    k7, _ = fa.flash_self_attention_plain(q, k, v)
    ref = k1.float().numpy()
    assert np.abs(k7.float().numpy() - ref).max() <= 2 * _bf16_ulp(ref)
