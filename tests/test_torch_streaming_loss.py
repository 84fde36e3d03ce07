"""The port's streaming sigmoid-loss block (K4 forward, K5 and K6 backward)
vs the JAX package's Pallas kernel in interpret mode, as
``tests/test_pallas_loss.py`` runs it on the CPU. On CPU tensors the port
runs the kernels' plain versions.

Shapes meet the TPU kernel's tiling (d % 128 == 0, tiles of 8 rows), so the
JAX side runs its kernel, not its XLA fallback (``traced_loss_kernels``).
Inputs come from numpy seeds and go through both packages.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops import pallas_sigmoid_loss as jpl
from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
from distributed_sigmoid_loss_tpu_torch.ops import quant
from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl
from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import sigmoid_loss_chunk_scan
from distributed_sigmoid_loss_tpu_torch.parallel import api

jsl = importlib.import_module("distributed_sigmoid_loss_tpu.ops.sigmoid_loss")

LOSS_RTOL = 1e-5
# Gradients: sums over up to 512 products of order-0.1 terms in another
# order; f32 round-off near zero needs an absolute floor (observed ≤ 1e-6).
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# bf16 inputs: both sides compute in f32 on the same bf16 values and round
# each gradient to bf16 at the end, so they may differ by one bf16 ulp
# (2^-8 relative) of the largest entry.
BF16_GRAD_RTOL_OF_MAX = 2.0 ** -7


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    # Positive pairs alike, as trained embeddings are, so the positive
    # terms are not all saturated.
    zi, zt = unit_rows(rng, b, d), unit_rows(rng, n, d)
    return zi, zt, np.float32(np.log(10.0) + 0.2), np.float32(-9.5)


def jax_block(zi, zt, tp, bias, off, dtype=jnp.float32):
    jpl.reset_traced_loss_kernels()
    fn = lambda a, b, c, e: jpl.streaming_block_loss_or_none(a, b, c, e, jnp.float32(off),
                                                             normalize=False)
    args = (jnp.asarray(zi, dtype), jnp.asarray(zt, dtype), jnp.asarray(tp), jnp.asarray(bias))
    loss, grads = jax.value_and_grad(fn, argnums=(0, 1, 2, 3))(*args)
    assert jpl.traced_loss_kernels() == ("streaming",)
    return float(loss), [np.asarray(g, np.float32) for g in grads]


def port_block(zi, zt, tp, bias, off, dtype=torch.float32):
    args = [torch.tensor(zi).to(dtype).requires_grad_(), torch.tensor(zt).to(dtype).requires_grad_(),
            torch.tensor(tp, requires_grad=True), torch.tensor(bias, requires_grad=True)]
    loss = ssl.streaming_block_loss_sum(*args, off)
    grads = torch.autograd.grad(loss, args)
    for g, a in zip(grads, args):
        assert g.dtype == a.dtype and g.shape == a.shape
    return loss.item(), [g.float().numpy() for g in grads]


# (b, n, d, pos_offset): one tile; a rank's view of the fused all-gather
# block at W = 4 (offset r·b, r = 2); a negatives-only block; a 2-D grid of
# default-size tiles where both operands stream.
BLOCKS = {
    "positive": (8, 8, 128, 0),
    "allgather_rank2_of_4": (8, 32, 128, 16),
    "negative_only": (16, 64, 128, ssl.NEGATIVE_ONLY_OFFSET),
    "grid_2x2": (256, 512, 128, 0),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_plain_kernels_match_pallas_f32(case):
    b, n, d, off = BLOCKS[case]
    zi, zt, tp, bias = inputs(b, n, d, seed=sorted(BLOCKS).index(case))
    ref_loss, ref_grads = jax_block(zi, zt, tp, bias, off)
    loss, grads = port_block(zi, zt, tp, bias, off)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    for name, g, r in zip(("dzimg", "dztxt", "dt_prime", "dbias"), grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def test_plain_kernels_match_pallas_bf16():
    zi, zt, tp, bias = inputs(8, 32, 128, seed=7)
    ref_loss, ref_grads = jax_block(zi, zt, tp, bias, 8, jnp.bfloat16)
    loss, grads = port_block(zi, zt, tp, bias, 8, torch.bfloat16)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    for name, g, r in zip(("dzimg", "dztxt", "dt_prime", "dbias"), grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=0, atol=BF16_GRAD_RTOL_OF_MAX * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("pass_", ["fwd", "bwd_img", "bwd_txt"])
def test_each_plain_pass_is_its_part_of_the_vjp(pass_):
    """K4, K5 and K6's plain versions alone: the loss, (dzimg, dt′, dbias)
    and dztxt of JAX's VJP at an upstream gradient g ≠ 1."""
    zi, zt, tp, bias = inputs(8, 16, 128, seed=11)
    g = np.float32(0.37)
    fn = lambda a, b, c, e: jpl.streaming_block_loss_or_none(a, b, c, e, jnp.float32(3),
                                                             normalize=False)
    args = (jnp.asarray(zi), jnp.asarray(zt), jnp.asarray(tp), jnp.asarray(bias))
    loss, vjp = jax.vjp(fn, *args)
    ref = vjp(jnp.float32(g))
    t = [torch.tensor(x) for x in (zi, zt, tp, bias)]
    if pass_ == "fwd":
        np.testing.assert_allclose(ssl.streaming_loss_fwd_plain(*t, 3).item(), float(loss),
                                   rtol=LOSS_RTOL)
    elif pass_ == "bwd_img":
        got = ssl.streaming_loss_bwd_img_plain(*t, 3, torch.tensor(g))
        for x, r in zip(got, (ref[0], ref[2], ref[3])):
            np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:
        got = ssl.streaming_loss_bwd_txt_plain(*t, 3, torch.tensor(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[1]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("positive_chunk", [0, 2])
def test_chunk_scan_use_pallas_matches_jax(positive_chunk):
    zi, zt, tp, bias = inputs(8, 24, 128, seed=3 + positive_chunk)
    chunks = zt.reshape(3, 8, 128)
    jpl.reset_traced_loss_kernels()
    fn = lambda a, b, c, e: jsl.sigmoid_loss_chunk_scan(a, b, c, e, positive_chunk=positive_chunk,
                                                        use_pallas=True)
    ref, ref_g = jax.value_and_grad(fn, argnums=(0, 1, 2, 3))(
        jnp.asarray(zi), jnp.asarray(chunks), jnp.asarray(tp), jnp.asarray(bias))
    assert jpl.traced_loss_kernels() == ("streaming",)
    ssl.reset_traced_loss_kernels()
    args = [torch.tensor(x, requires_grad=True) for x in (zi, chunks, tp, bias)]
    got = sigmoid_loss_chunk_scan(*args, positive_chunk=positive_chunk, use_pallas=True)
    got_g = torch.autograd.grad(got, args)
    assert ssl.traced_loss_kernels() == ("streaming",)
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_RTOL)
    for g, r in zip(got_g, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # ... and the port's chunk scan without the kernel.
    plain = [torch.tensor(x, requires_grad=True) for x in (zi, chunks, tp, bias)]
    want = sigmoid_loss_chunk_scan(*plain, positive_chunk=positive_chunk)
    np.testing.assert_allclose(got.item(), want.item(), rtol=LOSS_RTOL)
    for g, r in zip(got_g, torch.autograd.grad(want, plain)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_cpu_tensors_launch_nothing():
    """Plain-version calls on CPU tensors are not launches."""
    ssl.reset_launches()
    zi, zt, tp, bias = inputs(8, 8, 128, seed=0)
    port_block(zi, zt, tp, bias, 0)
    ssl.streaming_block_loss_sum(*(torch.tensor(x) for x in (zi, zt, tp, bias)), 0,
                                 quant="int8")
    assert ssl.launches() == {"fwd": 0, "bwd_img": 0, "bwd_txt": 0,
                              "fwd_int8": 0, "bwd_img_int8": 0, "bwd_txt_int8": 0}


def test_shape_mirrors():
    """The Python mirrors of the kernels' scratch and shared-memory sizes
    (held against the library's own on the card by chip_smoke.py)."""
    # K4: one partial a 128 × 128 tile; its shared memory is the ring (and,
    # in the f32 mode, two sets of TF32 planes), the same at every width.
    assert ssl.fwd_partials(100, 300) == 1 * 3
    assert ssl.fwd_smem_bytes() == 214016 <= 227 * 1024
    assert ssl.fwd_smem_bytes(quant=True) == 99328
    # K5/K6 keep their gradient rows and dlogits in registers: shared memory
    # is the wgmma operands' TF32 planes and the cp.async ring, the same at
    # every width and under Hopper's 227 KB. d is cut into slices of at most
    # 256 gradient columns; up to 8 slices share the logits as a cluster.
    assert ssl.bwd_smem_bytes(512) == 216064
    assert ssl.bwd_smem_bytes(1152) == 216064 <= 227 * 1024
    assert ssl.bwd_smem_bytes(2000) == 216064
    assert ssl.bwd_layout(512) == (2, 256, 2, 10)
    assert ssl.bwd_layout(1152) == (5, 256, 5, 10)  # So400m
    assert ssl.bwd_layout(2000) == (8, 256, 8, 10)
    assert ssl.bwd_layout(4096) == (16, 256, 1, 130)  # past the portable cluster size


SOURCE = Path(ssl.__file__).resolve().parents[1] / "csrc" / "sigmoid_loss.cu"


def _stated_bwd_layout() -> dict[int, tuple[int, int, int, int, int, int]]:
    """The source header's K5/K6 table: d → (slices, slice, cluster, steps a
    tile, shared bytes, blocks per SM by shared memory)."""
    rows = re.findall(r"^//\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+([\d,]+)\s+(\d+)\s*$",
                      SOURCE.read_text(), flags=re.M)
    return {int(d): (int(a), int(b), int(c), int(e), int(f.replace(",", "")), int(h))
            for d, a, b, c, e, f, h in rows}


def _stated_fwd_layout() -> dict[int, tuple]:
    """The source header's K4 table: d → (f32 steps a tile, int8 steps
    (None: '-'), f32 and int8 shared bytes, f32 and int8 blocks per SM)."""
    rows = re.findall(r"^//\s+(\d+)\s+(\d+)\s+(\d+|-)\s+([\d,]+)\s+([\d,]+)\s+(\d+)\s+(\d+)\s*$",
                      SOURCE.read_text(), flags=re.M)
    return {int(d): (int(f), None if q == "-" else int(q), int(fs.replace(",", "")),
                     int(qs.replace(",", "")), int(kf), int(kq))
            for d, f, q, fs, qs, kf, kq in rows if "," in fs}


@pytest.mark.parametrize("d", [200, 512, 1152, 2000, 4096])
def test_fwd_mirrors_match_the_layout_the_source_states(d):
    f32_steps, int8_steps, f32_smem, int8_smem, f32_blocks, int8_blocks = _stated_fwd_layout()[d]
    assert ssl.fwd_layout(d) == (f32_steps, int8_steps)
    assert (ssl.fwd_smem_bytes(), ssl.fwd_smem_bytes(quant=True)) == (f32_smem, int8_smem)
    # Blocks an SM by shared memory (228 KB, 1 KB reserved a block).
    assert (f32_blocks, int8_blocks) == tuple(228 * 1024 // (s + 1024)
                                              for s in (f32_smem, int8_smem))


@pytest.mark.parametrize("d", [200, 512, 1152, 2000, 4096])
def test_shape_mirrors_match_the_layout_the_source_states(d):
    slices, slice_, cluster, steps, smem, blocks = _stated_bwd_layout()[d]
    assert ssl.bwd_layout(d) == (slices, slice_, cluster, steps)
    assert ssl.bwd_smem_bytes(d) == smem
    assert af.SM_SMEM_BYTES // (smem + af.BLOCK_RESERVED_SMEM_BYTES) == blocks


def test_int8_refused_naming_its_row():
    """Once refused naming its ROADMAP row (queue A item 6.2), the loss's
    int8 mode now runs through every entry point that refused it: the block
    sum, the dispatch (recording ``"streaming_int8"``), the chunk scan and
    the per-shard loss, all at the plain int8 value. Unknown modes are still
    refused."""
    zi, zt, tp, bias = (torch.tensor(x) for x in inputs(32, 32, 128, seed=0))
    want = ssl.streaming_loss_fwd_plain(zi, zt, tp, bias, 0, quant="int8")
    assert want.item() != ssl.streaming_loss_fwd_plain(zi, zt, tp, bias, 0).item()
    assert ssl.streaming_block_loss_sum(zi, zt, tp, bias, 0, quant="int8").item() == want.item()
    ssl.reset_traced_loss_kernels()
    got = ssl.streaming_block_loss_or_none(zi, zt, tp, bias, 0, quant="int8", normalize=False)
    assert got.item() == want.item() and ssl.traced_loss_kernels() == ("streaming_int8",)
    scan = sigmoid_loss_chunk_scan(zi, zt[None], tp, bias, positive_chunk=0, use_pallas=True,
                                   quant="int8")
    np.testing.assert_allclose(scan.item(), want.item() / 32, rtol=1e-6)
    per_shard = api.make_per_shard_loss(use_pallas=True, quant="int8")
    np.testing.assert_allclose(per_shard(zi, zt, tp, bias).item(), want.item() / 32, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown loss quant"):
        ssl.streaming_block_loss_sum(zi, zt, tp, bias, 0, quant="int4")


# --- the int8 mode (K4 int8) and JAX's dispatch ------------------------------

def jax_block_int8(zi, zt, tp, bias, off):
    jpl.reset_traced_loss_kernels()
    fn = lambda a, b, c, e: jpl.streaming_block_loss_or_none(a, b, c, e, jnp.float32(off),
                                                             quant="int8", normalize=False)
    args = (jnp.asarray(zi), jnp.asarray(zt), jnp.asarray(tp), jnp.asarray(bias))
    loss, grads = jax.value_and_grad(fn, argnums=(0, 1, 2, 3))(*args)
    assert jpl.traced_loss_kernels() == ("streaming_int8",)
    return float(loss), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("positives", [True, False], ids=["positives", "negatives_only"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b", [32, 64, 128])
def test_plain_int8_kernels_match_pallas_int8(b, d, positives):
    """The plain K4/K5/K6 int8 against JAX's int8 kernel in the Pallas
    interpreter at b = n: the loss and every gradient within rtol 1e-5 (of
    each gradient's largest magnitude for the embedding gradients, whose
    entries near zero are sums of cancelling terms). The STE contract shows
    in dzimg and dztxt: products with the full-precision rows."""
    off = 0 if positives else ssl.NEGATIVE_ONLY_OFFSET
    zi, zt, tp, bias = inputs(b, b, d, seed=b + d + positives)
    ref_loss, ref_grads = jax_block_int8(zi, zt, tp, bias, off)
    args = [torch.tensor(x, requires_grad=True) for x in (zi, zt, tp, bias)]
    ssl.reset_traced_loss_kernels()
    loss = ssl.streaming_block_loss_or_none(*args, off, quant="int8", normalize=False)
    assert ssl.traced_loss_kernels() == ("streaming_int8",)
    grads = torch.autograd.grad(loss, args)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    # dt′ = t·Σ dl·raw sums b² terms of both signs that cancel to ~1% of
    # their magnitudes: its rounding is bounded by the sum of |terms|, so
    # it is held at 1e-5 of t·Σ|dl·raw| rather than of itself.
    dl, raw, t = ssl._dlogits(*(torch.tensor(x) for x in (zi, zt, tp, bias)), off,
                              torch.ones(()), "int8")
    scale = {"dt_prime": float((dl * raw).abs().sum() * t)}
    for name, g, r in zip(("dzimg", "dztxt", "dt_prime", "dbias"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * scale.get(name, np.abs(r).max()), err_msg=name)


def test_int8_raw_is_the_exact_int32_product_dequantized_in_jaxs_order():
    """The int8 mode's logit product is bitwise JAX's ``_tile_raw_int8`` on
    the same quantized rows, and the rows are quantized as JAX quantizes
    them."""
    zi, zt, _, _ = inputs(32, 32, 128, seed=4)
    jziq, jzis = jpl.quantize_int8(jnp.asarray(zi), axis=1)
    jztq, jzts = jpl.quantize_int8(jnp.asarray(zt), axis=1)
    ref = np.asarray(jpl._tile_raw_int8(jziq, jzis, jztq, jzts))
    got = quant.int8_product(*(torch.from_numpy(np.array(a)) for a in (jziq, jzis, jztq, jzts)),
                             torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        ssl._raw(torch.from_numpy(zi), torch.from_numpy(zt), "int8").numpy(), ref)


@pytest.mark.parametrize("b,n,d,quant", [(100, 100, 128, ""), (100, 100, 128, "int8"),
                                         (64, 64, 200, ""), (64, 48, 128, "int8"),
                                         (128, 128, 128, "")])
def test_pallas_compatible_and_the_record_match_jax(b, n, d, quant):
    """The dispatch returns None and records "xla" exactly where JAX's does
    (tiles that divide the block, 8 rows in f32 or 32 in int8, d % 128)."""
    zi, zt, tp, bias = inputs(b, n, d, seed=9)
    want = jpl.pallas_compatible(b, n, d, quant=bool(quant))
    assert ssl.pallas_compatible(b, n, d, quant=bool(quant)) == want
    jpl.reset_traced_loss_kernels()
    ssl.reset_traced_loss_kernels()
    jout = jpl.streaming_block_loss_or_none(*(jnp.asarray(x) for x in (zi, zt, tp, bias)),
                                            jnp.float32(0), quant=quant)
    pout = ssl.streaming_block_loss_or_none(*(torch.tensor(x) for x in (zi, zt, tp, bias)), 0,
                                            quant=quant)
    assert (jout is None) == (pout is None) == (not want)
    assert ssl.traced_loss_kernels() == jpl.traced_loss_kernels()
    if want:
        np.testing.assert_allclose(pout.item(), float(jout), rtol=LOSS_RTOL)


def test_untileable_block_takes_the_plain_block_at_the_losss_precision():
    """b = 100 fails the TPU kernel's tiling, so with ``use_pallas`` JAX
    computes that block on its XLA path at the loss's ``precision``; at
    "default" that is one bf16 pass on the TPU (the port's "default"). The
    port's dispatch now gives the same None, and the per-shard loss the
    plain block at "default": JAX's XLA block on the bf16-rounded
    embeddings. Before the repair the port ran its f32 kernel on every shape
    and got the f32 value, which differs."""
    zi, zt, tp, bias = inputs(100, 100, 128, seed=12)
    t = [torch.tensor(x) for x in (zi, zt, tp, bias)]
    ssl.reset_traced_loss_kernels()
    per_shard = api.make_per_shard_loss(variant="all_gather", use_pallas=True, precision="default")
    got = per_shard(*t).item()
    assert ssl.traced_loss_kernels() == ("xla",)
    rounded = [jnp.asarray(x, jnp.bfloat16).astype(jnp.float32) for x in (zi, zt)]
    ref = float(jsl.sigmoid_loss_block(*rounded, jnp.asarray(tp), jnp.asarray(bias),
                                       precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    # The f32 kernel's value (what the port returned before the repair) is
    # outside that tolerance, over ten times as far from JAX's value.
    before = ssl.streaming_block_loss_sum(*t, 0).item() / 100
    assert abs(before - ref) > LOSS_RTOL * abs(ref)
    assert abs(before - ref) > 10 * abs(got - ref)
    # The ring and the chunk scan fall back the same way.
    ring = api.make_per_shard_loss(variant="ring", use_pallas=True, precision="default")
    np.testing.assert_allclose(ring(*t).item(), ref, rtol=LOSS_RTOL)
    chunked = api.make_per_shard_loss(variant="all_gather", loss_impl="chunked", use_pallas=True,
                                      precision="default")
    np.testing.assert_allclose(chunked(*t).item(), ref, rtol=LOSS_RTOL)
