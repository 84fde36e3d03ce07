"""The sigmoid-loss backward's split-f32 (3xTF32) design, on the CPU.

K5 and K6 (``csrc/sigmoid_loss.cu``) run only on the card (``chip_smoke.py``
holds them against the plain versions there). Here their numeric design is
pinned by emulation: both products, the logits recompute and the gradient
product, formed as the kernels form them on the tensor cores
(``attention_f32.split_f32_matmul``: each f32 operand split into two TF32
parts, three TF32 products summed in f32), with ``logit_of``'s rounding
points (``raw·t``, then ``+ bias``) and the kernels' sigmoid between them.
The emulation is held against the plain versions and against JAX's
``pallas_sigmoid_loss._bwd`` in the Pallas interpreter. Inputs follow
``chip_smoke.loss_case_inputs``: unit rows, positives alike, t = 10, bias = −10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops import pallas_sigmoid_loss as jpl
from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl

NEG = ssl.NEGATIVE_ONLY_OFFSET
# (b, n, d, pos_offset): positives, negatives only, ragged (no multiple of
# the kernels' tiles, d % 4 == 0 but not % 32), So400m's width.
CASES = {
    "positives_512x1024x512": (512, 1024, 512, 0),
    "negatives_only_512x1024x512": (512, 1024, 512, NEG),
    "ragged_100x300x200": (100, 300, 200, 7),
    "so400m_256x512x1152": (256, 512, 1152, 0),
}
# Split f32 against the IEEE-f32 plain versions: a tenth of the kernels'
# contract. What split f32 drops is ~2^-22 of each product term; with f32
# sums in other orders the gradients stay near 1e-6 of the largest magnitude.
SPLIT_VS_PLAIN = 1e-5
# Against JAX's f32 kernel in the Pallas interpreter: the contract itself
# (gradients 1e-4 of the largest magnitude, the loss-side sums rtol 1e-5).
SPLIT_VS_JAX, SUMS_RTOL = 1e-4, 1e-5
# The int8 mode: the same gradient product at the exact int8 raw, held at
# LOSS_INT8_RTOL (chip_smoke.py), 1e-5 of the largest magnitude.
INT8_RTOL = 1e-5


def case_inputs(b, n, d, off, seed):
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    zimg = unit(rng.standard_normal((b, d)))
    ztxt = unit(rng.standard_normal((n, d)))
    rows = np.arange(b)
    keep = (rows + off >= 0) & (rows + off < n)
    ztxt[rows[keep] + off] = unit(zimg[rows[keep]] + 0.5 * ztxt[rows[keep] + off])
    return (zimg.astype(np.float32), ztxt.astype(np.float32), np.float32(np.log(10.0)),
            np.float32(-10.0))


def emulated_bwd(zimg, ztxt, t_prime, bias, off, g, terms=3, quant=""):
    """K5 and K6 as the kernels form them → (dzimg, dt′, dbias, dztxt): the
    logits (f32 mode) and both gradient products in split f32 (``terms`` 3)
    or plain TF32 (1); logit = raw·t then + bias, each rounded; dl =
    g·(−label·σ(−label·logit)) with σ(x) = 1 / (1 + exp(−x)); dt′ = t·Σ
    dl·raw, dbias = Σ dl. In the int8 mode raw is the exact int8 product
    dequantized (``ssl._raw``) and only the gradient products are split."""
    if quant:
        raw = ssl._raw(zimg, ztxt, quant)
    else:
        raw = af.split_f32_matmul(zimg, ztxt.T.contiguous(), terms)
    t = torch.exp(t_prime)
    logits = (raw * t) + bias
    labels = ssl._labels(raw.shape[0], raw.shape[1], off, raw.device)
    x = labels * logits
    dl = g * (-labels * (1.0 / (1.0 + torch.exp(x))))
    dzimg = af.split_f32_matmul(dl, ztxt, terms) * t
    dztxt = af.split_f32_matmul(dl.T.contiguous(), zimg, terms) * t
    return dzimg, (dl * raw).sum() * t, dl.sum(), dztxt, (dl * raw).abs().sum() * t


def plain_bwd(zimg, ztxt, t_prime, bias, off, g, quant=""):
    dzimg, dtp, dbias = ssl.streaming_loss_bwd_img_plain(zimg, ztxt, t_prime, bias, off, g, quant)
    return dzimg, dtp, dbias, ssl.streaming_loss_bwd_txt_plain(zimg, ztxt, t_prime, bias, off, g,
                                                               quant)


def errors(got, ref, dtp_scale):
    """dzimg and dztxt: the largest error as a share of the largest
    magnitude; dt′ (a sum of b·n terms of both signs that cancel) as a share
    of t·Σ|dl·raw|; dbias as a share of itself."""
    dzimg, dtp, dbias, dztxt = got
    r_dzimg, r_dtp, r_dbias, r_dztxt = ref
    return {
        "dzimg": float((dzimg - r_dzimg).abs().max() / r_dzimg.abs().max()),
        "dztxt": float((dztxt - r_dztxt).abs().max() / r_dztxt.abs().max()),
        "dt_prime": abs(float(dtp) - float(r_dtp)) / float(dtp_scale),
        "dbias": abs(float(dbias) - float(r_dbias)) / abs(float(r_dbias)),
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_f32_backward_matches_plain_f32(case):
    b, n, d, off = CASES[case]
    args = [torch.from_numpy(np.asarray(x)) for x in case_inputs(b, n, d, off, seed=len(case))]
    g = torch.tensor(1.0)
    ref = plain_bwd(*args, off, g)
    *got, scale = emulated_bwd(*args, off, g, terms=3)
    errs = errors(got, ref, scale)
    # For the record: plain TF32 (one product) at the same inputs.
    *got_1x, _ = emulated_bwd(*args, off, g, terms=1)
    print(f"\nsplit-f32 loss backward {case}: error (dzimg, dztxt of the largest magnitude) "
          f"3xTF32 {errs}, 1xTF32 {errors(got_1x, ref, scale)}")
    for name, e in errs.items():
        assert e <= SPLIT_VS_PLAIN, (name, e)


@pytest.mark.parametrize("case", sorted(c for c in CASES if "ragged" not in c))
def test_split_f32_backward_matches_jax_pallas_kernel(case):
    """The emulation against JAX's ``_bwd`` (both passes) in the Pallas
    interpreter at the kernel's default tiles. The ragged case fails JAX's
    tiling (JAX computes that block on its XLA path); the test above holds it
    against the plain versions."""
    b, n, d, off = CASES[case]
    zimg, ztxt, tp, bias = case_inputs(b, n, d, off, seed=len(case))
    g = np.float32(1.0)
    res = (jnp.asarray(zimg), jnp.asarray(ztxt), jnp.asarray(tp), jnp.asarray(bias),
           jnp.float32(off))
    dzimg, dztxt, dtp, dbias, _ = jpl._bwd("", min(jpl.DEFAULT_TILE_B, b),
                                           min(jpl.DEFAULT_TILE_N, n), True, res, jnp.float32(g))
    ref = tuple(torch.from_numpy(np.array(x, np.float32)) for x in (dzimg, dtp, dbias, dztxt))
    args = [torch.from_numpy(np.asarray(x)) for x in (zimg, ztxt, tp, bias)]
    *got, scale = emulated_bwd(*args, off, torch.tensor(g), terms=3)
    errs = errors(got, ref, scale)
    for name in ("dzimg", "dztxt"):
        assert errs[name] <= SPLIT_VS_JAX, (name, errs)
    for name in ("dt_prime", "dbias"):
        assert errs[name] <= SUMS_RTOL, (name, errs)


@pytest.mark.parametrize("off", [0, NEG], ids=["positives", "negatives_only"])
def test_int8_mode_split_f32_gradient_product_holds_its_contract(off):
    """The int8 mode's K5/K6 take the same split-f32 gradient product (its
    logits are the exact int8 raw): within 1e-5 of the largest magnitude of
    the plain int8 versions, whose products are IEEE f32."""
    b, n, d = 256, 512, 512
    args = [torch.from_numpy(np.asarray(x)) for x in case_inputs(b, n, d, off, seed=5)]
    g = torch.tensor(1.0)
    ref = plain_bwd(*args, off, g, quant="int8")
    *got, scale = emulated_bwd(*args, off, g, terms=3, quant="int8")
    errs = errors(got, ref, scale)
    print(f"\nint8 mode, split-f32 gradient product, off={off}: {errs}")
    for name, e in errs.items():
        assert e <= INT8_RTOL, (name, e)


def test_plain_tf32_would_miss_the_contract():
    """Why the kernels split: one TF32 product (hi·hi) at the positives case
    is over the 1e-4 contract, three are far inside it."""
    b, n, d, off = CASES["positives_512x1024x512"]
    args = [torch.from_numpy(np.asarray(x)) for x in case_inputs(b, n, d, off, seed=3)]
    g = torch.tensor(1.0)
    ref = plain_bwd(*args, off, g)
    *got_1x, scale = emulated_bwd(*args, off, g, terms=1)
    *got_3x, _ = emulated_bwd(*args, off, g, terms=3)
    errs_1x, errs_3x = errors(got_1x, ref, scale), errors(got_3x, ref, scale)
    assert max(errs_1x["dzimg"], errs_1x["dztxt"]) > SPLIT_VS_JAX, errs_1x
    assert max(errs_3x["dzimg"], errs_3x["dztxt"]) < SPLIT_VS_PLAIN, errs_3x
