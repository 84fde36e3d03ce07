"""The sigmoid-loss forward's design (K4, ``csrc/sigmoid_loss.cu``), on the CPU.

K4 runs only on the card (``chip_smoke.py`` holds it against the plain
version there). Here its arithmetic is pinned by emulation. In the f32 mode
the logits are formed as the kernel forms them on the tensor cores: each
32-column step of d a split-f32 (3xTF32) product
(``attention_f32.split_f32_matmul``), the steps' sums added in IEEE f32,
then ``logit_of``'s two roundings (``raw·t``, then ``+ bias``) and softplus.
The emulation is held against the plain version and against JAX's
``pallas_sigmoid_loss._fwd`` in the Pallas interpreter. In the int8 mode the
kernel's int32 sums over 128 values of d a step, with a ragged d zero-filled,
are exact and give the plain version's raw bit for bit. Inputs follow
``chip_smoke.loss_case_inputs``: unit rows, positives alike, t = 10,
bias = −10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.ops import pallas_sigmoid_loss as jpl
from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
from distributed_sigmoid_loss_tpu_torch.ops import quant
from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl
from test_torch_streaming_loss_split_f32 import CASES, case_inputs

# The kernel's steps: 32 columns of d (f32 mode), 128 int8 values (int8 mode).
STEP_F32, STEP_INT8 = 32, 128
# Split f32 with short sums against the IEEE-f32 plain version: a tenth of
# the kernel's contract (LOSS_RTOL, chip_smoke.py).
SPLIT_VS_PLAIN = 1e-6
# Against JAX's f32 kernel in the Pallas interpreter: the contract itself.
LOSS_RTOL = 1e-5
# int8 cases (b, n, d, pos_offset): d a whole number of steps, So400m's
# width, and a d whose last step is ragged (272 = 2·128 + 16).
INT8_CASES = {
    "positives_512x1024x512": (512, 1024, 512, 0),
    "so400m_256x512x1152": (256, 512, 1152, 0),
    "ragged_d_96x160x272": (96, 160, 272, 5),
}


def emulated_fwd(zimg, ztxt, t_prime, bias, off, terms=3):
    """K4's f32 mode as the kernel forms it: each 32-column step's product
    in split f32 (``terms`` 3) or plain TF32 (1), summed apart and added to
    the logits in IEEE f32; logit = raw·t then + bias, each rounded; the
    sum of softplus(−label·logit)."""
    b, d = zimg.shape
    raw = torch.zeros(b, ztxt.shape[0])
    for k0 in range(0, d, STEP_F32):
        raw = raw + af.split_f32_matmul(zimg[:, k0:k0 + STEP_F32].contiguous(),
                                        ztxt[:, k0:k0 + STEP_F32].T.contiguous(), terms)
    logits = raw * torch.exp(t_prime) + bias
    labels = ssl._labels(b, ztxt.shape[0], off, raw.device)
    return ssl._softplus(-labels * logits).sum()


def torch_inputs(case):
    b, n, d, off = CASES[case]
    return [torch.from_numpy(np.asarray(x)) for x in case_inputs(b, n, d, off, seed=len(case))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_f32_forward_matches_plain_f32(case):
    off = CASES[case][3]
    args = torch_inputs(case)
    ref = ssl.streaming_loss_fwd_plain(*args, off).item()
    got = emulated_fwd(*args, off).item()
    got_1x = emulated_fwd(*args, off, terms=1).item()
    print(f"\nsplit-f32 loss forward {case}: relative error "
          f"3xTF32 {abs(got - ref) / abs(ref):.3e}, 1xTF32 {abs(got_1x - ref) / abs(ref):.3e}")
    assert abs(got - ref) <= SPLIT_VS_PLAIN * abs(ref), (got, ref)


@pytest.mark.parametrize("case", sorted(c for c in CASES if "ragged" not in c))
def test_split_f32_forward_matches_jax_pallas_kernel(case):
    """The emulation against JAX's ``_fwd`` in the Pallas interpreter at the
    kernel's default tiles. The ragged case fails JAX's tiling (JAX computes
    that block on its XLA path); the test above holds it against the plain
    version."""
    b, n, d, off = CASES[case]
    zimg, ztxt, tp, bias = case_inputs(b, n, d, off, seed=len(case))
    loss, _ = jpl._fwd(jnp.asarray(zimg), jnp.asarray(ztxt), jnp.asarray(tp), jnp.asarray(bias),
                       jnp.float32(off), "", min(jpl.DEFAULT_TILE_B, b),
                       min(jpl.DEFAULT_TILE_N, n), True)
    ref = float(loss)
    got = emulated_fwd(*(torch.from_numpy(np.asarray(x)) for x in (zimg, ztxt, tp, bias)),
                       off).item()
    assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_chunked_sums_give_the_plain_raw_bitwise(case):
    """The int8 mode's raw as K4 forms it: int32 sums over 128 values of d a
    step (d zero-filled to whole steps) in step order, converted once, then
    the image scale and the text scale in JAX's order; bitwise the plain
    version's (exact int32 sums in any order)."""
    b, n, d, off = INT8_CASES[case]
    zimg, ztxt = (torch.from_numpy(x) for x in case_inputs(b, n, d, off, seed=len(case))[:2])
    ziq, zis = quant.quantize_int8(zimg, axis=1)
    ztq, zts = quant.quantize_int8(ztxt, axis=1)
    width = -(-d // STEP_INT8) * STEP_INT8
    a = np.zeros((b, width), np.int64)
    o = np.zeros((n, width), np.int64)
    a[:, :d], o[:, :d] = ziq.numpy(), ztq.numpy()
    acc = np.zeros((b, n), np.int64)
    for k0 in range(0, width, STEP_INT8):
        acc += a[:, k0:k0 + STEP_INT8] @ o[:, k0:k0 + STEP_INT8].T
        assert np.abs(acc).max() < 2 ** 31  # the int32 accumulator never overflows
    raw = (torch.from_numpy(acc.astype(np.int32)).float() * zis) * zts.T
    assert torch.equal(raw, ssl._raw(zimg, ztxt, "int8"))
