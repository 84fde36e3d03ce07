"""The port's Ulysses attention (``parallel/ulysses_attention.py``: two
differentiable all-to-alls around dense attention) over gloo ranks, one
spawn per world size, against the JAX package's ``make_ulysses_attention``
on a virtual CPU mesh (rtol 2e-5, atol 2e-6), against the port's ring on
the same ranks (values and gradients), and its refusals: heads that do not
divide by the axis and an unknown ``sp_impl``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import _torch_sp_workers as sp_workers
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.parallel.ulysses_attention import make_ulysses_attention
from distributed_sigmoid_loss_tpu_torch.models import SigLIP
from distributed_sigmoid_loss_tpu_torch.models.transformer import Encoder
from distributed_sigmoid_loss_tpu_torch.parallel.ring_attention import (
    dense_attention,
    sequence_parallel_attention,
)
from distributed_sigmoid_loss_tpu_torch.parallel.ulysses_attention import ulysses_attention
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

SHAPE = (2, 16, 4, 8)  # (b, S, h, dh): h divides by 2 and 4
WORLDS = (2, 4)
RTOL, ATOL = 2e-5, 2e-6


def inputs(causal: bool, shape=SHAPE):
    rng = np.random.default_rng(11 + causal)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(4))


def cases():
    out = []
    for causal in (False, True):
        q, k, v, cot = inputs(causal)
        for impl in ("ulysses", "ring"):
            out.append((f"{impl}_causal{int(causal)}", impl, q, k, v, cot, dict(causal=causal)))
    q, k, v, cot = inputs(False, (2, 16, 3, 8))  # 3 heads: divide by neither 2 nor 4
    out.append(("heads3", "ulysses", q, k, v, cot, {}))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = worker.spawn(sp_workers.attention_worker, world, (cases(),),
                                        tmp_path_factory.mktemp(f"ulysses{world}"),
                                        timeout_s=120)
        return cache[world]

    return get


@functools.cache
def jax_ulysses(world: int, causal: bool) -> np.ndarray:
    q, k, v, _ = inputs(causal)
    fn = make_ulysses_attention(make_mesh(world, "sp"), causal=causal)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", (False, True))
def test_ulysses_matches_jax(ranks, world, causal):
    want = jax_ulysses(world, causal)
    for rec in ranks(world):
        np.testing.assert_allclose(rec[f"ulysses_causal{int(causal)}"]["out"].numpy(), want,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", (False, True))
def test_ulysses_matches_ring_and_dense_gradients(ranks, world, causal):
    q, k, v, cot = inputs(causal)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (dense_attention(*leaves, causal=causal) * torch.from_numpy(cot)).sum().backward()
    for rec in ranks(world):
        uly, ring = rec[f"ulysses_causal{int(causal)}"], rec[f"ring_causal{int(causal)}"]
        np.testing.assert_allclose(uly["out"].numpy(), ring["out"].numpy(), rtol=RTOL,
                                   atol=ATOL)
        for name, leaf in zip(("dq", "dk", "dv"), leaves):
            np.testing.assert_allclose(uly[name].numpy(), ring[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            np.testing.assert_allclose(uly[name].numpy(), leaf.grad.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_refuses_heads_that_do_not_divide(ranks, world):
    for rec in ranks(world):
        assert rec["heads3"] == {
            "error": f"ulysses requires num_heads (3) divisible by axis size ({world})"}


def test_one_rank_ulysses_is_dense_attention():
    for causal in (False, True):
        q, k, v, _ = (torch.from_numpy(t) for t in inputs(causal))
        torch.testing.assert_close(ulysses_attention(q, k, v, causal=causal),
                                   dense_attention(q, k, v, causal=causal), rtol=0, atol=0)


def test_unknown_sp_impl_raises_jax_message():
    msg = "unknown sp_impl: 'bogus' \\(expected one of \\['ring', 'ulysses'\\]\\)"
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match=msg):
        sequence_parallel_attention(q, q, q, impl="bogus")
    with pytest.raises(ValueError, match=msg):
        Encoder(32, 1, 2, 4, torch.float32, sp_axis="sp", sp_impl="bogus")
    cfg = pc.SigLIPConfig.tiny_test()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, sequence_parallel_axis="sp", sequence_parallel_impl="bogus"))
    with pytest.raises(ValueError, match=msg):
        SigLIP(cfg, device="cpu")
