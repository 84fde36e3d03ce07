"""The port's ring attention (``parallel/ring_attention.py``) over gloo
ranks (``mp.spawn``, one spawn per world size) against the JAX package's
``make_ring_attention`` on a virtual CPU mesh of the same size, at JAX's
own pin (rtol 2e-5, atol 2e-6), causal and not. Its gradients are held to
a plain single-process oracle, ``dense_attention`` under autograd, since
JAX's ring-gradient test skips on this host. ``checkpoint_steps`` on and
off give the same values and gradients.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import _torch_sp_workers as sp_workers
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.parallel.ring_attention import make_ring_attention
from distributed_sigmoid_loss_tpu_torch.parallel import collectives
from distributed_sigmoid_loss_tpu_torch.parallel.ring_attention import (
    dense_attention,
    ring_self_attention,
    sequence_parallel_attention,
)

SHAPE = (2, 24, 2, 8)  # (b, S, h, dh): S divides by 2, 3 and 4
WORLDS = (2, 3, 4)
RTOL, ATOL = 2e-5, 2e-6  # JAX's tests/test_ring_attention.py pin


def inputs(causal: bool):
    rng = np.random.default_rng(7 + causal)
    return tuple(rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4))


def cases():
    out = []
    for causal in (False, True):
        q, k, v, cot = inputs(causal)
        for ckpt in (True, False):
            out.append((f"causal{int(causal)}_ckpt{int(ckpt)}", "ring", q, k, v, cot,
                        dict(causal=causal, checkpoint_steps=ckpt)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = worker.spawn(sp_workers.attention_worker, world, (cases(),),
                                        tmp_path_factory.mktemp(f"ring{world}"), timeout_s=120)
        return cache[world]

    return get


@functools.cache
def jax_ring(world: int, causal: bool) -> np.ndarray:
    q, k, v, _ = inputs(causal)
    fn = make_ring_attention(make_mesh(world, "sp"), causal=causal)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def dense_oracle(causal: bool):
    q, k, v, cot = inputs(causal)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = dense_attention(*leaves, causal=causal)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", (False, True))
def test_ring_matches_jax_make_ring_attention(ranks, world, causal):
    want = jax_ring(world, causal)
    s = SHAPE[1] // world
    for r, rec in enumerate(ranks(world)):
        got = rec[f"causal{int(causal)}_ckpt1"]
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=RTOL, atol=ATOL)
        # ring_self_attention itself, on this rank's block
        np.testing.assert_allclose(got["local"].detach().numpy(), want[:, r * s:(r + 1) * s],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", (False, True))
def test_ring_gradients_match_dense_oracle_on_every_rank(ranks, world, causal):
    """Every rank holds the whole (global) gradient of the replicated
    inputs: the sequence scatter and gather count it once."""
    out, grads = dense_oracle(causal)
    for rec in ranks(world):
        got = rec[f"causal{int(causal)}_ckpt1"]
        np.testing.assert_allclose(got["out"].numpy(), out.numpy(), rtol=RTOL, atol=ATOL)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_steps_on_equals_off(ranks, world):
    for rec in ranks(world):
        for causal in (0, 1):
            on, off = rec[f"causal{causal}_ckpt1"], rec[f"causal{causal}_ckpt0"]
            for key in ("out", "dq", "dk", "dv"):
                torch.testing.assert_close(on[key], off[key], rtol=0, atol=0)


def test_one_rank_ring_is_dense_attention():
    """A world of one: one block update, no exchange."""
    for causal in (False, True):
        q, k, v, _ = (torch.from_numpy(t) for t in inputs(causal))
        want = dense_attention(q, k, v, causal=causal)
        torch.testing.assert_close(ring_self_attention(q, k, v, causal=causal), want,
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(sequence_parallel_attention(q, k, v, causal=causal), want,
                                   rtol=RTOL, atol=ATOL)


def test_ring_validation_names_the_axis_it_runs_on():
    with pytest.raises(ValueError, match="over axis 'sp' \\(size 3\\)"):
        collectives.validate_ring_perm([(0, 1), (1, 1), (2, 0)], 3, "sp")


def test_seq_gather_counts_a_replicated_gradient_once(tmp_path):
    """The W-fold count of a plain all-gather: through ``seq_gather`` every
    rank's gradient of ``sum(x²)`` is 2x; through the loss collectives'
    all-gather (backward: a reduce-scatter of the ranks' cotangents) it
    would be W · 2x."""
    world = 2
    x = np.random.default_rng(3).standard_normal((2, 8, 3)).astype(np.float32)
    for rec in worker.spawn(sp_workers.naive_gather_worker, world, (x,), tmp_path):
        np.testing.assert_allclose(rec["seq"].numpy(), 2 * x, rtol=1e-6)
        np.testing.assert_allclose(rec["plain"].numpy(), world * 2 * x, rtol=1e-6)
