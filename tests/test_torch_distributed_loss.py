"""The port's distributed sigmoid loss over ``torch.distributed`` (gloo,
``mp.spawn``) vs the JAX package's ``make_sharded_loss_fn`` on the 8-device
CPU mesh, at W ∈ {2, 3, 4}: every composition (all-gather fused and
chunked; ring bidirectional, unidirectional, and both overlapped), with and
without the streaming loss kernel (its plain version on the CPU; JAX runs
its Pallas kernel in interpret mode). Also: W = N ≡ W = 1, the overlapped
ring bitwise equal to the serial one, the exchanges' and the all-gather's
directions forward and backward, and the ring-permutation messages.

Inputs are the reference harness's (the port's ``utils/parity_data.py``,
held bitwise equal to the JAX package's copy by
``tests/test_torch_compat.py``) with 128-wide towers,
so the JAX kernel engages (d % 128 == 0, local_b % 8 == 0). One spawn per W
runs every case (``tests/_torch_dist_worker.py``); the JAX side runs here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from distributed_sigmoid_loss_tpu.ops.pallas_sigmoid_loss import (
    reset_traced_loss_kernels as jax_reset_traced,
    traced_loss_kernels as jax_traced,
)
from distributed_sigmoid_loss_tpu.ops.sigmoid_loss import init_loss_params, l2_normalize
from distributed_sigmoid_loss_tpu.parallel import collectives as jcol
from distributed_sigmoid_loss_tpu.parallel import make_mesh, make_sharded_loss_fn
from distributed_sigmoid_loss_tpu_torch.parallel import collectives as pcol
from distributed_sigmoid_loss_tpu_torch.parallel.api import make_sharded_loss_fn as port_loss_fn
from distributed_sigmoid_loss_tpu_torch.utils.parity_data import (
    reference_encoder_weights,
    reference_partition,
)

WORLDS = (2, 3, 4)
GPU_BATCH, EMB_DIM, OUT_DIM = 8, 16, 128
LOSS_RTOL = 1e-5
# Tower gradients are sums over 8-32 rows of order-0.1 terms: f32 round-off
# near zero needs an absolute floor beside rtol 1e-4 (observed ≤ 2.4e-7).
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CASES = [(name, up) for name in worker.COMPOSITIONS for up in (False, True)]
# JAX's overlapped ring is bitwise its serial ring (tests/test_streamed_loss.py),
# so the overlapped cases are held to the serial JAX result, one compile fewer.
JAX_COMPOSITION = {name: name.removesuffix("_overlap") for name in worker.COMPOSITIONS}


def _data(world):
    img, txt = reference_partition(world, GPU_BATCH, EMB_DIM)
    wi, wt = reference_encoder_weights(EMB_DIM, OUT_DIM)
    return img, txt, wi, wt


@functools.cache
def _jax_result(world, name, use_pallas):
    """JAX loss and DP-averaged gradients of the parity pipeline, and the
    loss kernels its trace engaged."""
    img, txt, wi, wt = _data(world)
    jax_reset_traced()
    fn = make_sharded_loss_fn(make_mesh(world), use_pallas=use_pallas,
                              **worker.COMPOSITIONS[name])

    def objective(p):
        zimg = l2_normalize(jnp.asarray(img) @ p["wi"].T)
        ztxt = l2_normalize(jnp.asarray(txt) @ p["wt"].T)
        return fn(p["loss"], zimg, ztxt)

    params = {"loss": init_loss_params(), "wi": jnp.asarray(wi), "wt": jnp.asarray(wt)}
    loss, g = jax.value_and_grad(objective)(params)
    return {"loss": float(loss), "wi": np.asarray(g["wi"]), "wt": np.asarray(g["wt"]),
            "t_prime": float(g["loss"]["t_prime"]), "bias": float(g["loss"]["bias"]),
            "traced": jax_traced()}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Each rank's results per world size, one spawn per W, run on first use."""
    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"w{world}")
            cache[world] = worker.spawn(worker.loss_worker, world, _data(world), out)
        return cache[world]

    return get


@pytest.mark.parametrize("name,use_pallas", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_port_matches_jax_sharded_loss(port_results, world, name, use_pallas):
    ranks = port_results(world)
    ref = _jax_result(world, JAX_COMPOSITION[name], use_pallas)
    if use_pallas:
        assert ref["traced"] == ("streaming",)  # JAX ran its kernel, not the XLA fallback
    for r, res in enumerate(ranks):
        got = res[f"{name}/{int(use_pallas)}"]
        assert got["traced"] == (["streaming"] if use_pallas else [])
        np.testing.assert_allclose(got["loss"].item(), ref["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        for k in ("wi", "wt", "t_prime", "bias"):
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_w_equals_n_matches_w_equals_1(port_results, world, use_pallas):
    """The reference's W=N ≡ W=1 oracle: the single-process port on the
    global batch gives every composition's loss and averaged gradients."""
    img, txt, wi, wt = _data(world)
    ref = worker._tower_pipeline(port_loss_fn(use_pallas=use_pallas), img, txt, wi, wt)
    for name in worker.COMPOSITIONS:
        got = port_results(world)[0][f"{name}/{int(use_pallas)}"]
        np.testing.assert_allclose(got["loss"].item(), ref["loss"].item(), rtol=LOSS_RTOL)
        for k in ("wi", "wt", "t_prime", "bias"):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_overlapped_ring_is_bitwise_serial(port_results, world, use_pallas, bidir):
    serial = "ring_bidir" if bidir else "ring_unidir"
    for res in port_results(world):
        a, b = res[f"{serial}/{int(use_pallas)}"], res[f"{serial}_overlap/{int(use_pallas)}"]
        assert torch.equal(a["loss"], b["loss"])
        for ga, gb in zip(a["local"], b["local"]):
            assert torch.equal(ga, gb)


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_directions_forward_and_backward(port_results, world):
    """Rank r sends value r; the receiver weights what it received by its own
    tag, so each payload's gradient names the rank that consumed it."""
    ranks = port_results(world)
    for r, res in enumerate(ranks):
        left, right = (r - 1) % world, (r + 1) % world
        sr, sl, bd = res["shift_right"], res["shift_left"], res["bidir"]
        assert torch.equal(sr["y"], torch.full((2, 3), float(left)))  # from the left
        assert torch.equal(sr["dx"], torch.full((2, 3), 10.0 + right))  # consumed on the right
        assert torch.equal(sl["y"], torch.full((2, 3), float(right)))
        assert torch.equal(sl["dx"], torch.full((2, 3), 10.0 + left))
        assert torch.equal(bd["from_right"], torch.full((2,), float(right)))
        assert torch.equal(bd["from_left"], torch.full((2,), 100.0 + left))
        assert torch.equal(bd["d_to_left"], torch.full((2,), 10.0 + left))
        assert torch.equal(bd["d_to_right"], torch.full((2,), 1000.0 + right))


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_backward_is_reduce_scatter(port_results, world):
    """Rank s weights gathered chunk r by r + 10·s: rank r's gradient is
    Σ_s (r + 10·s), the reduce-scatter of every rank's cotangent."""
    for r, res in enumerate(port_results(world)):
        ag = res["all_gather"]
        assert torch.equal(ag["gathered"],
                           torch.arange(world, dtype=torch.float32)[:, None].expand(world, 2))
        expect = world * r + 10.0 * sum(range(world))
        assert torch.equal(ag["dx"], torch.full((2,), expect))


@pytest.mark.parametrize("perm,size", [
    ([(0, 1), (1, 1)], 8),
    ([(0, 1), (1, 2), (2, 0)], 4),
    ([(0, 9), (1, 0)], 2),
    ([(0, 1), (0, 2), (1, 0), (2, 1)], 3),
    ("not pairs", 2),
    ([(i, (i + 1) % 5) for i in range(5)], 5),
])
def test_validate_ring_perm_messages_match_jax(perm, size):
    assert pcol.ring_perm_problems(perm, size) == jcol.ring_perm_problems(perm, size)
    try:
        jcol.validate_ring_perm(perm, size, "dp")
    except ValueError as e:
        with pytest.raises(ValueError) as perr:
            pcol.validate_ring_perm(perm, size, "dp")
        assert str(perr.value) == str(e)
    else:
        pcol.validate_ring_perm(perm, size, "dp")


def test_single_process_exchanges_are_identity():
    """Without torch.distributed every rank is its own neighbour (JAX's
    ppermute at W = 1)."""
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(pcol.neighbour_exchange(x), x)
    fr, fl = pcol.neighbour_exchange_bidir(x, x + 1)
    assert torch.equal(fr, x) and torch.equal(fl, x + 1)
    assert torch.equal(pcol.all_gather(x), x[None])
    with pytest.raises(ValueError, match="n_hops must be >= 1"):
        pcol.double_buffered_scan(None, None, None, 0.0, 0)
