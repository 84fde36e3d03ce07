"""The port's softmax (CLIP/InfoNCE) loss family vs the JAX package, on the
CPU: the single-device loss and its gradients, the all-gather and ring
variants at W ∈ {2, 3, 4} over gloo (``mp.spawn``) against JAX's
``make_sharded_loss_fn`` on the 8-device CPU mesh, the refusals, and bf16
embeddings against the jitted JAX losses of both families.

Inputs come from numpy seeds and the reference harness's
(``utils/parity_data.py``), as ``tests/test_torch_distributed_loss.py``
builds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from distributed_sigmoid_loss_tpu.ops import softmax_loss as jsm
from distributed_sigmoid_loss_tpu.ops.sigmoid_loss import init_loss_params, l2_normalize
from distributed_sigmoid_loss_tpu.parallel import make_mesh, make_sharded_loss_fn
from distributed_sigmoid_loss_tpu.parallel.api import make_per_shard_loss as jax_make_per_shard_loss
from distributed_sigmoid_loss_tpu_torch.ops import softmax_loss as psm
from distributed_sigmoid_loss_tpu_torch.parallel import api
from test_torch_distributed_loss import GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, WORLDS, _data

VARIANTS = ("all_gather", "ring")


def _unit(rng, n, d, dtype=np.float32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(dtype)


def test_init_clip_loss_params_match_jax():
    ref, got = jsm.init_clip_loss_params(), psm.init_clip_loss_params()
    assert got.keys() == ref.keys()
    assert got["t_prime"].dtype == torch.float32
    assert got["t_prime"].item() == float(ref["t_prime"])


def test_single_device_loss_and_grads_match_jax():
    rng = np.random.default_rng(0)
    zi, zt = _unit(rng, 12, 16), _unit(rng, 12, 16)
    tp = np.float32(np.log(1 / 0.07) - 0.4)
    ref, ref_g = jax.value_and_grad(jsm.softmax_contrastive_loss, argnums=(0, 1, 2))(
        jnp.asarray(zi), jnp.asarray(zt), jnp.asarray(tp))
    args = [torch.tensor(x, requires_grad=True) for x in (zi, zt, tp)]
    got = psm.softmax_contrastive_loss(*args)
    got_g = torch.autograd.grad(got, args)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    for g, r in zip(got_g, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("family", ["sigmoid", "softmax"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_embeddings_match_the_jitted_jax_loss(family, variant):
    """bf16 embeddings (the GradCache stash): f32 products of the rounded
    embeddings, as the jitted JAX step computes them, for both families."""
    rng = np.random.default_rng(1)
    zi, zt = _unit(rng, 16, 32), _unit(rng, 16, 32)
    tp, bias = np.float32(2.4), np.float32(-10.0)
    fn = jax_make_per_shard_loss(family=family, variant=variant)
    ref = jax.jit(jax.shard_map(fn, mesh=make_mesh(1), in_specs=(P("dp"), P("dp"), P(), P()),
                                out_specs=P(), check_vma=False))(
        jnp.asarray(zi, jnp.bfloat16), jnp.asarray(zt, jnp.bfloat16), jnp.float32(tp),
        jnp.float32(bias))
    got = api.make_per_shard_loss(family=family, variant=variant)(
        torch.tensor(zi).bfloat16(), torch.tensor(zt).bfloat16(), torch.tensor(tp),
        torch.tensor(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(family="softmax", loss_impl="chunked"),
    dict(family="softmax", variant="ring", ring_overlap=True),
    dict(family="softmax", use_pallas=True),
    dict(family="softmax", use_pallas=True, quant="int8"),
])
def test_softmax_refusals_match_jax(kwargs):
    with pytest.raises(ValueError) as jerr:
        jax_make_per_shard_loss(**kwargs)
    with pytest.raises(ValueError) as perr:
        api.make_per_shard_loss(**kwargs)
    assert str(perr.value) == str(jerr.value)


def test_softmax_per_shard_ignores_bias():
    rng = np.random.default_rng(2)
    zi, zt = (torch.from_numpy(_unit(rng, 6, 8)) for _ in range(2))
    bias = torch.tensor(-10.0, requires_grad=True)
    tp = torch.tensor(2.0, requires_grad=True)
    for variant in VARIANTS:
        loss = api.make_per_shard_loss(family="softmax", variant=variant)(zi, zt, tp, bias)
        torch.testing.assert_close(loss, psm.softmax_contrastive_loss(zi, zt, tp), rtol=1e-6, atol=0)
        assert torch.autograd.grad(loss, [bias], allow_unused=True) == (None,)


@functools.cache
def _jax_result(world, variant):
    img, txt, wi, wt = _data(world)
    fn = make_sharded_loss_fn(make_mesh(world), variant=variant, family="softmax")

    def objective(p):
        zimg = l2_normalize(jnp.asarray(img) @ p["wi"].T)
        ztxt = l2_normalize(jnp.asarray(txt) @ p["wt"].T)
        return fn(p["loss"], zimg, ztxt)

    params = {"loss": init_loss_params(), "wi": jnp.asarray(wi), "wt": jnp.asarray(wt)}
    loss, g = jax.value_and_grad(objective)(params)
    return {"loss": float(loss), "wi": np.asarray(g["wi"]), "wt": np.asarray(g["wt"]),
            "t_prime": float(g["loss"]["t_prime"]), "bias": float(g["loss"]["bias"])}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"softmax_w{world}")
            cache[world] = worker.spawn(worker.contrastive_worker, world, _data(world), out)
        return cache[world]

    return get


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("world", WORLDS)
def test_distributed_softmax_matches_jax(port_results, world, variant):
    ref = _jax_result(world, variant)
    assert ref["bias"] == 0.0  # InfoNCE has no bias: JAX's gradient is zero, the port's None
    for r, res in enumerate(port_results(world)):
        got = res[variant]
        assert got["bias"] is None
        np.testing.assert_allclose(got["loss"].item(), ref["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        for k in ("wi", "wt", "t_prime"):
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_allgather_and_ring_agree(port_results, world):
    for res in port_results(world):
        a, b = res["all_gather"], res["ring"]
        np.testing.assert_allclose(a["loss"].item(), b["loss"].item(), rtol=LOSS_RTOL)
        for k in ("wi", "wt", "t_prime"):
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)
