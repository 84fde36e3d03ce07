"""The port's MoE towers with the experts replicated (``models/moe.py``,
``ops/quant.int8_expert_matmul[_ste]``, ``moe_aux_weight`` in both train
steps) against the JAX package's on the CPU.

- ``router_topk`` (ties to the lower expert), ``build_dispatch`` (k = 1 and
  2, over capacity, bf16 one-hots from f32 slots at a group of 512) and
  ``MoeMlp`` equal to JAX's, f32 within 1e-5; the aux loss, 1 at balanced
  routing.
- SigLIP towers with MoE blocks (scanned and not), their weights carried by
  ``params_from_jax`` (``moe/router`` (d, E), ``moe/wi`` (E, d, h) and
  ``moe/wo`` (E, h, d), none transposed), against JAX's: embeddings and the
  mean router aux (JAX's ``_mean_moe_aux``).
- ``int8_expert_matmul`` and its STE against JAX's (``test_quant.py:104``,
  ``test_quant_train.py:112``): zero rows exactly zero, the STE's backward
  the unquantized product's.
- ``make_train_step(moe_aux_weight=...)`` with local accumulation and with
  GradCache against JAX's, and the compressed step (int8 and adaptive) with
  MoE towers on a (dcn, dp) = (2, 2) grid of gloo ranks against JAX's
  (JAX's ``test_compressed_moe_matches_regular``,
  ``test_adaptive_composes_with_moe``).
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_adaptive_ref as ref
import _torch_adaptive_workers as aw
import _torch_dist_worker as worker
from _torch_adaptive_ref import BATCH, DCN, STEPS, TOPK_FRAC, TRAIN_CFG, WORLD, batch_np
from distributed_sigmoid_loss_tpu.models import moe as jmoe
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.ops import quant as jquant
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.train.train_step import _mean_moe_aux
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, moe as pmoe, params_from_jax
from distributed_sigmoid_loss_tpu_torch.ops import quant as pquant
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

MOE = dict(moe_experts=4, moe_group_size=8)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


# -- the layer ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_router_topk_equals_jax(k, ties):
    rng = np.random.default_rng(k)
    xg = rng.standard_normal((3, 8, 6)).astype(np.float32)
    wr = rng.standard_normal((6, 4)).astype(np.float32)
    if ties:
        wr[:, 2] = wr[:, 1]  # experts 1 and 2 tie on every token
        wr[:, 3] = wr[:, 0]
    probs, gates, idx = pmoe.router_topk(t(xg), t(wr), k)
    jp, jg, ji = jmoe.router_topk(jnp.asarray(xg), jnp.asarray(wr), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k", [1, 2])
def test_build_dispatch_equals_jax_over_capacity(k):
    rng = np.random.default_rng(5)
    n, g, e, capacity = 3, 12, 4, 3  # tight capacity: drops occur
    idx = rng.integers(0, e, (n, g, k))
    if k > 1:
        idx[..., 1] = (idx[..., 0] + 1 + rng.integers(0, e - 1, (n, g))) % e
    gates = rng.random((n, g, k)).astype(np.float32)
    d, c = pmoe.build_dispatch(t(gates), t(idx), e, capacity)
    jd, jcb = jmoe.build_dispatch(jnp.asarray(gates), jnp.asarray(idx), e, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jcb), rtol=1e-6, atol=0)
    assert float(d.sum()) < n * g * k  # some tokens dropped


def test_build_dispatch_bf16_keeps_f32_routing():
    rng = np.random.default_rng(6)
    n, g, e, capacity = 2, 512, 4, 160  # past 256: bf16 counts would go wrong
    idx = rng.integers(0, e, (n, g, 1))
    gates = rng.random((n, g, 1)).astype(np.float32)
    d16, c16 = pmoe.build_dispatch(t(gates), t(idx), e, capacity, dtype=torch.bfloat16)
    jd, jcb = jmoe.build_dispatch(jnp.asarray(gates), jnp.asarray(idx), e, capacity,
                                  dtype=jnp.bfloat16)
    assert d16.dtype == c16.dtype == torch.bfloat16
    np.testing.assert_array_equal(d16.float().numpy(), np.asarray(jd, np.float32))
    np.testing.assert_array_equal(c16.float().numpy(), np.asarray(jcb, np.float32))
    d32, _ = pmoe.build_dispatch(t(gates), t(idx), e, capacity)
    np.testing.assert_array_equal(d16.float().numpy(), d32.numpy())


def jax_moe_layer(k, cf=1.25, group=512, d=8, e=4, seed=0, quant=""):
    m = jmoe.MoeMlp(width=d, mlp_ratio=2, num_experts=e, dtype=jnp.float32, num_selected=k,
                    capacity_factor=cf, group_size=group, quant=quant)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, 12, d)), jnp.float32)
    params = nn.meta.unbox(m.init(jax.random.key(seed), x)["params"])
    return m, params, x


def port_layer(params, k, cf, group, quant=""):
    layer = pmoe.MoeMlp(8, 2, 4, torch.float32, num_selected=k, capacity_factor=cf,
                        group_size=group, quant=quant, device="cpu")
    layer.load_state_dict({n: t(params[n]) for n in ("router", "wi", "wo")})
    return layer


@pytest.mark.parametrize("k,cf,group", [(1, 1.25, 512), (2, 1.25, 8), (1, 0.5, 6), (2, 8.0, 24)])
def test_moe_mlp_and_aux_equal_jax(k, cf, group):
    m, params, x = jax_moe_layer(k, cf, group)
    y, state = m.apply({"params": params}, x, mutable=["intermediates"])
    (aux,) = state["intermediates"]["moe_aux_loss"]
    layer = port_layer(params, k, cf, group)
    with pmoe.collect_aux() as auxes:
        got = layer(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    assert len(auxes) == 1
    np.testing.assert_allclose(float(auxes[0]), float(aux), rtol=1e-6)
    # Outside a collector the layer keeps nothing.
    layer(t(x))
    assert len(auxes) == 1


def test_aux_loss_is_one_at_balanced_routing():
    """A zero router: uniform probabilities (P_e = 1/E) and every first
    choice on expert 0 by the tie rule, so E · Σ f_e · P_e = 1."""
    layer = pmoe.MoeMlp(8, 2, 4, torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.router.zero_()
    with pmoe.collect_aux() as auxes:
        layer(torch.ones(1, 8, 8))
    np.testing.assert_allclose(float(auxes[0]), 1.0, rtol=1e-6)


def test_moe_layer_refusals():
    for kw, match in ((dict(num_selected=3), "num_selected"), (dict(group_size=0), "group_size")):
        with pytest.raises(ValueError, match=match):
            pmoe.MoeMlp(8, 2, 4, torch.float32, device="cpu", **kw)
    with pytest.raises(ValueError, match="num_experts"):
        pmoe.MoeMlp(8, 2, 1, torch.float32, device="cpu")


# -- the towers ------------------------------------------------------------------------------


def moe_config(scan=False, k_text=2, **extra):
    cfg = jc.SigLIPConfig.tiny_test()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, scan_layers=scan, **MOE, **extra),
        text=dataclasses.replace(cfg.text, scan_layers=scan, moe_num_selected=k_text, **MOE,
                                 **extra),
        loss=dataclasses.replace(cfg.loss, variant="all_gather"))


@functools.cache
def jax_towers(scan):
    jcfg = moe_config(scan)
    b = batch_np(jcfg, 4)
    model = JaxSigLIP(jcfg)
    params = nn.meta.unbox(model.init(jax.random.key(1), b["images"], b["tokens"])["params"])
    (zi, zt, _), var = model.apply({"params": params}, b["images"], b["tokens"],
                                   mutable=["intermediates"])
    return jcfg, b, jax.tree.map(np.asarray, params), np.asarray(zi), np.asarray(zt), float(
        _mean_moe_aux(var))


@pytest.mark.parametrize("scan", [False, True])
def test_moe_towers_equal_jax(scan):
    jcfg, b, params, zi, zt, aux = jax_towers(scan)
    pcfg = ref.port_config(jcfg)
    state = params_from_jax(params, pcfg)
    assert state["visual.encoder.blocks.0.moe.router"].shape == (32, 4)
    assert state["visual.encoder.blocks.0.moe.wi"].shape == (4, 32, 128)
    assert state["visual.encoder.blocks.0.moe.wo"].shape == (4, 128, 32)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        pzi, pzt, lp = model(t(b["images"]), t(b["tokens"]))
    np.testing.assert_allclose(pzi.numpy(), zi, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pzt.numpy(), zt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(lp["moe_aux"]), aux, rtol=1e-5)


def test_moe_tower_gradients_reach_the_router_and_survive_remat():
    """Under remat with ``save_hot`` (the blocks recomputed in the
    backward, ``mlp_hidden`` kept) the aux loss's gradient reaches every
    router, and equals the gradient without remat."""
    jcfg, b, params, *_ = jax_towers(False)
    grads = {}
    for remat in (False, True):
        cfg = ref.port_config(dataclasses.replace(
            jcfg, vision=dataclasses.replace(jcfg.vision, remat=remat, remat_policy="save_hot"),
            text=dataclasses.replace(jcfg.text, remat=remat, remat_policy="save_hot")))
        model = SigLIP(cfg, device="cpu")
        model.load_state_dict(params_from_jax(params, cfg))
        _, _, lp = model(t(b["images"]), t(b["tokens"]))
        lp["moe_aux"].backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
    routers = [n for n in grads[False] if n.endswith("moe.router")]
    assert len(routers) == 4  # one a block, two blocks a tower
    assert all(float(grads[False][n].abs().max()) > 0 for n in routers)
    assert grads[True].keys() == grads[False].keys()
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=1e-5, atol=1e-7)


# -- the int8 expert products ---------------------------------------------------------------


def test_int8_expert_matmul_equals_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 16, 64)).astype(np.float32)  # (E, n, C, d)
    w = (rng.standard_normal((4, 64, 32)) * 0.05).astype(np.float32)
    x[0, 0, 0] = 0.0  # an unused capacity slot
    pquant.reset_int_mm_calls()
    out = pquant.int8_expert_matmul(t(x), t(w), torch.float32)
    assert pquant.int_mm_calls() == 4  # one int8 product an expert
    want = jquant.int8_expert_matmul(jnp.asarray(x), jnp.asarray(w), jnp.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out[0, 0, 0].numpy(), 0.0)
    ref_out = np.einsum("encd,edh->ench", x, w)
    rel = np.linalg.norm(out.numpy() - ref_out) / np.linalg.norm(ref_out)
    assert rel < 2e-2, rel
    bf16 = pquant.int8_expert_matmul(t(x).bfloat16(), t(w), torch.bfloat16)
    assert bf16.dtype == torch.bfloat16


def test_int8_expert_ste_forward_identical_backward_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    w = (rng.standard_normal((2, 8, 5)) * 0.05).astype(np.float32)
    g = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    px, pw = t(x).requires_grad_(), t(w).requires_grad_()
    out = pquant.Int8ExpertMatmulSTE.apply(px, pw, torch.float32)
    out.backward(t(g))
    jout, vjp = jax.vjp(lambda a, b: jquant.int8_expert_matmul_ste(a, b, jnp.float32),
                        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    jdx, jdw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jdx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jdw), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", ["int8", "int8_ste"])
def test_quantized_moe_layer_equals_jax(quant):
    m, params, x = jax_moe_layer(2, 8.0, 24, quant=quant)
    y, _ = m.apply({"params": params}, x, mutable=["intermediates"])
    got = port_layer(params, 2, 8.0, 24, quant=quant)(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)


# -- the train steps ---------------------------------------------------------------------------


STEP_CASES = {
    "local_accum": dict(accum_steps=2),
    "gradcache": dict(accum_steps=2, accum_negatives="global"),
}


@functools.cache
def jax_regular_steps(name):
    jcfg = moe_config()
    b = {k: jnp.asarray(v) for k, v in batch_np(jcfg, 8).items()}
    model = JaxSigLIP(jcfg)
    mesh = make_mesh(1)
    state = jts.create_train_state(jax.random.key(2), model,
                                   jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG)), b, mesh)
    params0 = jax.tree.map(np.asarray, state.params)
    step, sh = jts.make_train_step(model, mesh, jcfg.loss, moe_aux_weight=0.01,
                                   **STEP_CASES[name])
    b = jax.device_put(b, sh)
    metrics = []
    for _ in range(2):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return params0, metrics, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_step_with_moe_aux_weight_matches_jax(name):
    params0, jmetrics, jparams = jax_regular_steps(name)
    jcfg = moe_config()
    pcfg = ref.port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params0, pcfg))
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    step = pts.make_train_step(model, pcfg.loss, moe_aux_weight=0.01, **STEP_CASES[name])
    b = {k: t(v) for k, v in batch_np(jcfg, 8).items()}
    for want in jmetrics:
        state, m = step(state, b)
        assert set(m) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-4, atol=1e-6, err_msg=k)
    # Within 2·lr (AdamW's largest move) everywhere, and tightly but for the
    # key biases, whose gradient is rounding noise in both packages.
    lr = TRAIN_CFG["learning_rate"]
    outside, total = 0, 0
    for k, want in params_from_jax(jparams, pcfg).items():
        got = model.state_dict()[k].numpy()
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=2 * lr, err_msg=k)
        outside += int((np.abs(got - want.numpy()) > 1e-5 + 1e-4 * np.abs(want.numpy())).sum())
        total += want.numel()
    assert outside <= 0.005 * total, (outside, total)


def test_moe_aux_weight_on_a_dense_model_refuses_like_jax():
    cfg = pc.SigLIPConfig.tiny_test()
    model = SigLIP(cfg, device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    step = pts.make_train_step(model, cfg.loss, moe_aux_weight=0.01)
    b = {k: t(v) for k, v in batch_np(jc.SigLIPConfig.tiny_test(), 4).items()}
    with pytest.raises(ValueError, match="sowed no moe_aux_loss"):
        step(state, b)


COMPRESSED = {
    "int8_moe": dict(compression="int8"),
    "adaptive_moe": dict(compression="adaptive", topk_frac=TOPK_FRAC),
}


def compressed_moe_config():
    """Depth 1 with MoE blocks (JAX compiles six branches a tensor)."""
    cfg = ref.jax_config()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, **MOE),
        text=dataclasses.replace(cfg.text, moe_num_selected=2, **MOE))


def moe_tables(n):
    return [[(j + s) % 5 for j in range(n)] for s in range(STEPS)]


@pytest.fixture(scope="module")
def compressed_ranks(tmp_path_factory):
    jcfg = compressed_moe_config()
    pcfg = ref.port_config(jcfg)
    n = len(jax.tree.leaves(ref.jax_params0(jcfg)))
    runs = [(name, {"step": dict(kw, moe_aux_weight=0.01), "cfg": pcfg,
                    "tables": moe_tables(n)}) for name, kw in COMPRESSED.items()]
    args = (runs, params_from_jax(ref.jax_params0(jcfg), pcfg), pcfg, batch_np(jcfg, BATCH),
            pc.TrainConfig(**TRAIN_CFG), STEPS, DCN)
    return worker.spawn(aw.adaptive_step_worker, WORLD, args,
                        tmp_path_factory.mktemp("moe_step"), timeout_s=300)


@pytest.mark.parametrize("name", sorted(COMPRESSED))
def test_compressed_step_with_moe_matches_jax(compressed_ranks, name):
    """Each rank takes the aux over its own tokens and the world's mean is
    the metric, as JAX's compressed step (its per-device estimator)."""
    jcfg = compressed_moe_config()
    n = len(jax.tree.leaves(ref.jax_params0(jcfg)))
    kw = dict(COMPRESSED[name], moe_aux_weight=0.01)
    adaptive = kw["compression"] == "adaptive"
    want = ref.jax_controller_run(jcfg, kw, "greedy", None,
                                  tables=moe_tables(n) if adaptive else None)
    if adaptive:
        ref.check_against_jax(compressed_ranks, name, want, TRAIN_CFG["learning_rate"],
                              extra=("moe_aux",))
        return
    lr = TRAIN_CFG["learning_rate"]
    for rec in compressed_ranks:
        for i, (a, b) in enumerate(zip(rec[name]["metrics"], want["metrics"])):
            for k in ref.METRICS + ("moe_aux",):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-6,
                                           err_msg=f"step {i} {k}")
    for k, exp in want["params"].items():
        got = compressed_ranks[0][name]["params"][k]
        for rec in compressed_ranks[1:]:
            assert torch.equal(rec[name]["params"][k], got), k
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=2 * lr * (STEPS - 1),
                                   err_msg=k)
