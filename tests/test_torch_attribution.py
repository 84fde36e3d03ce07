"""The port's static attribution (``obs/attribution.py``) held to the JAX
package's ``jaxpr_costs`` / ``static_attribution``.

Per kernel: the FLOP formula each custom op carries equals JAX's walk of
the ``pallas_call`` it replaces (the body's products times the grid) at a
small shape, forward and backward, in bf16, f32 and the int8 mode, and the
int8 products equal JAX's int8 ``dot_general``s. The whole tiny train step:
``flops_est`` within 2% of JAX's. Nothing launches: the trace runs on
tensors without storage, and the real parameters come out untouched.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.obs import attribution as jatt
from distributed_sigmoid_loss_tpu.ops import flash_attention as jfa
from distributed_sigmoid_loss_tpu.ops import pallas_short_attention as jsa
from distributed_sigmoid_loss_tpu.ops import pallas_sigmoid_loss as jsl
from distributed_sigmoid_loss_tpu.ops import quant as jquant
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.obs import attribution as att
from distributed_sigmoid_loss_tpu_torch.ops import quant
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa
from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

RTOL = 1e-6
OPS = torch.ops.dsl_torch_port
TORCH_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _port_flops(fn, *tensors) -> float:
    """The port's count of ``fn`` on fake copies of ``tensors``."""
    return att.static_attribution(lambda *a: fn(*[t.clone() for t in a]), *tensors)["flops_est"]


def _jax_flops(fn, *shapes) -> float:
    return jatt.jaxpr_costs(jax.make_jaxpr(fn)(*shapes))["flops_est"]


def _pallas_calls(fn, *shapes) -> list[float]:
    """JAX's walk of each ``pallas_call`` in ``fn``'s jaxpr, in order."""
    out = []

    def visit(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                acc = jatt._Costs()
                jatt._walk(types.SimpleNamespace(eqns=[eqn]), {}, 1.0, acc)
                out.append(acc.flops)
                continue
            for sub in jatt._sub_jaxprs(eqn.params):
                visit(sub)

    visit(jax.make_jaxpr(fn)(*shapes).jaxpr)
    return out


def _qkv(shape, jdtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    return [torch.from_numpy(a).to(TORCH_DTYPES[jdtype]) for a in arrays]


ATTN_SHAPES = [(2, 50, 2, 16), (3, 65, 4, 8), (1, 130, 2, 32)]
DTYPES = [jnp.bfloat16, jnp.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_k1_forward_formula_equals_jaxs_walk(shape, dtype):
    q, k, v, _ = _qkv(shape, dtype)
    got = _port_flops(lambda q, k, v: OPS.short_attention_fwd(q, k, v, False, 0.25), q, k, v)
    spec = jax.ShapeDtypeStruct(shape, dtype)
    want = _jax_flops(lambda q, k, v: jsa._short_attention_fwd(q, k, v, False, None, True)[0],
                      spec, spec, spec)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("batch_heads", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ATTN_SHAPES[:2], ids=str)
def test_k2_k3_backward_formula_equals_jaxs_walk(shape, dtype, batch_heads):
    q, k, v, do = _qkv(shape, dtype)
    got = _port_flops(
        lambda q, k, v, do: OPS.short_attention_bwd(q, k, v, do, False, 0.25, batch_heads),
        q, k, v, do)
    spec = jax.ShapeDtypeStruct(shape, dtype)
    want = _jax_flops(
        lambda q, k, v, g: jsa._short_attention_bwd(False, None, True, batch_heads, (q, k, v), g),
        spec, spec, spec, spec)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 50, 2, 16), (1, 130, 2, 32), (2, 256, 1, 64)], ids=str)
def test_k7_formulas_equal_jaxs_walk_of_each_pass(shape, dtype):
    """Forward, dK/dV and dQ each against its own pallas_call (the vjp's
    jaxpr holds the forward again, then the two backward passes)."""
    q, k, v, do = _qkv(shape, dtype)
    spec = jax.ShapeDtypeStruct(shape, dtype)
    fwd, dkv, dq = _pallas_calls(
        lambda q, k, v, g: jax.vjp(jfa.flash_self_attention, q, k, v)[1](g),
        spec, spec, spec, spec)
    assert att.flash_attention_fwd_flops(shape) == pytest.approx(fwd, rel=RTOL)
    assert att.flash_attention_bwd_dkv_flops(shape) == pytest.approx(dkv, rel=RTOL)
    assert att.flash_attention_bwd_dq_flops(shape) == pytest.approx(dq, rel=RTOL)
    out, stats = OPS.flash_attention_fwd(q, k, v, False, 0.25)
    assert _port_flops(lambda q, k, v: OPS.flash_attention_fwd(q, k, v, False, 0.25),
                       q, k, v) == pytest.approx(fwd, rel=RTOL)
    assert _port_flops(
        lambda q, k, v, o, do, st: OPS.flash_attention_bwd(q, k, v, o, do, st, False, 0.25),
        q, k, v, out, do, stats) == pytest.approx(dkv + dq, rel=RTOL)


LOSS_SHAPES = [(64, 96, 128, 32, 32), (32, 64, 256, 32, 64)]


@pytest.mark.parametrize("quant_mode", ["", "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", LOSS_SHAPES, ids=str)
def test_k4_k5_k6_formulas_equal_jaxs_walk(shape, quant_mode):
    b, n, d, tb, tn = shape
    rng = np.random.default_rng(1)
    zi = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    zt = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    tp, bias, g = torch.tensor(2.3), torch.tensor(-10.0), torch.tensor(1.0)
    zs, ts = jax.ShapeDtypeStruct((b, d), jnp.float32), jax.ShapeDtypeStruct((n, d), jnp.float32)
    sc = jax.ShapeDtypeStruct((), jnp.float32)
    (fwd,) = _pallas_calls(
        lambda a, c, t, s: jsl._fwd(a, c, t, s, 0, quant_mode, tb, tn, True)[0], zs, ts, sc, sc)
    img, txt = _pallas_calls(
        lambda a, c, t, s, g: jsl._bwd(quant_mode, tb, tn, True, (a, c, t, s, 0), g),
        zs, ts, sc, sc, sc)
    assert att.sigmoid_loss_fwd_flops((b, d), (n, d)) == pytest.approx(fwd, rel=RTOL)
    assert att.sigmoid_loss_bwd_img_flops((b, d), (n, d)) == pytest.approx(img, rel=RTOL)
    assert att.sigmoid_loss_bwd_txt_flops((b, d), (n, d)) == pytest.approx(txt, rel=RTOL)
    # Through the wrapper's autograd node: K4, then K5 and K6.
    def loss_and_grad(zi, zt, tp, bias):
        for t in (zi, zt, tp, bias):
            t.requires_grad_(True)
        ssl.streaming_block_loss_sum(zi, zt, tp, bias, 0, quant=quant_mode).backward()

    assert _port_flops(loss_and_grad, zi, zt, tp, bias) == pytest.approx(fwd + img + txt,
                                                                          rel=RTOL)


@pytest.mark.parametrize("shape", [((4, 6, 32), 48), ((10, 64), 16)], ids=str)
def test_int8_projection_formulas_equal_jaxs_int8_dot(shape):
    """``int8_linear`` (inference), and the STE's forward through
    ``torch._int_mm`` (the flop counter counts nothing for it on its own)."""
    xs, out = shape
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((out, xs[-1])).astype(np.float32))
    bias = torch.zeros(out)
    want = _jax_flops(
        lambda x, w: jquant.int8_dot_general(x, w, (((x.ndim - 1,), (0,)), ((), ()))),
        jax.ShapeDtypeStruct(xs, jnp.float32), jax.ShapeDtypeStruct((xs[-1], out), jnp.float32))
    assert _port_flops(OPS.int8_linear, x, w, bias) == pytest.approx(want, rel=RTOL)
    assert _port_flops(quant.int8_dot_general, x, w) == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("shape", [(2, 3, 8, 16, 24), (4, 1, 5, 32, 8)], ids=str)
def test_int8_expert_product_formula_equals_jaxs(shape):
    e, g, c, k, m = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((e, g, c, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((e, k, m)).astype(np.float32))
    want = _jax_flops(lambda x, w: jquant.int8_expert_matmul(x, w, jnp.float32),
                      jax.ShapeDtypeStruct((e, g, c, k), jnp.float32),
                      jax.ShapeDtypeStruct((e, k, m), jnp.float32))
    got = _port_flops(lambda x, w: quant.int8_expert_matmul(x, w, torch.float32), x, w)
    assert got == pytest.approx(want, rel=RTOL)


def test_the_kernels_formulas_cover_every_custom_op():
    names = {name.split("::")[1] for name in torch._C._dispatch_get_all_op_names()
             if name.startswith("dsl_torch_port::")}
    assert names == set(att.KERNEL_FLOPS)


# --- the whole step ------------------------------------------------------------


def _tiny(**tower_kw):
    cfg = jc.SigLIPConfig.tiny_test()
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **tower_kw),
                               text=dataclasses.replace(cfg.text, **tower_kw))


def _port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def _batch(jcfg, n, seed=0):
    rng = np.random.default_rng(seed)
    hw = jcfg.vision.image_size
    return {"images": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            "tokens": rng.integers(0, jcfg.text.vocab_size,
                                   (n, jcfg.text.context_length)).astype(np.int32)}


def _both(jcfg, accum_steps, n=8):
    batch = _batch(jcfg, n)
    jmodel = JaxSigLIP(jcfg)
    jtx = jts.make_optimizer(jc.TrainConfig())
    mesh = make_mesh(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jts.create_train_state(jax.random.key(0), jmodel, jtx, jbatch, mesh)
    jstep, _ = jts.make_train_step(jmodel, mesh, jcfg.loss, accum_steps=accum_steps)
    want = jatt.static_attribution(jstep, jstate, jbatch)

    pcfg = _port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.params), pcfg))
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig()))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = pts.step_attribution(pts.make_train_step(model, pcfg.loss, accum_steps=accum_steps),
                               state, {k: torch.from_numpy(v) for k, v in batch.items()})
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for p in model.parameters())
    return got, want


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_tiny_step_flops_within_two_percent_of_jaxs(accum_steps):
    got, want = _both(_tiny(), accum_steps)
    assert got["flops_est"] == pytest.approx(want["flops_est"], rel=0.02)
    assert got["comm_bytes_total"] == want["comm_bytes_total"] == 0.0
    fields = att.metrics_line_fields(got)
    assert 0.0 < fields["mfu_est"] <= 1.0 and fields["comm_bytes_total"] == 0.0


def test_save_hot_step_flops_against_jaxs():
    """Under ``save_hot`` both count the backward's recompute of each block.
    On the dense attention core (the CPU's path) the port counts one
    attention-logits product (2·b·s²·width) a layer more than JAX: PyTorch's
    selective checkpointing keeps ops, not names, and the dense core's ops
    are not kept (``models/transformer.py``), so its recompute runs q·kᵀ
    again where JAX's remat keeps the named core. The kernels' path keeps
    the core's op and recomputes nothing of it."""
    jcfg = _tiny(remat=True, remat_policy="save_hot")
    got, want = _both(jcfg, 1)
    n = 8
    extra = sum(tower.depth * 2 * n * s * s * tower.width for tower, s in (
        (jcfg.vision, (jcfg.vision.image_size // jcfg.vision.patch_size) ** 2),
        (jcfg.text, jcfg.text.context_length)))
    assert got["flops_est"] - want["flops_est"] == extra
    assert got["flops_est"] == pytest.approx(want["flops_est"], rel=0.02)


def test_roofline_defaults_to_the_h100_and_matches_jaxs_arithmetic():
    est = att.roofline_estimate(2e12, 3e9)
    assert est["roofline_chip"] == att.DEFAULT_CHIP == "NVIDIA H100 80GB HBM3"
    tflops, hbm, link = att.CHIP_SPECS[att.DEFAULT_CHIP]
    compute, comm = 2e12 / (tflops * 1e12), 3e9 / (link * 1e9)
    assert est["mfu_est"] == round(compute / max(compute, comm), 3)
    assert est["bound"] == ("compute" if compute >= comm else "comm")
    assert att.roofline_estimate(0.0, 0.0)["mfu_est"] == 0.0
    # The same function of its inputs as JAX's, on JAX's own chip table.
    jax_est = jatt.roofline_estimate(2e12, 3e9, device_kind="TPU v5e")
    tf, _, ici = jatt.CHIP_SPECS["TPU v5e"]
    c, m = 2e12 / (tf * 1e12), 3e9 / (ici * 1e9)
    assert jax_est["mfu_est"] == round(c / max(c, m), 3)


def test_short_attention_wrapper_takes_the_op_on_fake_tensors():
    """The towers' no-grad call reaches K1's op on a tensor without storage
    (what a CUDA step's trace sees), and the plain version on a real one."""
    q, k, v, _ = _qkv((2, 16, 2, 8), jnp.bfloat16)
    sa.reset_launches()
    got = _port_flops(lambda q, k, v: sa.short_self_attention(q, k, v), q, k, v)
    assert got == att.short_attention_fwd_flops(q.shape)
    assert sa.launches() == 0


# --- collective bytes over gloo ranks ------------------------------------------

LOCAL_B, D = 4, 16


def _rows(world):
    rng = np.random.default_rng(world)
    z = rng.standard_normal((2, world * LOCAL_B, D)).astype(np.float32)
    return tuple(z / np.linalg.norm(z, axis=-1, keepdims=True))


@pytest.fixture(scope="module")
def port_comm(tmp_path_factory):
    """Each rank's traced collective bytes, one spawn per world size."""
    import _torch_dist_worker as worker
    import _torch_obs_workers as obs_worker

    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"w{world}")
            cache[world] = worker.spawn(obs_worker.comm_worker, world, _rows(world), out)
        return cache[world]

    return get


@pytest.fixture
def jax_sees_psum_invariant(monkeypatch):
    """This JAX writes ``pmean``'s reduction (and the transpose of a
    replicated input) as ``psum_invariant``, which its walk leaves out of
    every kind: with it mapped to ``psum`` (JAX's factor, in this test
    only), JAX's walk counts what the port's all-reduces send."""
    monkeypatch.setitem(jatt._KIND_OF, "psum_invariant", "psum")
    monkeypatch.setitem(jatt._WIRE_FACTORS, "psum_invariant", jatt._WIRE_FACTORS["psum"])


def _jax_comm(world, variant):
    from distributed_sigmoid_loss_tpu.ops.sigmoid_loss import init_loss_params
    from distributed_sigmoid_loss_tpu.parallel import make_sharded_loss_fn

    zi, zt = (jnp.asarray(z) for z in _rows(world))
    fn = make_sharded_loss_fn(make_mesh(world), variant=variant)
    return jatt.static_attribution(
        lambda p, a, b: jax.value_and_grad(fn, argnums=(0, 1, 2))(p, a, b),
        init_loss_params(), zi, zt)


def _jax_grad_average(world):
    from jax.sharding import PartitionSpec as P

    from jax import shard_map

    mesh = make_mesh(world)
    zi, zt = (jnp.asarray(z) for z in _rows(world))
    fn = shard_map(lambda a, b: jax.lax.pmean((a, b), "dp"), mesh=mesh,
                   in_specs=(P("dp"), P("dp")), out_specs=(P("dp"), P("dp")))
    return jatt.static_attribution(fn, zi, zt)


def _kinds(costs):
    return {k: costs[f"comm_bytes_{k}"] for k in att.COLLECTIVE_KINDS}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_loss_and_grad_average_bytes_equal_jaxs(port_comm, world,
                                                     jax_sees_psum_invariant):
    """The ring's hops and the dp gradient average send JAX's bytes. The
    scalars differ in count only: JAX's program reduces t′'s and bias's
    cotangents once a ring block (W times), the port once (DDP's average),
    beside the loss's mean in both."""
    psum = jatt._WIRE_FACTORS["psum"](world)
    want = _kinds(_jax_comm(world, "ring"))
    for r in port_comm(world):
        got = _kinds(r["ring"])
        assert got["ppermute"] == want["ppermute"] > 0
        assert {k: v for k, v in got.items() if k not in ("ppermute", "psum")} == \
            {k: v for k, v in want.items() if k not in ("ppermute", "psum")}
        assert want["psum"] == pytest.approx(psum * (4 + 8 * world))
        assert got["psum"] == pytest.approx(psum * (4 + 8))
        assert _kinds(r["grad_average"]) == _kinds(_jax_grad_average(world))
        assert r["probe"].item() == sum(range(world))


@pytest.mark.parametrize("world", [2, 4])
def test_all_gather_loss_bytes_against_jaxs(port_comm, world, jax_sees_psum_invariant):
    """Forward: the same all-gather bytes. Backward: JAX transposes the
    gather into a reduce-scatter; the port reduce-scatters on NCCL and, gloo
    having none, all-reduces the gathered gradient and keeps its block
    (``parallel/collectives.py``): the same operand at the all-reduce's
    factor, 2·s·(W-1)/W for the reduce-scatter's s·(W-1)/W."""
    want = _kinds(_jax_comm(world, "all_gather"))
    for r in port_comm(world):
        got = _kinds(r["all_gather"])
        assert got["all_gather"] == want["all_gather"] > 0
        assert got["ppermute"] == want["ppermute"] == 0
        assert want["psum_scatter"] > 0
        assert got["psum"] == want["psum"] + 2 * want["psum_scatter"]
        assert got["psum_scatter"] == 0
