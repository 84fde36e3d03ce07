"""The port's train step and what it is built from vs the JAX package, on the
CPU: the sigmoid loss functions, the optimizer and its schedules against
optax, the bf16 accumulator, the remat policies, the whole accumulated step
against JAX ``make_train_step`` on a one-device mesh, and the refusals.

Inputs come from numpy seeds and go through both packages; weights are
carried from JAX to the port with ``params_from_jax``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
from jax.experimental.pallas import tpu as pltpu
from test_torch_towers import K7_IMAGE_SIZE, force_vision_onto_k7

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.api import make_per_shard_loss as jax_make_per_shard_loss
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.parallel.microbatch import microbatch_split as jax_microbatch_split
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.ops import flash_attention
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa
from distributed_sigmoid_loss_tpu_torch.ops import sigmoid_loss as psl
from distributed_sigmoid_loss_tpu_torch.parallel import api
from distributed_sigmoid_loss_tpu_torch.parallel.microbatch import microbatch_split
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

# The JAX ops package re-exports the function sigmoid_loss under the module's name.
jsl = importlib.import_module("distributed_sigmoid_loss_tpu.ops.sigmoid_loss")


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(
        vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
        text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
        loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)),
    )


def tiny(**tower_kw):
    cfg = jc.SigLIPConfig.tiny_test()
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, **tower_kw),
        text=dataclasses.replace(cfg.text, **tower_kw),
    )


def batch_np(jcfg, n, seed=0):
    rng = np.random.default_rng(seed)
    hw = jcfg.vision.image_size
    return {
        "images": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
        "tokens": rng.integers(0, jcfg.text.vocab_size, (n, jcfg.text.context_length)).astype(np.int32),
    }


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# --- the loss functions -----------------------------------------------------

LOSS_CASES = {
    "block_positive": (
        lambda zi, zt, tp, b: jsl.sigmoid_loss_block(zi, zt[:6], tp, b),
        lambda zi, zt, tp, b: psl.sigmoid_loss_block(zi, zt[:6], tp, b),
    ),
    "block_negative_only": (
        lambda zi, zt, tp, b: jsl.sigmoid_loss_block(zi, zt[6:], tp, b, negative_only=True),
        lambda zi, zt, tp, b: psl.sigmoid_loss_block(zi, zt[6:], tp, b, negative_only=True),
    ),
    "sigmoid_loss": (
        lambda zi, zt, tp, b: jsl.sigmoid_loss(zi, zt[:6], tp, b),
        lambda zi, zt, tp, b: psl.sigmoid_loss(zi, zt[:6], tp, b),
    ),
    "chunk_scan": (
        lambda zi, zt, tp, b: jsl.sigmoid_loss_chunk_scan(
            zi, zt.reshape(3, 6, -1), tp, b, positive_chunk=1),
        lambda zi, zt, tp, b: psl.sigmoid_loss_chunk_scan(
            zi, zt.reshape(3, 6, -1), tp, b, positive_chunk=1),
    ),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_functions_and_grads_match_jax(case):
    jfn, pfn = LOSS_CASES[case]
    rng = np.random.default_rng(0)
    zi, zt = unit_rows(rng, 6, 8), unit_rows(rng, 18, 8)
    tp, b = np.float32(np.log(10.0) + 0.3), np.float32(-9.0)
    ref, ref_g = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(
        jnp.asarray(zi), jnp.asarray(zt), jnp.asarray(tp), jnp.asarray(b))
    args = [torch.tensor(x, requires_grad=True) for x in (zi, zt, tp, b)]
    got = pfn(*args)
    got_g = torch.autograd.grad(got, args)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    for g, r in zip(got_g, ref_g):
        # Gradients of order 1 summed over 6-18 terms: f32 round-off near
        # zero (observed 2e-7) needs an absolute floor.
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_init_loss_params_match_jax():
    ref, got = jsl.init_loss_params(), psl.init_loss_params()
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == torch.float32
        assert got[k].item() == float(ref[k])


def test_default_precision_is_one_bf16_pass():
    rng = np.random.default_rng(1)
    zi, zt = (torch.from_numpy(unit_rows(rng, 5, 16)) for _ in range(2))
    tp, b = torch.tensor(2.0), torch.tensor(-3.0)
    got = psl.pairwise_logits(zi, zt, tp, b, precision="default")
    rounded = (zi.bfloat16().double() @ zt.bfloat16().double().T) * np.exp(2.0) - 3.0
    np.testing.assert_allclose(got.numpy(), rounded.numpy(), rtol=1e-6)
    assert not torch.allclose(got, psl.pairwise_logits(zi, zt, tp, b), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="precision"):
        psl.pairwise_logits(zi, zt, tp, b, precision="high")


# --- the optimizer ----------------------------------------------------------

def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "b": rng.standard_normal((4,)).astype(np.float32),
        "t": np.float32(2.3),
    }


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("schedule", ["warmup_cosine", "rsqrt", "constant"])
def test_optimizer_matches_optax(schedule, mu_dtype):
    cfg = jc.TrainConfig(learning_rate=1e-2, weight_decay=0.05, warmup_steps=2,
                         total_steps=6, schedule=schedule, adam_mu_dtype=mu_dtype)
    jtx = jts.make_optimizer(cfg)
    ptx = pts.make_optimizer(pc.TrainConfig(**dataclasses.asdict(cfg)))
    params = {k: jnp.asarray(v) for k, v in _param_tree(0).items()}
    jstate = jtx.init(params)
    names = sorted(params)
    pparams = [torch.tensor(np.asarray(params[k])) for k in names]
    pstate = ptx.init(pparams)
    rng = np.random.default_rng(1)
    for i in range(5):
        # Norms alternate around the clipping threshold of 1.0.
        scale = 2.0 if i % 2 else 0.05
        grads = {k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, params)
        params = optax.apply_updates(params, updates)
        ptx.apply(pparams, [torch.tensor(grads[k]) for k in names], pstate)
        for k, p in zip(names, pparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(params[k]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {i} {k}")
        if i == 0:  # with warmup the first update is zero
            assert all(np.array_equal(p.numpy(), v) for p, v in
                       zip(pparams, (_param_tree(0)[k] for k in names)))
    adam = jstate[1][0]
    # The clipping divisor, the global norm, is summed in another order, so a
    # clipped gradient may differ in its last f32 bit, and a stored bf16
    # moment by one bf16 ulp (2^-8 relative).
    mu_rtol = 2.0 ** -8 if mu_dtype else 1e-6
    for k, mu, nu in zip(names, pstate.mu, pstate.nu):
        assert mu.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        np.testing.assert_allclose(mu.float().numpy(), np.asarray(adam.mu[k], np.float32),
                                   rtol=mu_rtol, atol=1e-9)
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu[k]), rtol=1e-6)
    assert pstate.count == int(adam.count) == 5


@pytest.mark.parametrize("warmup", [0, 3])
def test_warmup_cosine_schedule_matches_optax(warmup):
    cfg = pc.TrainConfig(learning_rate=2e-3, warmup_steps=warmup, total_steps=20)
    ref = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup, 20)
    port = pts.make_schedule(cfg)
    for count in range(0, 25):
        np.testing.assert_allclose(port(count), float(ref(jnp.int32(count))), rtol=1e-6, atol=1e-12)


# --- accumulation -----------------------------------------------------------

def test_accum_add_bf16_matches_jax():
    rng = np.random.default_rng(2)
    acc = rng.standard_normal((64,)).astype(np.float32)
    grads = [rng.standard_normal((64,)).astype(np.float32) * 1e-2 for _ in range(4)]
    jacc = [jnp.asarray(acc, jnp.bfloat16)]
    pacc = [torch.tensor(acc).bfloat16()]
    for g in grads:
        jacc = jts.accum_add(jacc, [jnp.asarray(g)])
        pts.accum_add(pacc, [torch.tensor(g)])
    assert pacc[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(pacc[0].float().numpy(), np.asarray(jacc[0], np.float32))
    fin = pts.accum_finish(pacc, [torch.zeros(64)], scale=4)[0]
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jts.accum_finish(jacc, [jnp.zeros(64)], 4)[0]))


def test_microbatch_split_matches_jax_at_one_device():
    x = np.arange(24 * 3, dtype=np.float32).reshape(24, 3)
    ref = jax_microbatch_split(jnp.asarray(x), 4, make_mesh(1), what="accum_steps")
    np.testing.assert_array_equal(microbatch_split(torch.tensor(x), 4, what="accum_steps").numpy(), ref)
    with pytest.raises(ValueError) as jerr:
        jax_microbatch_split(jnp.asarray(x[:5]), 2, make_mesh(1), what="accum_steps")
    with pytest.raises(ValueError) as perr:
        microbatch_split(torch.tensor(x[:5]), 2, what="accum_steps")
    assert str(perr.value) == str(jerr.value)


# --- remat ------------------------------------------------------------------

def _grads_and_attention_calls(monkeypatch, remat, policy, dtype, force_fused):
    cfg = port_config(tiny(dtype=dtype, remat=remat, remat_policy=policy))
    model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    b = batch_np(tiny(), 3, seed=1)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = sa.short_self_attention_plain, sa.short_self_attention_bwd_plain

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(sa, "short_self_attention_plain", counted("fwd", fwd))
    monkeypatch.setattr(sa, "short_self_attention_bwd_plain", counted("bwd", bwd))
    if force_fused:
        monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    zi, zt, lp = model(torch.from_numpy(b["images"]), torch.from_numpy(b["tokens"]))
    psl.sigmoid_loss(zi, zt, lp["t_prime"], lp["bias"]).backward()
    return {k: p.grad for k, p in model.named_parameters()}, calls


@pytest.mark.parametrize("policy", ["nothing", "save_hot", "save_all_hot", "save_mlp"])
def test_remat_policies_give_the_grads_of_no_remat(monkeypatch, policy):
    ref, _ = _grads_and_attention_calls(monkeypatch, False, "nothing", "float32", False)
    got, _ = _grads_and_attention_calls(monkeypatch, True, policy, "float32", False)
    assert ref.keys() == got.keys()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)


# 2 blocks per tower, 2 towers: 4 fused attention layers. "nothing" and
# "save_mlp" recompute the attention forward in the backward; "save_hot" and
# "save_all_hot" keep its output (attn_core) and never run it again.
@pytest.mark.parametrize("remat,policy,forwards", [
    (False, "nothing", 4), (True, "nothing", 8), (True, "save_hot", 4),
    (True, "save_all_hot", 4), (True, "save_mlp", 8),
])
def test_attention_forward_runs_once_per_layer_under_save_hot(monkeypatch, remat, policy, forwards):
    grads, calls = _grads_and_attention_calls(monkeypatch, remat, policy, "bfloat16", True)
    assert calls == {"fwd": forwards, "bwd": 4}
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        SigLIP(port_config(tiny(remat=True, remat_policy="save_everything")), device="cpu")


# --- the whole step ---------------------------------------------------------

TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio")


def _run_both(jcfg, steps=3, accum_steps=2, n=4):
    """(jax metrics, jax params, port metrics, port state dict) after
    ``steps`` accumulated steps from the same weights and batch."""
    batch = batch_np(jcfg, n)
    jmodel = JaxSigLIP(jcfg)
    jtx = jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG))
    mesh = make_mesh(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jts.create_train_state(jax.random.key(0), jmodel, jtx, jbatch, mesh)
    params0 = jax.tree.map(np.asarray, jstate.params)
    jstep, shardings = jts.make_train_step(jmodel, mesh, jcfg.loss, accum_steps=accum_steps)
    jbatch = jax.device_put(jbatch, shardings)
    jmetrics = []
    for _ in range(steps):
        jstate, m = jstep(jstate, jbatch)
        jmetrics.append({k: float(m[k]) for k in METRICS})

    pcfg = port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params0, pcfg), strict=True)
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    pstep = pts.make_train_step(model, pcfg.loss, accum_steps=accum_steps)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pmetrics = []
    for _ in range(steps):
        state, m = pstep(state, pbatch)
        pmetrics.append({k: float(m[k]) for k in METRICS})
    assert state.step == steps and state.opt_state.count == steps
    ref_params = params_from_jax(jax.tree.map(np.asarray, jstate.params), pcfg)
    return jmetrics, ref_params, pmetrics, model.state_dict()


def test_whole_step_f32_matches_jax():
    jm, jp, pm, pp = _run_both(tiny())
    for i, (a, b) in enumerate(zip(pm, jm)):
        for k in METRICS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-9, err_msg=f"step {i} {k}")
    assert pm[0]["update_ratio"] == 0.0  # warmup: the first update is zero
    assert pm[-1]["loss"] < pm[0]["loss"]
    # Parameters at rtol 1e-4, save where Adam's g/(√v + ε) divides f32
    # round-off by its own size: the attention k-projection biases, whose
    # gradient is zero in exact arithmetic (the softmax is shift-invariant),
    # and entries whose gradient is within round-off of zero. There either
    # package may step by up to lr in either direction, so every entry is
    # held within 2·lr per non-zero update and all but 0.5% of entries at
    # rtol 1e-4 (observed: 180 of 85,954 outside, 178 of them k biases).
    lr, outside, total = TRAIN_CFG["learning_rate"], 0, 0
    for k in jp:
        got, ref = pp[k].numpy(), jp[k].numpy()
        np.testing.assert_allclose(got, ref, atol=2 * lr * 2, err_msg=k)
        outside += int((np.abs(got - ref) > 1e-6 + 1e-4 * np.abs(ref)).sum())
        total += ref.size
    assert outside <= 0.005 * total, (outside, total)


def test_whole_step_bf16_fused_path_matches_jax(monkeypatch):
    # The port takes the fused short attention (its plain versions on the
    # CPU), JAX on the CPU the dense path; both run the towers in bf16 but
    # round at different points (f32 logits in the fused path, bf16 in the
    # dense one). The loss (~3) and the metrics agree to bf16 grade, 2e-2
    # relative. Adam's first updates are lr·sign(g) wherever |g| ≫ eps, so a
    # gradient entry near zero whose sign differs moves its parameter by up
    # to 2·lr per step: after the two non-zero updates, 4·lr = 1.2e-2.
    monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    sa.reset_traced_bwd_batch_heads()
    jm, jp, pm, pp = _run_both(tiny(dtype="bfloat16"))
    assert sa.traced_bwd_batch_heads() == (False,)
    for i, (a, b) in enumerate(zip(pm, jm)):
        for k in METRICS:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-2, atol=1e-6, err_msg=f"step {i} {k}")
    for k in jp:
        np.testing.assert_allclose(pp[k].numpy(), jp[k].numpy(), atol=4 * TRAIN_CFG["learning_rate"],
                                   err_msg=k)


# --- the slice on K7 ----------------------------------------------------------

def _k7_config(dtype):
    """tiny_test with a one-layer 361-patch vision tower in ``dtype`` whose
    attention takes the fused path (``attn_impl="flash"`` in f32, ``"auto"``
    in bf16). One layer keeps the Pallas interpreter's compile short."""
    cfg = tiny(dtype=dtype)
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_size=K7_IMAGE_SIZE, depth=1,
        attn_impl="flash" if dtype == "float32" else "auto"))


def _loss_grads_both(jcfg, n=4):
    """The sigmoid loss's gradient over every parameter, JAX (its flash
    kernel in the Pallas interpreter) and the port, from the same weights and
    batch: (jax state dict, port state dict) of gradients."""
    batch = batch_np(jcfg, n)
    jmodel = JaxSigLIP(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0), batch["images"], batch["tokens"])["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))

    def loss(p):
        zi, zt, lp = jmodel.apply({"params": p}, batch["images"], batch["tokens"])
        return jsl.sigmoid_loss(zi, zt, lp["t_prime"], lp["bias"])

    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.jit(jax.grad(loss))(params)
    pcfg = port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, pcfg), strict=True)
    zi, zt, lp = model(torch.from_numpy(batch["images"]), torch.from_numpy(batch["tokens"]))
    psl.sigmoid_loss(zi, zt, lp["t_prime"], lp["bias"]).backward()
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), pcfg)
    return ref, {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_step_on_k7_matches_jax(monkeypatch, dtype):
    """One accumulated ``make_train_step`` step and the loss's gradient with
    the vision tower's self-attention on K7 in both packages (JAX's kernel in
    the Pallas interpreter, the port's plain versions). f32: metrics and
    gradients at rtol 1e-4; bf16: the grade of the bf16 step above."""
    jcfg = _k7_config(dtype)
    force_vision_onto_k7(monkeypatch, jcfg.text.context_length)
    flash_calls = []
    real = flash_attention.flash_self_attention_bwd

    def counted(*a, **kw):
        flash_calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(flash_attention, "flash_self_attention_bwd", counted)
    with pltpu.force_tpu_interpret_mode():
        jm, _, pm, _ = _run_both(jcfg, steps=1)
    # 2 microbatches, 1 vision layer: one K7 backward each.
    assert flash_calls == [361] * 2
    ref, got = _loss_grads_both(jcfg)
    assert ref.keys() == got.keys()
    if dtype == "float32":
        for k in METRICS:
            np.testing.assert_allclose(pm[0][k], jm[0][k], rtol=1e-4, atol=1e-9, err_msg=k)
        for k in ref:
            # Each entry at rtol 1e-4 over a floor of 1e-5 of the tensor's
            # largest magnitude, for entries that are sums of cancelling
            # terms: the token table's rows (a token's gradient sums over its
            # occurrences) and the k-projection biases, whose gradient is
            # zero in exact arithmetic (the softmax is shift-invariant).
            r = ref[k].numpy()
            np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-4,
                                       atol=max(1e-5 * np.abs(r).max(), 1e-6), err_msg=k)
    else:
        for k in METRICS:
            np.testing.assert_allclose(pm[0][k], jm[0][k], rtol=2e-2, atol=1e-6, err_msg=k)
        g = torch.cat([got[k].flatten() for k in ref])
        r = torch.cat([ref[k].flatten() for k in ref])
        # The bf16 grade of the port's whole-model gradient checks
        # (chip_smoke.py): cosine at least 0.999 (observed 0.99988; the
        # relative norm of the difference 1.7e-2).
        assert float(torch.nn.functional.cosine_similarity(g, r, dim=0)) >= 0.999


# --- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(family="mse"),
    dict(variant="tree"),
    dict(loss_impl="chunked", variant="ring"),
    dict(ring_overlap=True, variant="all_gather"),
    dict(family="softmax", loss_impl="chunked"),
    dict(quant="int4"),
    dict(quant="int8"),
])
def test_per_shard_loss_refusals_match_jax(kwargs):
    with pytest.raises(ValueError) as jerr:
        jax_make_per_shard_loss(**kwargs)
    with pytest.raises(ValueError) as perr:
        api.make_per_shard_loss(**kwargs)
    assert str(perr.value) == str(jerr.value)


def test_unported_loss_paths_raise():
    # The streaming loss kernel is ported (K4-K6), and since queue A item 6.2
    # its int8 mode too: quant="int8" with use_pallas builds and runs.
    z32 = torch.nn.functional.normalize(torch.randn(32, 128), dim=-1)
    int8 = api.make_per_shard_loss(use_pallas=True, quant="int8")(
        z32, z32, torch.tensor(2.3), torch.tensor(-10.0))
    full = api.make_per_shard_loss(use_pallas=True)(z32, z32, torch.tensor(2.3),
                                                    torch.tensor(-10.0))
    assert torch.isfinite(int8) and int8 != full
    torch.testing.assert_close(int8, full, rtol=2e-2, atol=0)
    z = torch.nn.functional.normalize(torch.randn(4, 8), dim=-1)
    for variant in ("ring", "all_gather"):
        values = [api.make_per_shard_loss(variant=variant, use_pallas=up)(
            z, z, torch.tensor(2.3), torch.tensor(-10.0)) for up in (False, True)]
        assert all(torch.isfinite(v) for v in values)
        torch.testing.assert_close(values[1], values[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("kwargs", [
    dict(accum_steps=0),
    dict(accum_steps=1, accum_dtype="bfloat16"),
    dict(accum_negatives="nearby"),
    dict(gradcache_embed_dtype="bfloat16"),
    dict(update_sharding="ring"),
    dict(zero1=True, update_sharding="off"),
    dict(pp_microbatches=-1),
    dict(pp_microbatches=2),
])
def test_step_arg_refusals_match_jax(kwargs):
    full = dict(accum_steps=2, accum_dtype=None, accum_negatives="local", pp_microbatches=0)
    full.update(kwargs)
    with pytest.raises(ValueError) as jerr:
        jts.validate_step_args(**full)
    with pytest.raises(ValueError) as perr:
        pts.validate_step_args(**full)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kwargs,match", [
    (dict(moe_aux_weight=0.01), "MoE"),
])
def test_unported_step_paths_raise(kwargs, match):
    """``moe_aux_weight`` (ported since, with the MoE towers) builds, and on
    a dense model refuses at the first step with JAX's message; on MoE
    towers it trains (``tests/test_torch_moe.py`` holds it to JAX)."""
    model = SigLIP(port_config(tiny()), device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig()))
    step = pts.make_train_step(model, **kwargs)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(tiny(), 4).items()}
    with pytest.raises(ValueError, match="sowed no moe_aux_loss"):
        step(state, batch)
    moe = SigLIP(port_config(tiny(moe_experts=2)), device="cpu")
    state = pts.create_train_state(moe, pts.make_optimizer(pc.TrainConfig()))
    state, metrics = pts.make_train_step(moe, **kwargs)(state, batch)
    assert match == "MoE" and np.isfinite(float(metrics["moe_aux"]))


# --- the int8 path ---------------------------------------------------------------

def _int8_config():
    """tiny_test with both towers training through the int8 STE and the
    streaming loss on: 128-d embeddings, so a microbatch of 32 is a block
    JAX's int8 kernel takes (d % 128, 32-row tiles)."""
    cfg = tiny(quant_train="int8", embed_dim=128)
    return dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, use_pallas=True))


def test_loss_quant_resolution_and_refusals_match_jax():
    """``resolve_loss_quant`` gives "int8" only for STE towers with the
    streaming loss, as JAX's; ``quant="int8"`` towers are refused in
    training with JAX's message; ``quant_train`` towers train."""
    for jcfg in (_int8_config(), tiny(quant_train="int8"), tiny(), tiny(quant="int8")):
        model = SigLIP(port_config(jcfg), device="cpu")
        assert pts.resolve_loss_quant(model, port_config(jcfg).loss) == \
            jts.resolve_loss_quant(JaxSigLIP(jcfg), jcfg.loss)
    jcfg = tiny(quant="int8")
    with pytest.raises(ValueError) as jerr:
        jts.validate_trainable_quant(JaxSigLIP(jcfg))
    with pytest.raises(ValueError) as perr:
        pts.make_train_step(SigLIP(port_config(jcfg), device="cpu"), port_config(jcfg).loss)
    assert str(perr.value) == str(jerr.value)
    pts.validate_trainable_quant(SigLIP(port_config(_int8_config()), device="cpu"))


def test_whole_step_int8_with_the_streaming_loss_matches_jax():
    """One accumulated step (2 microbatches of 32 pairs) with
    ``quant_train="int8"`` and ``use_pallas=True`` in both packages: the
    towers' int8 STE projections and the loss's int8 blocks (JAX's kernel
    in the Pallas interpreter, the port's plain versions), both recording
    ``"streaming_int8"``. Metrics at rtol 1e-4; then the loss's gradient
    over every parameter through the int8 dispatch, at rtol 1e-4 over a
    floor of 1e-5 of each tensor's largest magnitude (entries that are
    sums of cancelling terms), as the f32 whole-step test on K7 holds it."""
    from distributed_sigmoid_loss_tpu.ops import pallas_sigmoid_loss as jpl
    from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl

    jcfg = _int8_config()
    jpl.reset_traced_loss_kernels()
    ssl.reset_traced_loss_kernels()
    jm, _, pm, _ = _run_both(jcfg, steps=1, accum_steps=2, n=64)
    assert jpl.traced_loss_kernels() == ssl.traced_loss_kernels() == ("streaming_int8",)
    for k in METRICS:
        np.testing.assert_allclose(pm[0][k], jm[0][k], rtol=1e-4, atol=1e-9, err_msg=k)

    batch = batch_np(jcfg, 32)
    jmodel = JaxSigLIP(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0), batch["images"], batch["tokens"])["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))

    def loss(p):
        zi, zt, lp = jmodel.apply({"params": p}, batch["images"], batch["tokens"])
        return jpl.streaming_block_loss_or_none(zi, zt, lp["t_prime"], lp["bias"],
                                                jnp.float32(0), quant="int8")

    jgrads = jax.jit(jax.grad(loss))(params)
    pcfg = port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, pcfg), strict=True)
    zi, zt, lp = model(torch.from_numpy(batch["images"]), torch.from_numpy(batch["tokens"]))
    ssl.streaming_block_loss_or_none(zi, zt, lp["t_prime"], lp["bias"], 0,
                                     quant="int8").backward()
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), pcfg)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert ref.keys() == got.keys()
    for k in ref:
        r = ref[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-4,
                                   atol=max(1e-5 * np.abs(r).max(), 1e-6), err_msg=k)
