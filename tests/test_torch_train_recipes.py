"""The port's training recipes vs the JAX package, on the CPU: Lion and
Adafactor against optax, the EMA against ``train/ema.py``, the JAX leaf
layout Adafactor works on, and whole train steps against JAX
``make_train_step`` on a one-device mesh (GradCache, EMA, each optimizer,
the bf16 step with the head-batched backward); then GradCache against the
unaccumulated step in the port alone, at W = 1 and W = 2 over gloo.

Inputs come from numpy seeds; weights and optimizer state are carried from
JAX to the port with ``params_from_jax`` and ``opt_state_from_optax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist_worker as worker
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import ema as jema
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.models.convert import jax_leaves, param_list_from_jax
from distributed_sigmoid_loss_tpu_torch.ops import flash_attention
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa
from distributed_sigmoid_loss_tpu_torch.train import ema as pema
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc
from test_torch_train_step import METRICS, batch_np, port_config, tiny

# --- the optimizers against optax -------------------------------------------

# Leaves of every kind Adafactor tells apart: too small to factor, 1-D, 0-d,
# factored 2-D, factored with a leading depth axis (a scan_layers stack),
# and a tie between its two largest dimensions.
SHAPES = {"w": (3, 4), "b": (4,), "t": (), "big": (130, 140), "stack": (3, 128, 136),
          "tie": (2, 128, 128)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32) for k, shape in SHAPES.items()}


def _run_optimizer(cfg, updates=5):
    """(port params, port state, optax params, optax state) after ``updates``
    updates of the same gradients, their norms alternating around the
    clipping threshold."""
    jtx = jts.make_optimizer(cfg)
    ptx = pts.make_optimizer(pc.TrainConfig(**dataclasses.asdict(cfg)))
    params = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    names = sorted(params)
    jstate = jtx.init(params)
    pparams = [torch.tensor(np.asarray(params[k])) for k in names]
    pstate = ptx.init(pparams)
    rng = np.random.default_rng(1)
    for i in range(updates):
        scale = 0.5 if i % 2 else 1e-3
        grads = {k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, params)
        params = optax.apply_updates(params, upd)
        ptx.apply(pparams, [torch.tensor(grads[k]) for k in names], pstate)
    return names, pparams, pstate, params, jstate


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_lion_matches_optax(mu_dtype):
    cfg = jc.TrainConfig(optimizer="lion", learning_rate=1e-2, weight_decay=0.05,
                         warmup_steps=2, total_steps=8, adam_mu_dtype=mu_dtype)
    names, pparams, pstate, params, jstate = _run_optimizer(cfg)
    lion = jstate[1][0]
    assert pstate.count == int(lion.count) == 5
    for k, p, mu in zip(names, pparams, pstate.mu):
        np.testing.assert_allclose(p.numpy(), np.asarray(params[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert mu.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        # A clipped gradient may differ in its last f32 bit (the global norm
        # is summed in another order), so a stored bf16 moment by one ulp of
        # its own magnitude, at most 2^-7 relative (observed: 1 entry of
        # 52,224 beyond 2^-8).
        np.testing.assert_allclose(mu.float().numpy(), np.asarray(lion.mu[k], np.float32),
                                   rtol=2.0 ** -7 if mu_dtype else 1e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("schedule", ["warmup_cosine", "constant"])
def test_adafactor_matches_optax(schedule):
    cfg = jc.TrainConfig(optimizer="adafactor", learning_rate=1e-2, weight_decay=0.05,
                         warmup_steps=2, total_steps=8, schedule=schedule)
    names, pparams, pstate, params, jstate = _run_optimizer(cfg)
    fs = jstate[1][0]
    assert pstate.count == int(fs.count) == 5
    for i, k in enumerate(names):
        np.testing.assert_allclose(pparams[i].numpy(), np.asarray(params[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        for field in ("v_row", "v_col", "v"):
            got, ref = getattr(pstate, field)[i], np.asarray(getattr(fs, field)[k])
            assert tuple(got.shape) == ref.shape, (k, field)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-30,
                                       err_msg=f"{k} {field}")


def test_adafactor_factors_the_two_largest_dims_from_128():
    tx = pts.make_optimizer(pc.TrainConfig(optimizer="adafactor"))
    assert tx.factored_dims((130, 140)) == (0, 1)
    assert tx.factored_dims((3, 128, 136)) == (1, 2)
    assert tx.factored_dims((2, 128, 128)) == (1, 2)  # ties: np.argsort's order
    assert tx.factored_dims((12, 768, 3072)) == (1, 2)
    assert tx.factored_dims((127, 4096)) is None
    assert tx.factored_dims((4096,)) is None


def test_unknown_optimizer_is_refused_as_jax_refuses_it():
    cfg = jc.TrainConfig(optimizer="sgd")
    with pytest.raises(ValueError) as jerr:
        jts.make_optimizer(cfg)
    with pytest.raises(ValueError) as perr:
        pts.make_optimizer(pc.TrainConfig(**dataclasses.asdict(cfg)))
    assert str(perr.value) == str(jerr.value)


# --- the EMA ----------------------------------------------------------------

def test_ema_decay_schedule_matches_jax():
    for step in (0, 1, 5, 90, 10_000, 10 ** 7):
        for decay in (0.9999, 0.99):
            assert pema.ema_decay_schedule(step, decay).item() == float(
                jema.ema_decay_schedule(step, decay))


@pytest.mark.parametrize("step", [None, 0, 3, 10 ** 6])
def test_update_ema_matches_jax_and_keeps_bf16_leaves(step):
    rng = np.random.default_rng(4)
    ema = {"a": rng.standard_normal((5, 3)).astype(np.float32),
           "b": rng.standard_normal((7,)).astype(np.float32)}
    params = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in ema.items()}
    jema_tree = {"a": jnp.asarray(ema["a"]), "b": jnp.asarray(ema["b"], jnp.bfloat16)}
    ref = jema.update_ema(jema_tree, {k: jnp.asarray(v) for k, v in params.items()}, step=step,
                          decay=0.999)
    got = [torch.tensor(ema["a"]), torch.tensor(ema["b"]).bfloat16()]
    pema.update_ema(got, [torch.tensor(params["a"]), torch.tensor(params["b"])], step=step,
                    decay=0.999)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    assert ref["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref["a"]))
    np.testing.assert_array_equal(got[1].float().numpy(), np.asarray(ref["b"], np.float32))


def test_init_ema_is_a_detached_copy():
    p = [torch.ones(3, requires_grad=True)]
    e = pema.init_ema(p)
    assert not e[0].requires_grad and e[0].data_ptr() != p[0].data_ptr()
    assert torch.equal(e[0], p[0].detach())


# --- the JAX leaf layout ----------------------------------------------------

@pytest.mark.parametrize("scan_layers", [False, True])
def test_jax_leaves_rebuild_the_jax_tree(scan_layers):
    jcfg = tiny(scan_layers=scan_layers)
    batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg, 2).items()}
    params = jax.tree.map(np.asarray, jts.init_params(jax.random.key(1), JaxSigLIP(jcfg), batch,
                                                      make_mesh(1)))
    pcfg = port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, pcfg))
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat = {"/".join(k.key for k in path): v for path, v in flat.items()}
    leaves = jax_leaves(model)
    assert sorted(leaf.path for leaf in leaves) == sorted(flat)
    tensors = [p.detach() for p in model.parameters()]
    for leaf in leaves:
        np.testing.assert_array_equal(leaf.gather(tensors).numpy(), flat[leaf.path],
                                      err_msg=leaf.path)
    stacked = [leaf for leaf in leaves if leaf.stacked]
    assert bool(stacked) == scan_layers
    assert all(len(leaf.members) == jcfg.vision.depth for leaf in stacked)
    # scatter_ is gather's inverse.
    copies = [torch.zeros_like(t) for t in tensors]
    for leaf in leaves:
        leaf.scatter_(copies, leaf.gather(tensors))
    assert all(torch.equal(a, b) for a, b in zip(copies, tensors))


# --- whole train steps against JAX ------------------------------------------

TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)


def _jax_run(jcfg, train_kw, step_kw, steps, n, ema):
    batch = batch_np(jcfg, n)
    jmodel = JaxSigLIP(jcfg)
    jtx = jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG, **train_kw))
    mesh = make_mesh(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jts.create_train_state(jax.random.key(0), jmodel, jtx, jbatch, mesh, ema=ema)
    jstep, shardings = jts.make_train_step(jmodel, mesh, jcfg.loss, **step_kw)
    jbatch = jax.device_put(jbatch, shardings)
    states, metrics = [jax.tree.map(np.asarray, jstate)], []
    for _ in range(steps):
        jstate, m = jstep(jstate, jbatch)
        states.append(jax.tree.map(np.asarray, jstate))
        metrics.append({k: float(m[k]) for k in METRICS})
    return batch, states, metrics


def _run_both(jcfg, train_kw=(), step_kw=(), steps=3, n=8, ema=False, start=0):
    """JAX and the port over ``steps`` steps of one batch; the port starts
    from JAX's state after ``start`` steps (parameters, optimizer state and
    EMA carried over). Returns (jax metrics, port metrics, jax final state,
    port state)."""
    train_kw, step_kw = dict(train_kw), dict(step_kw)
    batch, jstates, jmetrics = _jax_run(jcfg, train_kw, step_kw, steps, n, ema)
    pcfg = port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    j0 = jstates[start]
    model.load_state_dict(params_from_jax(j0.params, pcfg), strict=True)
    tx = pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG, **train_kw))
    state = pts.create_train_state(model, tx, ema=ema)
    if start:
        state.opt_state = pts.opt_state_from_optax(j0.opt_state, tx, model)
        state.step = start
        if ema:
            state.ema = param_list_from_jax(j0.ema, model)
    pstep = pts.make_train_step(model, pcfg.loss, ema_decay=0.99 if ema else None, **step_kw)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pmetrics = []
    for _ in range(steps - start):
        state, m = pstep(state, pbatch)
        pmetrics.append({k: float(m[k]) for k in METRICS})
    assert state.step == steps and state.opt_state.count == steps
    return jmetrics[start:], pmetrics, jstates[-1], state


def _step_bound(optimizer: str, count: int) -> float:
    """The largest change of one entry in one update, in units of the
    learning rate (weight decay aside): Adam's and Lion's are 1 (an entry
    whose gradient is round-off steps by lr·sign); Adafactor's unfactored
    g/√((1−β_t)·g²) is (count+1)^0.4."""
    return (count + 1) ** 0.4 if optimizer == "adafactor" else 1.0


def _check_params(got, ref, atol, outside_share=0.005):
    """The one-device step's parameter criterion (test_torch_train_step.py):
    every entry within ``atol``, twice the updates' largest steps (an entry
    whose gradient is round-off, as the attention k-projection biases',
    whose gradient is zero in exact arithmetic, may step either way in
    either package), and all but ``outside_share`` of them at rtol 1e-4."""
    outside = total = 0
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=atol, err_msg=k)
        outside += int((np.abs(got[k].numpy() - ref[k].numpy())
                        > 1e-6 + 1e-4 * np.abs(ref[k].numpy())).sum())
        total += ref[k].numel()
    assert outside <= outside_share * total, (outside, total)


def _check_metrics(pm, jm, rtol=1e-4, **metric_rtol):
    for i, (a, b) in enumerate(zip(pm, jm)):
        for k in METRICS:
            np.testing.assert_allclose(a[k], b[k], rtol=metric_rtol.get(k, rtol), atol=1e-9,
                                       err_msg=f"step {i} {k}")


STEP_CASES = {
    "gradcache_sigmoid_accum2": dict(step_kw=dict(accum_steps=2, accum_negatives="global")),
    "gradcache_softmax_accum4": dict(family="softmax",
                                     step_kw=dict(accum_steps=4, accum_negatives="global")),
    # The bf16 stash rounds the embeddings: two steps, both from the same
    # parameters (the first update is zero), so no bf16 rounding can flip on
    # an f32 round-off difference of the weights.
    "gradcache_sigmoid_bf16_stash": dict(steps=2, step_kw=dict(
        accum_steps=2, accum_negatives="global", gradcache_embed_dtype="bfloat16")),
    "gradcache_softmax_ring_bf16_stash": dict(
        family="softmax", variant="ring", steps=2,
        step_kw=dict(accum_steps=4, accum_negatives="global", gradcache_embed_dtype="bfloat16")),
    "ema_adamw": dict(ema=True, step_kw=dict(accum_steps=2)),
    "lion": dict(train_kw=dict(optimizer="lion", adam_mu_dtype="bfloat16")),
    "lion_from_step_2": dict(train_kw=dict(optimizer="lion"), start=2, steps=4, ema=True),
    "adafactor": dict(train_kw=dict(optimizer="adafactor")),
    "adafactor_scan_layers_from_step_2": dict(train_kw=dict(optimizer="adafactor"),
                                              scan_layers=True, start=2, steps=4),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_whole_step_matches_jax(case):
    kw = dict(STEP_CASES[case])
    loss = {k: kw.pop(k) for k in ("family", "variant") if k in kw}
    jcfg = tiny(scan_layers=kw.pop("scan_layers", False))
    jcfg = dataclasses.replace(jcfg, loss=dataclasses.replace(jcfg.loss, **loss))
    jm, pm, jfinal, state = _run_both(jcfg, **kw)
    optimizer = kw.get("train_kw", {}).get("optimizer", "adamw")
    metric_rtol, outside_share = {}, 0.005
    if optimizer == "adafactor":
        # Adafactor steps an entry whose gradient is round-off (the 192
        # attention k-projection bias entries of 85,954) by up to
        # (count+1)^0.4·lr, by a different amount in each package, where
        # Adam and Lion step by lr: the norm of the change moves by up to
        # 1e-3 relative (observed 3.0e-4).
        metric_rtol["update_ratio"] = 1e-3
    if kw.get("step_kw", {}).get("gradcache_embed_dtype"):
        # The loss reads the bf16 stash alike in both (f32 products of the
        # rounded embeddings); its cotangents dL/dZ do not: JAX transposes a
        # bf16 product, rounding the cotangents to bf16 at points the port
        # (f32 cotangents) does not. The gradients agree to bf16 grade,
        # 2^-8 (observed 1.9e-4 in the global norm).
        # Adam's first update is lr·sign(g), so an entry whose gradient is
        # within that error of zero may step the other way: 1% of the
        # entries (observed 434 of 85,954).
        metric_rtol.update(grad_norm=2.0 ** -8, update_ratio=2.0 ** -8)
        outside_share = 0.01
    _check_metrics(pm, jm, **metric_rtol)
    # Update `count` uses lr(count) <= lr; count 0 is zero (warmup).
    start, steps = kw.get("start", 0), kw.get("steps", 3)
    atol = 2 * TRAIN_CFG["learning_rate"] * sum(
        _step_bound(optimizer, c) for c in range(max(start, 1), steps))
    _check_params(state.model.state_dict(), params_from_jax(jfinal.params, port_config(jcfg)),
                  atol, outside_share)
    if kw.get("ema"):
        ref = param_list_from_jax(jfinal.ema, state.model)
        for got, r in zip(state.ema, ref):
            np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-4, atol=atol)


def test_whole_step_bf16_head_batched_backward_matches_jax(monkeypatch):
    # As the K2 test in test_torch_train_step.py: the port takes the fused
    # short attention (its plain versions on the CPU), here with the
    # head-batched backward; JAX on the CPU the dense path. bf16 grade:
    # metrics at 2e-2, parameters within 4·lr.
    monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    sa.set_bwd_batch_heads(True)
    sa.reset_traced_bwd_batch_heads()
    try:
        jm, pm, jfinal, state = _run_both(tiny(dtype="bfloat16"), step_kw=dict(accum_steps=2),
                                          n=4)
        assert sa.traced_bwd_batch_heads() == (True,)
    finally:
        sa.set_bwd_batch_heads(False)
        sa.reset_traced_bwd_batch_heads()
    _check_metrics(pm, jm, rtol=2e-2)
    ref = params_from_jax(jfinal.params, port_config(tiny(dtype="bfloat16")))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=4 * TRAIN_CFG["learning_rate"],
                                   err_msg=k)


def test_ema_without_ema_state_is_refused_as_jax_refuses_it():
    model = SigLIP(port_config(tiny()), device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig()))
    step = pts.make_train_step(model, ema_decay=0.999)
    with pytest.raises(ValueError, match=r"state.ema is None .* ema=True"):
        step(state, {k: torch.from_numpy(v) for k, v in batch_np(tiny(), 2).items()})


# --- GradCache in the port alone --------------------------------------------

def _port_step(pcfg, state_dict, batch, **step_kw):
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(state_dict)
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    step = pts.make_train_step(model, pcfg.loss, **step_kw)
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in METRICS})
    return metrics, model.state_dict()


@pytest.mark.parametrize("family", ["sigmoid", "softmax"])
@pytest.mark.parametrize("accum_steps", [2, 4])
def test_gradcache_equals_the_unaccumulated_step(family, accum_steps):
    pcfg = port_config(tiny())
    pcfg = dataclasses.replace(pcfg, loss=dataclasses.replace(pcfg.loss, family=family))
    state_dict = SigLIP(pcfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    batch = {k: torch.from_numpy(v) for k, v in batch_np(tiny(), 8, seed=2).items()}
    ref_m, ref_p = _port_step(pcfg, state_dict, batch)
    got_m, got_p = _port_step(pcfg, state_dict, batch, accum_steps=accum_steps,
                              accum_negatives="global")
    _check_metrics(got_m, ref_m)
    _check_params(got_p, ref_p, 2 * TRAIN_CFG["learning_rate"])  # one non-zero update


def test_gradcache_equals_the_unaccumulated_step_at_w2(tmp_path):
    pcfg = port_config(tiny())
    pcfg = dataclasses.replace(pcfg, loss=dataclasses.replace(pcfg.loss, variant="all_gather"))
    state_dict = SigLIP(pcfg, device="cpu", generator=torch.Generator().manual_seed(4)).state_dict()
    batch = batch_np(tiny(), 16, seed=5)
    ranks = worker.spawn(worker.gradcache_worker, 2,
                         (state_dict, pcfg, batch, pc.TrainConfig(**TRAIN_CFG), 4), tmp_path,
                         timeout_s=180)
    # The single-process step on the whole batch is the oracle of both.
    ref_m, ref_p = _port_step(pcfg, state_dict, {k: torch.from_numpy(v) for k, v in batch.items()})
    for res in ranks:
        for run in ("gradcache", "unaccumulated"):
            _check_metrics(res[run]["metrics"], ref_m)
            _check_params(res[run]["params"], ref_p, 2 * TRAIN_CFG["learning_rate"])
