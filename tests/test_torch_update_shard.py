"""Update sharding (``parallel/update_shard.py`` and the train step's
``update_sharding``) against the JAX package on the CPU.

- The placement rule and its helpers equal JAX's on a table of shapes.
- The regular step at dp = 2 over gloo ranks: ``"full"`` and ``"zero1"``
  give the replicated update (AdamW, Lion, Adafactor; two steps), the
  AdamW ``"full"`` run matches JAX's ``make_train_step(update_sharding=
  "full")``, and the optimizer's bytes on a rank drop under ``"full"``.
- Checkpoints stay portable: a ``"full"`` state's checkpoint holds whole
  moments and restores into ``"off"``, ``"zero1"`` and ``"full"`` states,
  each of which trains on.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_compression_workers as cw
import _torch_dist_worker as worker
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel import update_shard as jus
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.parallel import update_shard as pus
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

WORLD, STEPS, BATCH = 2, 2, 8
TRAIN = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
OPTIMIZERS = ("adamw", "lion", "adafactor")
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio")
SHAPES = [(), (1,), (2,), (3,), (7, 4), (8, 3), (1, 4, 32), (16, 2, 2), (9, 6)]


@pytest.mark.parametrize("mode", ["off", "zero1", "full"])
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_placement_rule_matches_jax(mode, w):
    for shape in SHAPES:
        assert pus.shardable(shape, w, mode) == jus.shardable(shape, w, mode), shape
        assert pus.ef_slot_shape(shape, 2, w, mode) == jus.ef_slot_shape(shape, 2, w, mode)
        if shape:
            assert pus.padded_rows(shape[0], w) == jus.padded_rows(shape[0], w)
    params = [np.zeros(s, np.float32) for s in SHAPES]
    assert pus.shard_leaf_sizes([torch.from_numpy(p) for p in params], w, mode) == \
        jus.shard_leaf_sizes(params, w, mode)


@pytest.mark.parametrize("args", [("", False), ("", True), ("full", False), ("zero1", True),
                                  ("off", True), ("bogus", False)])
def test_resolve_update_sharding_matches_jax(args):
    try:
        want = jus.resolve_update_sharding(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pus.resolve_update_sharding(*args)
        assert str(err.value) == str(e)
        return
    assert pus.resolve_update_sharding(*args) == want


def test_full_needs_two_ranks_and_states_must_match_the_step():
    """``"full"`` over one rank is refused with JAX's message where the
    state is laid out; the step takes its mode from the state, and so do
    the residuals of :func:`with_error_feedback`."""
    from distributed_sigmoid_loss_tpu_torch.train.compressed_step import with_error_feedback

    cfg = pc.SigLIPConfig.tiny_test()
    model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tx = pts.make_optimizer(pc.TrainConfig(**TRAIN))
    with pytest.raises(ValueError) as err:
        pts.create_train_state(model, tx, update_sharding="full")
    assert str(err.value) == "update_sharding='full' requires a dp axis of size > 1, got 'dp'=1"
    state = with_error_feedback(pts.create_train_state(model, tx, zero1=True))
    assert state.update_sharding == "zero1"
    assert [e.shape for e in state.ef] == [p.shape for p in model.parameters()]
    batch = {k: torch.from_numpy(v) for k, v in batch_np(4).items()}
    state, _ = pts.make_train_step(model, cfg.loss)(state, batch)
    assert state.update_sharding == "zero1" and state.step == 1


def test_zero1_at_one_rank_is_the_replicated_step():
    """A dp axis of one rank shards nothing: zero1 is the plain step."""
    cfg = pc.SigLIPConfig.tiny_test()
    batch = {k: torch.from_numpy(v) for k, v in batch_np(4).items()}
    out = []
    for mode in ("off", "zero1"):
        model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN)),
                                       update_sharding=mode)
        assert (state.layout is None) == (mode == "off")
        step = pts.make_train_step(model, cfg.loss)
        for _ in range(2):
            state, m = step(state, batch)
        out.append(model.state_dict())
    for k in out[0]:
        torch.testing.assert_close(out[1][k], out[0][k], rtol=0, atol=0)


def jax_config():
    return jc.SigLIPConfig.tiny_test()


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def batch_np(n, seed=0):
    cfg = jax_config()
    rng = np.random.default_rng(seed)
    hw = cfg.vision.image_size
    return {"images": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            "tokens": rng.integers(0, cfg.text.vocab_size,
                                   (n, cfg.text.context_length)).astype(np.int32)}


@functools.cache
def jax_full():
    """JAX's step with full update sharding on mesh(2): params0, metrics,
    final params."""
    jcfg = jax_config()
    mesh = make_mesh(WORLD)
    model = JaxSigLIP(jcfg)
    batch = {k: jnp.asarray(v) for k, v in batch_np(BATCH).items()}
    state = jts.create_train_state(jax.random.key(0), model,
                                   jts.make_optimizer(jc.TrainConfig(**TRAIN)), batch, mesh,
                                   update_sharding="full")
    params0 = jax.tree.map(np.asarray, state.params)
    step, shardings = jts.make_train_step(model, mesh, jcfg.loss, update_sharding="full")
    batch = jax.device_put(batch, shardings)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in METRICS})
    return (params0, metrics,
            params_from_jax(jax.tree.map(np.asarray, state.params), port_config(jcfg)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pcfg = port_config(jax_config())
    params0, _, _ = jax_full()
    runs = [(f"{opt}/{mode}", pc.TrainConfig(optimizer=opt, **TRAIN), mode)
            for opt in OPTIMIZERS for mode in ("off", "zero1", "full")]
    out = tmp_path_factory.mktemp("update_shard")
    return worker.spawn(cw.update_shard_worker, WORLD,
                        (runs, params_from_jax(params0, pcfg), pcfg, batch_np(BATCH), STEPS,
                         str(out)), out, timeout_s=300)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("mode", ["zero1", "full"])
def test_sharded_update_equals_replicated(ranks, optimizer, mode):
    for rec in ranks:
        off, got = rec[f"{optimizer}/off"], rec[f"{optimizer}/{mode}"]
        for a, b in zip(got["metrics"], off["metrics"]):
            for k in METRICS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-9, err_msg=k)
        for k, want in off["tensors"].items():
            torch.testing.assert_close(got["tensors"][k], want, rtol=1e-5, atol=1e-7, msg=k)
    for k, t in ranks[0][f"{optimizer}/{mode}"]["tensors"].items():
        assert torch.equal(t, ranks[1][f"{optimizer}/{mode}"]["tensors"][k]), k


def test_full_update_matches_jax(ranks):
    _, jmetrics, jparams = jax_full()
    lr = TRAIN["learning_rate"]
    for rec in ranks:
        for i, (a, b) in enumerate(zip(rec["adamw/full"]["metrics"], jmetrics)):
            for k in METRICS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-9,
                                           err_msg=f"step {i} {k}")
        outside, total = 0, 0
        for k, want in jparams.items():
            got = rec["adamw/full"]["tensors"][f"model.{k}"].numpy()
            np.testing.assert_allclose(got, want.numpy(), atol=2 * lr * (STEPS - 1), err_msg=k)
            # Each entry within a step's move; nearly all within rounding.
            outside += int((np.abs(got - want.numpy())
                            > 1e-6 + 1e-4 * np.abs(want.numpy())).sum())
            total += want.numel()
        assert outside <= 0.005 * total, (outside, total)


def test_full_sharding_shrinks_adam_and_lion_state_per_rank(ranks):
    """AdamW's and Lion's moments of every tensor with a leading dim of 2 or
    more are halved at dp = 2; Adafactor's factored statistics stay whole
    (ROADMAP.md, deliberate differences)."""
    for rec in ranks:
        for opt in ("adamw", "lion"):
            assert rec[f"{opt}/full"]["opt_bytes"] < 0.6 * rec[f"{opt}/off"]["opt_bytes"]
            assert rec[f"{opt}/zero1"]["opt_bytes"] < rec[f"{opt}/off"]["opt_bytes"]
        assert rec["adafactor/full"]["opt_bytes"] == rec["adafactor/off"]["opt_bytes"]


@pytest.mark.parametrize("target", ["off", "zero1", "full"])
def test_full_checkpoint_restores_into_every_mode(ranks, target):
    for rec in ranks:
        saved = rec["adamw/full"]["tensors"]
        restored = rec["restored"][target]
        assert restored.keys() == saved.keys()
        for k, t in saved.items():
            assert torch.equal(restored[k], t), k
        assert np.isfinite(rec["restored"][target + "/next_loss"])
    losses = {ranks[0]["restored"][m + "/next_loss"] for m in ("off", "zero1", "full")}
    assert max(losses) - min(losses) < 1e-5
    # The asynchronous saver writes the same checkpoint (rank 0 writes,
    # every rank's wait covers it).
    assert all(rec["async_equal"] for rec in ranks)
