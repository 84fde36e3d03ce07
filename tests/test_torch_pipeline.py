"""The port's pipeline towers (``parallel/pp_towers.py``,
``pp_microbatches`` in the train step) over gloo ranks (``mp.spawn``, one
spawn of four ranks for the file); the schedules themselves are
``test_torch_pipeline_schedules.py``'s.

JAX's dp × pp oracle skips on CPU hosts (``tests/test_pipeline.py``), so
the port's pipeline is held to JAX's own ``test_pp_train_step_matches_non_pp``
oracle instead: JAX's non-pp step on the same parameters and batch.

- The train step at pp = 4 (M = 4) and dp × pp = 2 × 2 (M = 1, 2), in the
  GPipe and the 1F1B schedule: every rank's metrics, and the synced
  gradient of every parameter it holds, equal to JAX's non-pp step's and
  global gradient at rtol 1e-4 in f32; the parameters after two steps
  within AdamW's move of JAX's.
- A checkpoint written at (dp, pp) = (2, 2) restores onto a plain dp = 4
  grid (JAX's ``test_pp_checkpoint_restores_onto_plain_dp_mesh``), with
  the towers of equal depth and with a text tower half the vision tower's
  depth (as L/14's 24 and 12 blocks), each stage's blocks under their
  whole-model names.
"""

import dataclasses
import functools
import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import _torch_pp_ep_workers as ppw
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

jsl = importlib.import_module("distributed_sigmoid_loss_tpu.ops.sigmoid_loss")

WORLD, BATCH = 4, 8
TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio")
# (name, dp, M, schedule, remat, optimizer)
STEP_CASES = [("pp4_m4_gpipe", 1, 4, "gpipe", False, "adamw"),
              ("pp4_m4_1f1b", 1, 4, "1f1b", False, "adamw"),
              ("dp2pp2_m1_gpipe", 2, 1, "gpipe", False, "adamw"),
              ("dp2pp2_m2_gpipe_remat", 2, 2, "gpipe", True, "adamw"),
              ("dp2pp2_m2_1f1b", 2, 2, "1f1b", False, "adamw"),
              ("dp2pp2_m2_gpipe_adafactor", 2, 2, "gpipe", False, "adafactor")]
# This file's; test_torch_pipeline_adafactor.py takes the Adafactor ones.
MINE = [c for c in STEP_CASES if c[-1] == "adamw"]
STEPS = 2


def jax_config(remat=False, text_depth=4) -> jc.SigLIPConfig:
    """tiny_test with four scanned blocks in the vision tower and
    ``text_depth`` in the text tower (pp = 4 divides four)."""
    cfg = jc.SigLIPConfig.tiny_test()
    kw = dict(depth=4, scan_layers=True)
    if remat:
        kw.update(remat=True, remat_policy="save_hot")
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **kw),
                               text=dataclasses.replace(cfg.text, **dict(kw, depth=text_depth)))


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def data(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            "tokens": rng.integers(0, 64, (n, 8)).astype(np.int32)}


@functools.cache
def init_params():
    batch = data(2)
    params = JaxSigLIP(jax_config()).init(jax.random.key(0), batch["images"],
                                          batch["tokens"])["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


@functools.cache
def jax_reference(remat=False, optimizer="adamw"):
    """JAX's non-pp step on one device over the whole batch: metrics per
    step, the parameters after, and the global gradient at the start."""
    jcfg = jax_config(remat)
    model = JaxSigLIP(jcfg)
    batch = {k: jnp.asarray(v) for k, v in data(BATCH, seed=1).items()}
    params = init_params()

    def loss(p):
        zi, zt, lp = model.apply({"params": p}, batch["images"], batch["tokens"])
        return jsl.sigmoid_loss(zi, zt, lp["t_prime"], lp["bias"])

    grads = jax.jit(jax.grad(loss))(params)
    mesh = make_mesh(1)
    state = jts.create_train_state(
        jax.random.key(0), model,
        jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG, optimizer=optimizer)), batch, mesh)
    state = state.replace(params=jax.device_put(params))
    step, shardings = jts.make_train_step(model, mesh, jcfg.loss)
    batch = jax.device_put(batch, shardings)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in METRICS})
    pcfg = port_config(jcfg)
    return (metrics, params_from_jax(jax.tree.map(np.asarray, state.params), pcfg),
            params_from_jax(jax.tree.map(np.asarray, grads), pcfg))


def spawn_cases(cases, optimizer: str, tmp):
    """The worker over ``cases`` of STEP_CASES and a checkpoint round trip
    with ``optimizer``."""
    steps = []
    for name, dp, m, schedule, remat, opt in cases:
        pcfg = port_config(jax_config(remat))
        steps.append((name, pcfg, params_from_jax(init_params(), pcfg), data(BATCH, seed=1),
                      pc.TrainConfig(**TRAIN_CFG, optimizer=opt), dp, m, schedule, STEPS))
    pcfg = port_config(jax_config())
    train_cfg = pc.TrainConfig(**TRAIN_CFG, optimizer=optimizer)
    ckpts = [(optimizer, pcfg, params_from_jax(init_params(), pcfg), data(BATCH, seed=1),
              train_cfg, str(tmp / "ckpt"))]
    if optimizer == "adamw":
        # The text tower at half the vision tower's depth: one block a
        # stage against two.
        short = port_config(jax_config(text_depth=2))
        ckpts.append((f"{optimizer}_text_depth_2", short,
                      SigLIP(short, device="cpu").state_dict(), data(BATCH, seed=1), train_cfg,
                      str(tmp / "ckpt")))
    return worker.spawn(ppw.pipeline_worker, WORLD, (steps, ckpts), tmp, timeout_s=240)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_cases(MINE, "adamw", tmp_path_factory.mktemp("pipeline"))


def check_step_against_jax(ranks, name, dp, remat, optimizer):
    jmetrics, jparams, jgrads = jax_reference(remat, optimizer)
    lr = TRAIN_CFG["learning_rate"]
    held = set()
    for rec in ranks:
        got = rec[name]
        for i, (a, b) in enumerate(zip(got["metrics"], jmetrics)):
            for k in METRICS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-9,
                                           err_msg=f"step {i} {k}")
        for k, g in got["grads"].items():
            want = jgrads[k].numpy()
            # The atol floor of the sp tests: key biases' gradients are
            # rounding noise (~1e-8) in both packages.
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=k)
        for k, p in got["params"].items():
            if optimizer == "adafactor" and k.endswith("attn.k.bias"):
                # A key bias's gradient is rounding noise in both packages
                # (softmax is invariant to it), and Adafactor scales each
                # entry's update to the learning rate whatever its size.
                continue
            np.testing.assert_allclose(p.numpy(), jparams[k].numpy(), rtol=0, atol=2 * lr,
                                       err_msg=k)
        held |= got["params"].keys()
    # Every parameter lives on some stage; a block on exactly 1 of S stages.
    assert held == jparams.keys()
    blocks = [k for k in ranks[0][name]["params"] if ".encoder.blocks." in k]
    assert len(blocks) * (WORLD // dp) == len([k for k in jparams if ".encoder.blocks." in k])


@pytest.mark.parametrize("name,dp,m,schedule,remat,optimizer", MINE)
def test_pp_train_step_matches_jax_non_pp_step(ranks, name, dp, m, schedule, remat, optimizer):
    check_step_against_jax(ranks, name, dp, remat, optimizer)


def check_checkpoint(ranks, name, text_depth=4):
    """AdamW's moments and the EMA by parameter, Adafactor's statistics by
    stacked JAX leaf (the stages' layers joined along the stack): whole in
    the checkpoint, equal after a restore on a plain dp = 4 grid, and after
    one back onto the stages; every stage's parameters in it under their
    whole-model names."""
    whole = ranks[0][f"ckpt_{name}"]["whole"]
    for rec in ranks:
        got = rec[f"ckpt_{name}"]
        assert got["step"] == 1 and got["count"] == 1
        for restored in (got["restored"], got["again"]):
            assert restored.keys() == whole.keys()
            for k, v in whole.items():
                torch.testing.assert_close(restored[k], v, rtol=0, atol=0, msg=k)
        for k, v in got["held"].items():
            torch.testing.assert_close(whole[f"model.{k}"], v, rtol=0, atol=0, msg=k)
    # Stage 1's blocks (the second half of each tower) are in the whole
    # checkpoint, and no block past a tower's depth.
    for tower, depth in (("visual", 4), ("textual", text_depth)):
        layers = {int(k.split(".encoder.blocks.")[1].split(".")[0])
                  for k in whole if f"model.{tower}.encoder.blocks." in k}
        assert layers == set(range(depth)), (tower, layers)
    if name == "adafactor":
        assert whole["opt.v.visual/encoder/blocks/block/mlp/wi/bias"].shape[0] == 4


def test_pp_checkpoint_restores_onto_plain_dp_grid(ranks):
    check_checkpoint(ranks, "adamw")


def test_pp_checkpoint_of_towers_of_unequal_depth_restores_onto_plain_dp_grid(ranks):
    check_checkpoint(ranks, "adamw_text_depth_2", text_depth=2)
