"""Sequence-parallel towers and the dp × sp train step of the port over
gloo ranks (``mp.spawn``, one spawn of four ranks for the file), against
the JAX package's sequence-parallel towers on a virtual CPU mesh, with the
weights carried across by ``models/convert.py``.

- Text and vision towers, ring and Ulysses, at sp = 4: embeddings, and every
  rank's gradient of every parameter equal to JAX's global gradient (each
  rank computes the towers' non-attention work on the whole sequence, and
  the sequence scatter/gather count that gradient once, not four times).
- Three steps of the train step on a (dp, sp) = (2, 2) grid against JAX's
  ``make_train_step`` on a (dp, sp, tp) = (2, 2, 1) mesh (JAX's
  ``test_train_step_with_sequence_parallel_text_tower`` composition): batch
  rows over dp, the ring loss and the gradient mean over dp.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_dist_worker as worker
import _torch_sp_workers as sp_workers
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import params_from_jax
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

WORLD, DP = 4, 2
STEPS, BATCH = 3, 8
TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio")
TOWERS = [f"{impl}_{tower}" for impl in ("ring", "ulysses") for tower in ("text", "vision")]
TOWERS += ["ring_text_remat"]  # checkpointed blocks: the recompute runs the ring again


def jax_config(impl: str | None, towers=("text", "vision"), remat=False) -> jc.SigLIPConfig:
    """f32 towers, 4 heads (Ulysses at sp = 4), 64 patches and 16 tokens."""
    vision = jc.ViTConfig(image_size=32, patch_size=4, width=32, depth=2, num_heads=4,
                          embed_dim=16, dtype="float32", remat=False, scan_layers=False)
    text = jc.TextConfig(vocab_size=64, context_length=16, width=32, depth=2, num_heads=4,
                         embed_dim=16, dtype="float32", remat=False, scan_layers=False)
    sp = dict(sequence_parallel_axis="sp", sequence_parallel_impl=impl) if impl else {}
    if remat:
        sp.update(remat=True, remat_policy="save_hot")
    return jc.SigLIPConfig(
        vision=dataclasses.replace(vision, **(sp if "vision" in towers else {})),
        text=dataclasses.replace(text, **(sp if "text" in towers else {})),
        loss=jc.LossConfig(variant="ring"))


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def data(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            "tokens": rng.integers(0, 64, (n, 16)).astype(np.int32)}


@functools.cache
def init_params():
    jcfg = jax_config(None)
    batch = data(2)
    params = JaxSigLIP(jcfg).init(jax.random.key(0), jnp.asarray(batch["images"]),
                                  jnp.asarray(batch["tokens"]))["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def cotangents():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2, 16)).astype(np.float32),
            rng.standard_normal((2, 16)).astype(np.float32))


def tower_case(name):
    impl, tower, *remat = name.split("_")
    return impl, (tower,), bool(remat)


@functools.cache
def jax_towers(name):
    """JAX's sp model on mesh(4, "sp"): embeddings and the global gradient
    of <zimg, c_img> + <ztxt, c_txt>, in the port's names."""
    jcfg = jax_config(*tower_case(name))
    model, params, batch = JaxSigLIP(jcfg), init_params(), data(2)
    c_img, c_txt = cotangents()

    def objective(p):
        zimg, ztxt, _ = model.apply({"params": p}, jnp.asarray(batch["images"]),
                                    jnp.asarray(batch["tokens"]))
        return (zimg * c_img).sum() + (ztxt * c_txt).sum(), (zimg, ztxt)

    with jax.set_mesh(make_mesh(WORLD, "sp")):
        (_, (zimg, ztxt)), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
    return (np.asarray(zimg), np.asarray(ztxt),
            params_from_jax(jax.tree.map(np.asarray, grads), port_config(jcfg)))


@functools.cache
def jax_step():
    """JAX's dp × sp step: metrics per step and the final parameters."""
    jcfg = jax_config("ring", ("text", "vision"))
    model = JaxSigLIP(jcfg)
    batch = {k: jnp.asarray(v) for k, v in data(BATCH, seed=1).items()}
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(DP, WORLD // DP, 1),
                ("dp", "sp", "tp"))
    with jax.set_mesh(mesh):
        state = jts.create_train_state(jax.random.key(0), model,
                                       jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG)), batch,
                                       mesh)
        state = state.replace(params=jax.device_put(init_params()))
        step, shardings = jts.make_train_step(model, mesh, jcfg.loss)
        batch = jax.device_put(batch, shardings)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(m[k]) for k in METRICS})
    return metrics, params_from_jax(jax.tree.map(np.asarray, state.params), port_config(jcfg))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    batch = data(2)
    c_img, c_txt = cotangents()
    cases = []
    for name in TOWERS:
        pcfg = port_config(jax_config(*tower_case(name)))
        cases.append((name, pcfg, params_from_jax(init_params(), pcfg), batch["images"],
                      batch["tokens"], c_img, c_txt))
    pcfg = port_config(jax_config("ring"))
    step_case = (pcfg, params_from_jax(init_params(), pcfg), data(BATCH, seed=1),
                 pc.TrainConfig(**TRAIN_CFG), STEPS, DP)
    return worker.spawn(sp_workers.towers_worker, WORLD, (cases, step_case),
                        tmp_path_factory.mktemp("long_context"), timeout_s=300)


@pytest.mark.parametrize("name", TOWERS)
def test_sp_towers_match_jax(ranks, name):
    zimg, ztxt, _ = jax_towers(name)
    for rec in ranks:
        np.testing.assert_allclose(rec[name]["zimg"].numpy(), zimg, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(rec[name]["ztxt"].numpy(), ztxt, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", TOWERS)
def test_every_rank_gradient_is_jax_global_gradient(ranks, name):
    """Each rank's gradient of every parameter equals JAX's global one: a
    W-fold count (a plain all-gather leaving the core) would be off by 4×."""
    _, _, grads = jax_towers(name)
    for rec in ranks:
        got = rec[name]["grads"]
        assert got.keys() == {k for k, g in grads.items() if k in got}
        for k, g in got.items():
            want = grads[k].numpy()
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=k)


def test_dp_sp_step_matches_jax(ranks):
    jmetrics, jparams = jax_step()
    for rec in ranks:
        for i, (a, b) in enumerate(zip(rec["step"]["metrics"], jmetrics)):
            for k in METRICS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-9,
                                           err_msg=f"step {i} {k}")
    lr = TRAIN_CFG["learning_rate"]
    outside, total = 0, 0
    for k, want in jparams.items():
        for rec in ranks:
            torch.testing.assert_close(rec["step"]["params"][k], ranks[0]["step"]["params"][k],
                                       rtol=0, atol=0)
        got = ranks[0]["step"]["params"][k].numpy()
        np.testing.assert_allclose(got, want.numpy(), atol=2 * lr * (STEPS - 1), err_msg=k)
        # Each entry within a step's move; nearly all within rounding.
        outside += int((np.abs(got - want.numpy()) > 1e-6 + 1e-4 * np.abs(want.numpy())).sum())
        total += want.numel()
    assert outside <= 0.005 * total, (outside, total)
