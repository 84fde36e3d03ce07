"""The port's data-parallel train step at W = 2 over gloo (``mp.spawn``) vs
JAX ``make_train_step`` on ``make_mesh(2)``: the tiny SigLIP with 128-wide
embeddings (so the JAX Pallas loss kernel engages, in interpret mode), two
accumulated microbatches per step, two steps, the streaming loss kernel as
the loss body, under the ring and the chunked all-gather variants. Metrics
and parameters are held as ``tests/test_torch_train_step.py`` holds the
one-device step. Also: the ranks' own microbatch splits are JAX's
dp-interleaved split.

Rank 1 starts from other weights than rank 0: ``create_train_state`` must
broadcast rank 0's, and both ranks must end bitwise equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.ops import pallas_sigmoid_loss as jpl
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.parallel.microbatch import microbatch_split as jax_microbatch_split
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import params_from_jax
from distributed_sigmoid_loss_tpu_torch.parallel.microbatch import microbatch_split
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

WORLD, ACCUM, STEPS, BATCH = 2, 2, 2, 32  # 8 pairs per rank per microbatch
TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio")
LOSSES = {
    "ring_pallas": dict(variant="ring", use_pallas=True),
    "allgather_chunked_pallas": dict(variant="all_gather", loss_impl="chunked", use_pallas=True),
}


def jax_config(loss_kw):
    cfg = jc.SigLIPConfig.tiny_test()
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, embed_dim=128),
        text=dataclasses.replace(cfg.text, embed_dim=128),
        loss=dataclasses.replace(cfg.loss, **loss_kw),
    )


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(
        vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
        text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
        loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)),
    )


def batch_np(jcfg, n, seed=0):
    rng = np.random.default_rng(seed)
    hw = jcfg.vision.image_size
    return {
        "images": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
        "tokens": rng.integers(0, jcfg.text.vocab_size, (n, jcfg.text.context_length)).astype(np.int32),
    }


@functools.cache
def jax_run(name):
    """JAX metrics per step, initial and final params."""
    jcfg = jax_config(LOSSES[name])
    batch = batch_np(jcfg, BATCH)
    mesh = make_mesh(WORLD)
    jmodel = JaxSigLIP(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jts.create_train_state(jax.random.key(0), jmodel,
                                    jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG)), jbatch, mesh)
    params0 = jax.tree.map(np.asarray, jstate.params)
    jpl.reset_traced_loss_kernels()
    jstep, shardings = jts.make_train_step(jmodel, mesh, jcfg.loss, accum_steps=ACCUM)
    jbatch = jax.device_put(jbatch, shardings)
    metrics = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, jbatch)
        metrics.append({k: float(m[k]) for k in METRICS})
    assert jpl.traced_loss_kernels() == ("streaming",)  # JAX ran its kernel
    return jcfg, batch, params0, metrics, jax.tree.map(np.asarray, jstate.params)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, batch, params0, _, _ = jax_run(name)
            pcfg = port_config(jcfg)
            args = (params_from_jax(params0, pcfg), pcfg, batch, pc.TrainConfig(**TRAIN_CFG),
                    STEPS, ACCUM)
            cache[name] = worker.spawn(worker.train_worker, WORLD, args,
                                       tmp_path_factory.mktemp(name), timeout_s=180)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_dp_metrics_match_jax(port_run, name):
    _, _, _, jmetrics, _ = jax_run(name)
    for rank in port_run(name):
        for i, (a, b) in enumerate(zip(rank["metrics"], jmetrics)):
            for k in METRICS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-9,
                                           err_msg=f"step {i} {k}")
        assert rank["metrics"][0]["update_ratio"] == 0.0  # warmup: the first update is zero


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_dp_params_match_jax_and_stay_in_sync(port_run, name):
    """Parameters as the one-device test holds them: every entry within 2·lr
    per non-zero update, all but 0.5% at rtol 1e-4 (Adam divides round-off
    near zero by its own size); and the two ranks bitwise equal."""
    jcfg, _, _, _, jparams = jax_run(name)
    ref = params_from_jax(jparams, port_config(jcfg))
    ranks = port_run(name)
    lr, outside, total = TRAIN_CFG["learning_rate"], 0, 0
    for k in ref:
        got, want = ranks[0]["params"][k].numpy(), ref[k].numpy()
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
        np.testing.assert_allclose(got, want, atol=2 * lr * (STEPS - 1), err_msg=k)
        outside += int((np.abs(got - want) > 1e-6 + 1e-4 * np.abs(want)).sum())
        total += want.size
    assert outside <= 0.005 * total, (outside, total)


def test_rank_splits_are_jax_dp_interleaved_split():
    """Rank r's microbatch i is the i-th chunk of its own rows: JAX's split
    of the global batch over a 2-device dp mesh, piece by piece."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    ref = np.asarray(jax_microbatch_split(jnp.asarray(x), 4, make_mesh(WORLD), what="accum_steps"))
    local = [microbatch_split(torch.from_numpy(x[r * 8:(r + 1) * 8]), 4, what="accum_steps")
             for r in range(WORLD)]
    for i in range(4):
        np.testing.assert_array_equal(torch.cat([s[i] for s in local]).numpy(), ref[i])
