"""Expert parallelism (``models/moe.py`` over an ``ep`` axis) on gloo ranks
(``mp.spawn``, one spawn of four ranks for the file) against the JAX
package's MoE towers on the CPU, with the weights carried by
``params_from_jax``.

JAX shards the stacked experts (E, d, h) over the ``ep`` axis of a (dp, ep)
mesh and lets GSPMD move the token slots; its batch is split over dp only.
The port moves them by explicit all-to-alls (this file: ep = 4; ep = 2 in
``test_torch_expert_parallel_dp2.py``). On (dp, ep) = (1, 4) every
rank's loss, ``moe_aux`` and gradient equal JAX's global ones (the router
and the rest whole, each rank's experts sliced), with ``moe_num_selected``
1 and 2, a capacity that drops tokens, and Adafactor (its block RMS over
every rank's experts), in the layout of JAX's
``tests/test_moe.py`` (4 experts, top-2 in the text tower). On (2, 2) the
loss and gradient, without the aux term (whose estimator differs at dp > 1:
ROADMAP.md, deliberate differences). A checkpoint written at ep = 2
restores at ep = 1.
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
from distributed_sigmoid_loss_tpu.train.train_step import _mean_moe_aux
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, moe as pmoe, params_from_jax
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

jsl = importlib.import_module("distributed_sigmoid_loss_tpu.ops.sigmoid_loss")

WORLD, BATCH = 4, 8
TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio")
# name -> (dp, vision top-k, capacity factor, aux weight, optimizer)
CASES = {
    "dp1ep4_k1_drop": (1, 1, 0.5, 0.01, "adamw"),
    "dp1ep4_k2": (1, 2, 1.25, 0.01, "adamw"),
    "dp1ep4_k1_adafactor": (1, 1, 1.25, 0.01, "adafactor"),
    "dp2ep2_k1_drop": (2, 1, 0.5, None, "adamw"),
    "dp2ep2_k2": (2, 2, 1.25, None, "adamw"),
}
# This file's cases; test_torch_expert_parallel_dp2.py takes the others.
MINE = ("dp1ep4_k1_drop", "dp1ep4_k2", "dp1ep4_k1_adafactor")


def jax_config(k: int = 1, cf: float = 1.25) -> jc.SigLIPConfig:
    cfg = jc.SigLIPConfig.tiny_test()
    moe = dict(moe_experts=4, moe_group_size=8, moe_capacity_factor=cf)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, moe_num_selected=k, **moe),
        text=dataclasses.replace(cfg.text, moe_num_selected=2, **moe))


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def data(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            "tokens": rng.integers(0, 64, (n, 8)).astype(np.int32)}


@functools.cache
def init_params():
    b = data(2)
    params = JaxSigLIP(jax_config()).init(jax.random.key(0), b["images"], b["tokens"])["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


@functools.cache
def jax_global(name):
    """JAX on one device over the whole batch: the step's metrics and the
    global gradient of its objective (the loss, plus the aux term when
    weighted)."""
    _, k, cf, aux_w, optimizer = CASES[name]
    jcfg = jax_config(k, cf)
    model = JaxSigLIP(jcfg)
    batch = {k_: jnp.asarray(v) for k_, v in data(BATCH).items()}
    params = init_params()

    def objective(p):
        (zi, zt, lp), var = model.apply({"params": p}, batch["images"], batch["tokens"],
                                        mutable=["intermediates"])
        loss = jsl.sigmoid_loss(zi, zt, lp["t_prime"], lp["bias"])
        return loss + (aux_w or 0.0) * _mean_moe_aux(var)

    grads = jax.jit(jax.grad(objective))(params)
    mesh = make_mesh(1)
    state = jts.create_train_state(
        jax.random.key(0), model,
        jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG, optimizer=optimizer)), batch, mesh)
    state = state.replace(params=jax.device_put(params))
    step, sh = jts.make_train_step(model, mesh, jcfg.loss, moe_aux_weight=aux_w)
    _, m = step(state, jax.device_put(batch, sh))
    return ({k_: float(v) for k_, v in m.items()},
            params_from_jax(jax.tree.map(np.asarray, grads), port_config(jcfg)))


def spawn_cases(names, tmp, with_checkpoint: bool):
    cases = []
    for name in names:
        dp, k, cf, aux_w, optimizer = CASES[name]
        pcfg = port_config(jax_config(k, cf))
        cases.append((name, pcfg, params_from_jax(init_params(), pcfg), data(BATCH),
                      pc.TrainConfig(**TRAIN_CFG, optimizer=optimizer), dp, aux_w))
    ckpt = None
    if with_checkpoint:
        pcfg = port_config(jax_config())
        ckpt = (pcfg, params_from_jax(init_params(), pcfg), data(BATCH),
                pc.TrainConfig(**TRAIN_CFG), str(tmp / "ckpt"))
    return worker.spawn(ppw.ep_worker, WORLD, (cases, ckpt), tmp, timeout_s=240)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_cases(MINE, tmp_path_factory.mktemp("ep"), with_checkpoint=True)


def check_against_jax(ranks, name):
    dp, _, _, aux_w, _ = CASES[name]
    ep = WORLD // dp
    jmetrics, jgrads = jax_global(name)
    for rec in ranks:
        got = rec[name]
        keys = METRICS + (("moe_aux",) if aux_w is not None else ())
        for k in keys:
            np.testing.assert_allclose(got["metrics"][k], jmetrics[k], rtol=1e-4, atol=1e-9,
                                       err_msg=k)
        j = got["ep_index"]
        experts = {k for k, a in zip(got["grads"], got["part_axes"]) if a == "ep"}
        assert experts == {k for k in jgrads if k.endswith((".moe.wi", ".moe.wo"))}
        for k, g in got["grads"].items():
            want = jgrads[k].numpy()
            if k in experts:
                per = want.shape[0] // ep
                want = want[j * per:(j + 1) * per]
            assert g.shape == want.shape, k
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=k)


@pytest.mark.parametrize("name", MINE)
def test_every_rank_matches_jax_global_loss_aux_and_gradient(ranks, name):
    check_against_jax(ranks, name)


def test_ep2_checkpoint_restores_at_ep1(ranks):
    whole = ranks[0]["ckpt"]["whole"]
    assert whole["model.visual.encoder.blocks.0.moe.wi"].shape[0] == 4
    for rec in ranks:
        restored = rec["ckpt"]["restored"]
        assert restored.keys() == whole.keys()
        for k, v in whole.items():
            torch.testing.assert_close(restored[k], v, rtol=0, atol=0, msg=k)


def test_ep_of_one_and_the_emulated_split_are_the_replicated_layer(monkeypatch):
    """On one process, the ep code path at ep = 1 (its two all-to-alls the
    identity) is the replicated layer bit for bit; and an ep = 2 layout
    emulated in one process (each half of the experts through the same
    local expert function, the halves' outputs summed) is the replicated
    layer's output to rounding."""
    jcfg = jax_config(2, 0.5)
    pcfg = port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(init_params(), pcfg))
    layer = model.visual.encoder.blocks[0].moe
    x = torch.randn(4, 4, 32, generator=torch.Generator().manual_seed(0))
    exchanges = []
    all_to_all = pmoe.all_to_all
    monkeypatch.setattr(pmoe, "all_to_all",
                        lambda *a, **kw: exchanges.append(a[1]) or all_to_all(*a, **kw))
    with torch.no_grad():
        want = layer(x)
        assert exchanges == []
        with ProcessGrid({"ep": 1}):
            pmoe.shard_experts(model)
            got = layer(x)
    assert layer.ep_axis == "ep" and exchanges == ["ep", "ep"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    xg = x.reshape(2, 8, 32)
    probs, gates, idx = pmoe.router_topk(xg, layer.router, 2)
    cap = pmoe.moe_capacity(8, 4, 2, 0.5)
    dispatch, combine = pmoe.build_dispatch(gates, idx, 4, cap)
    halves = sum(pmoe.expert_apply(xg, dispatch[..., h * 2:(h + 1) * 2, :],
                                   combine[..., h * 2:(h + 1) * 2, :],
                                   layer.wi[h * 2:(h + 1) * 2], layer.wo[h * 2:(h + 1) * 2],
                                   torch.float32) for h in range(2))
    torch.testing.assert_close(halves.reshape(want.shape), want, rtol=1e-5, atol=1e-6)


def test_shard_experts_records_its_parameters_and_refuses_a_second_sharding():
    model = SigLIP(port_config(jax_config()), device="cpu")
    with ProcessGrid({"ep": 1}):
        pmoe.shard_experts(model)
        with pytest.raises(ValueError, match="already sharded"):
            pmoe.shard_experts(model)
    assert pmoe.expert_params(model) == {
        f"{t}.encoder.blocks.{i}.moe.{w}" for t in ("visual", "textual") for i in range(2)
        for w in ("wi", "wo")}
