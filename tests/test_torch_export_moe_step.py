"""The MoE train step's export at ep = 1 (split off from
``test_torch_export_moe.py`` to keep each file's time down): the artifact of
``make_functional_train_step(moe_aux_weight=...)`` replays bitwise equal to
the function called live, two steps in a row, and that step and the eager
step from the same weights equal JAX's ``make_train_step(moe_aux_weight=...)``:
loss, ``moe_aux`` and the updated parameters at rtol 1e-4 in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.train import (
    create_train_state,
    export_step,
    load_exported,
    make_functional_train_step,
    make_optimizer,
    make_train_step,
    save_exported,
    train_state_tree,
    tree_leaves,
)
from distributed_sigmoid_loss_tpu_torch.utils import config as pc
from test_torch_export_moe import assert_bitwise, data, jax_config, jax_params, port_config

TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
AUX = 0.01


def test_moe_train_step_artifact_replays_bitwise_and_matches_jax(tmp_path):
    """Top-1 vision experts that drop tokens (capacity factor 0.5), top-2
    text experts."""
    jcfg = jax_config(1, 0.5)
    params0 = jax_params(jcfg)
    batch_np = data()
    # JAX's step on one device, the aux term weighted.
    jmodel = JaxSigLIP(jcfg)
    jbatch = {key: jnp.asarray(v) for key, v in batch_np.items()}
    mesh = make_mesh(1)
    jstate = jts.create_train_state(jax.random.key(0), jmodel,
                                    jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG)), jbatch, mesh)
    jstate = jstate.replace(params=jax.device_put(params0))
    jstep, sh = jts.make_train_step(jmodel, mesh, jcfg.loss, moe_aux_weight=AUX)
    jstate, jm = jstep(jstate, jax.device_put(jbatch, sh))
    jstate, jm2 = jstep(jstate, jax.device_put(jbatch, sh))
    pcfg = port_config(jcfg)
    jparams = params_from_jax(jax.tree.map(np.asarray, jstate.params), pcfg)

    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params0, pcfg))
    tx = make_optimizer(pc.TrainConfig(**TRAIN_CFG))
    state = create_train_state(model, tx)
    loss_cfg = pc.LossConfig(**dataclasses.asdict(jcfg.loss))
    batch = {key: torch.from_numpy(v) for key, v in batch_np.items()}
    fn = make_functional_train_step(model, tx, loss_cfg, moe_aux_weight=AUX)
    exported = export_step(fn, (train_state_tree(state), batch))
    save_exported(tmp_path / "step.pt2", exported)
    loaded = load_exported(tmp_path / "step.pt2")

    tree = train_state_tree(state)
    for want_m in (jm, jm2):
        args = pytree.tree_map(torch.clone, (tree, batch))
        got = loaded.call(*tree_leaves(args))
        live = fn(*pytree.tree_map(torch.clone, (tree, batch)))
        assert_bitwise(got, tree_leaves(live))
        tree, metrics = live
        for key in ("loss", "moe_aux", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(metrics[key]), float(want_m[key]), rtol=1e-4,
                                       atol=1e-9, err_msg=key)
    # The artifact's state after two steps and the eager step's, from the
    # same weights, against JAX's: within AdamW's move, nearly all tightly.
    eager = make_train_step(model, loss_cfg, moe_aux_weight=AUX)
    for _ in range(2):
        state, em = eager(state, batch)
    np.testing.assert_allclose(float(em["moe_aux"]), float(jm2["moe_aux"]), rtol=1e-4)
    lr = TRAIN_CFG["learning_rate"]
    outside, total = 0, 0
    for name, want in jparams.items():
        for got in (tree["params"][name], model.state_dict()[name]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2 * lr,
                                       err_msg=name)
            outside += int((np.abs(got.numpy() - want.numpy())
                            > 1e-5 + 1e-4 * np.abs(want.numpy())).sum())
            total += want.numel()
    assert outside <= 0.005 * total, (outside, total)
