"""The port's pipeline schedules (``parallel/pipeline.py``) and the pieces
of ``parallel/pp_towers.py`` that need no train step, on the CPU.

- ``gpipe`` (with and without ``checkpoint_stages``) and ``one_f_one_b`` on
  a toy residual stack over four gloo ranks (``mp.spawn``, one spawn for
  the file) at pp = 4 and M = 1, 2, 4: outputs and loss equal to the plain
  sequential stack, and the gradients of every stage's parameters and of
  the inputs equal to its autograd's (so the two schedules agree with each
  other).
- ``stack_stage_params`` and ``validate_pp_tower`` against JAX's;
  ``microbatch_merge`` inverting ``microbatch_split``.
- At pp = 1 (one process, the card's size) the pipelined towers give the
  model's own embeddings and gradients in both schedules, and a stage model
  refuses the plain forward.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import _torch_pp_ep_workers as ppw
from distributed_sigmoid_loss_tpu.parallel import pipeline as jpipe
from distributed_sigmoid_loss_tpu.parallel import pp_towers as jpp
from distributed_sigmoid_loss_tpu_torch.models import params_from_jax
from distributed_sigmoid_loss_tpu_torch.parallel import pipeline, pp_towers
from distributed_sigmoid_loss_tpu_torch.parallel.microbatch import (
    microbatch_merge,
    microbatch_split,
)
from distributed_sigmoid_loss_tpu_torch.utils import config as pc
from test_torch_pipeline import BATCH, WORLD, data, init_params, jax_config, port_config

LIB_CASES = [("gpipe_m1", "gpipe", 1, False), ("gpipe_m2", "gpipe", 2, False),
             ("gpipe_m4", "gpipe", 4, False), ("gpipe_m4_ckpt", "gpipe", 4, True),
             ("1f1b_m1", "1f1b", 1, False), ("1f1b_m4", "1f1b", 4, False)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn(ppw.schedule_worker, WORLD, (LIB_CASES,),
                        tmp_path_factory.mktemp("schedules"), timeout_s=120)


def sequential(name, schedule, m):
    """The toy stack run plainly: outputs (or the 1F1B loss) and the
    gradients of its parameters and inputs."""
    layers = [(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in ppw._stack(8, 2 * WORLD, seed=3)]
    xs = torch.randn(m, 3, 8, generator=torch.Generator().manual_seed(4)).requires_grad_()
    c = torch.randn(m, 3, 8, generator=torch.Generator().manual_seed(5))
    y = ppw._stage_fn(layers)(xs)
    if schedule == "gpipe":
        value = y.detach()
        (y * c).sum().backward()
    else:
        loss = sum((y[i] * c[0]).sum() + y[i].square().sum() for i in range(m)) / m
        value = loss.detach()
        loss.backward()
    return value, xs.grad, [t.grad for wb in layers for t in wb]


@pytest.mark.parametrize("name,schedule,m,ckpt", LIB_CASES)
def test_schedules_match_the_sequential_stack(ranks, name, schedule, m, ckpt):
    value, dxs, grads = sequential(name, schedule, m)
    for rank, rec in enumerate(ranks):
        got = rec[name]
        torch.testing.assert_close(got["value"], value, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got["dxs"], dxs, rtol=1e-5, atol=1e-6)
        for g, want in zip(got["grads"], grads[rank * 4:(rank + 1) * 4]):
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)


def test_stack_stage_params_and_stage_layers_match_jax():
    rng = np.random.default_rng(0)
    leaves = {"w": rng.standard_normal((8, 3, 2)).astype(np.float32),
              "b": rng.standard_normal((8, 2)).astype(np.float32)}
    got = pipeline.stack_stage_params({k: torch.from_numpy(v) for k, v in leaves.items()}, 4)
    want = jpipe.stack_stage_params({k: jnp.asarray(v) for k, v in leaves.items()}, 4)
    for k in leaves:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for s in range(4):
            np.testing.assert_array_equal(got[k][s].numpy(),
                                          leaves[k][list(pipeline.stage_layers(8, 4, s))])
    with pytest.raises(ValueError) as jerr:
        jpipe.stack_stage_params({"w": jnp.zeros((6, 2))}, 4)
    with pytest.raises(ValueError) as perr:
        pipeline.stack_stage_params({"w": torch.zeros(6, 2)}, 4)
    assert str(perr.value) == str(jerr.value)


def test_microbatch_merge_inverts_split():
    x = torch.arange(24.0).reshape(12, 2)
    y = microbatch_split(x, 3)
    assert y.shape == (3, 4, 2)
    torch.testing.assert_close(microbatch_merge(y), x, rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [
    ("scan_layers", False), ("depth", 3), ("sequence_parallel_axis", "sp"),
    ("moe_experts", 4),
])
def test_validate_pp_tower_refuses_like_jax(field, value):
    jcfg = dataclasses.replace(jax_config().vision, **{field: value})
    pcfg = pc.ViTConfig(**dataclasses.asdict(jcfg))
    with pytest.raises(ValueError) as jerr:
        jpp.validate_pp_tower(jcfg, 2, "vision")
    with pytest.raises(ValueError) as perr:
        pp_towers.validate_pp_tower(pcfg, 2, "vision")
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_one_stage_pipeline_is_the_plain_forward(schedule):
    """At pp = 1 (one process, the card's run) the pipelined towers give the
    model's own embeddings and gradients, and a stage model that lost its
    blocks refuses the plain forward."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.ops import sigmoid_loss as psl
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid

    pcfg = port_config(jax_config(remat=True))
    b = {k: torch.from_numpy(v) for k, v in data(BATCH).items()}
    out = []
    for pipelined in (False, True):
        model = SigLIP(pcfg, device="cpu")
        model.load_state_dict(params_from_jax(init_params(), pcfg))
        with ProcessGrid({"pp": 1}):
            fwd = (functools.partial(pp_towers.siglip_forward_pp, model, num_microbatches=4,
                                     schedule=schedule) if pipelined else model)
            zi, zt, lp = fwd(b["images"], b["tokens"])
            psl.sigmoid_loss(zi, zt, lp["t_prime"], lp["bias"]).backward()
        out.append((zi.detach(), zt.detach(), {n: p.grad for n, p in model.named_parameters()}))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-5, atol=1e-6)
    for k, g in out[0][2].items():
        torch.testing.assert_close(out[1][2][k], g, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(g.abs().max())), msg=k)
    with pytest.raises(ValueError, match="one pipeline stage's"):
        staged = SigLIP(pcfg, device="cpu")
        for tower in (staged.visual, staged.textual):
            tower.encoder.blocks = torch.nn.ModuleDict({"0": tower.encoder.blocks[0]})
        staged(b["images"], b["tokens"])
