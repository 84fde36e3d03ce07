"""The JAX side of the port's adaptive compression and MoE step tests: the
tiny configs, the seeded batch, JAX's adaptive step with its controller in
the loop (each built step kept, so one compile serves every run of a
configuration), and the comparisons of a port run against it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel import adaptive_compression as jac
from distributed_sigmoid_loss_tpu.parallel.mesh import make_2d_mesh, make_mesh
from distributed_sigmoid_loss_tpu.train import compressed_step as jcs
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import params_from_jax
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

TOPK_FRAC = 0.2
DCN, WORLD, STEPS, BATCH = 2, 4, 3, 16
TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio", "ef_norm",
           "dcn_wire_bytes", "bits_per_param")


def as_np(x):
    return np.asarray(x)


def jax_config():
    """The tiny config at depth 1 (fewer tensors: JAX compiles six branches
    a tensor)."""
    cfg = jc.SigLIPConfig.tiny_test()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=1),
        text=dataclasses.replace(cfg.text, depth=1),
        loss=dataclasses.replace(cfg.loss, variant="all_gather"))


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def batch_np(jcfg, n, seed=0):
    rng = np.random.default_rng(seed)
    hw = jcfg.vision.image_size
    return {"images": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            "tokens": rng.integers(0, jcfg.text.vocab_size,
                                   (n, jcfg.text.context_length)).astype(np.int32)}


@functools.cache
def jax_params0(jcfg=None):
    jcfg = jcfg or jax_config()
    batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg, BATCH).items()}
    state = jts.create_train_state(jax.random.key(0), JaxSigLIP(jcfg),
                                   jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG)), batch,
                                   make_mesh(1))
    return jax.tree.map(np.asarray, state.params)


def pinned_mbps(frac: float, jcfg=None) -> float:
    """A bandwidth whose round allows ``frac`` of the all-int8 egress."""
    sizes = jac.leaf_sizes(jax_params0(jcfg))
    egress = (DCN - 1) * sum(int(jac.payload_bytes_table(s)[0]) for s in sizes)
    return frac * egress * 8.0 / 0.1 / 1e6


_JAX_STEPS = {}


def _jax_step(jcfg, step_kw, mode):
    """JAX's compressed step for a configuration, built once (one compile)."""
    key = (jcfg, tuple(sorted(step_kw.items())), mode)
    if key not in _JAX_STEPS:
        mesh = make_2d_mesh(DCN, WORLD // DCN, axis_names=("dcn", "dp"))
        model = JaxSigLIP(jcfg)
        step, shardings = jcs.make_compressed_train_step(model, mesh, jcfg.loss,
                                                         topk_approximate=False,
                                                         update_sharding=mode, **step_kw)
        # One optimizer too: a new optax chain is new pytree metadata of the
        # state, which would retrace the step.
        tx = jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG))
        _JAX_STEPS[key] = (mesh, model, step, shardings, tx)
    return _JAX_STEPS[key]


def jax_controller_run(jcfg, step_kw, controller, bandwidth, *, learned=False, mode="",
                       steps=STEPS, tables=None, encoders=None):
    """JAX's compressed step; for the adaptive ladder with the controller
    in the loop (JAX ``cli.py``'s wrapper without the timing), or with
    ``tables`` staged; under
    ``learned`` the codec trainer's codec is staged once it is warm, or
    each step the codec of ``encoders`` (its decoder the transpose, as
    every codec of the trainer's). Each step's metrics, staged table and
    stats, and the final parameters in the port's names."""
    mesh, model, step, shardings, tx = _jax_step(jcfg, step_kw, mode)
    batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg, BATCH).items()}
    state = jts.create_train_state(jax.random.key(0), model, tx, batch, mesh,
                                   update_sharding=mode)
    state = state.replace(params=jax.tree.map(lambda new, old: jax.device_put(new, old.sharding),
                                              jax_params0(jcfg), state.params))
    adaptive = step_kw.get("compression", "int8") in ("adaptive", "learned")
    if adaptive:
        state = jcs.with_adaptive_compression(state, mesh, update_sharding=mode or "off",
                                              learned=learned)
    else:
        state = jcs.with_error_feedback(state, mesh, update_sharding=mode or "off")
    batch = jax.device_put(batch, shardings)
    ctl = jac.BitController(jac.leaf_sizes(state.params), n_dcn=DCN,
                            topk_frac=step_kw.get("topk_frac", 0.01), controller=controller,
                            learned=learned)
    ctl.override_bandwidth(bandwidth)
    trainer = jac.CodecTrainer() if learned else None
    metrics, staged, stats, codecs = [], [], [], []
    for i in range(steps):
        if not adaptive:
            state, m = step(state, batch)
            metrics.append({k: as_np(v) for k, v in m.items()})
            continue
        table = ctl.scheme if tables is None else np.asarray(tables[i], np.int32)
        state = jcs.stage_scheme(state, table, mesh)
        staged.append(np.asarray(table).copy())
        if encoders is not None:
            enc = np.asarray(encoders[i], np.float32)
            state = jcs.stage_codec(state, {"enc": enc, "dec": enc.transpose(0, 2, 1)}, mesh)
        if learned:
            codecs.append(as_np(state.comp["codec_enc"]))
        state, m = step(state, batch)
        metrics.append({k: as_np(v) for k, v in m.items()})
        stats.append({k: as_np(v) for k, v in state.comp.items()})
        ctl.decide(as_np(state.comp["ef_ratio"]), gnorm=as_np(state.comp["gnorm"]),
                   gvar=as_np(state.comp["gvar"]))
        if trainer is not None and encoders is None:
            codec = trainer.update(as_np(state.comp["blockmoment"]))
            if trainer.rounds >= trainer.warmup_rounds:
                state = jcs.stage_codec(state, codec, mesh)
    params = params_from_jax(jax.tree.map(np.asarray, state.params), port_config(jcfg))
    return {"metrics": metrics, "staged": staged, "params": params, "stats": stats,
            "codecs": codecs}


def replay_controller(jcfg, spec, rec, learned=False):
    """JAX's controller fed a port run's stats, step by step: its tables."""
    ctl = jac.BitController(jac.leaf_sizes(jax_params0(jcfg)), n_dcn=DCN,
                            topk_frac=spec["step"].get("topk_frac", 0.01),
                            controller=spec["controller"], learned=learned)
    ctl.override_bandwidth(spec["bandwidth_mbps"])
    return [ctl.decide(st["ef_ratio"].numpy(), gnorm=st["gnorm"].numpy(),
                       gvar=st["gvar"].numpy()).tolist() for st in rec["stats"]]


def check_against_jax(ranks, name, want, lr, extra=()):
    """Every rank's staged tables, metrics (rtol 1e-3) and scheme
    histograms against JAX's run ``want``; the ranks' parameters equal, and
    within 2·lr of JAX's."""
    for rec in ranks:
        got = rec[name]
        for i, (table, exp) in enumerate(zip(got["staged"], want["staged"])):
            np.testing.assert_array_equal(table, exp, err_msg=f"step {i} table")
        for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in METRICS + tuple(extra):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-6,
                                           err_msg=f"step {i} {k}")
            np.testing.assert_array_equal(a["compression_scheme_hist"],
                                          b["compression_scheme_hist"])
    for k, exp in want["params"].items():
        got = ranks[0][name]["params"][k]
        for rec in ranks[1:]:
            assert torch.equal(rec[name]["params"][k], got), k
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=2 * lr * (STEPS - 1),
                                   err_msg=k)
