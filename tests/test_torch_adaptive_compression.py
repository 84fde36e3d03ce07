"""The port's adaptive compression ladder (``parallel/adaptive_compression.py``,
the adaptive path of ``train/compressed_step.py``) against the JAX
package's on the CPU.

- The packers, the int4 quantizer, the payload table, the DCT basis and the
  cold-start codec bitwise equal to JAX's.
- ``adaptive_axis_mean`` for every rung and for a mixed table, two rounds
  with the residual carried, on gloo ranks at n_dcn = 2 and 4 against JAX's
  under ``shard_map``: means and residuals within 1e-6 of the largest
  magnitude, stats at rtol 1e-5, wire bytes equal.
- ``BitController`` (greedy, budgeted, with the learned rung; ``observe``,
  ``override_bandwidth``, the n_dcn < 2 refusal) equal to JAX's.
- The adaptive step on a (dcn, dp) = (2, 2) grid, the controller in the
  loop under a pinned bandwidth (greedy and budgeted), and composed with
  ``zero1`` and accumulation, against JAX's for 3 steps: the staged tables
  equal JAX's and every rank's each step, metrics at rtol 1e-3, parameters
  within 2·lr. With every tensor on int8 it equals the fixed int8 step
  bitwise (off, ``full``, GradCache); under ``full`` the ranks agree; ranks
  whose timings differ still stage one table, world rank 0's.
- ``comp`` is left out of checkpoints, and a restore resets its stats.
"""

import dataclasses
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_adaptive_ref as ref
import _torch_adaptive_workers as aw
import _torch_dist_worker as worker
from _torch_adaptive_ref import (
    BATCH,
    DCN,
    STEPS,
    TOPK_FRAC,
    TRAIN_CFG,
    WORLD,
    as_np,
    batch_np,
    jax_config,
    jax_params0,
    pinned_mbps,
    port_config,
)
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel import adaptive_compression as jac
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.parallel import adaptive_compression as pac
from distributed_sigmoid_loss_tpu_torch.train import checkpoint as ckpt
from distributed_sigmoid_loss_tpu_torch.train import compressed_step as pcs
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

SHAPES = [(6, 5), (7,), (3, 4, 2), (), (9, 20)]
ROUNDS = 2

# -- the packers and tables ----------------------------------------------------------


@pytest.mark.parametrize("size", [1, 7, 8, 33])
def test_int4_and_sign_packers_bitwise_equal_to_jax(size):
    rng = np.random.default_rng(size)
    q = rng.integers(-7, 8, (size,)).astype(np.int8)
    packed = pac.pack_int4(torch.from_numpy(q))
    jpacked = jac.pack_int4(jnp.asarray(q))
    np.testing.assert_array_equal(packed.numpy(), as_np(jpacked))
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(pac.unpack_int4(packed, size).numpy(), q)
    x = rng.standard_normal(size).astype(np.float32)
    x[::3] = 0.0  # zero counts as non-negative
    signs = pac.pack_signs(torch.from_numpy(x))
    np.testing.assert_array_equal(signs.numpy(), as_np(jac.pack_signs(jnp.asarray(x))))
    assert signs.dtype == torch.uint8
    np.testing.assert_array_equal(pac.unpack_signs(signs, size).numpy(),
                                  as_np(jac.unpack_signs(jnp.asarray(signs.numpy()), size)))


@pytest.mark.parametrize("case", ["normal", "ties", "zeros"])
def test_int4_quantizer_bitwise_equal_to_jax(case):
    rng = np.random.default_rng(5)
    t = {"normal": rng.standard_normal((9, 11)).astype(np.float32) * 1e-2,
         "ties": np.array([7.0, 3.5, -3.5, 0.5, 1.5, 2.5, -2.5, -0.5, -7.0], np.float32),
         "zeros": np.zeros((4, 3), np.float32)}[case]
    q, s = pac.quantize_tensor_int4(torch.from_numpy(t))
    jq, js = jac.quantize_tensor_int4(jnp.asarray(t))
    np.testing.assert_array_equal(q.numpy(), as_np(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()


def test_tables_basis_and_cold_codec_equal_jax():
    for size in (1, 7, 64, 65, 1000, 210_000):
        for frac in (0.01, 0.2, 1.0):
            np.testing.assert_array_equal(pac.payload_bytes_table(size, frac),
                                          jac.payload_bytes_table(size, frac))
    np.testing.assert_array_equal(pac.dct_matrix(), jac.dct_matrix())
    for k in ("enc", "dec"):
        np.testing.assert_array_equal(pac.default_codec()[k], jac.default_codec()[k])
    assert (pac.SCHEME_NAMES, pac.SCHEME_DISTORTION, pac.CODEC_BLOCK, pac.CODEC_LATENT,
            pac.CODEC_GROUPS) == (jac.SCHEME_NAMES, jac.SCHEME_DISTORTION, jac.CODEC_BLOCK,
                                  jac.CODEC_LATENT, jac.CODEC_GROUPS)
    for shape in ((), (3,), (3, 4), (2, 3, 4)):
        assert pac.codec_group(shape) == jac.codec_group(shape)


# -- adaptive_axis_mean over gloo ranks ----------------------------------------------


def round_grads(world):
    rng = np.random.default_rng(10 + world)
    return [[[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(world)] for _ in range(ROUNDS)]


def trained_codec():
    """A codec other than the cold start: orthonormal columns from a seed."""
    rng = np.random.default_rng(3)
    enc = np.stack([np.linalg.qr(rng.standard_normal((64, 16)))[0] for _ in range(2)])
    enc = enc.astype(np.float32)
    return {"enc": enc, "dec": np.ascontiguousarray(enc.transpose(0, 2, 1))}


def mean_cases():
    """(name, scheme table, codec): every rung alone, then a mixed table
    with a live codec."""
    n = len(SHAPES)
    cases = [(f"rung{c}", np.full(n, c, np.int32), None) for c in range(pac.N_SCHEMES)]
    cases.append(("mixed", np.array([5, 2, 1, 3, 5], np.int32), trained_codec()))
    return cases


@functools.cache
def jax_axis_mean(world):
    grads = round_grads(world)
    mesh = make_mesh(world, "dcn")

    def stack(r):
        return [jnp.asarray(np.stack([grads[r][rank][i] for rank in range(world)]))
                for i in range(len(SHAPES))]

    def body(ts, es, scheme, codec):
        mean, new, stats, wire = jac.adaptive_axis_mean(
            [t[0] for t in ts], "dcn", es, scheme, topk_frac=TOPK_FRAC,
            topk_approximate=False, codec=codec)
        return [m[None] for m in mean], new, stats, wire

    # One jit for every case: the table and the codec are operands (one
    # trace without a codec, one with).
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("dcn"), P("dcn"), P(), P()),
                               out_specs=(P("dcn"), P("dcn"), P(), P()), check_vma=False))
    out = {}
    for name, scheme, codec in mean_cases():
        live = None if codec is None else {k: jnp.asarray(v) for k, v in codec.items()}
        ef = [jnp.zeros((world,) + s, jnp.float32) for s in SHAPES]
        rounds = []
        for r in range(ROUNDS):
            mean, ef, stats, wire = fn(stack(r), ef, jnp.asarray(scheme), live)
            rounds.append({"mean": [as_np(m) for m in mean], "ef": [as_np(e) for e in ef],
                           "stats": {k: as_np(v) for k, v in stats.items()},
                           "wire": float(wire)})
        out[name] = rounds
    return out


@pytest.fixture(scope="module")
def mean_ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cases = [(name, round_grads(world), scheme, codec, TOPK_FRAC)
                     for name, scheme, codec in mean_cases()]
            cache[world] = worker.spawn(aw.adaptive_mean_worker, world, (cases,),
                                        tmp_path_factory.mktemp(f"amean{world}"))
        return cache[world]

    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in mean_cases()])
def test_adaptive_axis_mean_matches_jax(mean_ranks, world, name):
    """Within 1e-6 of the largest magnitude of the tensor's gradients that
    round: ``target − sent`` is one fused multiply-add in XLA's CPU code and
    two roundings in the port (an ulp of the target apart)."""
    want = jax_axis_mean(world)[name]
    grads = round_grads(world)
    for rank, rec in enumerate(mean_ranks(world)):
        for r, (got, exp) in enumerate(zip(rec[name], want)):
            for what in ("mean", "ef"):
                for i, (g, e) in enumerate(zip(got[what], exp[what])):
                    e = e[rank]
                    atol = 1e-6 * max(float(np.abs(grads[r][k][i]).max()) for k in range(world))
                    np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=atol,
                                               err_msg=f"round {r} {what} {i}")
            assert got["wire"] == exp["wire"]
            assert set(got["stats"]) == set(exp["stats"])
            for k, v in exp["stats"].items():
                # Sums that cancel (off-diagonal moments, a residual at
                # rounding level) are held to 1e-6 of the stat's scale.
                np.testing.assert_allclose(got["stats"][k].numpy(), v, rtol=1e-5,
                                           atol=1e-6 * max(1.0, float(np.abs(v).max())),
                                           err_msg=f"round {r} {k}")


def test_adaptive_axis_mean_requires_error_feedback():
    with pytest.raises(ValueError, match="error feedback"):
        pac.adaptive_axis_mean([torch.zeros(4)], "dcn", None, [0])


# -- the bit controller -----------------------------------------------------------------


CONTROLLER_CASES = {
    "greedy": dict(controller="greedy"),
    "budgeted": dict(controller="budgeted"),
    "learned": dict(controller="greedy", learned=True),
    "budgeted_learned": dict(controller="budgeted", learned=True),
    "big_topk": dict(controller="greedy", topk_frac=0.6),
}


@pytest.mark.parametrize("name", sorted(CONTROLLER_CASES))
def test_bit_controller_equals_jax(name):
    kw = CONTROLLER_CASES[name]
    rng = np.random.default_rng(len(name))
    sizes = [int(s) for s in rng.integers(1, 5000, 12)] + [1, 64]
    a = pac.BitController(sizes, n_dcn=4, **kw)
    b = jac.BitController(sizes, n_dcn=4, **kw)
    np.testing.assert_array_equal(a.ladders, b.ladders)
    np.testing.assert_array_equal(a.decide(), b.decide())
    for bw, dur in ((None, 0.02), (0.5, None), (None, 3.0), (None, 0.001)):
        if bw is not None:
            a.override_bandwidth(bw)
            b.override_bandwidth(bw)
        else:
            a.override_bandwidth(None)
            b.override_bandwidth(None)
            for wire in (40_000.0, 20_000.0):
                a.observe(dur, wire)
                b.observe(dur, wire)
        assert a.bw_est_mbps == b.bw_est_mbps and a.bytes_allowed() == b.bytes_allowed()
        ratio = rng.random(len(sizes))
        gnorm = rng.random(len(sizes)) * 3
        np.testing.assert_array_equal(a.decide(ratio, gnorm=gnorm), b.decide(ratio, gnorm=gnorm))
        assert a.scheme.dtype == np.int32
        assert a.last_error_budget == b.last_error_budget
    for c in (pac, jac):
        with pytest.raises(ValueError, match="n_dcn >= 2"):
            c.BitController([10], n_dcn=1)
        with pytest.raises(ValueError, match="greedy"):
            c.BitController([10], n_dcn=2, controller="lazy")


# -- the adaptive train step -------------------------------------------------------------


def controller_spec(step, controller, frac, mode=""):
    return {"step": step, "controller": controller, "bandwidth_mbps": pinned_mbps(frac),
            "update_sharding": mode}


# own_tables: JAX's controller decides JAX's tables; otherwise JAX stages
# the port's (see test_adaptive_step_with_controller_matches_jax).
ADAPTIVE = dict(compression="adaptive", topk_frac=TOPK_FRAC)
STEP_RUNS = {
    "adaptive": (controller_spec(ADAPTIVE, "greedy", 0.3), True),
    "adaptive_budgeted": (controller_spec(ADAPTIVE, "budgeted", 0.3), True),
    # zero1's sharded moments and two accumulated microbatches in one run.
    "adaptive_zero1_accum": (controller_spec(dict(ADAPTIVE, accum_steps=2), "greedy", 0.3,
                                             "zero1"), False),
}


@functools.cache
def _jax_step(name, tables):
    spec, _ = STEP_RUNS[name]
    return ref.jax_controller_run(jax_config(), dict(spec["step"]), spec["controller"],
                                  spec["bandwidth_mbps"], mode=spec["update_sharding"],
                                  tables=tables)


def jax_step(name, tables=None):
    return _jax_step(name, None if tables is None else tuple(map(tuple, tables)))


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    jcfg = jax_config()
    pcfg = port_config(jcfg)
    n = len(jac.leaf_sizes(jax_params0()))
    int8_tables = [[0] * n] * STEPS
    runs = [(name, spec) for name, (spec, _) in STEP_RUNS.items()]
    runs += [("full", controller_spec(ADAPTIVE, "greedy", 0.3, "full")),
             ("skew", {"step": ADAPTIVE, "controller": "greedy", "bandwidth_mbps": None,
                       "skew": True})]
    # Every tensor on int8 against the fixed int8 step, in three layouts.
    for tag, extra, mode in (("off", {}, ""), ("full", {}, "full"),
                             ("gradcache", dict(accum_steps=2, accum_negatives="global"), "")):
        runs += [(f"int8_table/{tag}", {"step": dict(compression="adaptive", **extra),
                                        "tables": int8_tables, "update_sharding": mode}),
                 (f"fixed_int8/{tag}", {"step": dict(compression="int8", **extra),
                                        "update_sharding": mode})]
    args = (runs, params_from_jax(jax_params0(), pcfg), pcfg, batch_np(jcfg, BATCH),
            pc.TrainConfig(**TRAIN_CFG), STEPS, DCN)
    return worker.spawn(aw.adaptive_step_worker, WORLD, args,
                        tmp_path_factory.mktemp("adaptive_step"), timeout_s=300)


@pytest.mark.parametrize("name", sorted(STEP_RUNS))
def test_adaptive_step_with_controller_matches_jax(step_ranks, name):
    """Every rank's controller decides what JAX's controller decides on the
    same stats, every rank stages the same tables, and the steps match
    JAX's. The stats of a few tensors are rounding noise (a key bias's
    gradient is zero in exact arithmetic: softmax ignores a constant added
    to every logit), so under accumulation the two packages' greedy orders
    part there; that run's JAX reference stages the port's tables."""
    spec, own_tables = STEP_RUNS[name]
    rec0 = step_ranks[0][name]
    assert rec0["decided"] == ref.replay_controller(jax_config(), spec, rec0)
    want = jax_step(name, None if own_tables else rec0["staged"])
    # The pinned bandwidth does narrow tensors after the first step.
    assert any((np.asarray(t) != want["staged"][0]).any() for t in want["staged"][1:])
    ref.check_against_jax(step_ranks, name, want, TRAIN_CFG["learning_rate"])


@pytest.mark.parametrize("tag", ["off", "full", "gradcache"])
def test_all_int8_table_equals_the_fixed_int8_step(step_ranks, tag):
    """Every tensor on the int8 rung is the fixed int8 sync: the same
    per-tensor scales on JAX's layout (a transpose keeps the max), so the
    parameters and the wire bytes are bitwise the fixed step's."""
    for rec in step_ranks:
        got, want = rec[f"int8_table/{tag}"], rec[f"fixed_int8/{tag}"]
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), k
        for a, b in zip(got["metrics"], want["metrics"]):
            assert a["dcn_wire_bytes"] == b["dcn_wire_bytes"]
            assert a["loss"] == b["loss"]
            assert a["compression_scheme_hist"][0] == len(got["staged"][0])


def test_full_sharding_ranks_agree_and_keep_shard_local_residuals(step_ranks):
    """Under ``full`` the tensors are each rank's rows (the port's layout):
    every rank stages the same tables and ends with the same parameters,
    within 2·lr a step of JAX's unsharded run, and the residuals are the
    rows."""
    jparams = jax_step("adaptive")["params"]
    lr = TRAIN_CFG["learning_rate"]
    recs = [rec["full"] for rec in step_ranks]
    for rec in recs[1:]:
        assert rec["staged"] == recs[0]["staged"]
        assert [m["loss"] for m in rec["metrics"]] == [m["loss"] for m in recs[0]["metrics"]]
    for k, want in jparams.items():
        got = recs[0]["params"][k]
        for rec in recs[1:]:
            assert torch.equal(rec["params"][k], got), k
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2 * lr * (STEPS - 1))
    assert sum(np.prod(s) for s in recs[0]["ef_shapes"]) < sum(
        np.prod(s) for s in step_ranks[0]["adaptive"]["ef_shapes"])
    for m in recs[0]["metrics"]:
        assert all(np.isfinite(v) for k, v in m.items() if k != "compression_scheme_hist")


def test_skewed_ranks_stage_rank0s_table(step_ranks):
    """Each rank times its rounds differently, so its controller decides a
    different table; every rank stages world rank 0's."""
    decided = [rec["skew"]["decided"] for rec in step_ranks]
    assert any(decided[0][0] != d[0] for d in decided[1:]), \
        "the skewed timings should make the ranks' own decisions differ"
    for rec in step_ranks:
        assert rec["skew"]["staged"] == step_ranks[0]["skew"]["staged"]
        assert rec["skew"]["staged"][1] == decided[0][0]
        for k, v in step_ranks[0]["skew"]["params"].items():
            assert torch.equal(rec["skew"]["params"][k], v), k


# -- derived state ---------------------------------------------------------------------------


def test_checkpoint_leaves_comp_out_and_restore_resets_its_stats(tmp_path):
    cfg = port_config(jax_config())
    model = SigLIP(cfg, device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    state = pcs.with_adaptive_compression(state, learned=True)
    names = ckpt.state_tensors(state).keys()
    assert not any(n.startswith(("ef", "comp")) or "codec" in n or "gnorm" in n for n in names)
    path = str(tmp_path / "c")
    ckpt.save_checkpoint(path, state)
    table = np.arange(len(state.ef), dtype=np.int32) % pac.N_SCHEMES
    pcs.stage_scheme(state, table)
    codec = pac.default_codec()
    codec["enc"] = codec["enc"] * 2
    pcs.stage_codec(state, codec)
    for k in ("gnorm", "gvar", "ef_ratio", "blockmoment", "codec_recon_err"):
        state.comp[k].fill_(float("nan"))
    for e in state.ef:
        e.fill_(float("nan"))
    ckpt.restore_checkpoint(path, state)
    for k in ("gnorm", "gvar", "ef_ratio", "blockmoment", "codec_recon_err"):
        assert torch.equal(state.comp[k], torch.zeros_like(state.comp[k])), k
    assert all(torch.equal(e, torch.zeros_like(e)) for e in state.ef)
    np.testing.assert_array_equal(state.comp["scheme"].numpy(), table)
    np.testing.assert_array_equal(state.comp["codec_enc"].numpy(), codec["enc"])


def test_stage_and_step_refusals():
    cfg = port_config(jax_config())
    model = SigLIP(cfg, device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    with pytest.raises(ValueError, match="with_adaptive_compression"):
        pcs.stage_scheme(state, [0])
    step = pcs.make_compressed_train_step(model, cfg.loss, compression="adaptive")
    state = pcs.with_error_feedback(state)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(jax_config(), 4).items()}
    with pytest.raises(ValueError, match="comp"):
        step(state, batch)
    state = pcs.with_adaptive_compression(state)
    with pytest.raises(ValueError, match="entries"):
        pcs.stage_scheme(state, [0, 1])
    with pytest.raises(ValueError, match="codec carry"):
        pcs.stage_codec(state, pac.default_codec())
    learned = pcs.make_compressed_train_step(model, cfg.loss, compression="learned")
    with pytest.raises(ValueError, match="codec slots"):
        learned(state, batch)


def test_compression_leaves_follow_jax_tree_order():
    """The table's order is ``jax.tree.leaves``' on the JAX params, with
    each leaf's shape in JAX's layout (a scanned tower's layers stacked)."""
    for scan in (False, True):
        jcfg = jax_config()
        jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision,
                                                                    scan_layers=scan))
        batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg, 2).items()}
        jparams = flax.linen.meta.unbox(jax.eval_shape(
            JaxSigLIP(jcfg).init, jax.random.key(0), batch["images"], batch["tokens"])["params"])
        flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
        want = [("/".join(str(k.key) for k in path), tuple(leaf.shape)) for path, leaf in flat]
        model = SigLIP(port_config(jcfg), device="cpu")
        leaves = pcs.compression_leaves(model)
        params = list(model.parameters())
        assert [(leaf.path, tuple(leaf.gather(params).shape)) for leaf in leaves] == want

