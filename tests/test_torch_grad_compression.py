"""The port's compressed gradient sync (``parallel/compression.py``,
``train/compressed_step.py``) against the JAX package's on the CPU.

- int8 payloads and scales bitwise equal to JAX's, ties at .5 included; the
  port's one (exact) top-k: indices equal to JAX's exact ``lax.top_k``, in
  its order, ties by lower index, and the same magnitudes as JAX's default
  ``approx_max_k``.
- ``compressed_axis_mean`` without and with error feedback (two rounds) at
  dcn = 2 and 4 over gloo ranks against JAX's in ``shard_map``.
- The compressed train step on a (dcn, dp) = (2, 2) grid, int8, top-k,
  int8 with ``update_sharding="full"``, int8 over 2 accumulated
  microbatches (local and GradCache's global negatives) and top-k with
  ``"zero1"``, against JAX's ``make_compressed_train_step`` (two steps):
  metrics, parameters, the residuals' shard-local shapes and the wire
  bytes; its int8 gradient within JAX's int8 bound of the uncompressed one
  per tensor.
- The refusals: JAX's config refusals word for word; the adaptive ladder
  and the MoE composition (ported since) run a step on one process.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_compression_workers as cw
import _torch_dist_worker as worker
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel import compression as jcomp
from distributed_sigmoid_loss_tpu.parallel.mesh import make_2d_mesh, make_mesh
from distributed_sigmoid_loss_tpu.train import compressed_step as jcs
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.parallel import compression as pcomp
from distributed_sigmoid_loss_tpu_torch.train import compressed_step as pcs
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

SHAPES = [(6, 5), (7,), (3, 4, 2), ()]
ROUNDS = 2
DCN, WORLD, STEPS, BATCH = 2, 4, 2, 16
TRAIN_CFG = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
METRICS = ("loss", "t", "bias", "grad_norm", "param_norm", "update_ratio", "ef_norm",
           "dcn_wire_bytes", "bits_per_param")
STEP_RUNS = {
    "int8": dict(compression="int8"),
    "topk": dict(compression="topk", topk_frac=0.1),
    "int8_full": dict(compression="int8", update_sharding="full"),
    # Local accumulation (one dcn hop a step), GradCache's exact global
    # negatives, and zero1's sharded moments.
    "int8_accum": dict(compression="int8", accum_steps=2),
    "int8_gradcache": dict(compression="int8", accum_steps=2, accum_negatives="global"),
    "topk_zero1": dict(compression="topk", topk_frac=0.1, update_sharding="zero1"),
}


def tie_tensor():
    """Entries at exact halves of the scale (max 127 → scale 1)."""
    return np.array([127.0, 63.5, -63.5, 0.5, 1.5, 2.5, -2.5, -0.5, 3.0, -127.0], np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "tiny"])
def test_int8_payload_bitwise_equal_to_jax(case):
    rng = np.random.default_rng(3)
    t = {"normal": rng.standard_normal((64, 33)).astype(np.float32) * 1e-2,
         "ties": tie_tensor(), "zeros": np.zeros((5, 4), np.float32),
         "tiny": rng.standard_normal(17).astype(np.float32) * 1e-20}[case]
    jq, js = jcomp.quantize_tensor_int8(jnp.asarray(t))
    q, s = pcomp.quantize_tensor_int8(torch.from_numpy(t))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(pcomp.dequantize_tensor_int8(q, s).numpy(),
                                  np.asarray(jcomp.dequantize_tensor_int8(jq, js)))


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("case", ["normal", "ties"])
def test_topk_indices_equal_jax(approximate, case):
    rng = np.random.default_rng(4)
    if case == "ties":
        t = rng.choice(np.float32([-2, -1, 1, 2, 3, 0.5]), size=(8, 9)).astype(np.float32)
    else:
        t = rng.standard_normal((8, 9)).astype(np.float32)
    for k in (1, 7, 20, 72):
        # The port's one (exact) top-k against JAX under each setting.
        v, i = pcomp.sparsify_topk(torch.from_numpy(t), k)
        jv, ji = jcomp.sparsify_topk(jnp.asarray(t), k, approximate=approximate)
        if approximate:
            # JAX's default approx_max_k keeps the same magnitudes here;
            # among ties it may pick others (at k = 1 it takes the last).
            np.testing.assert_array_equal(np.sort(np.abs(v.numpy())),
                                          np.sort(np.abs(np.asarray(jv))))
            continue
        # lax.top_k's entries and order (ties by lower index).
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji), err_msg=f"k={k}")
        assert i.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            pcomp.densify_topk(v, i, t.size).numpy(),
            np.asarray(jcomp.densify_topk(jv, ji, t.size)))


def round_grads(world):
    rng = np.random.default_rng(world)
    return [[[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(world)] for _ in range(ROUNDS)]


@functools.cache
def jax_axis_mean(world):
    """JAX's compressed_axis_mean in shard_map over a dcn mesh: per method,
    no EF, then ROUNDS rounds with EF; each entry (means, residuals) as
    lists of (world, ...) arrays."""
    grads = round_grads(world)
    mesh = make_mesh(world, "dcn")
    out = {}

    def stack(r):
        return [jnp.asarray(np.stack([grads[r][rank][i] for rank in range(world)]))
                for i in range(len(SHAPES))]

    for method in ("int8", "topk"):
        def no_ef(ts, method=method):
            mean, _ = jcomp.compressed_axis_mean([t[0] for t in ts], "dcn", None, method=method,
                                                 topk_frac=0.1)
            return [m[None] for m in mean]

        fn = jax.jit(jax.shard_map(no_ef, mesh=mesh, in_specs=(P("dcn"),), out_specs=P("dcn"),
                                   check_vma=False))
        out[f"{method}/no_ef"] = ([np.asarray(m) for m in fn(stack(0))], None)

        def with_ef(ts, es, method=method):
            mean, new = jcomp.compressed_axis_mean([t[0] for t in ts], "dcn", es,
                                                   method=method, topk_frac=0.1)
            return [m[None] for m in mean], new

        fn = jax.jit(jax.shard_map(with_ef, mesh=mesh, in_specs=(P("dcn"), P("dcn")),
                                   out_specs=(P("dcn"), P("dcn")), check_vma=False))
        ef = [jnp.zeros((world,) + s, jnp.float32) for s in SHAPES]
        for r in range(ROUNDS):
            mean, ef = fn(stack(r), ef)
            out[f"{method}/ef{r}"] = ([np.asarray(m) for m in mean], [np.asarray(e) for e in ef])
    return out


@pytest.fixture(scope="module")
def mean_ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = worker.spawn(cw.axis_mean_worker, world, (round_grads(world), ROUNDS),
                                        tmp_path_factory.mktemp(f"mean{world}"))
        return cache[world]

    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressed_axis_mean_and_error_feedback_match_jax(mean_ranks, world, method):
    want = jax_axis_mean(world)
    for rank, rec in enumerate(mean_ranks(world)):
        for key in [f"{method}/no_ef"] + [f"{method}/ef{r}" for r in range(ROUNDS)]:
            means, efs = want[key]
            got = rec[key]
            for i, m in enumerate(means):
                np.testing.assert_allclose(got["mean"][i].numpy(), m[rank], rtol=1e-6,
                                           atol=1e-7, err_msg=f"{key} mean {i}")
            if efs is None:
                assert got["ef"] is None
                continue
            for i, e in enumerate(efs):
                # target − q·scale: XLA's CPU code fuses it into one FMA, the
                # port rounds the product first; they differ by up to an ulp
                # of the tensor's largest entry (the inputs are O(1)).
                np.testing.assert_allclose(got["ef"][i].numpy(), e[rank], rtol=1e-6, atol=1e-6,
                                           err_msg=f"{key} ef {i}")


# -- the compressed train step ------------------------------------------------------


def jax_config():
    cfg = jc.SigLIPConfig.tiny_test()
    return dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, variant="all_gather"))


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
def jax_params0():
    jcfg = jax_config()
    batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg, BATCH).items()}
    state = jts.create_train_state(jax.random.key(0), JaxSigLIP(jcfg),
                                   jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG)), batch,
                                   make_mesh(1))
    return jax.tree.map(np.asarray, state.params)


@functools.cache
def jax_step(name):
    jcfg = jax_config()
    kw = STEP_RUNS[name]
    mode = kw.get("update_sharding", "")
    mesh = make_2d_mesh(DCN, WORLD // DCN, axis_names=("dcn", "dp"))
    model = JaxSigLIP(jcfg)
    batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg, BATCH).items()}
    state = jts.create_train_state(jax.random.key(0), model,
                                   jts.make_optimizer(jc.TrainConfig(**TRAIN_CFG)), batch, mesh,
                                   update_sharding=mode)
    state = state.replace(params=jax.tree.map(lambda new, old: jax.device_put(new, old.sharding),
                                              jax_params0(), state.params))
    state = jcs.with_error_feedback(state, mesh, update_sharding=mode or "off")
    step, shardings = jcs.make_compressed_train_step(model, mesh, jcfg.loss, **kw)
    batch = jax.device_put(batch, shardings)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in METRICS})
    return metrics, params_from_jax(jax.tree.map(np.asarray, state.params), port_config(jcfg))


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    jcfg = jax_config()
    pcfg = port_config(jcfg)
    args = (list(STEP_RUNS.items()), params_from_jax(jax_params0(), pcfg), pcfg,
            batch_np(jcfg, BATCH), pc.TrainConfig(**TRAIN_CFG), STEPS, DCN)
    return worker.spawn(cw.compressed_step_worker, WORLD, args,
                        tmp_path_factory.mktemp("compressed_step"), timeout_s=300)


@pytest.mark.parametrize("name", sorted(STEP_RUNS))
def test_compressed_step_matches_jax(step_ranks, name):
    jmetrics, jparams = jax_step(name)
    lr = TRAIN_CFG["learning_rate"]
    # Under full sharding the port shards its own tensors' rows (a linear
    # weight is (out, in), a flax kernel (in, out)), so the per-shard int8
    # scales, the residuals and the padded payloads are not JAX's shards':
    # those three metrics agree to a few percent, the rest as in the others.
    by_rows = ("ef_norm", "dcn_wire_bytes", "bits_per_param") if "full" in name else ()
    for rec in step_ranks:
        for i, (a, b) in enumerate(zip(rec[name]["metrics"], jmetrics)):
            for k in METRICS:
                np.testing.assert_allclose(a[k], b[k], rtol=0.05 if k in by_rows else 1e-3,
                                           atol=1e-6, err_msg=f"step {i} {k}")
    outside, total = 0, 0
    for k, want in jparams.items():
        got = step_ranks[0][name]["params"][k]
        for rec in step_ranks[1:]:
            assert torch.equal(rec[name]["params"][k], got), k
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2 * lr * (STEPS - 1),
                                   err_msg=k)
        outside += int((np.abs(got.numpy() - want.numpy())
                        > 1e-6 + 1e-4 * np.abs(want.numpy())).sum())
        total += want.numel()
    if not by_rows:  # full: the int8 buckets differ, each update stays within 2·lr
        assert outside <= 0.005 * total, (outside, total)


def test_int8_full_step_matches_plain_reference_of_its_row_layout(step_ranks):
    """Under full sharding the port quantizes its own rows, not JAX's, so
    it is held tightly to a plain PyTorch reference of that layout (the dp
    mean, int8 per block of rows with its own residual, the dcn mean, a
    replicated AdamW step): parameters, ``grad_norm`` and each rank's
    residuals."""
    for rec in step_ranks:
        got, ref = rec["int8_full"], rec["int8_full_ref"]
        np.testing.assert_allclose([m["grad_norm"] for m in got["metrics"]], ref["grad_norm"],
                                   rtol=1e-5, atol=0)
        for k, want in ref["params"].items():
            torch.testing.assert_close(got["params"][k], want, rtol=1e-5, atol=1e-7, msg=k)
        for e, want in zip(got["ef"], ref["ef"]):
            torch.testing.assert_close(e, want, rtol=1e-5, atol=1e-7)


def test_full_sharding_keeps_shard_local_residuals_and_sends_less(step_ranks):
    from distributed_sigmoid_loss_tpu.parallel.update_shard import ef_slot_shape

    shapes = [tuple(p.shape) for p in SigLIP(port_config(jax_config()), device="cpu").parameters()]
    w = WORLD // DCN
    for rec in step_ranks:
        want = [ef_slot_shape(s, DCN, w, "full")[1:] for s in shapes]
        want = [(e[0] // w,) + e[1:] if s and s[0] >= w else e for e, s in zip(want, shapes)]
        assert rec["int8_full"]["ef_shapes"] == want
        assert rec["int8"]["ef_shapes"] == shapes
        full = rec["int8_full"]["metrics"][0]["dcn_wire_bytes"]
        assert full < 0.6 * rec["int8"]["metrics"][0]["dcn_wire_bytes"]
        assert rec["int8_full"]["opt_bytes"] < 0.6 * rec["int8"]["opt_bytes"]


def test_compressed_gradient_within_int8_bound_of_uncompressed(step_ranks):
    """JAX's oracle (``test_compressed_step_grads_match_uncompressed``): per
    tensor, the largest difference under 2% of the largest entry (one int8
    bucket is 1/127 of it; the mean of dcn = 2 buckets stays within ~1%)."""
    for rec in step_ranks:
        for exact, got in zip(rec["grads"]["exact"], rec["grads"]["compressed"]):
            scale = float(exact.abs().max()) if exact.numel() else 0.0
            if scale < 1e-8:
                continue
            assert float((got - exact).abs().max()) / scale < 0.02


REFUSALS = [
    dict(compression="bogus"),
    dict(compression="topk", error_feedback=False),
    dict(compression="adaptive", error_feedback=False),
    dict(compression="learned", error_feedback=False),
    dict(loss_variant="ring"),
    dict(accum_negatives="nearby"),
    dict(gradcache_embed_dtype="bfloat16"),
    dict(pp_microbatches=-1),
    dict(update_sharding="ring"),
]


@pytest.mark.parametrize("kwargs", REFUSALS)
def test_compressed_step_arg_refusals_match_jax(kwargs):
    full = dict(accum_steps=2, accum_dtype=None, accum_negatives="local", pp_microbatches=0)
    full.update(kwargs)
    with pytest.raises(ValueError) as jerr:
        jcs.validate_compressed_step_args(**full)
    with pytest.raises(ValueError) as perr:
        pcs.validate_compressed_step_args(**full)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kwargs,metric", [
    (dict(compression="adaptive"), "compression_scheme_hist"),
    (dict(compression="learned"), "codec_recon_err"),
    (dict(moe_aux_weight=0.01), "moe_aux"),
])
def test_ported_compressed_paths_run_on_one_process(kwargs, metric):
    """The adaptive ladder and the MoE composition (no longer refused) run a
    step at n_dcn = 1: finite metrics, the path's own among them
    (``tests/test_torch_{adaptive_compression,learned_codec,moe}.py`` hold
    them to JAX at W = 4)."""
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    jcfg = jax_config()
    if "moe_aux_weight" in kwargs:
        jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision, moe_experts=2),
                                   text=dataclasses.replace(jcfg.text, moe_experts=2))
    model = SigLIP(port_config(jcfg), device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    adaptive = kwargs.get("compression") in ("adaptive", "learned")
    state = (pcs.with_adaptive_compression(state, learned=kwargs.get("compression") == "learned")
             if adaptive else pcs.with_error_feedback(state))
    step = pcs.make_compressed_train_step(model, pc.LossConfig(variant="all_gather"), **kwargs)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch_np(jcfg, 4).items()})
    assert metric in m
    assert all(np.isfinite(v.float().numpy()).all() for v in m.values())


def test_step_without_residuals_refuses_like_jax():
    from distributed_sigmoid_loss_tpu_torch.train import train_step as pts

    model = SigLIP(port_config(jax_config()), device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    step = pcs.make_compressed_train_step(model, pc.LossConfig(variant="all_gather"))
    with pytest.raises(ValueError, match="with_error_feedback"):
        step(state, {k: torch.from_numpy(v) for k, v in batch_np(jax_config(), 4).items()})
