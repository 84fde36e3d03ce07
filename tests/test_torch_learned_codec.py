"""The learned rung of the port's adaptive compression
(``parallel/adaptive_compression.py``: ``CodecTrainer``, the ``learned``
rung, the ``blockmoment`` stat; ``compression="learned"`` in
``train/compressed_step.py``) against the JAX package's on the CPU.

- ``CodecTrainer``: warm-up, determinism, a poisoned moment skipped, the
  planted subspace recovered: equal to JAX's, bit for bit.
- The learned rung, its ``blockmoment`` and ``codec_recon_err`` on a linear
  weight's leaf: the port's weight is (out, in), the flax kernel (in, out);
  the compression view is the kernel's layout, so the blocks, the stats and
  the mean are JAX's (and the port's own layout would give other blocks).
- A learned step on a (dcn, dp) = (2, 2) grid, every rung on some tensors,
  the codec trainer in the loop (its codec staged after warm-up), against
  JAX's for 3 steps; and the learned ladder under the budgeted controller,
  each rank deciding what JAX's controller decides on the same stats.
"""

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
    batch_np,
    jax_config,
    jax_params0,
    pinned_mbps,
    port_config,
)
from distributed_sigmoid_loss_tpu.parallel import adaptive_compression as jac
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.parallel import adaptive_compression as pac
from distributed_sigmoid_loss_tpu_torch.train import compressed_step as pcs
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc


def planted_moment(rng):
    w = np.linalg.qr(rng.standard_normal((64, 16)))[0].T.astype(np.float32)  # (L, B)
    z = rng.standard_normal((256, 16)).astype(np.float32)
    blocks = z @ w
    return np.stack([blocks.T @ blocks / len(blocks)] * 2)


def test_codec_trainer_equals_jax():
    rng = np.random.default_rng(0)
    moments = [planted_moment(rng) for _ in range(3)]
    moments.insert(2, np.full_like(moments[0], np.nan))  # a poisoned round
    port, want = pac.CodecTrainer(), jac.CodecTrainer()
    cold = pac.default_codec()
    for i, m in enumerate(moments):
        a, b = port.update(m), want.update(m)
        for k in ("enc", "dec"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"round {i} {k}")
        assert port.rounds == want.rounds
        if i == 0:  # the warm-up keeps the cold start
            np.testing.assert_array_equal(a["enc"], cold["enc"])
    assert port.rounds == 3 and not np.allclose(a["enc"], cold["enc"])
    np.testing.assert_array_equal(port.moment, want.moment)
    # The re-solved codec reconstructs the planted blocks, the cold one not.
    blocks = (rng.standard_normal((64, 16)) @ np.linalg.qr(
        rng.standard_normal((64, 16)))[0].T).astype(np.float32)
    tr = pac.CodecTrainer()
    m = np.stack([blocks.T @ blocks / len(blocks)] * 2)
    tr.update(m)
    codec = tr.update(m)

    def err(c):
        out = (blocks @ c["enc"][0]) @ c["dec"][0]
        return np.linalg.norm(out - blocks) / np.linalg.norm(blocks)

    assert err(codec) < 1e-4 and err(cold) > 0.5
    with pytest.raises(ValueError, match="blockmoment"):
        port.update(np.zeros((2, 2)))


def kernel_leaf(model):
    """A linear weight's leaf of the compression view and its index."""
    leaves = pcs.compression_leaves(model)
    for leaf in leaves:
        if leaf.transposed and leaf.path.endswith("mlp/wi/kernel"):
            return leaf
    raise AssertionError("no transposed leaf")


@pytest.mark.parametrize("codec_kind", ["cold", "trained"])
def test_learned_rung_on_a_transposed_leaf_equals_jax(codec_kind):
    model = SigLIP(port_config(jax_config()), device="cpu")
    params = list(model.parameters())
    leaf = kernel_leaf(model)
    (i,) = leaf.members
    rng = np.random.default_rng(7)
    kernel = rng.standard_normal(tuple(params[i].shape[::-1])).astype(np.float32)  # (in, out)
    grads = [torch.zeros_like(p) for p in params]
    grads[i] = torch.from_numpy(np.ascontiguousarray(kernel.T))  # the port's (out, in)
    view = leaf.gather(grads)
    np.testing.assert_array_equal(view.numpy(), kernel)
    codec = pac.default_codec() if codec_kind == "cold" else {
        k: v * 1.5 for k, v in pac.default_codec().items()}
    live = {k: torch.from_numpy(v) for k, v in codec.items()}
    ef = [torch.zeros_like(view)]
    mean, new_ef, stats, wire = pac.adaptive_axis_mean(
        [view], "dcn", ef, [pac.SCHEME_LEARNED], codec=live)

    mesh = make_mesh(1, "dcn")

    def body(t, e, codec):
        m, n, s, w = jac.adaptive_axis_mean([t], "dcn", [e], jnp.asarray([jac.SCHEME_LEARNED]),
                                            codec=codec)
        return m[0], n[0], s, w

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P("dcn"), P()),
                               out_specs=(P(), P("dcn"), P(), P()), check_vma=False))
    jm, jn, js, jw = fn(jnp.asarray(kernel), jnp.zeros((1,) + kernel.shape),
                        {k: jnp.asarray(v) for k, v in codec.items()})
    scale = float(np.abs(kernel).max())
    np.testing.assert_allclose(mean[0].numpy(), np.asarray(jm), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(new_ef[0].numpy(), np.asarray(jn)[0], rtol=0, atol=1e-6 * scale)
    # The decoded mean goes back to the port's (out, in) weight.
    (part,) = leaf.parts(mean[0])
    np.testing.assert_allclose(part.numpy(), np.asarray(jm).T, rtol=0, atol=1e-6 * scale)
    bm = np.asarray(js["blockmoment"])
    np.testing.assert_allclose(stats["blockmoment"].numpy(), bm, rtol=1e-5,
                               atol=1e-6 * np.abs(bm).max())
    np.testing.assert_allclose(float(stats["codec_recon_err"]), float(js["codec_recon_err"]),
                               rtol=1e-5)
    assert wire == float(jw) == 0.0
    # The element order matters: the port's own (out, in) layout cuts other
    # blocks, with another moment.
    own = pac.codec_blocks(grads[i])
    other = (own.T @ own / own.shape[0]).numpy()
    assert np.abs(other - bm[0]).max() > 1e-2 * np.abs(bm[0]).max()


# -- the learned step ------------------------------------------------------------------------


LEARNED = dict(compression="learned", topk_frac=TOPK_FRAC)


def every_rung_tables():
    """Tables that put each rung on some tensors, shifting each step. The
    key biases stay on int8: their gradient is zero in exact arithmetic
    (softmax ignores a constant added to every logit), so what either
    package computes for them is rounding noise, and so is their relative
    reconstruction error on a lossy rung (``codec_recon_err`` averages it)."""
    paths = [leaf.path for leaf in pcs.compression_leaves(
        SigLIP(port_config(jax_config()), device="meta"))]
    return [[0 if p.endswith("attn/k/bias") else (j + s) % pac.N_SCHEMES
             for j, p in enumerate(paths)] for s in range(STEPS)]


@pytest.fixture(scope="module")
def learned_ranks(tmp_path_factory):
    jcfg = jax_config()
    pcfg = port_config(jcfg)
    runs = [("pinned", {"step": LEARNED, "tables": every_rung_tables()}),
            ("budgeted", {"step": LEARNED, "controller": "budgeted",
                          "bandwidth_mbps": pinned_mbps(0.2)})]
    args = (runs, params_from_jax(jax_params0(), pcfg), pcfg, batch_np(jcfg, BATCH),
            pc.TrainConfig(**TRAIN_CFG), STEPS, DCN)
    return worker.spawn(aw.adaptive_step_worker, WORLD, args,
                        tmp_path_factory.mktemp("learned_step"), timeout_s=300)


def test_learned_step_with_every_rung_and_a_trained_codec_matches_jax(learned_ranks):
    """The codec trainer folds each step's block moment (JAX's layout);
    after two rounds its codec is staged, so step 3 runs the learned rung on
    the re-solved codec. Held in three links: the block moments equal JAX's
    (rtol 1e-4), the trainer is JAX's bit for bit on the same moment
    (``test_codec_trainer_equals_jax``), and the steps equal JAX's staging
    the port's codecs. (Two closed-form solves of moments an ulp apart can
    differ past the 16th eigenvalue's gap, so the codecs each package
    trains itself are compared by what they keep: the recon error within
    2%.)"""
    rec0 = learned_ranks[0]["pinned"]
    want = ref.jax_controller_run(jax_config(), dict(LEARNED), "greedy", None, learned=True,
                                  tables=every_rung_tables(), encoders=rec0["codecs"])
    ref.check_against_jax(learned_ranks, "pinned", want, TRAIN_CFG["learning_rate"],
                          extra=("codec_recon_err",))
    for i, st in enumerate(want["stats"]):
        bm = st["blockmoment"]
        got = rec0["comp"]["blockmoment"].numpy() if i == STEPS - 1 else None
        if got is not None:
            np.testing.assert_allclose(got, bm, rtol=1e-4, atol=1e-6 * np.abs(bm).max())
    for rec in learned_ranks:
        got = rec["pinned"]
        assert all(m["compression_scheme_hist"][pac.SCHEME_LEARNED] > 0 for m in got["metrics"])
        assert got["codecs"] == rec0["codecs"]
    # Before step 3 the staged codec is the trained one.
    assert not np.allclose(rec0["codecs"][2], pac.default_codec()["enc"])
    own = ref.jax_controller_run(jax_config(), dict(LEARNED), "greedy", None, learned=True,
                                 tables=every_rung_tables())
    np.testing.assert_allclose(rec0["metrics"][2]["codec_recon_err"],
                               own["metrics"][2]["codec_recon_err"], rtol=0.02)


def test_learned_ladder_under_the_budgeted_controller(learned_ranks):
    """Every rank decides what JAX's controller (learned ladder, budgeted)
    decides on the same stats, stages the same tables and ends equal; the
    learned rung is taken."""
    spec = {"step": LEARNED, "controller": "budgeted", "bandwidth_mbps": pinned_mbps(0.2)}
    rec0 = learned_ranks[0]["budgeted"]
    assert rec0["decided"] == ref.replay_controller(jax_config(), spec, rec0, learned=True)
    assert any(t.count(pac.SCHEME_LEARNED) for t in rec0["staged"][1:])
    for rec in learned_ranks[1:]:
        assert rec["budgeted"]["staged"] == rec0["staged"]
        for k, v in rec0["params"].items():
            assert torch.equal(rec["budgeted"]["params"][k], v), k
    assert all(np.isfinite(m["codec_recon_err"]) for m in rec0["metrics"])


def test_cold_codec_matches_jax_default():
    """Both packages start the learned rung on the same codec."""
    model = SigLIP(port_config(jax_config()), device="cpu")
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN_CFG)))
    state = pcs.with_adaptive_compression(state, learned=True)
    for k, mine in (("enc", "codec_enc"), ("dec", "codec_dec")):
        np.testing.assert_array_equal(state.comp[mine].numpy(), jac.default_codec()[k])

