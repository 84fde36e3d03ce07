"""The port's retrieval tiers, router, hot swap, telemetry and service tail
vs the JAX package's on the CPU.

- ``ShardedIndex``: 4 shards on the CPU against JAX's over a 4-device mesh
  and against ``topk_ids`` (uneven corpus, planted exact ties across shards,
  k past the rows per shard, one query row, custom ids): identical ids,
  scores within 1e-6.
- ``AnnIndex`` and ``sign_sketch*``: the same survivors and ids as JAX's at
  the same ``rerank_k``, the sketches bitwise.
- ``RetrievalRouter``: every tier against JAX's router, ``stats()`` keys
  equal; ``SwapController`` over the tiny towers under concurrent load, and
  the swapped weights' embeddings against JAX's engine swapped the same way.
- ``obs``: the registry equal to JAX's, ``render_openmetrics`` equal text,
  the live ``/metrics`` and ``/healthz`` endpoints.
"""

import dataclasses
import json
import threading
import urllib.request

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.eval.retrieval import topk_ids
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.obs import metrics_schema as jax_schema
from distributed_sigmoid_loss_tpu.obs import telemetry as jax_telemetry
from distributed_sigmoid_loss_tpu.ops import quant as jax_quant
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.serve import AnnIndex as JaxAnnIndex
from distributed_sigmoid_loss_tpu.serve import InferenceEngine as JaxInferenceEngine
from distributed_sigmoid_loss_tpu.serve import RetrievalRouter as JaxRetrievalRouter
from distributed_sigmoid_loss_tpu.serve import ShardedIndex as JaxShardedIndex
from distributed_sigmoid_loss_tpu.utils.config import SigLIPConfig as JaxSigLIPConfig
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.obs import metrics_schema, telemetry
from distributed_sigmoid_loss_tpu_torch.ops import quant
from distributed_sigmoid_loss_tpu_torch.serve import (
    AnnIndex,
    EmbeddingService,
    InferenceEngine,
    RetrievalRouter,
    ShardedIndex,
    SwapController,
)
from distributed_sigmoid_loss_tpu_torch.utils import config as pc
from distributed_sigmoid_loss_tpu_torch.utils.logging import MetricsLogger

SHARDS = 4
CPU4 = ["cpu"] * SHARDS


def _l2(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(SHARDS)


def _assert_same_search(port, ref, queries, k, oracle_sims=None):
    ps, pi = port.search(queries, k)
    js, ji = ref.search(queries, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, np.asarray(js), rtol=0, atol=1e-6)
    if oracle_sims is not None:
        np.testing.assert_array_equal(np.atleast_2d(pi), topk_ids(oracle_sims, k))
    return pi


# ---------------------------------------------------------------------------
# ShardedIndex — 4 CPU shards vs JAX's 4-device mesh vs the one-matrix oracle
# ---------------------------------------------------------------------------


def test_sharded_uneven_corpus_matches_jax_and_oracle(mesh4):
    rng = np.random.default_rng(1)
    corpus = _l2(rng.standard_normal((203, 16)).astype(np.float32))  # 203 = 4*51 - 1
    queries = _l2(rng.standard_normal((9, 16)).astype(np.float32))
    idx = ShardedIndex(corpus, devices=CPU4)
    assert idx.shard_count == SHARDS and len(idx) == 203 and idx.rows_per_shard == 51
    _assert_same_search(idx, JaxShardedIndex(corpus, mesh=mesh4), queries, 7,
                        queries @ corpus.T)


def test_sharded_planted_exact_ties_across_shards(mesh4):
    rng = np.random.default_rng(2)
    row = _l2(np.ones((1, 16), np.float32))
    corpus = _l2(rng.standard_normal((40, 16)).astype(np.float32))
    # Identical rows on different shards (10 rows a shard): the cross-shard
    # exact-tie merge, and a tie inside one shard (positions 21 and 27).
    for pos in (5, 21, 27, 35):
        corpus[pos] = row
    ids = _assert_same_search(ShardedIndex(corpus, devices=CPU4),
                              JaxShardedIndex(corpus, mesh=mesh4), row, 6, row @ corpus.T)
    assert ids[0][:4].tolist() == [5, 21, 27, 35]  # the tie run, lower id first


def test_sharded_integer_scores_full_of_ties(mesh4):
    """Small-integer rows: every score is exact in f32 in any summation
    order, and most rows tie with others; the per-shard stable sort must
    give JAX's (lax.top_k's) lower-index order."""
    rng = np.random.default_rng(3)
    corpus = rng.integers(-2, 3, (203, 4)).astype(np.float32)
    queries = rng.integers(-2, 3, (6, 4)).astype(np.float32)
    _assert_same_search(ShardedIndex(corpus, devices=CPU4),
                        JaxShardedIndex(corpus, mesh=mesh4), queries, 17, queries @ corpus.T)


def test_sharded_k_past_rows_per_shard_and_clamp(mesh4):
    rng = np.random.default_rng(4)
    corpus = _l2(rng.standard_normal((12, 8)).astype(np.float32))  # 3 rows a shard
    queries = _l2(rng.standard_normal((4, 8)).astype(np.float32))
    port, ref = ShardedIndex(corpus, devices=CPU4), JaxShardedIndex(corpus, mesh=mesh4)
    assert port.rows_per_shard == 3
    _assert_same_search(port, ref, queries, 10, queries @ corpus.T)
    ids = _assert_same_search(port, ref, queries, 1000, queries @ corpus.T)
    assert ids.shape == (4, 12)


def test_sharded_single_query_row_and_custom_ids(mesh4):
    rng = np.random.default_rng(5)
    corpus = _l2(rng.standard_normal((50, 8)).astype(np.float32))
    custom = np.arange(50, dtype=np.int64) * 3 + 7  # ascending, not contiguous
    port = ShardedIndex(corpus, custom, devices=CPU4)
    q = corpus[13]
    scores, ids = port.search(q, 5)
    assert scores.shape == ids.shape == (5,)
    np.testing.assert_array_equal(ids, custom[topk_ids(q[None] @ corpus.T, 5)[0]])
    _assert_same_search(port, JaxShardedIndex(corpus, custom, mesh=mesh4), q, 5)


def test_sharded_tensor_input_and_bucket_discipline():
    rng = np.random.default_rng(6)
    corpus = _l2(rng.standard_normal((64, 8)).astype(np.float32))
    from_tensor = ShardedIndex(torch.from_numpy(corpus), devices=CPU4, query_buckets=(1, 8))
    from_array = ShardedIndex(corpus, devices=["cpu"], query_buckets=(1, 8))
    for n in (1, 1, 3, 8, 5):  # mixed sizes inside the bucket grid
        q = _l2(rng.standard_normal((n, 8)).astype(np.float32))
        for a, b in zip(from_tensor.search(q, 5), from_array.search(q, 5)):
            np.testing.assert_array_equal(a, b)
    # Two (query bucket, k_local) points, never one per request.
    assert from_tensor.compile_count == 2
    assert from_tensor.stats() == {"size": 64, "shard_count": 4, "rows_per_shard": 16,
                                   "compile_count": 2}
    with pytest.raises(ValueError, match="query bucket"):
        from_tensor.search(np.zeros((9, 8), np.float32), 5)
    with pytest.raises(ValueError, match="dim"):
        from_tensor.search(np.zeros((1, 4), np.float32), 5)
    with pytest.raises(ValueError, match="non-empty"):
        ShardedIndex(np.zeros((0, 8), np.float32), devices=CPU4)
    with pytest.raises(ValueError, match=">= 0"):
        ShardedIndex(corpus, np.full(64, -2), devices=CPU4)
    with pytest.raises(ValueError, match="devices"):
        ShardedIndex(corpus, devices=[])


# ---------------------------------------------------------------------------
# AnnIndex and the sign sketches
# ---------------------------------------------------------------------------


def test_sign_sketch_bitwise_equal_to_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((33, 37)).astype(np.float32)
    x[0, :5] = 0.0  # the sign bit of zero: >= 0
    q = rng.standard_normal((5, 37)).astype(np.float32)
    bits, jbits = quant.sign_sketch(x), jax_quant.sign_sketch(x)
    assert bits.dtype == jbits.dtype and bits.shape == (33, 5)
    np.testing.assert_array_equal(bits, jbits)
    qbits = quant.sign_sketch(q)
    np.testing.assert_array_equal(quant.sign_sketch_scores(qbits, bits, 37),
                                  jax_quant.sign_sketch_scores(qbits, bits, 37))
    with pytest.raises(ValueError, match="rows"):
        quant.sign_sketch(x[0])


@pytest.mark.parametrize("coarse,rerank_k", [("int8", None), ("int8", 16), ("sign", 24),
                                             ("sign", 128)])
def test_ann_survivors_and_ids_match_jax(coarse, rerank_k):
    rng = np.random.default_rng(8)
    corpus = _l2(rng.standard_normal((256, 32)).astype(np.float32))
    queries = _l2(rng.standard_normal((16, 32)).astype(np.float32))
    port = AnnIndex(corpus, coarse=coarse, rerank_k=rerank_k)
    ref = JaxAnnIndex(corpus, coarse=coarse, rerank_k=rerank_k)
    if coarse == "int8":
        np.testing.assert_array_equal(port._q8, ref._q8)
        np.testing.assert_array_equal(port._scale, ref._scale)
    rk = port._resolve_rerank_k(5, None)
    assert rk == ref._resolve_rerank_k(5, None)
    pos, jpos = port.coarse_positions(queries, rk), ref.coarse_positions(queries, rk)
    np.testing.assert_array_equal(np.sort(pos, axis=1), np.sort(jpos, axis=1))
    ps, pi = port.search(queries, 5)
    js, ji = ref.search(queries, 5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(ps, js)
    assert port.stats() == ref.stats()


def test_ann_full_width_rerank_is_exact_and_validates():
    rng = np.random.default_rng(9)
    corpus = _l2(rng.standard_normal((256, 16)).astype(np.float32))
    queries = _l2(rng.standard_normal((16, 16)).astype(np.float32))
    for coarse in ("int8", "sign"):
        _, ids = AnnIndex(corpus, coarse=coarse).search(queries, 10, rerank_k=256)
        np.testing.assert_array_equal(ids, topk_ids(queries @ corpus.T, 10))
    with pytest.raises(ValueError, match="coarse"):
        AnnIndex(np.eye(4, dtype=np.float32), coarse="fp4")
    ann = AnnIndex(np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="dim"):
        ann.search(np.ones(8, np.float32), 2)
    with pytest.raises(ValueError, match="k must be"):
        ann.search(np.ones(4, np.float32), 0)


# ---------------------------------------------------------------------------
# RetrievalRouter — every tier against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["exact", "sharded", "ann"])
def test_router_tier_matches_jax_router(tier, mesh4):
    rng = np.random.default_rng(10)
    corpus = _l2(rng.standard_normal((96, 16)).astype(np.float32))
    corpus[50] = corpus[3]  # an exact tie across shards
    queries = _l2(rng.standard_normal((5, 16)).astype(np.float32))
    queries[0] = corpus[3]
    port = RetrievalRouter(tier=tier, measure_every=1,
                           **({"devices": CPU4} if tier == "sharded" else {}))
    ref = JaxRetrievalRouter(tier=tier, measure_every=1,
                             **({"mesh": mesh4} if tier == "sharded" else {}))
    for router in (port, ref):
        assert len(router) == 0
        with pytest.raises(ValueError, match="publish"):
            router.search(queries, 6)
        assert router.publish(corpus) == 1 and len(router) == 96
    for q in (queries, queries[1]):
        ps, pi, pv = port.search(q, 6, return_version=True)
        js, ji, jv = ref.search(q, 6, return_version=True)
        assert pv == jv == 1
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(ps, np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.search(queries, 6)[1], topk_ids(queries @ corpus.T, 6))
    assert port.search(queries, 6)[1][0][:2].tolist() == [3, 50]
    assert port.publish_built(None) == ref.publish_built(None) == 2
    snap, jsnap = port.stats(), ref.stats()
    assert list(snap) == list(jsnap)
    assert sorted(snap["search_stage_latency_ms"]) == sorted(jsnap["search_stage_latency_ms"])
    for key in ("index_tier", "index_version", "shard_count", "swap_count", "recall_at_k",
                "rerank_k", "swap_in_flight"):
        assert snap[key] == jsnap[key], key
    assert metrics_schema.validate_metrics(snap, fields=metrics_schema.SERVE_STATS_FIELDS,
                                           prefixes=()) == []


def test_router_refusals():
    with pytest.raises(ValueError, match="devices"):
        RetrievalRouter(tier="sharded")
    with pytest.raises(ValueError, match="tier"):
        RetrievalRouter(tier="ivf")
    router = RetrievalRouter()
    with pytest.raises(ValueError, match="publish"):
        router.publish_built(None)


# ---------------------------------------------------------------------------
# Hot swap over the tiny towers, against JAX's engine swapped the same way
# ---------------------------------------------------------------------------

CTX = 8
BUCKETS = (1, 4)


def _port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(
        vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
        text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
        loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)),
    )


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxSigLIPConfig.tiny_test()
    jmodel = JaxSigLIP(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32),
                                  np.zeros((1, CTX), np.int32))
    params = jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))
    jeng = JaxInferenceEngine.from_model(jmodel, params, batch_buckets=BUCKETS)
    jeng.warmup()
    cfg = _port_config(jcfg)
    model = SigLIP(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    peng = InferenceEngine.from_model(model, batch_buckets=BUCKETS)
    peng.warmup()
    return jeng, peng, params, cfg


def test_swap_params_takes_jax_perturbed_weights(engines):
    """The same additive perturbation swapped into both engines: the port's
    embeddings follow JAX's, and no bucket is added."""
    jeng, peng, params, cfg = engines
    rng = np.random.default_rng(11)
    perturbed = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype), params)
    toks = rng.integers(1, 64, (3, CTX)).astype(np.int32)
    old_j, old_p = jeng.params, peng.params
    before = peng.encode_text(toks)
    try:
        jeng.swap_params(perturbed)
        peng.swap_params(params_from_jax(perturbed, cfg))
        got, want = peng.encode_text(toks), jeng.encode_text(toks)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        assert not np.allclose(got, before)
        assert peng.compile_count == peng.bucket_space
    finally:
        jeng.swap_params(old_j)
        peng.swap_params(old_p)
    np.testing.assert_array_equal(peng.encode_text(toks), before)


def test_swap_under_concurrent_load_versions_monotone(engines):
    """Concurrent search clients across three hot swaps of weights and
    index: no errors, each client's versions non-decreasing, no new
    bucket, the swap bookkeeping in ``stats()``."""
    _, engine, _, _ = engines
    rng = np.random.default_rng(12)
    corpus = np.concatenate([engine.encode_text(rng.integers(0, 64, (4, CTX), dtype=np.int32))
                             for _ in range(6)])
    router = RetrievalRouter(tier="ann", measure_every=4)
    router.publish(corpus)
    old = engine.params
    ctl = SwapController(engine, router)
    errors, versions = [], {}
    start = threading.Barrier(5)
    try:
        with EmbeddingService(engine, index=router, max_wait_ms=2.0) as svc:

            def client(cid):
                crng = np.random.default_rng(100 + cid)
                seen = []
                try:
                    start.wait(timeout=10)
                    for _ in range(20):
                        q = crng.integers(0, 64, CTX, dtype=np.int32)
                        _, ids, ver = svc.search(q, k=3, return_version=True)
                        assert ids.shape[-1] == 3
                        seen.append(ver)
                except Exception as e:  # noqa: BLE001 — the drill counts them
                    errors.append(e)
                versions[cid] = seen

            threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            start.wait(timeout=10)
            for j in range(3):
                ctl.swap(params={k: v + 0.01 * (j + 1) for k, v in old.items()},
                         embeddings=corpus)
            for t in threads:
                t.join(timeout=60)
            snap = svc.stats()
    finally:
        engine.swap_params(old)
    assert errors == []
    assert router.version == 4
    for cid, seen in versions.items():
        assert len(seen) == 20 and all(a <= b for a, b in zip(seen, seen[1:])), (cid, seen)
    assert engine.compile_count == engine.bucket_space
    assert snap["swap_count"] == 3 and snap["index_version"] == 4
    assert not snap["swap_in_flight"]
    with pytest.raises(ValueError, match="params and/or embeddings"):
        ctl.swap()


# ---------------------------------------------------------------------------
# obs: the registry, the exposition text, the live endpoints
# ---------------------------------------------------------------------------


def test_metrics_registry_equal_to_jax():
    for name in ("TRAIN_METRICS_FIELDS", "TRAIN_METRICS_PREFIXES", "SERVE_STATS_FIELDS",
                 "HEALTH_EVENT_FIELDS"):
        assert getattr(metrics_schema, name) == getattr(jax_schema, name), name
    bad = {"metric": "serve_stats", "qps": 1.0, "made_up": 2}
    assert metrics_schema.validate_metrics(bad, metrics_schema.SERVE_STATS_FIELDS) == \
        jax_schema.validate_metrics(bad, jax_schema.SERVE_STATS_FIELDS)
    assert metrics_schema.validate_metrics([1]) == jax_schema.validate_metrics([1])


def test_render_openmetrics_equal_to_jax():
    snap = {"qps": 12.5, "requests": 3, "swap_in_flight": True, "index_tier": "ann",
            "recall_at_k": None, "latency_ms": {"p50_ms": 1.25, "p99_ms": 3.0},
            "batch_size_hist": {"text": {"1": 2, "4": 1}, "image": {}},
            "stage_latency_ms": {"text": {"device": {"p50_ms": 0.5}}},
            "admission": {"capacity": 8, "per_tenant": {"gold": {"shed": 1,
                                                                 "latency_ms": {"p95_ms": 2}}}}}
    for labels in (None, {"tenant": 'a"b'}):
        assert telemetry.render_openmetrics(snap, labels=labels) == \
            jax_telemetry.render_openmetrics(snap, labels=labels)


def test_metrics_logger_warns_on_unregistered_fields(capsys):
    import io

    out = io.StringIO()
    logger = MetricsLogger(out, schema=metrics_schema.TRAIN_METRICS_FIELDS,
                           schema_prefixes=metrics_schema.TRAIN_METRICS_PREFIXES)
    logger.log(1, {"loss": 1.0, "eval/i2t_recall@1": 0.5})
    logger.log(2, {"loss": 0.5, "mystery": 1.0})
    logger.write({"metric": "serve_stats", "nope": 1}, schema=metrics_schema.SERVE_STATS_FIELDS)
    err = capsys.readouterr().err
    assert "'mystery'" in err and "'nope'" in err and "eval/" not in err
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [r.get("step") for r in lines] == [1, 2, None]  # every line still printed


def test_live_metrics_and_healthz_endpoints(engines):
    _, engine, _, _ = engines
    router = RetrievalRouter(tier="exact")
    router.publish(np.eye(16, dtype=np.float32))
    with EmbeddingService(engine, index=router, max_wait_ms=1.0) as svc:
        exporter = svc.start_metrics_server(port=0, labels={"tenant": "t0"}, refresh_s=60.0)
        with pytest.raises(RuntimeError, match="already started"):
            svc.start_metrics_server()
        svc.encode_text(np.arange(1, CTX + 1, dtype=np.int32))
        base = f"http://{exporter.host}:{exporter.port}"
        bodies = []
        for _ in range(3):
            with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
                assert resp.status == 200
                bodies.append(resp.read().decode())
        assert bodies[0] == bodies[1] == bodies[2]  # one snapshot per refresh window
        assert exporter.render_count == 1 and exporter.scrapes == 3
        text = bodies[0]
        for field in svc.stats():
            assert f"dsl_serve_{field}" in text or field == "index_tier", field
        assert 'tenant="t0"' in text and 'index_tier="exact"' in text
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health == {"ok": True, "status": "ok", "shed_rate": 0.0,
                          "swap_in_flight": False, "reasons": []}
        router.begin_swap()
        assert svc.health()["reasons"] == ["swap_in_flight"]
        router.end_swap()
        logged = svc.log_stats()
        assert logged["compile_count"] == engine.compile_count
    assert svc._exporter is None  # close() stopped it
