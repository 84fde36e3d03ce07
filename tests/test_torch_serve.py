"""The port's serving stack vs the JAX package's on the CPU.

Both packages' ``InferenceEngine.from_model`` + ``EmbeddingService`` run the
tiny towers on the same weights (carried with ``params_from_jax``) and the
same numpy-seeded requests: embeddings agree at rtol 1e-4, search ids are
identical on a tie-free corpus, and the port keeps the engine's bucket,
padding, swap and cache contracts. The host-only pieces (ranking helpers,
index, batcher, latency window, content keys) are held to their JAX
counterparts directly.
"""

import dataclasses
import threading

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.eval import retrieval as jax_retrieval
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.serve import EmbeddingService as JaxEmbeddingService
from distributed_sigmoid_loss_tpu.serve import InferenceEngine as JaxInferenceEngine
from distributed_sigmoid_loss_tpu.serve import RetrievalIndex as JaxRetrievalIndex
from distributed_sigmoid_loss_tpu.serve import content_key as jax_content_key
from distributed_sigmoid_loss_tpu.utils.config import SigLIPConfig as JaxSigLIPConfig
from distributed_sigmoid_loss_tpu.utils.logging import LatencyWindow as JaxLatencyWindow
from distributed_sigmoid_loss_tpu_torch.eval.retrieval import merge_topk, topk_ids
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.serve import (
    EmbeddingCache,
    EmbeddingService,
    InferenceEngine,
    MicroBatcher,
    QueueFullError,
    RetrievalIndex,
    content_key,
)
from distributed_sigmoid_loss_tpu_torch.utils import config as pc
from distributed_sigmoid_loss_tpu_torch.utils.logging import LatencyWindow

BUCKETS = (1, 4)
CTX = 8  # tiny config's context_length
HW = 16  # tiny config's image size


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(
        vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
        text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
        loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)),
    )


@pytest.fixture(scope="module")
def stacks():
    """(jax service, port service) over the same tiny weights."""
    jcfg = JaxSigLIPConfig.tiny_test()
    jmodel = JaxSigLIP(jcfg)
    imgs = np.zeros((1, HW, HW, 3), np.float32)
    toks = np.zeros((1, CTX), np.int32)
    params = jax.jit(jmodel.init)(jax.random.key(0), imgs, toks)
    params = jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))
    jeng = JaxInferenceEngine.from_model(jmodel, params, batch_buckets=BUCKETS)
    jeng.warmup()
    model = SigLIP(port_config(jcfg), device="cpu")
    model.load_state_dict(params_from_jax(params, port_config(jcfg)), strict=True)
    peng = InferenceEngine.from_model(model, batch_buckets=BUCKETS)
    assert peng.warmup() == peng.bucket_space == len(BUCKETS) * 2
    jsvc = JaxEmbeddingService(jeng, cache=None, max_wait_ms=1.0)
    psvc = EmbeddingService(peng, cache=EmbeddingCache(64), max_wait_ms=1.0)
    yield jsvc, psvc
    jsvc.close()
    psvc.close()


def test_service_embeddings_match_jax(stacks):
    jsvc, psvc = stacks
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 64, (3, CTX)).astype(np.int32)
    imgs = rng.standard_normal((4, HW, HW, 3)).astype(np.float32)
    for kind, x in (("text", toks), ("image", imgs)):
        ref = getattr(jsvc, f"encode_{kind}")(x)
        out = getattr(psvc, f"encode_{kind}")(x)
        assert out.dtype == np.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


def test_search_ids_identical_to_jax_and_oracle(stacks):
    jsvc, psvc = stacks
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((12, HW, HW, 3)).astype(np.float32)
    queries = rng.integers(1, 64, (4, CTX)).astype(np.int32)
    jidx, pidx = JaxRetrievalIndex(chunk_size=5), RetrievalIndex(chunk_size=5)
    jemb, pemb = jsvc.encode_image(corpus), psvc.encode_image(corpus)
    jidx.add(jemb)
    pidx.add(pemb)
    jsvc_search = JaxEmbeddingService(jsvc.engine, index=jidx, max_wait_ms=1.0)
    psvc_search = EmbeddingService(psvc.engine, index=pidx, max_wait_ms=1.0)
    try:
        _, jids = jsvc_search.search(queries, k=5)
        scores, pids = psvc_search.search(queries, k=5)
        q = psvc_search.encode_text(queries)
    finally:
        jsvc_search.close()
        psvc_search.close()
    sims = q @ pemb.T
    # Tie-free: the top-6 scores of every row are separated.
    top = np.sort(sims, axis=1)[:, ::-1][:, :6]
    assert np.all(np.diff(top, axis=1) < -1e-4)
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_array_equal(pids, topk_ids(sims, 5))
    np.testing.assert_allclose(scores, np.take_along_axis(sims, pids, axis=1), rtol=1e-6)


def test_compile_count_stays_at_bucket_space_over_mixed_sizes(stacks):
    _, psvc = stacks
    engine = psvc.engine
    assert engine.compile_count == engine.bucket_space
    rng = np.random.default_rng(2)
    for _ in range(10):
        n = int(rng.integers(1, BUCKETS[-1] + 1))
        engine.encode_text(rng.integers(0, 64, (n, int(rng.integers(1, CTX + 1)))))
        engine.encode_image(rng.standard_normal((n, HW, HW, 3)).astype(np.float32))
    assert engine.compile_count == engine.bucket_space
    with pytest.raises(ValueError, match="largest bucket"):
        engine.encode_text(np.zeros((BUCKETS[-1] + 1, CTX), np.int32))
    with pytest.raises(ValueError, match="shape"):
        engine.encode_image(np.zeros((1, 8, 8, 3), np.float32))


def test_batch_padding_leaves_real_rows_unchanged(stacks):
    _, psvc = stacks
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, (3, CTX)).astype(np.int32)
    imgs = rng.standard_normal((3, HW, HW, 3)).astype(np.float32)
    for enc, x in ((psvc.engine.encode_text, toks), (psvc.engine.encode_image, imgs)):
        one_by_one = np.stack([enc(row)[0] for row in x])
        batched = enc(x)  # pads 3 -> bucket 4
        np.testing.assert_allclose(batched, one_by_one, rtol=1e-5, atol=1e-6)


def test_swap_params_refuses_shape_change_and_keeps_buckets(stacks):
    _, psvc = stacks
    engine = psvc.engine
    old = engine.params
    bad = dict(old)
    bad["visual.proj.bias"] = torch.zeros(old["visual.proj.bias"].shape[0] + 1)
    with pytest.raises(ValueError, match="spec"):
        engine.swap_params(bad)
    missing = {k: v for k, v in old.items() if k != "bias"}
    with pytest.raises(ValueError, match="names"):
        engine.swap_params(missing)
    toks = np.arange(1, CTX + 1, dtype=np.int32)[None]
    before = engine.encode_text(toks)
    # An additive perturbation (a rescale would normalize away).
    engine.swap_params({k: v + 0.05 for k, v in old.items()})
    try:
        assert not np.allclose(engine.encode_text(toks), before)
        assert engine.compile_count == engine.bucket_space
    finally:
        engine.swap_params(old)
    np.testing.assert_array_equal(engine.encode_text(toks), before)


def test_cache_hit_returns_stored_row(stacks):
    _, psvc = stacks
    row = np.arange(2, CTX + 2, dtype=np.int32)
    first = psvc.encode_text(row)
    hits = psvc.cache.stats()["hits"]
    second = psvc.encode_text(row)
    assert psvc.cache.stats()["hits"] == hits + 1
    np.testing.assert_array_equal(second, first)
    np.testing.assert_array_equal(psvc.cache.get(content_key(row, "text")), first[0])
    stats = psvc.stats()
    assert stats["compile_count"] == stats["bucket_space"]
    assert stats["requests"] >= 2 and stats["cache"]["hits"] >= 1


def test_ranking_helpers_match_jax():
    rng = np.random.default_rng(4)
    sims = rng.integers(0, 5, (6, 40)).astype(np.float32)  # many exact ties
    np.testing.assert_array_equal(topk_ids(sims, 7), jax_retrieval.topk_ids(sims, 7))
    ids = np.stack([rng.permutation(40) for _ in range(6)])
    ids[:, :3] = -1  # padding candidates
    for a, b in zip(merge_topk(sims, ids, 9), jax_retrieval.merge_topk(sims, ids, 9)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk_size", [3, 4096])
def test_index_matches_jax_index_under_ties(chunk_size):
    rng = np.random.default_rng(5)
    rows = rng.integers(-2, 3, (30, 4)).astype(np.float32)
    queries = rng.integers(-2, 3, (5, 4)).astype(np.float32)
    pidx, jidx = RetrievalIndex(chunk_size=chunk_size), JaxRetrievalIndex(chunk_size=chunk_size)
    for block in (rows[:7], rows[7:]):
        pidx.add(block)
        jidx.add(block)
    for a, b in zip(pidx.search(queries, 8), jidx.search(queries, 8)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pidx.search(queries, 8)[1], topk_ids(queries @ rows.T, 8))


def test_batcher_coalesces_and_backpressures():
    release = threading.Event()
    calls = []

    def run_batch(items):
        if not calls:
            release.wait(timeout=10)
        calls.append(len(items))
        return [x * 2 for x in items]

    # The worker holds its first batch (at most 4 items) until released, so
    # at most 4 + 8 submissions fit before the bounded queue pushes back.
    with MicroBatcher(run_batch, max_batch_size=4, max_wait_ms=50, max_queue=8) as mb:
        futures = []
        with pytest.raises(QueueFullError):
            for i in range(13):
                futures.append(mb.submit(i))
        release.set()
        results = [f.result(timeout=10) for f in futures]
    assert results == [2 * i for i in range(len(futures))]
    assert max(calls) > 1 and sum(calls) == len(futures)
    assert sum(mb.batch_size_histogram().values()) == len(calls)


def test_batcher_drains_backlog_past_deadline():
    """Past the first item's deadline the worker still takes what is already
    queued, so a backlog flushes as full batches, not one item per call."""
    started, release = threading.Event(), threading.Event()
    calls = []

    def run_batch(items):
        if not calls:
            started.set()
            release.wait(timeout=10)
        calls.append(len(items))
        return items

    with MicroBatcher(run_batch, max_batch_size=4, max_wait_ms=0, max_queue=64) as mb:
        futures = [mb.submit(0)]
        assert started.wait(timeout=10)
        futures += [mb.submit(i) for i in range(1, 9)]
        release.set()
        assert [f.result(timeout=10) for f in futures] == list(range(9))
    assert calls == [1, 4, 4]


def test_latency_window_and_content_key_match_jax():
    samples = np.random.default_rng(6).exponential(0.01, 101)
    pw, jw = LatencyWindow(64), JaxLatencyWindow(64)
    for s in samples:
        pw.record(s)
        jw.record(s)
    assert pw.percentiles_ms((50, 95, 99)) == jw.percentiles_ms((50, 95, 99))
    assert pw.count == jw.count == 101
    for content in ("a caption", b"raw", np.arange(6, dtype=np.int32).reshape(2, 3)):
        assert content_key(content, "text") == jax_content_key(content, "text")
