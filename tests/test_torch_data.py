"""The port's input pipeline (``data/``) against the JAX package's: the
synthetic stream bitwise, the byte and BPE tokenizers (the same ids, the
same trained vocab JSON), the worker-count resolution; and ``prefetch``'s
contract: order, a source error at its position, ``close`` joining the
worker, and the starvation counters. On the CPU.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.data import tokenizer as jax_tok
from distributed_sigmoid_loss_tpu.data import workers as jax_workers
from distributed_sigmoid_loss_tpu.data.synthetic import SyntheticImageText as JaxSynthetic
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.data import (
    BpeTokenizer,
    ByteTokenizer,
    PrefetchStats,
    SyntheticImageText,
    prefetch,
    put_batch,
    shard_batch,
)
from distributed_sigmoid_loss_tpu_torch.data import workers as port_workers
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

CORPUS = [
    "a photo of a cat on a mat",
    "a photo of a dog in the fog",
    "the cat and the dog, together — ünïcödé too",
    "   leading and trailing spaces   ",
    "photo photo photo of of of",
    "a black and white photo of a cat",
]


@pytest.mark.parametrize("seeds", [(42, 40), (43, 41), (7, 9)])
def test_synthetic_stream_is_jaxs_bitwise(seeds):
    jcfg = jc.SigLIPConfig.tiny_test()
    pcfg = pc.SigLIPConfig.tiny_test()
    ref, got = iter(JaxSynthetic(jcfg, 6, *seeds)), iter(SyntheticImageText(pcfg, 6, *seeds))
    for _ in range(3):
        r, g = next(ref), next(got)
        for k in ("images", "tokens"):
            want = np.asarray(r[k])
            assert g[k].device.type == "cpu" and g[k].numpy().dtype == want.dtype, k
            assert np.array_equal(g[k].numpy(), want), k


def test_shard_batch_takes_a_ranks_rows():
    b = {"x": torch.arange(12).reshape(6, 2), "y": torch.arange(6)}
    assert all(torch.equal(shard_batch(b)[k], b[k]) for k in b)  # one process: every row
    got = shard_batch(b, rank=1, world=3)
    assert torch.equal(got["x"], b["x"][2:4]) and torch.equal(got["y"], b["y"][2:4])
    with pytest.raises(ValueError, match="world size 4"):
        shard_batch(b, rank=0, world=4)


def test_put_batch_on_the_cpu():
    b = {"x": np.ones((2, 3), np.float32), "t": torch.zeros(2, dtype=torch.int32)}
    out = put_batch(b, "cpu")
    assert out["x"].dtype == torch.float32 and torch.equal(out["x"], torch.ones(2, 3))
    assert out["t"].dtype == torch.int32
    # A copy: the source may reuse its buffers for the next batch.
    b["x"][:] = 7
    b["t"][:] = 7
    assert torch.equal(out["x"], torch.ones(2, 3)) and not out["t"].any()


TEXTS = ["hello", "ünïcödé", "a much longer caption that will be truncated", "", "x y"]


@pytest.mark.parametrize("length", [4, 8, 64])
@pytest.mark.parametrize("bos_eos", [(True, True), (False, True), (True, False)])
def test_byte_tokenizer_ids_are_jaxs(length, bos_eos):
    ref, got = jax_tok.ByteTokenizer(*bos_eos), ByteTokenizer(*bos_eos)
    assert got.vocab_size == ref.vocab_size
    out = got(TEXTS, length)
    assert out.dtype == np.int32 and np.array_equal(out, ref(TEXTS, length))
    for t in TEXTS:
        assert got.encode(t) == ref.encode(t)
        assert got.decode(got.encode(t)) == ref.decode(ref.encode(t))


@pytest.mark.parametrize("vocab_size", [259, 280, 4096])
def test_bpe_trains_the_same_vocab_json_and_ids(tmp_path, vocab_size):
    ref = jax_tok.BpeTokenizer.train(CORPUS, vocab_size)
    got = BpeTokenizer.train(CORPUS, vocab_size)
    ref.save(str(tmp_path / "jax.json"))
    got.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert got.vocab_size == ref.vocab_size
    for t in CORPUS + TEXTS:
        assert got.encode(t) == ref.encode(t)
        assert got.decode(got.encode(t)) == t
    assert np.array_equal(got(CORPUS, 12), ref(CORPUS, 12))
    loaded = BpeTokenizer.load(str(tmp_path / "jax.json"))
    assert loaded.merges == got.merges
    json.dump({"format": "other"}, open(tmp_path / "bad.json", "w"))
    with pytest.raises(ValueError, match="dsl-bpe-v1"):
        BpeTokenizer.load(str(tmp_path / "bad.json"))


@pytest.mark.parametrize("env", [None, "6", "nonsense"])
@pytest.mark.parametrize("requested", [None, 0, 3])
def test_resolve_data_workers_is_jaxs(monkeypatch, env, requested):
    if env is None:
        monkeypatch.delenv("DSL_DATA_WORKERS", raising=False)
    else:
        monkeypatch.setenv("DSL_DATA_WORKERS", env)
    warns = env == "nonsense" and not requested  # an explicit count reads no env
    with pytest.warns(UserWarning) if warns else _nothing():
        got = port_workers.resolve_data_workers(requested)
    with pytest.warns(UserWarning) if warns else _nothing():
        want = jax_workers.resolve_data_workers(requested)
    assert got == want >= 1
    with pytest.raises(ValueError):
        port_workers.resolve_data_workers(-2)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --- prefetch ------------------------------------------------------------------


def _host_batches(n, rows=8, delay=0.0):
    for i in range(n):
        if delay:
            time.sleep(delay)
        yield {"x": np.full((rows, 4), i, np.float32)}


def test_prefetch_keeps_order_and_places_on_the_device():
    got = list(prefetch(_host_batches(5), "cpu", size=2))
    assert [float(b["x"][0, 0]) for b in got] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["x"], torch.Tensor) for b in got)


def test_prefetch_relays_a_source_error_at_its_position():
    class Boom(RuntimeError):
        pass

    def source():
        yield {"x": np.zeros((8, 2), np.float32)}
        raise Boom("decode failed")

    stream = prefetch(source(), "cpu", size=2, stats=PrefetchStats())
    next(stream)
    with pytest.raises(Boom):
        next(stream)


def test_prefetch_close_joins_the_worker_and_releases_the_source():
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield {"x": np.full((8, 2), i, np.float32)}

    src = source()
    stream = prefetch(src, "cpu", size=2)
    next(stream)
    stream.close()
    assert not [t for t in threading.enumerate() if t.name == "dsl-prefetch"]
    n_after_close = len(produced)
    time.sleep(0.2)
    assert len(produced) == n_after_close, "the worker kept pulling after close"
    next(src)  # the caller owns the iterator again
    assert len(produced) == n_after_close + 1


def test_prefetch_stats_near_zero_when_the_producer_keeps_ahead():
    stats = PrefetchStats()
    stream = prefetch(_host_batches(12), "cpu", size=4, stats=stats)
    try:
        seen = 0
        for _ in zip(stream, range(10)):
            time.sleep(0.02)  # a slow consumer
            assert stats.consumed >= seen
            seen = stats.consumed
    finally:
        stream.close()
    snap = stats.snapshot()
    assert snap["produced"] >= snap["consumed"] >= 10
    assert snap["input_wait_frac"] < 0.2, snap
    assert snap["producer_wait_s"] > 0.01, snap


def test_prefetch_stats_positive_under_a_throttled_producer():
    stats = PrefetchStats()
    assert stats.input_wait_frac() == 0.0  # before the first get
    stream = prefetch(_host_batches(8, delay=0.05), "cpu", size=2, stats=stats)
    try:
        for _ in zip(stream, range(6)):
            pass
    finally:
        stream.close()
    snap = stats.snapshot()
    assert snap["input_wait_frac"] > 0.3, snap
    assert snap["consumer_wait_s"] > 0.0 and snap["consumed"] >= 6, snap
