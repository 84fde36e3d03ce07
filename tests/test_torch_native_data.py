"""The port's native engines (``data/native_decode.py``,
``data/native_loader.py``) against the JAX package's, on the CPU.

The port builds ``native/jpeg_decode.cc`` and ``native/dataloader.cc`` with
``g++`` into a temporary directory here (its ``BUILD_DIR``; the checkout's
``build/`` otherwise), never into ``native/``. Then:

- ``decode_batch`` equals JAX's bitwise on the committed JPEG fixture
  (``tests/fixtures/jpeg_pairs.tar``) and on PIL-made JPEGs; mixed batches
  fall back bitwise, the thread count changes nothing, and a corrupt blob
  raises; the shard loader with ``native_decode=True`` gives JAX's batches;
- ``NativeSyntheticImageText`` gives JAX's batches bitwise across seeds and
  thread counts, with ``zero_copy`` on and off and through ``prefetch``;
  ``close()`` does not hang while a consumer is blocked;
- ``train --native-decode`` on JPEG shards learns the convergence oracle
  without its fallback warning, and ``train --native-data`` runs without
  its own.

Each skips with a reason where ``g++`` or libjpeg is missing, as JAX's own
tests do.
"""

import contextlib
import io
import json
import os
import shutil
import sys
import tarfile
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from distributed_sigmoid_loss_tpu.data import files as jax_files
from distributed_sigmoid_loss_tpu.data import native_decode as jax_decode
from distributed_sigmoid_loss_tpu.data import native_loader as jax_loader
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.data import ByteTokenizer, files, prefetch
from distributed_sigmoid_loss_tpu_torch.data import native_decode, native_loader
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jpeg_pairs.tar")
sys.path.insert(0, os.path.join(REPO, "tests"))
from _torch_real_data import bmp, pil_bytes, train_oracle, write_oracle_dataset  # noqa: E402

JCFG, PCFG = jc.SigLIPConfig.tiny_test(), pc.SigLIPConfig.tiny_test()


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    """The port's native libraries build into a temporary directory."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler (g++) on this host")
    path = tmp_path_factory.mktemp("native_build")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native_loader, "BUILD_DIR", path)
        yield path


@pytest.fixture(scope="module")
def jpeg_engine(build_dir):
    if not native_decode.native_decode_available():
        pytest.skip("the libjpeg engine does not build here (libjpeg missing)")
    if not jax_decode.native_decode_available():
        pytest.skip("the JAX package's libjpeg engine is unavailable")
    return build_dir


def fixture_blobs():
    with tarfile.open(FIXTURE) as tf:
        return [tf.extractfile(m).read() for m in tf if m.name.endswith(".jpg")]


def noise_jpeg(w, h, seed=0):
    """Uniform noise at quality 95: the decoders' worst case."""
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=95)
    return buf.getvalue()


def test_fixture_is_16_jpeg_pairs_within_64_kb():
    assert os.path.getsize(FIXTURE) <= 64 * 1024
    with tarfile.open(FIXTURE) as tf:
        names = sorted(m.name for m in tf)
    assert len(names) == 32
    for blob in fixture_blobs():
        with Image.open(io.BytesIO(blob)) as im:
            assert im.format == "JPEG" and im.size == (64, 48)


def test_libraries_build_into_the_build_dir_not_native(build_dir):
    before = sorted(os.listdir(native_loader.NATIVE_DIR))
    native_loader.load_library()
    assert sorted(os.listdir(native_loader.NATIVE_DIR)) == before
    built = [p for p in os.listdir(build_dir) if p.startswith("libdsl_data-")]
    assert len(built) == 1 and built[0].endswith(".so")


@pytest.mark.parametrize("size", [16, 64, 224])
def test_decode_batch_is_jaxs_bitwise_on_the_fixture(jpeg_engine, size):
    blobs = fixture_blobs()
    want = jax_decode.decode_batch(blobs, size, threads=3)
    got = native_decode.decode_batch(blobs, size, threads=3)
    assert got.shape == (16, size, size, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("w,h", [(320, 240), (100, 300), (64, 64), (640, 480)])
def test_decode_batch_is_jaxs_bitwise_on_pil_jpegs(jpeg_engine, w, h):
    blobs = [noise_jpeg(w, h, seed=s) for s in range(3)]
    for size in (64, 224):
        want = jax_decode.decode_batch(blobs, size)
        got = native_decode.decode_batch(blobs, size)
        assert np.array_equal(got, want), size
        assert got.min() >= -1.0 and got.max() <= 1.0


def test_mixed_batches_fall_back_bitwise_and_threads_change_nothing(jpeg_engine):
    arr = np.random.default_rng(1).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    blobs = [noise_jpeg(200, 150, seed=i) for i in range(3)]
    blobs += [pil_bytes(arr, "PNG"), bmp(arr), bmp(arr, 32, top_down=True), fixture_blobs()[0]]
    want = jax_decode.decode_batch(blobs, 48, threads=4)
    one, four = (native_decode.decode_batch(blobs, 48, threads=t) for t in (1, 4))
    assert np.array_equal(one, four) and np.array_equal(four, want)
    # The rejected blobs came back through decode_and_resize.
    for i in (3, 4, 5):
        assert np.array_equal(four[i], files.decode_and_resize(blobs[i], 48))


def test_corrupt_blob_raises(jpeg_engine):
    with pytest.raises(Exception):
        native_decode.decode_batch([b"not an image at all"], 32)
    with pytest.raises(Exception):
        native_decode.decode_batch([fixture_blobs()[0][:200]], 32)


def tokenize(texts, length):
    return np.asarray(ByteTokenizer()(texts, length)) % PCFG.text.vocab_size


@pytest.mark.parametrize("pipelined", [False, True])
def test_shard_loader_with_native_decode_is_jaxs(jpeg_engine, pipelined):
    kw = dict(seed=1, shuffle_buffer=8, native_decode=True, data_workers=2, pipelined=pipelined)
    ref = jax_files.ImageTextShards([FIXTURE], JCFG, 4, tokenize, **kw)
    got = files.ImageTextShards([FIXTURE], PCFG, 4, tokenize, **kw)
    for r, g in zip([b for b, _ in zip(ref, range(8))], [b for b, _ in zip(got, range(8))]):
        assert np.array_equal(g["images"], r["images"])
        assert np.array_equal(g["tokens"], r["tokens"])


# --- the synthetic engine ------------------------------------------------------


def take(it, n):
    """n batches, copied; a generator is closed after (a zero-copy stream
    holds its last slot until then, and the engine's close waits for it)."""
    try:
        return [{k: np.array(v) for k, v in next(it).items()} for _ in range(n)]
    finally:
        if hasattr(it, "close"):
            it.close()


@pytest.mark.parametrize("seeds", [(42, 40), (7, 8)])
@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("zero_copy", [False, True])
def test_native_synthetic_is_jaxs_bitwise(build_dir, seeds, threads, zero_copy):
    with jax_loader.NativeSyntheticImageText(JCFG, 8, *seeds, num_threads=2) as ref:
        want = take(iter(ref), 4)
    with native_loader.NativeSyntheticImageText(PCFG, 8, *seeds, num_threads=threads,
                                                queue_depth=3) as ds:
        got = take(ds.batches(zero_copy=zero_copy), 4)
    for g, w in zip(got, want):
        for k in ("images", "tokens"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_native_synthetic_yields_cpu_tensors_and_rejects_bad_configs(build_dir):
    with native_loader.NativeSyntheticImageText(PCFG, 4, num_threads=2) as ds:
        batch = next(iter(ds))
        stream = ds.batches(zero_copy=True)
        view = next(stream)
        stream.close()
    v = PCFG.vision
    assert batch["images"].shape == (4, v.image_size, v.image_size, 3)
    assert batch["images"].dtype == torch.float32 and batch["tokens"].dtype == torch.int32
    assert view["images"].device.type == "cpu"
    with pytest.raises(ValueError, match="positive"):
        native_loader.NativeSyntheticImageText(PCFG, 0)


def test_zero_copy_through_prefetch_matches_the_copy_path(build_dir):
    """Ring-slot tensors placed by prefetch's put_batch: the placed batches
    equal the copy path's (a placed batch never aliases a recycled slot)."""

    def run(zero_copy):
        with native_loader.NativeSyntheticImageText(PCFG, 8, num_threads=2) as ds:
            stream = prefetch(ds.batches(zero_copy=zero_copy), "cpu", size=2)
            try:
                got = [{k: v.clone() for k, v in b.items()} for b, _ in zip(stream, range(5))]
            finally:
                stream.close()
        return got

    for a, b in zip(run(False), run(True)):
        assert torch.equal(a["images"], b["images"]) and torch.equal(a["tokens"], b["tokens"])


def test_close_while_a_consumer_is_blocked_ends_the_stream(build_dir):
    ds = native_loader.NativeSyntheticImageText(PCFG, 8, num_threads=1, queue_depth=2)
    consumed, done = [], threading.Event()

    def consume():
        for batch in ds:
            consumed.append(int(batch["tokens"][0, 0]))
            time.sleep(0.01)
        done.set()

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.1)
    ds.close()
    assert done.wait(timeout=5.0), "the consumer did not unblock after close()"
    t.join(timeout=5.0)
    assert not t.is_alive() and consumed
    ds.close()  # idempotent


# --- the train command -----------------------------------------------------------


def test_train_native_decode_on_jpeg_shards_learns_colour_retrieval(jpeg_engine, tmp_path):
    write_oracle_dataset(str(tmp_path), "JPEG")
    rc, last, err = train_oracle(str(tmp_path), "--native-decode")
    assert rc == 0, err
    assert "falling back to PIL decode" not in err
    assert last["eval/i2t_recall@1"] >= 0.5 and last["eval/t2i_recall@1"] >= 0.5, last


def test_train_native_data_runs_without_its_fallback(build_dir):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["train", "--tiny", "--cpu-devices", "1", "--batch", "8", "--steps", "2",
                       "--native-data", "--data-workers", "2", "--eval-every", "2"])
    assert rc == 0, err.getvalue()
    assert "falling back to the numpy pipeline" not in err.getvalue()
    # No --eval-data on a native stream: JAX's warning, and the first batch.
    assert "--eval-every without --eval-data" in err.getvalue()
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines if "loss" in x] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines if "loss" in x)
