"""The port's real-data layer (``data/files.py``) against the JAX package's,
on the CPU.

- ``resize_bilinear`` gives ``PIL.Image.resize(BILINEAR)``'s integers on
  random uint8 images, down, up, at odd aspects and at the same size.
- ``decode_and_resize`` equals JAX's bitwise on BMP (24- and 32-bit, both
  row orders), PNG (RGB, RGBA, L, P) and JPEG; with PIL hidden, BMP still
  decodes to the same array and PNG / JPEG raise the error that names the
  PIL-free routes.
- ``ImageTextFolder`` / ``ImageTextShards`` batches (images and token ids)
  equal JAX's bitwise over two epochs, with and without the shuffle buffer,
  read-ahead and pipelining; striping is disjoint; JAX's cases of
  ``tests/test_files_data.py`` and ``tests/test_data_pipeline.py``
  (incomplete pairs skipped, too few pairs raise, no thread outlives an
  abandoned stream).
- ``train --cpu-devices 1`` on PNG tar shards learns the real-data
  convergence oracle (``tests/test_convergence_real_data.py``): recall@1 at
  least 0.5 both ways, chance 0.0625.
"""

import ast
import contextlib
import io
import json
import os
import struct
import sys
import tarfile
import threading
import time

import numpy as np
import pytest
from PIL import Image

from distributed_sigmoid_loss_tpu.data import files as jax_files
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.data import ByteTokenizer
from distributed_sigmoid_loss_tpu_torch.data import files
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_real_data import (  # noqa: E402
    bmp,
    noise,
    pil_bytes,
    train_oracle,
    write_oracle_dataset,
)

JCFG, PCFG = jc.SigLIPConfig.tiny_test(), pc.SigLIPConfig.tiny_test()


def tokenize(texts, length):
    """The CLI's fold of byte ids into the tiny vocab (one function, both
    packages)."""
    return np.asarray(ByteTokenizer()(texts, length)) % PCFG.text.vocab_size


# --- resize ------------------------------------------------------------------

RESIZES = [((240, 320), (224, 224)), ((240, 320), (299, 224)), ((16, 16), (224, 224)),
           ((97, 300), (224, 224)), ((300, 97), (224, 224)), ((97, 300), (224, 693)),
           ((64, 48), (64, 48)), ((64, 48), (64, 20)), ((1000, 37), (13, 400))]


@pytest.mark.parametrize("hw,size", RESIZES, ids=[f"{h}x{w}->{s}" for (h, w), s in RESIZES])
def test_resize_gives_pils_bilinear_integers(hw, size):
    img = noise(*hw, seed=sum(hw))
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    got = files.resize_bilinear(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


# --- decode ------------------------------------------------------------------

SHAPES = [(240, 320), (16, 16), (97, 300), (300, 97), (16, 24)]
ENCODINGS = {
    "bmp24": lambda a: bmp(a, 24), "bmp24_top_down": lambda a: bmp(a, 24, top_down=True),
    "bmp32": lambda a: bmp(a, 32), "bmp32_top_down": lambda a: bmp(a, 32, top_down=True),
    "bmp_pil": lambda a: pil_bytes(a, "BMP"),
    "bmp32_pil": lambda a: pil_bytes(a, "BMP", "RGBA"),
    "png_rgb": lambda a: pil_bytes(a, "PNG"), "png_rgba": lambda a: pil_bytes(a, "PNG", "RGBA"),
    "png_l": lambda a: pil_bytes(a, "PNG", "L"), "png_p": lambda a: pil_bytes(a, "PNG", "P"),
    "jpeg": lambda a: pil_bytes(a, "JPEG"),
}


@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_decode_and_resize_is_jaxs_bitwise(encoding):
    for i, hw in enumerate(SHAPES):
        blob = ENCODINGS[encoding](noise(*hw, seed=i))
        for size in (16, 224):
            want = jax_files.decode_and_resize(blob, size)
            got = files.decode_and_resize(blob, size)
            assert got.dtype == np.float32 and got.shape == (size, size, 3)
            assert np.array_equal(got, want), (encoding, hw, size)


@contextlib.contextmanager
def pil_hidden(monkeypatch):
    """Import of PIL fails, as on a machine without it."""
    with monkeypatch.context() as m:
        for name in [n for n in sys.modules if n == "PIL" or n.startswith("PIL.")]:
            m.setitem(sys.modules, name, None)
        m.setitem(sys.modules, "PIL", None)
        yield


@pytest.mark.parametrize("encoding", ["bmp24", "bmp32_top_down", "bmp_pil", "bmp32_pil"])
def test_bmp_decodes_without_pil(monkeypatch, encoding):
    blob = ENCODINGS[encoding](noise(97, 300, seed=3))
    want = jax_files.decode_and_resize(blob, 224)
    with pil_hidden(monkeypatch):
        with pytest.raises(ImportError):
            import PIL.Image  # noqa: F401
        got = files.decode_and_resize(blob, 224)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("encoding", ["png_rgb", "jpeg"])
def test_other_formats_without_pil_name_the_way_out(monkeypatch, encoding):
    blob = ENCODINGS[encoding](noise(20, 24))
    with pil_hidden(monkeypatch):
        with pytest.raises(ImportError, match="--native-decode.*BMP"):
            files.decode_and_resize(blob, 16)


def test_corrupt_bmp_raises():
    blob = bmp(noise(20, 24))
    with pytest.raises(ValueError, match="truncated"):
        files.decode_and_resize(blob[:-100], 16)


# --- loaders -----------------------------------------------------------------


def mixed_pairs(n, seed=0):
    """(name, blob, caption) with distinct pixels: PNG, BMP and JPEG, up-
    and downscaled to the tiny tower's 16 px."""
    rng = np.random.default_rng(seed)
    encoders = [lambda a: pil_bytes(a, "PNG"), lambda a: bmp(a, 24),
                lambda a: pil_bytes(a, "JPEG"), lambda a: bmp(a, 32, top_down=True)]
    exts = ["png", "bmp", "jpg", "bmp"]
    out = []
    for i in range(n):
        h, w = rng.integers(10, 40, 2)
        out.append((f"s{i:04d}", exts[i % 4], encoders[i % 4](noise(h, w, seed=seed + i)),
                    f"pair {i} of {n}"))
    return out


def write_shards(root, n_shards, per_shard, seed=0):
    paths = []
    pairs = mixed_pairs(n_shards * per_shard, seed)
    for s in range(n_shards):
        path = os.path.join(root, f"shard{s:02d}.tar")
        with tarfile.open(path, "w") as tf:
            for name, ext, blob, cap in pairs[s * per_shard:(s + 1) * per_shard]:
                for member, data in ((f"{name}.{ext}", blob), (f"{name}.txt", cap.encode())):
                    info = tarfile.TarInfo(member)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def shard_set(tmp_path_factory):
    return write_shards(str(tmp_path_factory.mktemp("shards")), 3, 12)


def take(src, n):
    it = iter(src)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("images", "tokens"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("shuffle_buffer", [0, 64])
@pytest.mark.parametrize("read_ahead,pipelined", [(False, False), (True, False), (False, True),
                                                  (True, True)])
def test_shards_batches_are_jaxs_over_two_epochs(shard_set, shuffle_buffer, read_ahead,
                                                 pipelined):
    # 36 pairs, batches of 8: 4 a epoch, the last 4 pairs dropped.
    kw = dict(seed=3, shuffle_buffer=shuffle_buffer, read_ahead=read_ahead, pipelined=pipelined)
    want = take(jax_files.ImageTextShards(shard_set, JCFG, 8, tokenize, **kw), 8)
    got = take(files.ImageTextShards(shard_set, PCFG, 8, tokenize, **kw), 8)
    assert_same_batches(got, want)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder")
    for name, ext, blob, cap in mixed_pairs(14, seed=5):
        (root / f"{name}.{ext}").write_bytes(blob)
        (root / f"{name}.txt").write_text(cap)
    (root / "orphan.png").write_bytes(pil_bytes(noise(8, 8), "PNG"))
    (root / "textonly.txt").write_text("no image")
    return str(root)


@pytest.mark.parametrize("seed", [0, 7, None])
def test_folder_batches_are_jaxs_over_two_epochs(folder, seed):
    ds = files.ImageTextFolder(folder, PCFG, 4, tokenize, seed=seed, keep_captions=True)
    ref = jax_files.ImageTextFolder(folder, JCFG, 4, tokenize, seed=seed, keep_captions=True)
    assert len(ds) == len(ref) == 14  # the orphans are skipped
    got, want = take(ds, 6), take(ref, 6)  # 3 a epoch
    assert_same_batches(got, want)
    assert [b["captions"] for b in got] == [b["captions"] for b in want]


def test_folder_refuses_too_few_pairs_and_out_of_vocab_ids(folder):
    with pytest.raises(ValueError, match="need at least one batch"):
        files.ImageTextFolder(folder, PCFG, 16, tokenize)
    with pytest.raises(ValueError, match="outside vocab_size"):
        next(iter(files.ImageTextFolder(folder, PCFG, 4, ByteTokenizer())))


def test_shards_striping_is_disjoint_and_validated(tmp_path):
    shards = write_shards(str(tmp_path), 4, 2)
    host0 = files.ImageTextShards(shards, PCFG, 2, tokenize, seed=None, shard_index=0,
                                  num_shards=2)
    host1 = files.ImageTextShards(shards, PCFG, 2, tokenize, seed=None, shard_index=1,
                                  num_shards=2)
    assert set(host0.shards).isdisjoint(host1.shards)
    assert sorted(host0.shards + host1.shards) == sorted(shards)
    assert not np.array_equal(next(iter(host0))["images"], next(iter(host1))["images"])
    for kw, match in (({"shards": []}, "no shards"),
                      ({"shards": shards[:1], "shard_index": 1, "num_shards": 2},
                       "received no shards"),
                      ({"shards": shards, "shuffle_buffer": -1}, "shuffle_buffer"),
                      ({"shards": shards, "seed": None, "shuffle_buffer": 8}, "seed")):
        kw = {"cfg": PCFG, "batch_size": 2, "tokenize": tokenize, **kw}
        with pytest.raises(ValueError, match=match):
            files.ImageTextShards(**kw)


def test_shards_too_few_pairs_raise_instead_of_hanging(tmp_path):
    shards = write_shards(str(tmp_path), 1, 2)
    with pytest.raises(ValueError, match="fewer complete"):
        next(iter(files.ImageTextShards(shards, PCFG, 4, tokenize)))


def test_shards_skip_incomplete_pairs_like_jax(tmp_path):
    path = str(tmp_path / "ragged.tar")
    with tarfile.open(path, "w") as tf:
        for member, data in (("a.png", pil_bytes(noise(9, 9, 1), "PNG")), ("a.txt", b"one"),
                             ("b.png", pil_bytes(noise(9, 9, 2), "PNG")), ("c.txt", b"orphan"),
                             ("d.bmp", bmp(noise(9, 9, 3))), ("d.txt", b"two"),
                             ("e.dat", b"ignored"), ("f.txt", b"three"),
                             ("f.JPG", pil_bytes(noise(9, 9, 4), "JPEG"))):
            info = tarfile.TarInfo(member)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    want = take(jax_files.ImageTextShards([path], JCFG, 3, tokenize, keep_captions=True), 2)
    got = take(files.ImageTextShards([path], PCFG, 3, tokenize, keep_captions=True), 2)
    assert_same_batches(got, want)
    assert got[0]["captions"] == ["one", "two", "three"]


def test_abandoned_stream_leaks_no_threads(shard_set):
    take(files.ImageTextShards(shard_set, PCFG, 8, tokenize, seed=0), 2)  # mid-epoch
    time.sleep(0.2)
    leaked = [t.name for t in threading.enumerate() if t.name.startswith("dsl-")]
    assert not leaked, f"input-pipeline threads outlived the stream: {leaked}"


# --- the train command on real data ---------------------------------------------


def test_train_on_png_shards_learns_colour_retrieval(tmp_path):
    write_oracle_dataset(str(tmp_path), "PNG")
    rc, last, err = train_oracle(str(tmp_path))
    assert rc == 0, err
    assert last["step"] == 80, last
    # Chance is 0.0625.
    assert last["eval/i2t_recall@1"] >= 0.5 and last["eval/t2i_recall@1"] >= 0.5, last


def test_eval_on_real_pairs_scores_captions_as_classes(tmp_path):
    write_oracle_dataset(str(tmp_path), "PNG")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["eval", "--tiny", "--cpu-devices", "1", "--batch", "16", "--data-shards",
                       str(tmp_path / "eval.tar")])
    assert rc == 0
    result = ast.literal_eval(out.getvalue().strip().splitlines()[-1])
    # 16 distinct captions: zero-shot top@5 is defined, chance 5/16.
    assert set(result) == {"i2t_recall@1", "t2i_recall@1", "i2t_recall@5", "t2i_recall@5",
                           "zeroshot_top@1", "zeroshot_top@5"}
    assert all(0.0 <= v <= 1.0 for v in result.values())
