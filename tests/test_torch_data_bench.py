"""The port's ``data-bench`` command (``data/data_bench.py``) on the CPU
(``--cpu-devices 1``): the five stage records and the composed record, each
valid under the JAX package's bench-record schema
(``analysis/bench_schema.validate_record``) with the JAX command's keys; on
BMP shards with PIL hidden (a machine without PIL) under ``--pil-decode``;
and its usage exits.
"""

import contextlib
import io
import json
import os
import sys
import tarfile

import numpy as np
import pytest

from distributed_sigmoid_loss_tpu.analysis.bench_schema import validate_record
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.data import native_loader

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_real_data import bmp  # noqa: E402

STAGES = {"shard_read", "decode", "tokenize", "augment", "h2d_commit"}
# The keys of the JAX command's records (data/data_bench.py).
STAGE_KEYS = {"metric", "stage", "value", "unit", "model", "global_batch", "steps",
              "data_workers", "native_decode", "n_devices", "device_kind"}
COMPOSED_KEYS = (STAGE_KEYS - {"stage"}) | {
    "synthetic_pairs_per_sec", "synthetic_ratio", "input_wait_frac", "pipelined",
    "read_ahead", "zero_copy"}
SMALL = ["--cpu-devices", "1", "--model", "tiny", "--batch", "8", "--batches", "2"]


@pytest.fixture(autouse=True)
def build_dir(tmp_path, monkeypatch):
    """The native libraries build into a temporary directory."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")


def bench(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["data-bench", *argv])
    records = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    return rc, records, err.getvalue()


def check_records(records, native_decode):
    for r in records:
        assert validate_record(r) == [], r
    stages = [r for r in records if r["metric"] == "data_bench_stage"]
    assert {r["stage"] for r in stages} == STAGES and len(stages) == 5
    for r in stages:
        assert set(r) - {"worker_scaling"} == STAGE_KEYS and r["value"] > 0, r
        assert r["device_kind"] == "cpu" and r["n_devices"] == 1
        assert r["native_decode"] is native_decode and r["data_workers"] >= 1
    decode = next(r for r in stages if r["stage"] == "decode")
    assert "1" in decode["worker_scaling"]
    (composed,) = [r for r in records if r["metric"] == "data_bench_pipeline_pairs_per_sec"]
    assert set(composed) - {"bound_stage", "worker_scaling"} == COMPOSED_KEYS
    assert composed["unit"] == "pairs/s" and 0.0 <= composed["input_wait_frac"] <= 1.0
    # Both rates are rounded to 0.1 and the ratio to 0.001.
    assert composed["synthetic_ratio"] == pytest.approx(
        composed["value"] / composed["synthetic_pairs_per_sec"], rel=0.01, abs=5e-4)
    if composed["synthetic_ratio"] < 0.95:
        assert composed["bound_stage"] in STAGES and composed["worker_scaling"]


def test_data_bench_on_generated_shards_emits_every_stage():
    rc, records, err = bench([*SMALL, "--image-hw", "48x64", "--shards", "2",
                              "--data-workers", "2"])
    assert rc == 0, err
    check_records(records, native_decode="native libjpeg engine unavailable" not in err)


def test_data_bench_on_bmp_shards_without_pil(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for s in range(2):
        with tarfile.open(tmp_path / f"bmp-{s}.tar", "w") as tf:
            for i in range(14):
                for member, data in ((f"p{s}-{i}.bmp", bmp(rng.integers(0, 256, (24, 32, 3),
                                                                         dtype=np.uint8))),
                                     (f"p{s}-{i}.txt", f"caption {s} {i}".encode())):
                    info = tarfile.TarInfo(member)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    with monkeypatch.context() as m:
        for name in [n for n in sys.modules if n == "PIL" or n.startswith("PIL.")]:
            m.setitem(sys.modules, name, None)
        m.setitem(sys.modules, "PIL", None)
        rc, records, err = bench([*SMALL, "--data-shards", str(tmp_path / "bmp-*.tar"),
                                  "--pil-decode", "--data-workers", "2", "--no-zero-copy"])
    assert rc == 0, err
    check_records(records, native_decode=False)
    assert not any(r["zero_copy"] for r in records if "zero_copy" in r)


@pytest.mark.parametrize("argv,message", [
    (["--data-shards", "/nonexistent/*.tar"], "--data-shards matched nothing"),
    (["--image-hw", "48by64"], "--image-hw must be HxW"),
    (["--shards", "0"], "--shards must be >= 1"),
    (["--data-workers", "-2"], "--data-workers: data workers must be >= 1"),
])
def test_data_bench_usage_errors_exit_2(argv, message):
    rc, records, err = bench([*SMALL, *argv])
    assert rc == 2 and records == [] and message in err
