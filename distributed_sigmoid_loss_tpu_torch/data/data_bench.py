"""Stage-level input-pipeline benchmark, the ``data-bench`` command (the
port's copy of the JAX package's ``data/data_bench.py``).

The step feeds on host work: tar shard read → decode → tokenize → (on the
device) augment → host→device commit. This bench measures:

- each stage alone (``data_bench_stage`` records: shard_read, decode,
  tokenize, augment, h2d_commit; items/s each), with a decode
  worker-scaling curve;
- the composed real-data pipeline (read-ahead shards + decode/tokenize
  batcher + ``prefetch``) against the synthetic loader on the same host
  (``data_bench_pipeline_pairs_per_sec``), with the starvation ratio
  (``input_wait_frac``) and ``synthetic_ratio``: the real path should reach
  95% of the synthetic rate, or the record names the bound stage.

One JSON record a line, with the JAX package's keys. ``augment`` and
``h2d_commit`` run on ``cuda`` unless ``--cpu-devices 1``. Without
``--data-shards`` it writes JPEG shards through PIL first; on a machine
without PIL, pass ``--data-shards``.
"""

from __future__ import annotations

import io
import json
import os
import sys
import tarfile
import tempfile
import time

import numpy as np

__all__ = ["add_data_bench_args", "run_data_bench", "make_synthetic_shards"]


def add_data_bench_args(ap) -> None:
    """The data-bench arguments (the JAX command's)."""
    ap.add_argument("--batch", type=int, default=64,
                    help="global batch size (pairs per composed-pipeline batch)")
    ap.add_argument("--batches", type=int, default=8,
                    help="timed batches per stage measurement")
    ap.add_argument("--model", choices=["b16", "l14", "so400m", "tiny"], default="tiny",
                    help="tower config supplying image_size / context_length")
    ap.add_argument("--data-shards", default="",
                    help="measure these webdataset-style tar shards (glob) instead of "
                         "generating a synthetic JPEG shard set")
    ap.add_argument("--data-workers", type=int, default=0,
                    help="host worker threads for decode/generation (0 = auto: cpu_count "
                         "minus the prefetch/main threads; the resolved value lands in "
                         "every record)")
    ap.add_argument("--image-hw", default="240x320", metavar="HxW",
                    help="source resolution of the generated shard images (ignored with "
                         "--data-shards)")
    ap.add_argument("--shards", type=int, default=4,
                    help="generated shard count (read-ahead needs >= 2)")
    ap.add_argument("--pil-decode", action="store_true",
                    help="decode with files.decode_and_resize (PIL for JPEG/PNG, the "
                         "port's own BMP decoder) instead of the native libjpeg engine")
    ap.add_argument("--no-read-ahead", action="store_true",
                    help="disable shard read-ahead in the composed pipeline (A/B)")
    ap.add_argument("--no-pipelined", action="store_true",
                    help="disable the decode+tokenize worker overlap in the composed "
                         "pipeline (A/B)")
    ap.add_argument("--no-zero-copy", action="store_true",
                    help="synthetic reference: copy the C++ ring's batches instead of the "
                         "pinned zero-copy handoff (A/B)")
    ap.add_argument("--seed", type=int, default=0)


def make_synthetic_shards(out_dir: str, num_shards: int, pairs_per_shard: int,
                          hw: tuple[int, int], seed: int = 0, quality: int = 90) -> list[str]:
    """Write webdataset-style tar shards of synthetic JPEG + caption pairs
    (needs PIL). Images are smooth random sinusoid mixes, which compress and
    decode like photographs (uint8 noise decodes ~3x slower than any real
    photo)."""
    from PIL import Image

    h, w = hw
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    paths = []
    for s in range(num_shards):
        path = os.path.join(out_dir, f"bench-{s:05d}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(pairs_per_shard):
                f = rng.uniform(1.0, 6.0, (2, 3)).astype(np.float32)
                ph = rng.uniform(0.0, 6.28, (2, 3)).astype(np.float32)
                img = 63.75 * (2.0 + np.sin(6.28 * f[0] * yy + ph[0])
                               + np.sin(6.28 * f[1] * xx + ph[1]))
                arr = np.clip(img, 0, 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "JPEG", quality=quality)
                blob = buf.getvalue()
                name = f"pair-{s:05d}-{i:05d}"
                info = tarfile.TarInfo(f"{name}.jpg")
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
                cap = f"synthetic scene {s}-{i} hue {i % 11}".encode()
                info = tarfile.TarInfo(f"{name}.txt")
                info.size = len(cap)
                tf.addfile(info, io.BytesIO(cap))
        paths.append(path)
    return paths


def _emit_record(record: dict, collected: list) -> None:
    """One JSON line a record, checked against the declared schema
    (``analysis/bench_schema.py``: a violation warns and never drops the
    record), then appended to the run ledger (``obs/ledger.py``; never
    fatal)."""
    from distributed_sigmoid_loss_tpu_torch.analysis.bench_schema import validate_record
    from distributed_sigmoid_loss_tpu_torch.obs.ledger import append_record

    problems = validate_record(record)
    if problems:
        print("WARNING: data-bench record schema violation: " + "; ".join(problems),
              file=sys.stderr)
    collected.append(record)
    print(json.dumps(record), flush=True)
    append_record(record, source="data-bench", problems=problems)


def _timed(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return time.perf_counter() - t0


def _shard_paths(args, need_pairs: int):
    """(the shards to read, the temporary directory that holds generated
    ones or None), or (None, exit code) after a message."""
    import glob as globmod

    if args.data_shards:
        shard_paths = sorted(globmod.glob(args.data_shards))
        if not shard_paths:
            print(f"--data-shards matched nothing: {args.data_shards!r}", file=sys.stderr)
            return None, 2
        return shard_paths, None
    try:
        h, w = (int(x) for x in args.image_hw.lower().split("x"))
    except ValueError:
        print(f"--image-hw must be HxW (e.g. 240x320), got {args.image_hw!r}", file=sys.stderr)
        return None, 2
    if args.shards < 1:
        print(f"--shards must be >= 1, got {args.shards}", file=sys.stderr)
        return None, 2
    tmp = tempfile.TemporaryDirectory(prefix="dsl_data_bench_")
    per_shard = -(-need_pairs // args.shards)
    t0 = time.perf_counter()
    shard_paths = make_synthetic_shards(tmp.name, args.shards, per_shard, (h, w), seed=args.seed)
    print(f"generated {args.shards} shard(s) x {per_shard} pairs ({h}x{w} JPEG) in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return shard_paths, tmp


def run_data_bench(args, collected: list | None = None) -> int:
    """Run every stage and the composed comparison; returns the exit code.
    ``collected`` (a list) receives every emitted record."""
    from distributed_sigmoid_loss_tpu_torch.cli import _device
    from distributed_sigmoid_loss_tpu_torch.data.workers import resolve_data_workers

    device, code = _device(args)
    if device is None:
        return code
    try:
        workers = resolve_data_workers(args.data_workers)
    except ValueError as e:
        print(f"--data-workers: {e}", file=sys.stderr)
        return 2
    shard_paths, tmp = _shard_paths(args, args.batch * (args.batches + 1))  # +1 warmup batch
    if shard_paths is None:
        return tmp
    try:
        return _run(args, collected if collected is not None else [], device, workers,
                    shard_paths)
    finally:
        if tmp is not None:
            tmp.cleanup()


def _run(args, records: list, device, workers: int, shard_paths: list[str]) -> int:
    import torch

    from distributed_sigmoid_loss_tpu_torch.cli import _byte_tokenize_for
    from distributed_sigmoid_loss_tpu_torch.data.augment import augment_batch
    from distributed_sigmoid_loss_tpu_torch.data.files import ImageTextShards, decode_and_resize
    from distributed_sigmoid_loss_tpu_torch.data.loader import PrefetchStats, prefetch, put_batch
    from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = {"tiny": SigLIPConfig.tiny_test, "b16": SigLIPConfig.b16, "l14": SigLIPConfig.l14,
           "so400m": SigLIPConfig.so400m}[args.model]()
    size = cfg.vision.image_size
    tokenize = _byte_tokenize_for(cfg)
    batch, n_batches = args.batch, args.batches
    need_pairs = batch * (n_batches + 1)
    native = False
    if not args.pil_decode:
        from distributed_sigmoid_loss_tpu_torch.data.native_decode import (
            decode_batch,
            native_decode_available,
        )

        native = native_decode_available()
        if not native:
            print("native libjpeg engine unavailable; decode stage runs decode_and_resize",
                  file=sys.stderr)

    base = {
        "unit": "items/s",
        "model": args.model,
        "global_batch": batch,
        "steps": n_batches,
        "data_workers": workers,
        "native_decode": native,
        "n_devices": 1,
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
    }

    def stage(name: str, value: float, **extra) -> None:
        _emit_record({"metric": "data_bench_stage", "stage": name, "value": round(value, 1),
                      **base, **extra}, records)

    probe = ImageTextShards(shard_paths, cfg, batch, tokenize, native_decode=native,
                            data_workers=workers, read_ahead=False, pipelined=False)

    # --- shard_read: raw pair streaming (tar IO + member pairing only).
    t0 = time.perf_counter()
    pairs: list[tuple[bytes, str]] = []
    for p in probe._pairs(np.arange(len(probe.shards))):
        pairs.append(p)
        if len(pairs) >= need_pairs:
            break
    read_s = time.perf_counter() - t0
    if len(pairs) < batch:
        print(f"shards hold {len(pairs)} pairs; need at least one batch of {batch}",
              file=sys.stderr)
        return 2
    read_ips = len(pairs) / read_s
    stage("shard_read", read_ips)

    blobs = [b for b, _ in pairs[:need_pairs]]
    texts = [t for _, t in pairs[:need_pairs]]

    # --- decode (native fans over threads; decode_and_resize is serial),
    # with its worker-scaling curve.
    def decode_ips(threads: int, reps: int = n_batches) -> float:
        if native:
            def one(i):
                decode_batch(blobs[i * batch:(i + 1) * batch], size, threads=threads)
        else:
            def one(i):
                for b in blobs[i * batch:(i + 1) * batch]:
                    decode_and_resize(b, size)

        reps = min(reps, len(blobs) // batch)
        one(0)  # the library build and first touch outside the clock
        t0 = time.perf_counter()
        for i in range(reps):
            one(i)
        return reps * batch / (time.perf_counter() - t0)

    curve = {}
    w_points = sorted({1, *(2 ** k for k in range(1, 6) if 2 ** k < workers), workers})
    for w_ in w_points:
        curve[str(w_)] = round(decode_ips(w_, reps=max(2, n_batches // 2)), 1)
    dec_ips = decode_ips(workers)
    stage("decode", dec_ips, worker_scaling=curve)

    # --- tokenize.
    tok_reps = min(n_batches, len(texts) // batch)
    tok_s = _timed(lambda: [tokenize(texts[i * batch:(i + 1) * batch], cfg.text.context_length)
                            for i in range(tok_reps)], 1)
    tok_ips = tok_reps * batch / tok_s
    stage("tokenize", tok_ips)

    # --- augment, on the device (it overlaps the step in production; its
    # number shows whether it could become the bound).
    host_batch = {
        "images": np.zeros((batch, size, size, 3), np.float32),
        "tokens": np.asarray(tokenize(texts[:batch], cfg.text.context_length), np.int32),
    }
    dev_images = torch.zeros((batch, size, size, 3), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def augment():
        augment_batch(gen, dev_images, size)
        sync()

    augment()  # first call outside the clock
    stage("augment", n_batches * batch / _timed(augment, n_batches))

    # --- host->device commit.
    def commit():
        put_batch(host_batch, device)
        sync()

    commit()
    stage("h2d_commit", n_batches * batch / _timed(commit, n_batches))

    # --- composed real-data pipeline: read-ahead shards -> batcher ->
    # prefetch -> device. One batch warms up (thread/pool spin-up).
    def run_pipeline(it):
        stats = PrefetchStats()
        stream = prefetch(it, device, size=2, stats=stats)
        try:
            next(stream)
            sync()
            t0 = time.perf_counter()
            for _ in range(n_batches):
                next(stream)
                sync()
            dt = time.perf_counter() - t0
        finally:
            stream.close()
        return n_batches * batch / dt, stats

    real_src = ImageTextShards(shard_paths, cfg, batch, tokenize, native_decode=native,
                               data_workers=workers, read_ahead=not args.no_read_ahead,
                               pipelined=not args.no_pipelined, seed=args.seed)
    real_pps, real_stats = run_pipeline(iter(real_src))

    # --- synthetic reference on the same host and device: the C++ ring with
    # its pinned zero-copy handoff where it builds, the numpy stream
    # otherwise.
    from distributed_sigmoid_loss_tpu_torch.data.native_loader import native_available

    zero_copy = False
    if native_available():
        from distributed_sigmoid_loss_tpu_torch.data.native_loader import (
            NativeSyntheticImageText,
        )

        zero_copy = not args.no_zero_copy
        with NativeSyntheticImageText(cfg, batch, num_threads=workers) as ds:
            syn_pps, _ = run_pipeline(ds.batches(zero_copy=zero_copy))
    else:
        from distributed_sigmoid_loss_tpu_torch.data.synthetic import SyntheticImageText

        syn_pps, _ = run_pipeline(iter(SyntheticImageText(cfg, batch)))

    ratio = real_pps / syn_pps if syn_pps > 0 else 0.0
    # Host stages that serialize on the real path; the slowest bounds the
    # composed number (augment and h2d overlap the step in production).
    host_stages = {"shard_read": read_ips, "decode": dec_ips, "tokenize": tok_ips}
    composed = {
        "metric": "data_bench_pipeline_pairs_per_sec",
        "value": round(real_pps, 1),
        **base,
        "unit": "pairs/s",
        "synthetic_pairs_per_sec": round(syn_pps, 1),
        "synthetic_ratio": round(ratio, 3),
        "input_wait_frac": round(real_stats.input_wait_frac(), 4),
        "pipelined": not args.no_pipelined,
        "read_ahead": not args.no_read_ahead,
        "zero_copy": zero_copy,
    }
    if ratio < 0.95:
        composed["bound_stage"] = min(host_stages, key=host_stages.get)
        composed["worker_scaling"] = curve
    _emit_record(composed, records)
    return 0
