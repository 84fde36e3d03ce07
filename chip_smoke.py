#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failed check ends the run with a non-zero exit
and nothing is caught:

1. the card (``nvidia-smi`` name and power limit, ``torch.cuda``);
2. build every kernel from ``distributed_sigmoid_loss_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and time kernel, plain version and the
   PyTorch library call beside the work's least time on this card;
4. the main path: SigLIP-B/16 at full width and depth in bf16, seeded random
   weights, ``InferenceEngine`` + ``EmbeddingService`` serving a 256-image
   corpus and 64 mixed requests from 8 threads, with the kernel launch
   counts read around that run, then the towers' device time by kernel at
   the largest bucket (torch.profiler);
5. a JSON line of the kernels' numbers and, last, the device record.

Without CUDA, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 and bf16 tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# Kernel vs plain version in bf16: both round p to bf16 after sums in
# different orders (a p may move one bf16 ulp) and round the output to bf16
# (|out| < 2 here, one ulp <= 2^-7): two output ulps.
K1_ATOL = 1.6e-2
BUCKETS = (1, 8, 32, 128)
CORPUS, REQUESTS, CLIENTS = 256, 64, 8


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, s, h, dh, causal=False) -> tuple[float, str]:
    """Least time for the attention forward: q, k, v read once and out
    written once (bf16) against the two products' operations (causal: only
    the unmasked half-triangle the data needs)."""
    nbytes = 4 * b * s * h * dh * 2
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * 2 * b * h * pairs * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_breakdown(fn, wall_ms: float) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler), grouped
    into K1, matrix products and the rest, with the device's idle share
    against ``wall_ms`` (the call's CUDA-event time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the device")
    groups = {"short_attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        if "short_attention" in name:
            group = "short_attention_fwd"
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            group = "matmul"
        else:
            group = "other"
        groups[group] += e.self_device_time_total / 1e3
    total = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "kernel_ms": total,
        "ms_by_group": groups,
        "idle_share": max(0.0, 1.0 - total / wall_ms),
        "top": [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top],
    }


def check_short_attention(sa, gen) -> dict:
    """K1 against its plain version at the main path's shapes; returns the
    JSON record of the vision shape (the main path's largest)."""
    import torch.nn.functional as F

    cases = {
        "vision": (128, 196, 12, 64, False),  # B/16 image tower, bucket 128
        "text": (128, 64, 12, 64, False),  # B/16 text tower, bucket 128
        "causal": (4, 77, 8, 64, True),
        "head_dim_72": (2, 256, 16, 72, False),  # so400m head width, L/14 length
        "scalar_path": (2, 50, 3, 20, True),  # width 60: element-wise loads and stores
    }
    record = None
    for name, (b, s, h, dh, causal) in cases.items():
        q, k, v = (
            torch.randn(b, s, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(3)
        )
        out = sa.short_self_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ref = sa.short_self_attention_plain(q, k, v, causal)
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        row = dict(case=name, shape=[b, s, h, dh], causal=causal, max_abs_err=err,
                   atol=K1_ATOL, finite=finite,
                   blocks_per_sm=sa._library().short_attention_occupancy(s, dh))
        if name in ("vision", "text"):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["ms"] = time_ms(lambda: sa.short_self_attention(q, k, v, causal))
            row["plain_ms"] = time_ms(lambda: sa.short_self_attention_plain(q, k, v, causal))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            )
            row["bound_ms"], row["bound_by"] = attention_bound_ms(b, s, h, dh, causal)
        log("kernel", **row)
        if not finite or err > K1_ATOL:
            raise AssertionError(f"short_attention_fwd disagrees with its plain version: {row}")
        if name == "vision":
            record = row
    return record


def run_main_path(args, sa) -> dict:
    from distributed_sigmoid_loss_tpu_torch.eval.retrieval import topk_ids
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.serve import (
        EmbeddingCache,
        EmbeddingService,
        InferenceEngine,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

    cfg = SigLIPConfig.b16()
    t0 = time.monotonic()
    model = SigLIP(cfg, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(args.seed)).eval()
    engine = InferenceEngine.from_model(model, batch_buckets=BUCKETS)
    torch.cuda.synchronize()
    log("main", config="SigLIP-B/16", dtype=cfg.vision.dtype, depth=cfg.vision.depth,
        width=cfg.vision.width, params=sum(p.numel() for p in model.parameters()),
        init_s=time.monotonic() - t0)
    rng = np.random.default_rng(args.seed)
    hw, ctx, vocab = cfg.vision.image_size, cfg.text.context_length, cfg.text.vocab_size

    # -- the main path, between the two reads of the launch counts ----------
    sa.reset_launches()
    engine.calls.clear()
    t0 = time.monotonic()
    warmed = engine.warmup()
    t_warm = time.monotonic() - t0
    svc = EmbeddingService(engine, cache=EmbeddingCache(4096), max_wait_ms=5.0,
                           default_timeout=120.0)
    corpus = rng.random((CORPUS, hw, hw, 3), dtype=np.float32)
    t0 = time.monotonic()
    corpus_emb = svc.encode_image(corpus)
    t_corpus = time.monotonic() - t0
    svc.index.add(corpus_emb)
    pool = rng.integers(1, vocab, (16, ctx)).astype(np.int32)  # repeated captions hit the cache
    plans = []
    for i in range(REQUESTS):
        kind = ("text", "image", "search")[i % 3]
        if kind == "text":
            n = int(rng.integers(1, 5))
            x = pool[rng.integers(0, len(pool), n)] if i % 2 else rng.integers(1, vocab, (n, ctx)).astype(np.int32)
        elif kind == "image":
            x = rng.random((int(rng.integers(1, 3)), hw, hw, 3), dtype=np.float32)
        else:
            x = rng.integers(1, vocab, (1, ctx)).astype(np.int32)
        plans.append((kind, x))
    results, errors, lat = [None] * len(plans), [], []

    def client(worker: int):
        try:
            for i in range(worker, len(plans), CLIENTS):
                kind, x = plans[i]
                t = time.monotonic()
                if kind == "search":
                    results[i] = svc.search(x, k=10)
                else:
                    results[i] = getattr(svc, f"encode_{kind}")(x)
                lat.append(time.monotonic() - t)
        except BaseException as e:  # re-raised on the main thread below
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(w,)) for w in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_requests = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = sa.launches()
    tower_calls = dict(engine.calls)
    # -- end of the main path ----------------------------------------------
    if errors:
        raise errors[0]
    stats = svc.stats()

    checked = 0
    for (kind, x), res in zip(plans, results):
        if kind == "search":
            scores, ids = res
            q = svc.encode_text(x)  # a cache hit: the very row the search used
            oracle = topk_ids(q @ corpus_emb.T, 10)
            if not np.array_equal(ids, oracle):
                raise AssertionError(f"search ids {ids} != topk_ids oracle {oracle}")
            checked += 1
            continue
        if not np.all(np.isfinite(res)):
            raise AssertionError(f"non-finite {kind} embedding")
        norms = np.linalg.norm(res, axis=-1)
        if np.abs(norms - 1).max() > 1e-3:
            raise AssertionError(f"{kind} embeddings not unit-norm: {norms}")
    if not np.all(np.isfinite(corpus_emb)) or np.abs(np.linalg.norm(corpus_emb, axis=-1) - 1).max() > 1e-3:
        raise AssertionError("corpus embeddings not finite and unit-norm")
    if warmed != engine.bucket_space or engine.compile_count != engine.bucket_space:
        raise AssertionError(f"compile_count {engine.compile_count} != bucket_space {engine.bucket_space}")
    expected = cfg.vision.depth * tower_calls.get("image", 0) + cfg.text.depth * tower_calls.get("text", 0)
    if launches != expected or launches == 0:
        raise AssertionError(f"short_attention launches {launches} != 12 per tower call ({expected})")
    svc.close()
    lat_ms = sorted(1e3 * x for x in lat)
    log("main", warmup_s=t_warm, compile_count=engine.compile_count,
        bucket_space=engine.bucket_space, corpus=len(corpus), corpus_s=t_corpus,
        corpus_images_per_s=len(corpus) / t_corpus, requests=len(plans), clients=CLIENTS,
        requests_s=t_requests,
        request_p50_ms=lat_ms[int(np.ceil(0.50 * len(lat_ms))) - 1],
        request_p95_ms=lat_ms[int(np.ceil(0.95 * len(lat_ms))) - 1],
        searches_checked=checked, tower_calls=tower_calls, short_attention_launches=launches)
    log("main", service_stats=stats)

    # Outside the counted run: the model with the kernel vs with the plain
    # attention on one batch, and the tower times at the largest bucket.
    imgs = torch.from_numpy(rng.random((8, hw, hw, 3), dtype=np.float32)).cuda()
    toks = torch.from_numpy(rng.integers(1, vocab, (8, ctx))).cuda()
    with torch.inference_mode():
        kernel_out = (model.encode_image(imgs), model.encode_text(toks))
        real = sa.short_self_attention
        sa.short_self_attention = sa.short_self_attention_plain
        try:
            plain_out = (model.encode_image(imgs), model.encode_text(toks))
        finally:
            sa.short_self_attention = real
        cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
               for a, b in zip(kernel_out, plain_out)]
        big_img = torch.from_numpy(rng.random((128, hw, hw, 3), dtype=np.float32)).cuda()
        big_tok = torch.from_numpy(rng.integers(1, vocab, (128, ctx))).cuda()
        image_ms = time_ms(lambda: model.encode_image(big_img), iters=5, warmup=2)
        text_ms = time_ms(lambda: model.encode_text(big_tok), iters=5, warmup=2)
        breakdown = {
            "image": device_breakdown(lambda: model.encode_image(big_img), image_ms),
            "text": device_breakdown(lambda: model.encode_text(big_tok), text_ms),
        }
    log("main", min_cosine_kernel_vs_plain={"image": cos[0], "text": cos[1]},
        tower_ms_b128={"image": image_ms, "text": text_ms},
        images_per_s_b128=128 / image_ms * 1e3, texts_per_s_b128=128 / text_ms * 1e3)
    for tower, row in breakdown.items():
        log("profile", tower=tower, batch=128, **row)
    if min(cos) <= 0.999:
        raise AssertionError(f"kernel vs plain attention through the model: cosine {cos}")
    return {"short_attention_fwd": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda
    from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", name=name, count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build every kernel from the checkout's sources.
    t0 = time.monotonic()
    built = _cuda.build()
    for lib, info in built.items():
        usage = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
        log("build", library=lib, seconds=info["seconds"], ptxas=usage[:4])
    log("build", seconds=time.monotonic() - t0, built=sorted(built))
    smem = sa._library().short_attention_smem_bytes(196, 64)
    if smem != sa.short_attention_smem_bytes(196, 64):
        raise AssertionError(f"kernel smem {smem} != python mirror {sa.short_attention_smem_bytes(196, 64)}")

    # Phase 3: each kernel against its plain version.
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = check_short_attention(sa, gen)

    # Phase 4: the main path.
    launches = run_main_path(args, sa)

    # Phase 5: the records.
    kernels = [{
        "name": "short_attention_fwd",
        "route": "cuda",
        "source": "distributed_sigmoid_loss_tpu_torch/csrc/short_attention.cu",
        "replaces": "distributed_sigmoid_loss_tpu/ops/pallas_short_attention.py:257",
        "launches": launches["short_attention_fwd"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "shape": "b=128 s=196 h=12 dh=64 bf16",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
