#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failed check ends the run with a non-zero exit
and nothing is caught:

1. the card (``nvidia-smi`` name and power limit, ``torch.cuda``);
2. build every kernel from ``distributed_sigmoid_loss_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together);
3. hold each kernel (K1, the attention forward; K2, its backward) against
   its plain PyTorch version on the card at the shapes the main paths give
   it, and time kernel, plain version and the PyTorch library call beside
   the work's least time on this card;
4. the serving path: SigLIP-B/16 at full width and depth in bf16, seeded
   random weights, ``InferenceEngine`` + ``EmbeddingService`` serving a
   256-image corpus and 64 mixed requests from 8 threads, with the kernel
   launch counts read around that run, then the towers' device time by
   kernel at the largest bucket (torch.profiler);
5. the training path: the headline train step (B/16, 16 accumulated
   microbatches of 128 pairs, ``save_hot`` remat, bf16 accumulator and Adam
   first moment, ring loss at precision "default") for 3 steps, with the
   launch counts read around them; then one microbatch's device time by
   kernel, the gradient through the whole model with the kernels against
   both plain versions, and a 10-step fit of one fixed batch;
6. a JSON line of the kernels' numbers and, last, the device record.

Without CUDA, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
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
# K2 vs its plain version in bf16: both round p and ds to bf16 after f32 sums
# taken in different orders (a p or ds may move one bf16 ulp) and round each
# gradient to bf16; 2^-6 of a gradient's largest magnitude is at least two
# bf16 ulps there.
K2_RTOL_OF_MAX = 2.0 ** -6
BUCKETS = (1, 8, 32, 128)
CORPUS, REQUESTS, CLIENTS = 256, 64, 8
# The headline train step (bench.py's no-argument run): 16 microbatches of 128.
ACCUM, MICRO, TRAIN_STEPS = 16, 128, 3
FIT_STEPS = 10
# Kernel cases of both kernels: (b, s, h, dh, causal).
ATTENTION_CASES = {
    "vision": (128, 196, 12, 64, False),  # B/16 image tower, batch 128
    "text": (128, 64, 12, 64, False),  # B/16 text tower, batch 128
    "causal": (4, 77, 8, 64, True),
    "head_dim_72": (2, 256, 16, 72, False),  # so400m head width, L/14 length
    "scalar_path": (2, 50, 3, 20, True),  # width 60: element-wise loads and stores
}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def ptxas_usage(build_log: str) -> dict:
    """``{kernel<template args>: "N registers, S spill bytes"}`` from ``nvcc
    -Xptxas -v``."""
    usage, kernel = {}, None
    for line in build_log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            short = re.search(r"(short_attention_(?:fwd|bwd_dq|bwd_dkdv)_kernel)ILi(\d+)E", name)
            kernel = f"{short.group(1)}<{short.group(2)}>" if short else name
        elif kernel and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)
            usage[kernel] = f"spill {spill.group(1)} B" if spill else line.strip()
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            usage[kernel] = f"{regs.group(1)} registers, " + usage.get(kernel, "")
    return usage


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


def device_ms(fn, iters: int = 5):
    """Mean device time of the kernels of one call of ``fn`` over ``iters``
    calls (torch.profiler), without the host's launch gaps that a CUDA-event
    time includes; None ("not measured") when the profiler records no
    kernel, which it has done for a whole call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def attention_bound_ms(b, s, h, dh, causal=False, tensors=4, products=2) -> tuple[float, str]:
    """Least time for attention work: ``tensors`` (b, s, h, dh) bf16 tensors
    each read or written once against ``products`` matrix products over the
    (causal: unmasked half-triangle) score pairs. The forward moves q, k, v,
    out in two products; the backward q, k, v, do, dq, dk, dv in five."""
    nbytes = tensors * b * s * h * dh * 2
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = products * 2 * b * h * pairs * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


KERNEL_GROUPS = (
    ("short_attention_bwd", "short_attention_bwd"),
    ("short_attention", "short_attention_fwd"),
)


def device_breakdown(fn, wall_ms: float, host_ops: bool = True) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler), grouped
    into K1, K2, matrix products and the rest, with the device's idle share
    against ``wall_ms`` (the call's time unprofiled). ``host_ops=False``
    traces the device alone, for calls of ~10^5 kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the device")
    groups = {"short_attention_fwd": 0.0, "short_attention_bwd": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        group = next((g for key, g in KERNEL_GROUPS if key in name), None)
        if group is None:
            matmul = any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma"))
            group = "matmul" if matmul else "other"
        groups[group] += e.self_device_time_total / 1e3
    total = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "kernel_ms": total,
        "kernel_launches": sum(e.count for e in kernels),
        "ms_by_group": groups,
        "idle_share": max(0.0, 1.0 - total / wall_ms),
        "top": [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top],
    }


def check_short_attention(sa, gen) -> dict:
    """K1 against its plain version at the main path's shapes; returns the
    JSON record of the vision shape (the main path's largest)."""
    import torch.nn.functional as F

    record = None
    for name, (b, s, h, dh, causal) in ATTENTION_CASES.items():
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
                   blocks_per_sm=sa._library("short_attention").short_attention_occupancy(s, dh))
        if name in ("vision", "text"):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["ms"] = time_ms(lambda: sa.short_self_attention(q, k, v, causal))
            row["plain_ms"] = time_ms(lambda: sa.short_self_attention_plain(q, k, v, causal))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            )
            row["device_ms"] = device_ms(lambda: sa.short_self_attention(q, k, v, causal))
            row["library_device_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            )
            row["bound_ms"], row["bound_by"] = attention_bound_ms(b, s, h, dh, causal)
        log("kernel", **row)
        if not finite or err > K1_ATOL:
            raise AssertionError(f"short_attention_fwd disagrees with its plain version: {row}")
        if name == "vision":
            record = row
    return record


def check_short_attention_bwd(sa, gen) -> dict:
    """K2 against its plain version at the same cases as K1; returns the
    JSON record of the vision shape (the main path's largest)."""
    import torch.nn.functional as F

    lib = sa._library("short_attention_bwd")
    record = None
    for name, (b, s, h, dh, causal) in ATTENTION_CASES.items():
        q, k, v, do = (
            torch.randn(b, s, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(4)
        )
        got = sa.short_self_attention_bwd(q, k, v, do, causal)
        torch.cuda.synchronize()
        ref = sa.short_self_attention_bwd_plain(q, k, v, do, causal)
        errs = {n: (g.float() - r.float()).abs().max().item() for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        tols = {n: K2_RTOL_OF_MAX * r.float().abs().max().item() for n, r in zip(("dq", "dk", "dv"), ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        row = dict(case=name, shape=[b, s, h, dh], causal=causal, max_abs_err=errs, atol=tols,
                   finite=finite,
                   blocks_per_sm={"dq": lib.short_attention_bwd_occupancy(s, dh, 0),
                                  "dkdv": lib.short_attention_bwd_occupancy(s, dh, 1)})
        if name in ("vision", "text"):
            row["ms"] = time_ms(lambda: sa.short_self_attention_bwd(q, k, v, do, causal))
            row["plain_ms"] = time_ms(lambda: sa.short_self_attention_bwd_plain(q, k, v, do, causal))
            # Library yardstick: the backward of scaled_dot_product_attention,
            # taken by autograd on the same inputs.
            leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            dout = do.transpose(1, 2)
            row["library_ms"] = time_ms(
                lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
            )
            row["device_ms"] = device_ms(lambda: sa.short_self_attention_bwd(q, k, v, do, causal))
            row["library_device_ms"] = device_ms(
                lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
            )
            row["bound_ms"], row["bound_by"] = attention_bound_ms(b, s, h, dh, causal, 7, 5)
            del out, leaves
        log("kernel_bwd", **row)
        if not finite or any(errs[n] > tols[n] for n in errs):
            raise AssertionError(f"short_attention_bwd disagrees with its plain version: {row}")
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
    launches, bwd_launches = sa.launches(), sa.bwd_launches()
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
    if bwd_launches != 0:
        raise AssertionError(f"serving launched the attention backward {bwd_launches} times")
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
    del model, engine, svc
    torch.cuda.empty_cache()
    return {"short_attention_fwd": launches}


def forward_flops_per_pair(cfg) -> float:
    """Forward FLOPs of one image-text pair through the towers, on the
    model-FLOPs basis of the JAX package's bench (its
    ``model_forward_flops_per_pair``, copied here): per layer
    (4 + 4 + 4·mlp_ratio)·s·w² + 4·s²·w, plus the patch embedding, the MAP
    heads' k/v projections and the projections; the loss matmul excluded."""
    def tower(s, w, depth, ratio):
        return depth * ((4 + 4 + 4 * ratio) * s * w * w + 4 * s * s * w)

    v, t = cfg.vision, cfg.text
    s_img = (v.image_size // v.patch_size) ** 2
    vit = tower(s_img, v.width, v.depth, v.mlp_ratio)
    vit += 2.0 * s_img * v.patch_size * v.patch_size * 3 * v.width
    if v.pool == "map":
        vit += 4.0 * s_img * v.width * v.width
    if v.use_proj:
        vit += 2.0 * v.width * v.embed_dim
    txt = tower(t.context_length, t.width, t.depth, t.mlp_ratio)
    if t.pool == "map":
        txt += 4.0 * t.context_length * t.width * t.width
    txt += 2.0 * t.width * t.embed_dim
    return float(vit + txt)


def headline_config():
    """SigLIP-B/16 as the headline train step runs it: save_hot remat in both
    towers, the ring loss at precision "default"."""
    from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

    cfg = SigLIPConfig.b16()
    remat = dict(remat=True, remat_policy="save_hot")
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, **remat),
        text=dataclasses.replace(cfg.text, **remat),
        loss=dataclasses.replace(cfg.loss, variant="ring", precision="default"),
    )


def random_batch(cfg, n, gen) -> dict:
    hw, ctx = cfg.vision.image_size, cfg.text.context_length
    return {
        "images": torch.rand((n, hw, hw, 3), device="cuda", generator=gen),
        "tokens": torch.randint(1, cfg.text.vocab_size, (n, ctx), device="cuda", generator=gen),
    }


def tower_grads(model, per_shard, batch) -> dict:
    """Flattened f32 gradient of each tower for one (micro)batch."""
    model.zero_grad(set_to_none=True)
    zimg, ztxt, lp = model(batch["images"], batch["tokens"])
    per_shard(zimg, ztxt, lp["t_prime"], lp["bias"]).backward()
    out = {tower: torch.cat([p.grad.float().flatten() for n, p in model.named_parameters()
                             if n.startswith(tower + ".")])
           for tower in ("visual", "textual")}
    model.zero_grad(set_to_none=True)
    return out


def run_train_path(args, sa) -> dict:
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_per_shard_loss
    from distributed_sigmoid_loss_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import TrainConfig

    cfg = headline_config()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = SigLIP(cfg, device="cuda", generator=gen)
    tx = make_optimizer(TrainConfig(warmup_steps=100, total_steps=100_000,
                                    adam_mu_dtype="bfloat16"))
    state = create_train_state(model, tx)
    step = make_train_step(model, cfg.loss, accum_steps=ACCUM, accum_dtype="bfloat16")
    batches = [random_batch(cfg, ACCUM * MICRO, gen) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    log("train", config="SigLIP-B/16", remat_policy=cfg.vision.remat_policy,
        accum_steps=ACCUM, microbatch=MICRO, accum_dtype="bfloat16", adam_mu_dtype="bfloat16",
        loss_variant=cfg.loss.variant, loss_precision=cfg.loss.precision,
        loss_precision_meaning="embeddings rounded to bf16, products summed in f32 (one bf16 pass)",
        train_config="TrainConfig(warmup_steps=100, total_steps=100_000)")

    # -- the training path, between the two reads of the launch counts -----
    sa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_s, metrics = [], []
    for batch in batches:
        t0 = time.monotonic()
        state, m = step(state, batch)
        m = {k: v.item() for k, v in m.items()}
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        metrics.append(m)
    launches, bwd_launches = sa.launches(), sa.bwd_launches()
    # -- end of the training path ------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    expected = (cfg.vision.depth + cfg.text.depth) * ACCUM * TRAIN_STEPS
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    pairs_per_s = ACCUM * MICRO / steady
    flops = 3.0 * forward_flops_per_pair(cfg)
    for i, (m, t) in enumerate(zip(metrics, step_s)):
        log("train", step=i, step_ms=1e3 * t, **m)
    log("train", steady_step_ms=1e3 * steady, pairs_per_s=pairs_per_s,
        model_tflops_per_pair_basis=flops / 1e12,
        mfu=flops * pairs_per_s / BF16_FLOP_PER_S, max_memory_allocated_gib=peak / 2**30,
        short_attention_fwd_launches=launches, short_attention_bwd_launches=bwd_launches,
        expected_each=expected, traced_bwd_batch_heads=sa.traced_bwd_batch_heads())
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite train metrics: {metrics}")
    if launches != expected or bwd_launches != expected:
        raise AssertionError(
            f"attention launches fwd {launches} / bwd {bwd_launches} != 24 per microbatch "
            f"({expected}); a forward count of 48 per microbatch means the remat policy "
            "re-ran the attention forward"
        )

    # Outside the counted run: one whole step, the optimizer update alone,
    # and one microbatch's forward+backward, on the device by kernel group.
    log("profile", path="train step", accum_steps=ACCUM, batch=ACCUM * MICRO,
        **device_breakdown(lambda: step(state, batches[0]), 1e3 * steady, host_ops=False))
    zero_grads = [torch.zeros_like(p) for p in state.params]
    update_ms = time_ms(lambda: state.tx.apply(state.params, zero_grads, state.opt_state),
                        iters=3, warmup=1)
    log("train", optimizer_update_ms=update_ms, params=len(zero_grads))
    del zero_grads
    per_shard = make_per_shard_loss(variant=cfg.loss.variant, precision=cfg.loss.precision)
    micro = {k: v[:MICRO] for k, v in batches[0].items()}

    def microstep():
        zimg, ztxt, lp = model(micro["images"], micro["tokens"])
        per_shard(zimg, ztxt, lp["t_prime"], lp["bias"]).backward()
        model.zero_grad(set_to_none=True)

    micro_ms = time_ms(microstep, iters=5, warmup=2)
    log("profile", path="train microbatch fwd+bwd", batch=MICRO, **device_breakdown(microstep, micro_ms))

    # The gradient through the whole model, kernels vs both plain versions.
    small = {k: v[:8] for k, v in batches[0].items()}
    kernel_grads = tower_grads(model, per_shard, small)
    launch_fwd, launch_bwd = sa._launch_fwd, sa._launch_bwd
    sa._launch_fwd = lambda q, k, v, c, sc: sa.short_self_attention_plain(q, k, v, c, sc)
    sa._launch_bwd = lambda q, k, v, do, c, sc: sa.short_self_attention_bwd_plain(q, k, v, do, c, sc)
    try:
        plain_grads = tower_grads(model, per_shard, small)
    finally:
        sa._launch_fwd, sa._launch_bwd = launch_fwd, launch_bwd
    cos = {t: float(torch.nn.functional.cosine_similarity(kernel_grads[t], plain_grads[t], dim=0))
           for t in kernel_grads}
    log("train", grad_cosine_kernel_vs_plain_b8=cos)
    if min(cos.values()) <= 0.999:
        raise AssertionError(f"kernel vs plain gradient through the model: cosine {cos}")
    del state, step, batches, kernel_grads, plain_grads
    torch.cuda.empty_cache()

    # A short fit: FIT_STEPS steps on one fixed batch at a constant rate.
    # Adam's first steps are about lr·sign(g) on each of 210M parameters, a
    # first-order change of the loss of about lr·‖g‖₁ (‖g‖₂ ≈ 55 here): at
    # 1e-5 that is several nats and the loss jumps about; at 1e-6 it descends.
    fit_tx = make_optimizer(TrainConfig(learning_rate=1e-6, warmup_steps=0,
                                        schedule="constant", adam_mu_dtype="bfloat16"))
    fit_state = create_train_state(model, fit_tx)
    fit_step = make_train_step(model, cfg.loss)
    fixed = random_batch(cfg, MICRO, gen)
    losses = []
    for _ in range(FIT_STEPS):
        fit_state, m = fit_step(fit_state, fixed)
        losses.append(m["loss"].item())
    log("train", fit_losses=losses)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")
    return {"short_attention_fwd": launches, "short_attention_bwd": bwd_launches}


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
        log("build", library=lib, seconds=info["seconds"], ptxas=ptxas_usage(info["log"]))
    log("build", seconds=time.monotonic() - t0, built=sorted(built))
    for lib, mirror in (("short_attention", sa.short_attention_smem_bytes),
                        ("short_attention_bwd", sa.short_attention_bwd_smem_bytes)):
        smem = getattr(sa._library(lib), f"{lib}_smem_bytes")(196, 64)
        if smem != mirror(196, 64):
            raise AssertionError(f"{lib} smem {smem} != python mirror {mirror(196, 64)}")

    # Phase 3: each kernel against its plain version.
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = check_short_attention(sa, gen)
    k2 = check_short_attention_bwd(sa, gen)

    # Phases 4 and 5: the main paths, each between two reads of the counts.
    t0 = time.monotonic()
    serve = run_main_path(args, sa)
    t_serve = time.monotonic() - t0
    t0 = time.monotonic()
    train = run_train_path(args, sa)
    log("paths", serve_s=t_serve, train_s=time.monotonic() - t0)

    # Phase 6: the records.
    source = "distributed_sigmoid_loss_tpu_torch/csrc/"
    replaces = "distributed_sigmoid_loss_tpu/ops/pallas_short_attention.py:"
    shape = "b=128 s=196 h=12 dh=64 bf16"
    kernels = [{
        "name": "short_attention_fwd",
        "route": "cuda",
        "source": source + "short_attention.cu",
        "replaces": replaces + "257",
        "launches": serve["short_attention_fwd"] + train["short_attention_fwd"],
        "launches_by_path": {"serve": serve["short_attention_fwd"],
                             "train": train["short_attention_fwd"]},
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "shape": shape,
    }, {
        "name": "short_attention_bwd",
        "route": "cuda",
        "source": source + "short_attention_bwd.cu",
        "replaces": replaces + "278",
        "launches": train["short_attention_bwd"],
        "launches_by_path": {"serve": 0, "train": train["short_attention_bwd"]},
        "max_abs_err": max(k2["max_abs_err"].values()),
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "shape": shape,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
