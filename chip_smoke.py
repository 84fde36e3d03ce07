#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failed check ends the run with a non-zero exit
and nothing is caught:

1. the card (``nvidia-smi`` name and power limit, ``torch.cuda``);
2. build every kernel from ``distributed_sigmoid_loss_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together);
3. hold each kernel (K1, the attention forward; K2, its backward, within
   one bf16 ulp, run twice for bitwise repeatability, its two kernels' p
   and ds bit for bit equal where the warpgroup body runs; K3, the
   head-batched backward, also against K2 and run twice) against its plain
   PyTorch version on the card at the shapes the main paths give it, and
   time kernel, plain version and the PyTorch library call beside the
   work's least time on this card (K1's, K2's and K3's lines name the body
   each case took, its registers from ``[build]`` and its blocks per SM; K2's
   and K3's warpgroup kernels must spill nothing and keep their wgmma
   asynchronous, and every dh-64 K3 case must take K3's warpgroup body);
4. the serving path (``run_serve_path`` with ``SERVE``): SigLIP-B/16 at
   full width and depth in bf16, seeded random weights,
   ``InferenceEngine`` + ``EmbeddingService`` serving a 256-image corpus and
   64 mixed requests from 8 threads, with the kernel launch counts read
   around that run, then the towers against their plain attention and their
   device time by kernel at the largest bucket (torch.profiler);
   Then the loss kernels (K4, the streaming loss forward; K5 and K6, its
   backward) against their plain versions in eight cases (the headline
   block, a fused all-gather rank view, a ring hop at 32k global over 8
   ranks with and without positives, bf16, ragged, So400m width, the fused
   all-gather's block at 32k global, 4096 × 32768), twice for bitwise
   repeatability, with K5/K6's splits and scratch bytes, timed at the ring
   hop, the headline block and the 32k block beside cuBLAS's f32 products
   ("product only"), each against both bounds (CUDA cores and split f32 on
   the tensor cores) with its body and registers; and a NaN in zimg at the
   ring hop, which the loss and every gradient must carry exactly where the
   plain version's do (``[loss_kernel_nan]``);
5. the training path (``run_train_path`` with ``TRAIN``): the headline
   train step (B/16, 16 accumulated
   microbatches of 128 pairs, ``save_hot`` remat, bf16 accumulator and Adam
   first moment, ring loss at precision "default") for 3 steps, with the
   launch counts read around them; then one step's and one microbatch's
   device time by kernel, the gradient through the whole model with the kernels against
   both plain versions, and a 10-step fit of one fixed batch;
6. the rank view: what rank 3 of an 8-GPU chunked all-gather run at 32k
   global computes after its gather (``sigmoid_loss_chunk_scan`` with
   ``use_pallas=True`` over 8 chunks of 4096), forward and backward against
   the plain chunk scan, with its time, peak memory and launches;
7. the headline step with ``LossConfig(use_pallas=True)`` for 2 steps, with
   the launch counts read around them, and the gradient through the whole
   model with the loss kernels against their plain versions;
8. the training recipes (``[train_recipes]``): the headline step with the
   head-batched backward K3, the softmax (InfoNCE) ring loss, GradCache's
   exact global negatives over 16 × 128 with a bf16 stash and the EMA, for
   2 steps with Lion and 2 with Adafactor, with the launch counts read
   around them; then GradCache at 4 × 128 against one 512-pair batch and
   K3 against K2, each by the cosine of the whole model's gradient;
9. the flash attention kernel K7 (``[kernel_flash]``, run with phase 3):
   forward, dK/dV and dQ against their plain versions at the kernels' own
   key block in nine cases (B/16 at 512 px, So400m-384's dh=72 at s=729,
   causal at s=1000, s=196, the context block's s=4,096, dh=128 at
   s=1,024, the single key tile at s=64 and causal at s=50, causal dh=128
   at s=577), bitwise repeatable, timed beside SDPA, with each kernel's
   body (wgmma fed by TMA at head dims 64 and 128, mma.sync otherwise),
   registers and blocks per SM; then SigLIP-B/16 at 512 px (1,024
   patches, K7 in every vision layer) served by ``run_serve_path`` with
   ``SERVE_512`` (``[serve_512]``: a 64-image corpus, 16 mixed requests,
   search == oracle, 12 K7 forwards per image tower call) and trained by
   ``run_train_path`` with ``TRAIN_512`` (``[train_512]``: 2 steps of 4 ×
   32 pairs under ``save_hot``, 48 launches of each K7 kernel per step, the
   gradient against the plain versions);
10. the context block (``[context]``, the JAX bench's ``--context``): one
   width-768 block, forward and backward, at s=1,024 and 4,096, dense
   attention against K7, ms per layer and peak memory;
11. the f32 attention kernels (``[kernel_f32_attention]``, run with phase
   3): their forward in K1's role and their backward in K2's and K3's at
   B/16 vision, and both in K7's at b=32, s=1,024, against the plain
   versions in f32 (TF32 off) at rtol 1e-4 of the largest magnitude, twice
   for bitwise repeatability (each case with the body, registers and blocks
   per SM of its split-f32 kernels, which must spill nothing and keep their
   wgmma asynchronous), timed beside SDPA in f32 (each pass, the pair, the
   K2/K3 role whole: the forward it runs again, dK/dV and dQ; and K7's role,
   forward and backward) with two bounds, on the CUDA cores and in 3xTF32
   on the tensor cores, and a NaN in q, which the K1, K2 and K3 roles must
   carry exactly where the plain versions do
   (``[kernel_f32_attention_nan]``); then an f32
   B/16 model with ``attn_impl="flash"`` (``[f32_tower]``: 224 px with K2
   and with K3 as its backward, 512 px on K7's role), forward and backward
   between two reads of the counts (the roles' and each f32 kernel's own),
   the gradient against the plain versions; K3 (``[kernel_bwd_batched]``)
   also at JAX's longest lengths (s = 225 and 250 at width 768, 212 at
   1,024, 208 at 1,152; the warpgroup body timed at s = 250 and the in-place
   mma.sync kernel at s = 208, dh = 72, beside their plain version and SDPA)
   and refusing s = 251;
12. the int8 mode of the loss kernels (``[loss_kernel_int8]``, run with
   phase 3): K4, K5 and K6 int8 against their plain int8 versions at the
   headline block, the 32k ring hop with and without positives,
   So400m's d = 1,152 and the fused all-gather's 32k block, twice for
   bitwise repeatability, a non-tileable block refused to the caller's
   plain path, timed at the ring hop and the 32k block beside
   ``torch._int_mm`` (K5/K6 int8: with one cuBLAS f32 product, the gradient
   product; K4 int8: its device time split into the kernel's own and the
   quantize passes in front of it);
   then B/16 served with int8 projections (``[serve_int8]``, the serving
   path of phase 4 with ``quant="int8"``, each embedding against the same
   weights in bf16) and the headline step with ``quant_train="int8"`` and
   ``use_pallas=True`` (``[train_int8]``: the int8 loss kernels, the STE
   projections, the gradient against every kernel's plain version);
13. the reference's loss classes (``[compat]``): ``DDPSigmoidLoss`` and
   ``SigLipLoss`` at W = 1 on 4096 × 512 unit rows, with and without the
   loss kernels (one K4, K5 and K6 a call, read around each call), each
   bitwise equal to ``make_sharded_loss_fn``, the kernels against the plain
   path (the loss and all four gradients), one class against the other;
14. the train command (``[train_cli]``, ``cli.main`` in this process) at
   full B/16 width and depth, TRAIN_CLI_FLAGS: (a) 2 steps saved at 2 into
   D, (b) resumed from D to 4, (c) 4 steps into E, the counts read around
   each run against ``[train_pallas]``'s per microbatch plus K1 for each
   eval forward; D's and E's step-4 states compared; each checkpoint's bytes
   and save seconds; ``eval`` of D with and without ``--ema``
   (``[eval_cli]``); steps timed with and without an asynchronous save in
   flight; steps through the resilient loop with and without the host copy
   of ``--watchdog skip`` before the first checkpoint, a NaN batch rolled
   back bit for bit; D and E deleted;
15. real image-text data (``[train_data]``, ``cli.main`` in this process):
   BMP tar shards written here with ``struct`` (240 x 320 sinusoid mixes: 2
   train shards of 160 pairs, an eval shard of 256), each
   ``decode_and_resize`` at 224 px timed; B/16 trained on them for 3 steps
   (TRAIN_DATA_FLAGS, a shuffle buffer, ``--eval-data``, an eval every 2
   steps), the counts read around the run against ``[train_pallas]``'s per
   microbatch plus K1 for each eval forward; the real-data convergence
   oracle (16 colour classes, ``--tiny``, 80 steps) at recall@1 >= 0.5 both
   ways; 2 B/16 steps on ``--native-data`` without its fallback;
   ``data-bench`` over the train shards; whether libjpeg (and PIL) are
   here, and if libjpeg is, 2 ``--tiny`` steps with ``--native-decode`` on
   the committed JPEG fixture without its fallback; the shards deleted;
16. the serve-bench command (``[serve_bench]``, ``cli.main`` in this
   process) at full B/16 width (SERVE_BENCH_FLAGS): the snapshot on the
   exact tier with one scrape of the live ``/metrics``, on the sharded tier
   (``--mesh``: one shard on the card; every search also answered by the
   exact index on the host, the ids equal but for near ties of the exact
   scores), on the ann tier, with ``--swap-every 64``; the burst, skew,
   slowloris and swapstorm scenarios; the host-loss and split-brain drills
   (their workers from a fork server, CUDA being initialized), each run
   between two reads of the counts (12 K1 launches per tower call, nothing
   else), exit 0, ``compile_count`` at the 8 warmed buckets, no silent
   drop, no over-ceiling sample; then ``ShardedIndex`` alone at 1,048,576 ×
   512 small-integer rows (2 GiB) in 4 shards on cuda:0 with planted exact
   ties: ids and scores equal to the host's exact index, and its search
   time;
17. a JSON line of the kernels' numbers and, last, the device record.

Without CUDA, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tarfile
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
# K2 and K3 vs their plain versions (and K3 vs K2) in bf16: both round p and
# ds to bf16 after f32 sums taken in different orders (a p or ds may move one
# bf16 ulp) and round each gradient to bf16; held to one bf16 ulp at the
# gradient's largest magnitude, 2^(floor(log2 max) - 7).
K3_ULPS = 1
# The training recipes: 2 steps with Lion, then 2 with Adafactor; GradCache
# checked at 4 × 128 against one batch of 512 pairs.
RECIPE_STEPS = 2
GRADCACHE_CHECK = (4, 128)
GRADCACHE_MIN_COSINE = 0.999
K3_VS_K2_MIN_COSINE = 0.99999
# FP32 outside the tensor cores (NVIDIA data sheet, H100 SXM): the loss
# kernels' IEEE f32 FMAs.
FP32_FLOP_PER_S = 67e12
NEGATIVE_ONLY_OFFSET = -(2 ** 24)
# Loss-kernel cases: (b, n, d, pos_offset, dtype).
LOSS_CASES = {
    "headline_block": (128, 128, 512, 0, torch.float32),  # one microbatch of the headline, W = 1
    "allgather_w8_rank3": (128, 1024, 512, 3 * 128, torch.float32),  # fused all-gather, rank 3 of 8
    "ring_hop_32k_positive": (4096, 4096, 512, 0, torch.float32),  # 32k global over 8 ranks
    "ring_hop_32k_negative": (4096, 4096, 512, NEGATIVE_ONLY_OFFSET, torch.float32),
    "bf16_block": (128, 128, 512, 0, torch.bfloat16),
    "ragged": (100, 300, 200, 7, torch.float32),
    "so400m_width": (256, 512, 1152, 0, torch.float32),  # SigLIPConfig.so400m embeddings
    # The fused all-gather's block, rank 3 of 8 at 32k global: K5 walks
    # 512 text tiles, so its splits and their scratch are the most any case
    # needs.
    "fused_allgather_w8_32k": (4096, 32768, 512, 3 * 4096, torch.float32),
}
LOSS_TIMED = "ring_hop_32k_positive"
# Also timed (not in the kernels line): the headline microbatch's block,
# where 128-row K5/K6 blocks leave most of the card idle, and the fused
# all-gather's 32k block.
LOSS_TIMED_MORE = ("headline_block", "fused_allgather_w8_32k")
# Loss kernels vs plain versions, both IEEE f32 with sums in other orders:
# the loss at rtol 1e-5; each gradient within 1e-4 of its largest magnitude
# (sums over up to 4096 products of order-1 terms). bf16 inputs: the
# gradients are rounded to bf16 at the end, so two bf16 ulps of the largest.
LOSS_RTOL = 1e-5
LOSS_GRAD_RTOL_OF_MAX = 1e-4
BF16_GRAD_RTOL_OF_MAX = 2.0 ** -7
# The headline train step (bench.py's no-argument run): 16 microbatches of 128.
ACCUM, MICRO = 16, 128
# The rank view of the chunked all-gather at 32k global over 8 ranks:
# (local_b, W, d, rank), and the steps of the headline with use_pallas.
RANK_VIEW = (4096, 8, 512, 3)
TRAIN_PALLAS_STEPS = 2
# Kernel cases of both kernels: (b, s, h, dh, causal).
ATTENTION_CASES = {
    "vision": (128, 196, 12, 64, False),  # B/16 image tower, batch 128
    "text": (128, 64, 12, 64, False),  # B/16 text tower, batch 128
    "causal": (4, 77, 8, 64, True),
    "head_dim_72": (2, 256, 16, 72, False),  # so400m head width, L/14 length
    "l14": (64, 256, 16, 64, False),  # L/14 (width 1,024, 16 heads), batch 64
    "scalar_path": (2, 50, 3, 20, True),  # width 60: element-wise loads and stores
    "s416": (4, 416, 12, 64, False),  # the K1/K7 dispatch limit at width 768 / 12: two passes
}
# Further K2 cases (b, s, h, dh, causal): a ragged length the warpgroup body
# takes (s_pad = 208, not 196's) and the first length past its range, which
# the wmma body takes.
K2_MORE_CASES = {"ragged_200": (8, 200, 12, 64, False), "s257": (2, 257, 12, 64, False)}
# K2's bodies (short_attention_bwd_body), and the cases that must take the
# warpgroup body (head dim 64, 16-byte rows, s_pad <= 256); the others
# (dh 72, width 60, s = 257 and 416) take the wmma body.
K2_BODIES = {1: "wgmma, TMA, resident operands", 0: "wmma, cp.async"}
K2_WGMMA_CASES = ("vision", "text", "causal", "l14", "ragged_200")
# K7 cases: (b, s, h, dh, causal).
FLASH_CASES = {
    "b16_512": (32, 1024, 12, 64, False),  # the B/16-512 vision shape, microbatch 32
    "so400m_384": (8, 729, 16, 72, False),  # So400m-384's head: width 1152, 16 heads
    "causal_1000": (4, 1000, 12, 64, True),
    "s196": (32, 196, 12, 64, False),
    "context_4096": (4, 4096, 12, 64, False),  # the [context] block's longest shape
    "head_dim_128": (8, 1024, 8, 128, False),  # the warpgroup body at dh=128
    "single_tile": (16, 64, 12, 64, False),  # one key tile: p normalised before the cast
    "single_tile_causal": (4, 50, 12, 64, True),
    "ragged_causal_128": (4, 577, 8, 128, True),  # the backward bodies' ragged, causal edges
}
FLASH_TIMED = "b16_512"
# K7 vs its plain version at the kernels' own key block: both round p (and
# ds) to bf16 after f32 sums in other orders; the output within one bf16 ulp
# of its largest magnitude, each gradient within two, and every cosine
# above 0.999.
K7_OUT_ULPS, K7_GRAD_ULPS, K7_MIN_COSINE = 1, 2, 0.999
# K3 at JAX's longest lengths: (b, s, h, dh, causal) at widths 768 / 12,
# 1,024 / 16 and 1,152 / 16 (dh = 72), the in-place kernel causal and on its
# element-wise path (width 60), and the first length JAX refuses at 768 / 12.
K3_LONG_CASES = {
    "s225_w768": (32, 225, 12, 64, False),  # B/16 at 240 px
    "s250_w768": (32, 250, 12, 64, False),
    "s212_w1024": (16, 212, 16, 64, False),
    "s208_w1152": (16, 208, 16, 72, False),
    "s250_causal": (4, 250, 12, 64, True),
    "s240_scalar_causal": (2, 240, 3, 20, True),
}
K3_REFUSED_CASE = (2, 251, 12, 64)
# K3's bodies (short_attention_bwd_batched_body), and the cases that must
# take the warpgroup body (head dim 64, 16-byte rows, s_pad <= 256): every
# dh-64 case K3 takes. The others (dh 72 and 20) take the mma.sync kernels.
K3_BODIES = {1: "wgmma, TMA: a producer warpgroup and two consumers (one warpgroup at "
                "s <= 64)", 0: "mma.sync, cp.async"}
K3_WGMMA_CASES = ("vision", "text", "causal", "s225_w768", "s250_w768", "s212_w1024",
                  "s250_causal")
# The case timed past s_pad = 208, the in-place kernel's range before the
# warpgroup body took it; its row stands beside the vision and text rows.
K3_IN_PLACE_TIMED = "s250_w768"
# The cases timed for the mma.sync kernels that remain, by kernel: the
# two-array kernel on its element-wise path, the in-place one at dh 72.
K3_MMA_SYNC_TIMED = {"short_attention_bwd_batched_two_arrays": "scalar_path",
                     "short_attention_bwd_batched_in_place": "s208_w1152"}
# The f32 attention kernels: K1's and K2/K3's roles at B/16 vision, K7's at
# the B/16-512 shape, all (b, s, h, dh); held at rtol 1e-4 of the largest
# magnitude, as JAX's f32 kernels are held, with TF32 off.
F32_ATTENTION_CASES = {"vision": (128, 196, 12, 64), "b16_512": (32, 1024, 12, 64)}
# Further f32 cases held like those (b, s, h, dh, causal): causal text, an
# odd head dim, and K7's role causal and ragged; B/16's text and the wider
# head dims at s <= 64, where the forward runs one warpgroup a block.
F32_ATTENTION_MORE = {"causal": (4, 77, 8, 64, True), "head_dim_20": (2, 50, 3, 20, True),
                      "head_dim_72": (2, 256, 16, 72, False),
                      "head_dim_128": (2, 196, 12, 128, False),
                      "text": (128, 64, 12, 64, False),
                      "head_dim_72_short": (2, 40, 3, 72, False),
                      "head_dim_128_short": (2, 64, 4, 128, True),
                      "k7_causal_1000": (2, 1000, 12, 64, True)}
F32_RTOL_OF_MAX = 1e-4
# TF32 on the tensor cores (NVIDIA data sheet, H100 SXM, dense): the f32
# backward's split products, three TF32 products for each f32 one.
TF32_FLOP_PER_S = 495e12
F32_BWD_BODY = "mma.sync m16n8k8 split f32 (3xTF32), two-stage cp.async ring"
# The f32 forward's body (csrc/attention_f32.cu): both products on wgmma in
# split f32, the online softmax in registers.
F32_FWD_BODY = ("wgmma m64nNk8 (N: a chunk's keys, 64, or 32 past dh 64; a last chunk of "
                "<= 16 or 32 live keys at that width) / m64n(32·ceil(dh/32))k8 split f32 "
                "(3xTF32), Q, K and V in TF32 hi/lo planes split once a block, p from the "
                "accumulator, one cp.async stage")
# K5/K6's body (csrc/sigmoid_loss.cu): the logits and the gradient product
# on wgmma in split f32, B split once per block into TF32 planes, the
# slices of a row block a cluster that shares the logits.
LOSS_BWD_BODY = ("wgmma m64n64k8 / m64n256k8 split f32 (3xTF32), TF32 hi/lo planes, "
                 "four-stage cp.async ring, slices share the logits as a cluster")
# K4's bodies (csrc/sigmoid_loss.cu): a persistent walk over 128 x 128
# tiles, the logits on wgmma in split f32 or int8, the epilogue in registers.
LOSS_FWD_BODY = ("persistent 128 x 128 tiles, wgmma m64n128k8 split f32 (3xTF32), B in TF32 "
                 "hi/lo planes split while the products run, four-stage cp.async ring, "
                 "one block an SM")
LOSS_FWD_INT8_BODY = ("persistent 128 x 128 tiles, wgmma m64n128k32 s8 from swizzled shared "
                      "memory, three-stage cp.async ring, two blocks an SM")
# SASS instructions of K4's epilogue for one logit in the int8 mode
# (dequantize, the label, logit_of, softplus with precise expf and log1pf,
# the mask and the sum), as `compare_sigmoid_loss.py --count-epilogue`
# counted them for sm_90a (a static count: one branch, one MUFU.EX2); each
# issues for 32 lanes on the CUDA cores.
K4_EPILOGUE_INSTRUCTIONS = 61
# The f32 model with attn_impl="flash": batch at 224 px and at 512 px.
F32_TOWER_BATCH = {"b16": 8, "b16_512": 2}
# int8 (NVIDIA data sheet, H100 SXM, dense): the loss kernels' int8 products.
INT8_OP_PER_S = 1979e12
# The int8 loss cases: (b, n, d, pos_offset), all tileable by JAX's dispatch.
LOSS_INT8_CASES = {
    "headline_block": (128, 128, 512, 0),
    "ragged_rows": (96, 160, 256, 5),  # tileable by JAX, ragged for the 64-row tiles
    "ring_hop_32k_positive": (4096, 4096, 512, 0),
    "ring_hop_32k_negative": (4096, 4096, 512, NEGATIVE_ONLY_OFFSET),
    "so400m_width": (256, 512, 1152, 0),
    # The fused all-gather's block, rank 3 of 8 at 32k global: K5's sums run
    # over 32,768 text rows, the longest of any case.
    "fused_allgather_w8_32k": (4096, 32768, 512, 3 * 4096),
}
LOSS_INT8_TIMED = "ring_hop_32k_positive"
# Also timed (not in the kernels line).
LOSS_INT8_TIMED_MORE = ("fused_allgather_w8_32k",)
# int8 loss kernels vs plain: the int8 raw is exact on both sides, so the
# loss and the bias gradient within rtol 1e-5, each embedding gradient within
# 1e-5 of its largest magnitude (against an f64 product of the plain
# version's dlogits), and t′'s (a sum of b·n terms that cancel) within 1e-5
# of t·Σ|dl·raw|.
LOSS_INT8_RTOL = 1e-5
# int8 serving vs the same weights in bf16 (JAX's fidelity contract,
# tests/test_quant.py): every embedding row's cosine above this.
INT8_MIN_COSINE = 0.995
TRAIN_INT8_STEPS = 2

# The reference's loss classes at W = 1 (``[compat]``): rows of the ring hop.
COMPAT_ROWS, COMPAT_DIM = 4096, 512
# The train command at full B/16 width and depth (``[train_cli]``): a global
# batch of 256 in 2 microbatches of 128, the headline's bf16 accumulator and
# save_hot remat, the loss kernels, the EMA, asynchronous checkpoints and an
# eval every 2 steps; (a) 2 steps saved at 2, (b) resumed to 4, (c) 4 steps
# uninterrupted; then ``eval`` of (b)'s checkpoint with and without --ema.
TRAIN_CLI_FLAGS = ("--model", "b16", "--batch", "256", "--accum", "2", "--accum-bf16",
                   "--remat-policy", "save_hot", "--use-pallas", "--ema-decay", "0.999",
                   "--async-checkpoint", "--eval-every", "2")
TRAIN_CLI_ACCUM, TRAIN_CLI_EVAL_EVERY, TRAIN_CLI_EVAL_BATCH = 2, 2, 128
# The resumed and the uninterrupted run on the card: the token embedding's
# gradient sums by atomics, so they may differ in the last bits; then the
# parameters' cosine and the losses of steps 3-4 are held to these.
TRAIN_CLI_MIN_COSINE, TRAIN_CLI_LOSS_RTOL = 0.999999, 1e-5
TRAIN_CLI_KERNELS = ("short_attention_fwd", "short_attention_bwd", "sigmoid_loss_fwd",
                     "sigmoid_loss_bwd_img", "sigmoid_loss_bwd_txt")
# Steps timed with and without an asynchronous save in flight.
SAVE_IN_FLIGHT_STEPS = 3
# Steps through the resilient loop with and without the skip rollback's
# host copy; the NaN batch's position under "skip".
SKIP_LOOP_STEPS, SKIP_POISON = 6, 3
# Real image-text data (``[train_data]``): BMP tar shards of HW sinusoid
# mixes, SHARDS train shards of PAIRS pairs and one eval shard of a whole
# batch (the holdout is one batch of --batch rows); B/16 as TRAIN_CLI_FLAGS
# without its checkpoints and EMA, STEPS steps, an eval every EVAL_EVERY.
TRAIN_DATA_HW, TRAIN_DATA_SHARDS, TRAIN_DATA_PAIRS = (240, 320), 2, 160
TRAIN_DATA_BATCH, TRAIN_DATA_ACCUM = 256, 2
TRAIN_DATA_FLAGS = ("--model", "b16", "--batch", str(TRAIN_DATA_BATCH), "--accum",
                    str(TRAIN_DATA_ACCUM), "--accum-bf16", "--remat-policy", "save_hot",
                    "--use-pallas")
TRAIN_DATA_STEPS, TRAIN_DATA_EVAL_EVERY, TRAIN_DATA_NATIVE_STEPS = 3, 2, 2
# Images timed through decode_and_resize at 224 px.
TRAIN_DATA_DECODE_TIMED = 64
# The real-data convergence oracle (the JAX package's
# tests/test_convergence_real_data.py), its shards in BMP: recall@1 both
# ways at least this (chance 1/16).
ORACLE_NAMES = ("red", "green", "blue", "cyan", "magenta", "yellow", "white", "gray",
                "crimson", "lime", "navy", "teal", "purple", "olive", "silver", "black")
ORACLE_COLORS = ((220, 30, 30), (30, 200, 30), (30, 30, 220), (30, 200, 200),
                 (200, 30, 200), (220, 220, 30), (240, 240, 240), (128, 128, 128),
                 (150, 20, 60), (120, 255, 60), (20, 20, 120), (20, 120, 120),
                 (120, 20, 160), (120, 120, 30), (190, 190, 190), (15, 15, 15))
ORACLE_MIN_RECALL = 0.5
JPEG_FIXTURE = os.path.join("tests", "fixtures", "jpeg_pairs.tar")
# The serve-bench command (``[serve_bench]``, ``cli.main`` in this process) at
# full B/16 width: the snapshot on each index tier, --swap-every churn, four
# scenarios on the engine, the host-loss and split-brain drills, one scrape
# of the live /metrics; then the sharded index alone on the card at 1M rows.
SERVE_BENCH_FLAGS = ("--model", "b16", "--batch-buckets", "1,8,32,128", "--pool", "256",
                     "--index-size", "256", "--requests", "512", "--clients", "8")
SERVE_BENCH_DRILL = ("--duration-s", "2")
SERVE_BENCH_RUNS = (
    ("exact", ("--metrics-port", "0")),
    ("sharded", ("--index-tier", "sharded", "--mesh")),
    ("ann", ("--index-tier", "ann", "--rerank-k", "64")),
    ("swap", ("--swap-every", "64")),
    ("burst", ("--scenario", "burst") + SERVE_BENCH_DRILL),
    ("skew", ("--scenario", "skew") + SERVE_BENCH_DRILL),
    ("slowloris", ("--scenario", "slowloris") + SERVE_BENCH_DRILL),
    ("swapstorm", ("--scenario", "swapstorm") + SERVE_BENCH_DRILL),
    ("hostloss", ("--scenario", "hostloss") + SERVE_BENCH_DRILL),
    ("fleet-splitbrain", ("--fleet-scenario", "fleet-splitbrain") + SERVE_BENCH_DRILL),
)
# Searches whose sharded (card) and exact (host) ids differ only where the
# exact scores of the differing rows lie within this of each other: the
# two sum the same f32 products in different orders.
SERVE_BENCH_NEAR_TIE = 1e-5
# The sharded index alone: rows, width, shards on cuda:0, queries, k; the
# rows are small integers in f32, so every score is exact in any order of
# summation and the ids must equal the host's exact index's.
SHARDED_AT_SCALE = (1 << 20, 512, 4, 128, 10)


@dataclasses.dataclass(frozen=True)
class Serving:
    """One serving run: its log tag, the configuration's name (see
    ``siglip_config``), the engine's buckets, the corpus images, the requests
    and client threads, the seed's offset, and the launch counter of the
    image tower's attention kernel (the text tower's is always K1's)."""

    phase: str
    config: str
    buckets: tuple[int, ...]
    corpus: int
    requests: int
    clients: int
    seed_offset: int
    vision_kernel: str
    # A configuration whose embeddings of the same weights each row must
    # match to INT8_MIN_COSINE (the int8 run against bf16), or None.
    reference: str | None = None


@dataclasses.dataclass(frozen=True)
class Training:
    """One training run: its log tag, the configuration's name, microbatches
    per step, pairs per microbatch, steps, the seed's offset, the Adam first
    moment's and the accumulator's dtypes (None: f32), the launch counters of
    the vision tower's attention kernels (the text tower runs K1 and K2), and
    the steps of the fixed-batch fit after it (0: none)."""

    phase: str
    config: str
    accum: int
    micro: int
    steps: int
    seed_offset: int
    adam_mu_dtype: str | None
    accum_dtype: str | None
    vision_kernels: tuple[str, ...]
    fit_steps: int


K1_K2 = ("short_attention_fwd", "short_attention_bwd")
K7 = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
# B/16 at 224 px: 256 images and 64 requests from 8 threads; the headline
# step, 3 steps, then a 10-step fit. B/16 at 512 px: buckets to 32 (a 512 px
# batch of 128 is 400 MB of f32 pixels), 64 images and 16 requests from 4
# threads; 2 steps of 4 × 32 pairs.
SERVE = Serving("main", "b16", (1, 8, 32, 128), 256, 64, 8, 0, "short_attention_fwd")
SERVE_512 = Serving("serve_512", "b16_512", (1, 8, 32), 64, 16, 4, 3, "flash_attention_fwd")
# B/16 at 224 px with int8 projections in both towers, the same seed (so the
# same weights) as SERVE, held against them in bf16.
SERVE_INT8 = Serving("serve_int8", "b16_int8", (1, 8, 32, 128), 256, 64, 8, 0,
                     "short_attention_fwd", reference="b16")
TRAIN = Training("train", "headline", ACCUM, MICRO, 3, 0, "bfloat16", "bfloat16", K1_K2, 10)
TRAIN_512 = Training("train_512", "b16_512", 4, 32, 2, 4, None, None, K7, 0)
# The context block: (s, b), the JAX bench's "--context" shapes.
CONTEXT_CASES = ((1024, 16), (4096, 4))


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def kernel_name(mangled: str) -> str:
    """``kernel<template args>`` of one of the port's mangled kernel names."""
    short = re.search(r"\d((?:short_attention|sigmoid_loss|flash_attention|attention_f32)"
                      r"_\w*?kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    if not short:
        return mangled
    args = re.findall(r"L[ib](\d+)E", short.group(2) or "")
    return short.group(1) + (f"<{', '.join(args)}>" if args else "")


def wgmma_serialized(build_log: str) -> list[str]:
    """The kernels whose wgmma products ptxas serialised (its "Potential
    Performance Loss" notes): a body that must stay asynchronous is not."""
    return [kernel_name(m.group(1)) for m in re.finditer(
        r"wgmma\.mma_async instructions are serialized.*?function '(\w+)'", build_log)]


def ptxas_usage(build_log: str) -> dict:
    """``{kernel<template args>: "N registers, S spill bytes"}`` from ``nvcc
    -Xptxas -v``."""
    usage, kernel = {}, None
    for line in build_log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            kernel = kernel_name(entry.group(1))
        elif kernel and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)
            usage[kernel] = f"spill {spill.group(1)} B" if spill else line.strip()
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            usage[kernel] = f"{regs.group(1)} registers, " + usage.get(kernel, "")
    return usage


# ``[build]``'s ptxas lines of this run, by kernel instantiation (empty for
# a library that was already built).
PTXAS: dict[str, str] = {}


def registers(kernel: str) -> str:
    """``"N registers, spill S B"`` of one kernel instantiation, from
    ``[build]``."""
    return PTXAS.get(kernel, "not built in this run")


def short_attention_body(sa, s: int, dh: int, vec: int) -> tuple[str, str]:
    """(body, ptxas line) of the K1 instantiation a call at (s, dh) runs."""
    lib = sa._library("short_attention")
    keys, code = lib.short_attention_row_keys(s, dh, vec), lib.short_attention_body(s, dh, vec)
    if code == 2:
        return (f"wgmma, one pass, {keys} keys of a row in registers, cp.async",
                registers(f"short_attention_fwd_wgmma_kernel<{keys // 8}>"))
    body = (f"mma.sync, one pass, {keys} keys of a row in registers" if keys
            else "mma.sync, two passes over 64-key chunks") + (", cp.async" if vec else ", element-wise")
    return body, registers(f"short_attention_fwd_kernel<{(dh + 15) // 16}, {keys // 8}>")


def short_attention_bwd_body(sa, s: int, dh: int, vec: int) -> tuple[str, dict]:
    """(body, {kernel: ptxas line}) of the K2 body a call at (s, dh) runs:
    the warpgroup body's dQ kernel is instantiated at the 64, 208 or 256
    keys of its products, the wmma body's kernels at dh's 16-wide tiles."""
    code = sa._library("short_attention_bwd").short_attention_bwd_body(s, dh, vec)
    if code != sa.short_attention_bwd_body(s, dh, vec):
        raise AssertionError(f"K2 body at s={s}, dh={dh}, vec={vec} != python mirror")
    body = K2_BODIES[code] + ("" if vec or code else " (element-wise loads)")
    if code:
        s_pad = (s + 15) // 16 * 16
        keys = 64 if s_pad <= 64 else 208 if s_pad <= 208 else 256
        kernels = (f"short_attention_bwd_dq_wgmma_kernel<{keys}>",
                   "short_attention_bwd_dkdv_wgmma_kernel")
    else:
        kernels = tuple(f"short_attention_bwd_{k}_kernel<{(dh + 15) // 16}>" for k in ("dq", "dkdv"))
    return body, {k: registers(k) for k in kernels}


def short_attention_bwd_batched_body(sa, s: int, dh: int, vec: int) -> tuple[str, dict]:
    """(body, {kernel: ptxas line}) of the K3 kernel a call at (s, dh) runs:
    the warpgroup body at the 64, 208 or 256 keys of its products, else the
    two-array or in-place mma.sync kernel (key tiles, head-dim tiles)."""
    lib = sa._library("short_attention_bwd_batched")
    code = lib.short_attention_bwd_batched_body(s, dh, vec)
    if code != sa.short_attention_bwd_batched_body(s, dh, vec):
        raise AssertionError(f"K3 body at s={s}, dh={dh}, vec={vec} != python mirror")
    body = K3_BODIES[code] + ("" if vec or code else " (element-wise loads)")
    nt = (s + 15) // 16
    if code:
        kernel = f"short_attention_bwd_batched_wgmma_kernel<{sa._wgmma_keys(s)}>"
    elif lib.short_attention_bwd_batched_variant(s, dh) == 1:
        kernel = f"short_attention_bwd_batched_kernel<{nt}>"
    else:
        kernel = (f"short_attention_bwd_batched_inplace_kernel<{nt}, "
                  f"{8 if (dh + 15) // 16 <= 4 else 16}>")
    return body, {kernel: registers(kernel)}


FLASH_BODIES = {1: "wgmma, TMA producer", 2: "wgmma, element-wise producer",
                0: "mma.sync, two-stage cp.async"}


def flash_body(fa, dh: int, vec: int, which: str = "fwd") -> tuple[str, str]:
    """(body, ptxas line) of the K7 kernel ``which`` (``"fwd"``, ``"dkv"``
    or ``"dq"``) that a call at head dim dh runs."""
    if which == "fwd":
        code = fa._library("flash_attention").flash_attention_fwd_body(dh, vec)
        name = "flash_attention_fwd"
    else:
        code = fa._library("flash_attention_bwd").flash_attention_bwd_body(
            dh, vec, ("dkv", "dq").index(which))
        name = f"flash_attention_bwd_{which}"
    body = FLASH_BODIES[code] + ("" if vec or code else " (element-wise loads)")
    kernel = f"{name}_wgmma_kernel<{dh}>" if code else f"{name}_kernel<{(dh + 15) // 16}>"
    return body, registers(kernel)


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


def device_ms(fn, iters: int = 5, by_kernel: bool = False):
    """Mean device time of the kernels of one call of ``fn`` over ``iters``
    calls (torch.profiler), without the host's launch gaps that a CUDA-event
    time includes; None ("not measured") when the profiler records no
    kernel, which it has done for a whole call. ``by_kernel``: a dict of the
    same by kernel name instead."""
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
    if by_kernel:
        return {e.key[:60]: e.self_device_time_total / 1e3 / iters for e in kernels}
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
    ("flash_attention", "flash_attention"),  # K7: fwd, di, dkv and dq
    ("short_attention_bwd_batched", "short_attention_bwd_batched"),
    ("short_attention_bwd", "short_attention_bwd"),
    ("short_attention", "short_attention_fwd"),
)


def device_breakdown(fn, wall_ms: float, host_ops: bool = True) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler), grouped
    into K1, K2, K3, K7, matrix products and the rest, with the device's idle share
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
    groups = {"short_attention_fwd": 0.0, "short_attention_bwd": 0.0,
              "short_attention_bwd_batched": 0.0, "flash_attention": 0.0, "matmul": 0.0,
              "other": 0.0}
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
        body, regs = short_attention_body(sa, s, dh, sa._vec(dh, h * dh, (q, k, v, out)))
        row = dict(case=name, shape=[b, s, h, dh], causal=causal, max_abs_err=err,
                   atol=K1_ATOL, finite=finite, body=body, registers=regs,
                   blocks_per_sm=sa._library("short_attention").short_attention_occupancy(s, dh))
        if name in ("vision", "text", "l14"):
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
            if row["device_ms"]:
                row["bound_over_device"] = row["bound_ms"] / row["device_ms"]
        log("kernel", **row)
        if not finite or err > K1_ATOL:
            raise AssertionError(f"short_attention_fwd disagrees with its plain version: {row}")
        if name == "vision":
            record = row
    return record


def check_short_attention_bwd(sa, gen) -> dict:
    """K2 against its plain version at the same cases as K1 and at
    K2_MORE_CASES: each gradient within K3_ULPS bf16 ulps of its largest
    magnitude, run twice for bitwise repeatability, with the body each call
    took (B/16 vision and text and L/14 must take the warpgroup body, s=257
    the wmma body), its kernels' registers and blocks per SM. Where the
    warpgroup body runs, its two kernels' p and ds are held bit for bit
    equal (``sa._launch_bwd_probe`` on up to 8 batch rows). Times K2 beside
    its plain version and SDPA's backward at the vision and text shapes, with
    the device time of each of its two launches. Returns the JSON record of
    the vision shape (the main path's largest)."""
    import torch.nn.functional as F

    lib = sa._library("short_attention_bwd")
    record = None
    for name, (b, s, h, dh, causal) in {**ATTENTION_CASES, **K2_MORE_CASES}.items():
        q, k, v, do = (
            torch.randn(b, s, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(4)
        )
        got = sa.short_self_attention_bwd(q, k, v, do, causal)
        again = sa.short_self_attention_bwd(q, k, v, do, causal)
        torch.cuda.synchronize()
        repeatable = all(torch.equal(a, c) for a, c in zip(got, again))
        ref = sa.short_self_attention_bwd_plain(q, k, v, do, causal)
        names = ("dq", "dk", "dv")
        errs = {n: (g.float() - r.float()).abs().max().item() for n, g, r in zip(names, got, ref)}
        tols = {n: K3_ULPS * bf16_ulp(r) for n, r in zip(names, ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        vec = sa._vec(dh, h * dh, (q, k, v, do))
        body, regs = short_attention_bwd_body(sa, s, dh, vec)
        wgmma = body == K2_BODIES[1]
        row = dict(case=name, shape=[b, s, h, dh], causal=causal, max_abs_err=errs, atol=tols,
                   finite=finite, repeatable=repeatable, body=body, registers=regs,
                   blocks_per_sm={"dq": lib.short_attention_bwd_occupancy(s, dh, vec, 0),
                                  "dkdv": lib.short_attention_bwd_occupancy(s, dh, vec, 1)})
        if wgmma:
            row["smem_bytes"] = {w: sa.short_attention_bwd_wgmma_smem_bytes(s, w)
                                 for w in ("dq", "dkdv")}
            bp = min(b, 8)
            probe = sa._launch_bwd_probe(*(t[:bp].contiguous() for t in (q, k, v, do)), causal,
                                         dh ** -0.5)[3]
            torch.cuda.synchronize()
            row["p_ds_bitwise_equal_between_kernels"] = bool(
                torch.equal(probe[0], probe[1]) and torch.equal(probe[2], probe[3]))
            del probe
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
            row["device_ms_by_kernel"] = device_ms(
                lambda: sa.short_self_attention_bwd(q, k, v, do, causal), by_kernel=True)
            row["device_ms"] = (sum(row["device_ms_by_kernel"].values())
                                if row["device_ms_by_kernel"] else None)
            row["library_device_ms"] = device_ms(
                lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
            )
            row["bound_ms"], row["bound_by"] = attention_bound_ms(b, s, h, dh, causal, 7, 5)
            if row["device_ms"]:
                row["bound_over_device"] = row["bound_ms"] / row["device_ms"]
            del out, leaves
        log("kernel_bwd", **row)
        if not (finite and repeatable) or any(errs[n] > tols[n] for n in errs):
            raise AssertionError(f"short_attention_bwd disagrees with its plain version: {row}")
        if wgmma and not row["p_ds_bitwise_equal_between_kernels"]:
            raise AssertionError(f"K2's two kernels disagree on p or ds at {name}: {row}")
        if (name in K2_WGMMA_CASES) != wgmma:
            raise AssertionError(f"K2 took the {body} body at {name}")
        if name == "vision":
            record = row
        if name == "text":
            record["text"] = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "device_ms",
                                                   "library_device_ms", "bound_ms", "bound_by")}
    return record


def bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (float(np.floor(np.log2(x.float().abs().max().item()))) - 7)


def check_short_attention_bwd_batched(sa, gen) -> dict:
    """K3 against its plain version and against K2 at the same cases as K1
    and K2 and at JAX's longest K3 lengths (K3_LONG_CASES); a shape K3 does
    not take must be refused with ValueError. Each case runs twice for
    bitwise repeatability, with the body it took (K3_WGMMA_CASES must take
    the warpgroup body, the others the mma.sync kernels), its kernel's
    registers, blocks per SM and shared memory. Times K3 beside K2 at every
    long case, and beside the plain version and SDPA's backward too at the
    vision and text shapes, K3_IN_PLACE_TIMED and K3_MMA_SYNC_TIMED. Returns
    the JSON record of the vision shape, with the text, K3_IN_PLACE_TIMED and
    mma.sync rows under "text", "long" and "mma_sync"."""
    import torch.nn.functional as F

    lib = sa._library("short_attention_bwd_batched")
    timed = {"vision", "text", K3_IN_PLACE_TIMED, *K3_MMA_SYNC_TIMED.values()}
    rows = {}
    for name, (b, s, h, dh, causal) in {**ATTENTION_CASES, **K3_LONG_CASES}.items():
        if not sa.short_attention_bwd_batched_fits(s, h * dh, h, 2):
            if name in K3_LONG_CASES:
                raise AssertionError(f"K3 refuses {name}, which JAX's K3 takes")
            q = torch.zeros(b, s, h, dh, device="cuda", dtype=torch.bfloat16)
            try:
                sa.short_self_attention_bwd(q, q, q, q, causal, batch_heads=True)
            except ValueError as e:
                log("kernel_bwd_batched", case=name, shape=[b, s, h, dh], refused=str(e))
                continue
            raise AssertionError(f"K3 took {name}, which its fit predicate refuses")
        q, k, v, do = (
            torch.randn(b, s, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(4)
        )

        def k3(k2=False):
            return sa.short_self_attention_bwd(q, k, v, do, causal, batch_heads=not k2)

        got, again = k3(), k3()
        torch.cuda.synchronize()
        repeatable = all(torch.equal(a, c) for a, c in zip(got, again))
        ref = sa.short_self_attention_bwd_batched_plain(q, k, v, do, causal)
        k2 = k3(k2=True)
        names = ("dq", "dk", "dv")
        errs = {n: (g.float() - r.float()).abs().max().item() for n, g, r in zip(names, got, ref)}
        errs_k2 = {n: (g.float() - c.float()).abs().max().item() for n, g, c in zip(names, got, k2)}
        tols = {n: K3_ULPS * bf16_ulp(r) for n, r in zip(names, ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        vec = sa._vec(dh, h * dh, (q, k, v, do))
        body, regs = short_attention_bwd_batched_body(sa, s, dh, vec)
        wgmma = body == K3_BODIES[1]
        row = dict(case=name, shape=[b, s, h, dh], causal=causal, max_abs_err=errs,
                   max_abs_err_vs_k2=errs_k2, atol=tols, finite=finite, repeatable=repeatable,
                   body=body, registers=regs,
                   variant=lib.short_attention_bwd_batched_variant(s, dh),
                   blocks_per_sm=lib.short_attention_bwd_batched_occupancy(s, dh),
                   smem_bytes=sa.short_attention_bwd_batched_wgmma_smem_bytes(s) if wgmma
                   else sa.short_attention_bwd_batched_smem_bytes(s, dh))
        if name in K3_LONG_CASES or name in timed:
            few = name in K3_LONG_CASES
            row["ms"] = time_ms(k3, iters=10 if few else 20)
            row["k2_ms"] = time_ms(lambda: k3(k2=True), iters=10 if few else 20)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(b, s, h, dh, causal, 7, 5)
        if name in timed:
            row["plain_ms"] = time_ms(
                lambda: sa.short_self_attention_bwd_batched_plain(q, k, v, do, causal),
                iters=3 if few else 20)
            leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            dout = do.transpose(1, 2)

            def sdpa_bwd():
                return torch.autograd.grad(out, leaves, dout, retain_graph=True)

            row["library_ms"] = time_ms(sdpa_bwd, iters=10 if few else 20)
            row["device_ms"] = device_ms(k3)
            row["k2_device_ms"] = device_ms(lambda: k3(k2=True))
            row["library_device_ms"] = device_ms(sdpa_bwd)
            if row["device_ms"]:
                row["bound_over_device"] = row["bound_ms"] / row["device_ms"]
            del out, leaves
        log("kernel_bwd_batched", **row)
        if not (finite and repeatable) or any(errs[n] > tols[n] or errs_k2[n] > tols[n]
                                              for n in names):
            raise AssertionError(f"short_attention_bwd_batched disagrees at {name}: {row}")
        if (name in K3_WGMMA_CASES) != wgmma:
            raise AssertionError(f"K3 took the {body} body at {name}")
        rows[name] = row
    b, s, h, dh = K3_REFUSED_CASE
    if sa.short_attention_bwd_batched_fits(s, h * dh, h, 2):
        raise AssertionError(f"K3 takes s={s} at width {h * dh}, which JAX refuses")
    q = torch.zeros(b, s, h, dh, device="cuda", dtype=torch.bfloat16)
    try:
        sa.short_self_attention_bwd(q, q, q, q, False, batch_heads=True)
    except ValueError as e:
        log("kernel_bwd_batched", case="s251_w768", shape=[b, s, h, dh], refused=str(e))
    else:
        raise AssertionError(f"K3 took s={s} at width {h * dh}, which JAX refuses")
    record = rows["vision"]
    record["text"] = {k: rows["text"][k] for k in (
        "ms", "k2_ms", "plain_ms", "library_ms", "device_ms", "k2_device_ms",
        "library_device_ms", "bound_ms", "bound_by", "bound_over_device") if k in rows["text"]}
    record["long"] = rows[K3_IN_PLACE_TIMED]
    record["mma_sync"] = {kernel: rows[case] for kernel, case in K3_MMA_SYNC_TIMED.items()}
    return record


def f32_attention_bound_ms(b, s, h, dh, tensors, products) -> tuple[float, str]:
    """Least time for f32 attention work: ``tensors`` (b, s, h, dh) f32
    tensors read or written once against ``products`` matrix products over
    the s² score pairs at the f32 peak outside the tensor cores."""
    nbytes = tensors * b * s * h * dh * 4
    flops = products * 2 * b * h * s * s * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def split_f32_bounds_ms(nbytes, flops) -> dict:
    """Both bounds of IEEE-f32 work of ``flops`` operations on ``nbytes``
    bytes: on the CUDA cores (f32 FMAs at 67 TFLOP/s) and on the tensor
    cores in split f32 (three TF32 products for each f32 one at 495
    TFLOP/s), each against the bytes; ``bound_ms`` is the lower."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_cc, t_ops = flops / FP32_FLOP_PER_S, 3 * flops / TF32_FLOP_PER_S
    cuda_core = max(t_bytes, t_cc) * 1e3
    by_cc = "bytes" if t_bytes >= t_cc else "operations"
    tensor_core = max(t_bytes, t_ops) * 1e3
    by_tc = "bytes" if t_bytes >= t_ops else "operations"
    return dict(bound_cuda_core_ms=cuda_core, bound_tensor_core_ms=tensor_core,
                bound_ms=min(cuda_core, tensor_core),
                bound_by=(by_tc if tensor_core <= cuda_core else by_cc) +
                (", 3xTF32 on the tensor cores" if tensor_core <= cuda_core
                 else ", f32 on the CUDA cores"))


def f32_bwd_bounds_ms(b, s, h, dh, tensors, products) -> dict:
    """Both bounds of f32 attention backward work (``split_f32_bounds_ms``):
    ``tensors`` (b, s, h, dh) f32 tensors against ``products`` s²·dh
    products."""
    return split_f32_bounds_ms(tensors * b * s * h * dh * 4,
                               products * 2 * b * h * s * s * dh)


def f32_bwd_body(af, dh: int, vec: bool) -> dict:
    """Body, ptxas line and blocks per SM of the f32 backward kernels a call
    at head dim dh runs (both instantiated at round16(dh) / 16)."""
    kc = (dh + 15) // 16
    lib = af._library()
    return dict(body=F32_BWD_BODY + (", 16-byte copies" if vec else ", 4-byte copies"),
                registers={w: registers(f"attention_f32_{w}_kernel<{kc}>") for w in ("dkv", "dq")},
                blocks_per_sm={"dkv": lib.attention_f32_occupancy(dh, 1, 0),
                               "dq": lib.attention_f32_occupancy(dh, 2, 0)},
                smem_bytes={"dkv": af.smem_bytes(dh, 1), "dq": af.smem_bytes(dh, 2)})


def f32_fwd_body(af, s: int, dh: int, vec: bool) -> dict:
    """Body, ptxas line and blocks per SM of the f32 forward a call at (s,
    dh) runs (instantiated at P = ceil(dh / 32) panels and fwd_groups(s)
    warpgroups)."""
    groups = af.fwd_groups(s)
    return dict(body=F32_FWD_BODY + (", 16-byte copies" if vec else ", 4-byte copies"),
                registers=registers(f"attention_f32_fwd_kernel<{(dh + 31) // 32}, {groups}>"),
                blocks_per_sm=af._library().attention_f32_occupancy(dh, 0, s),
                smem_bytes=af.smem_bytes(dh, 0, s), query_rows_a_block=64 * groups)


def card_nan() -> torch.Tensor:
    """The card's NaN, 0x7FFFFFFF (what its arithmetic makes), as a 0-d f32
    tensor: the split products' TF32 rounding once carried it into the sign
    bit and read it as −0."""
    return torch.full((), 0x7FFFFFFF, dtype=torch.int32, device="cuda").view(torch.float32)


def nan_held(tag: str, role: str, names, got, want, **extra) -> None:
    """Logs the NaN count of each output beside its plain version's and
    raises unless the NaNs sit exactly where the plain version's do (and
    some output has one)."""
    row = {name: dict(nan=int(torch.isnan(g).sum()), plain_nan=int(torch.isnan(w).sum()),
                      same=torch.equal(torch.isnan(g), torch.isnan(w)))
           for name, g, w in zip(names, got, want)}
    log(tag, role=role, **extra, **row)
    if not all(r["same"] for r in row.values()) or not any(r["nan"] for r in row.values()):
        raise AssertionError(f"[{tag}] {role} loses a NaN its plain version keeps: {row}")


def check_f32_attention(sa, fa, gen) -> dict:
    """The f32 attention kernels against their plain versions in f32 (TF32
    off): the forward in K1's role and the backward in K2's and K3's at B/16
    vision, both in K7's at b=32, s=1,024, and F32_ATTENTION_MORE; each
    output within F32_RTOL_OF_MAX of its largest magnitude, run twice for
    bitwise repeatability, each case with its body, registers and blocks
    per SM. Times the forward, the dK/dV and the dQ pass, the pair and the
    K2/K3 role at B/16 vision, and K7's role (forward and backward), beside
    the plain versions, SDPA in f32 and the bounds (on the CUDA cores and in
    3xTF32). Returns ``{"fwd", "bwd_dkv", "bwd_dq", "k7_role"}`` records for
    the JSON line."""
    import torch.nn.functional as F

    from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af

    def held(role, shape, kernel, plain, inputs=None):
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        ref = plain()
        errs = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref)]
        cos = [float(F.cosine_similarity(g.flatten(), r.flatten(), dim=0)) for g, r in zip(got, ref)]
        row = dict(role=role, shape=list(shape), max_err_of_max=max(errs), min_cosine=min(cos),
                   repeatable=all(torch.equal(a, c) for a, c in zip(got, again)),
                   finite=all(bool(torch.isfinite(g).all()) for g in got))
        if inputs is not None:  # a backward role: the body its two kernels ran
            row.update(f32_bwd_body(af, shape[-1], af.bwd_vec(shape[-1], *inputs)))
        else:  # a forward role
            row.update(f32_fwd_body(af, shape[1], shape[-1], af.bwd_vec(shape[-1], q, k, v)))
        log("kernel_f32_attention", **row)
        if not (row["finite"] and row["repeatable"]) or max(errs) > F32_RTOL_OF_MAX:
            raise AssertionError(f"f32 attention in {role} disagrees with its plain version: {row}")
        return max(errs)

    b, s, h, dh = F32_ATTENTION_CASES["vision"]
    scale = dh ** -0.5
    q, k, v, do = (torch.randn(b, s, h, dh, device="cuda", generator=gen) for _ in range(4))
    err_fwd = held("K1", (b, s, h, dh), lambda: (sa.short_self_attention(q, k, v),),
                   lambda: (sa.short_self_attention_plain(q, k, v),))
    err_bwd = held("K2", (b, s, h, dh),
                   lambda: sa.short_self_attention_bwd(q, k, v, do, batch_heads=False),
                   lambda: sa.short_self_attention_bwd_plain(q, k, v, do), (q, k, v, do))
    err_bwd = max(err_bwd, held(
        "K3", (b, s, h, dh), lambda: sa.short_self_attention_bwd(q, k, v, do, batch_heads=True),
        lambda: sa.short_self_attention_bwd_batched_plain(q, k, v, do), (q, k, v, do)))
    # One entry of q the card's NaN: each role's outputs NaN where the plain
    # version's are.
    qn = q.clone()
    qn[0, 5, 0, 3] = card_nan()
    for role, names, kernel, plain in (
            ("K1", ("out",), lambda: (sa.short_self_attention(qn, k, v),),
             lambda: (sa.short_self_attention_plain(qn, k, v),)),
            ("K2", ("dq", "dk", "dv"),
             lambda: sa.short_self_attention_bwd(qn, k, v, do, batch_heads=False),
             lambda: sa.short_self_attention_bwd_plain(qn, k, v, do)),
            ("K3", ("dq", "dk", "dv"),
             lambda: sa.short_self_attention_bwd(qn, k, v, do, batch_heads=True),
             lambda: sa.short_self_attention_bwd_batched_plain(qn, k, v, do))):
        nan_held("kernel_f32_attention_nan", role, names, kernel(), plain(),
                 shape=[b, s, h, dh], nan_at=[0, 5, 0, 3])
    del qn

    # Each pass alone at B/16 vision, timed; dK/dV and dQ from one forward.
    out, stats = af.launch_fwd(q, k, v, False, scale, with_stats=True)
    _, _, di = af.launch_bwd_dkv(q, k, v, out, do, stats, False, scale)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    dout = do.transpose(1, 2)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True),
                          iters=5)
    passes = {
        "fwd": (lambda: af.launch_fwd(q, k, v, False, scale, with_stats=False),
                lambda: sa.short_self_attention_plain(q, k, v),
                lambda: F.scaled_dot_product_attention(*leaves), 4, 2, err_fwd),
        "bwd_dkv": (lambda: af.launch_bwd_dkv(q, k, v, out, do, stats, False, scale),
                    lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, out, do, stats, False,
                                                             scale, fa.BLOCK_K),
                    None, 7, 4, err_bwd),
        "bwd_dq": (lambda: af.launch_bwd_dq(q, k, v, do, stats, di, False, scale),
                   lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, stats, di, False, scale,
                                                           fa.BLOCK_K),
                   None, 5, 3, err_bwd),
    }
    records = {}
    for which, (kernel, plain, library, tensors, products, err) in passes.items():
        rec = dict(case="vision f32", shape=[b, s, h, dh], max_abs_err=err,
                   ms=time_ms(kernel, iters=10), device_ms=device_ms(kernel),
                   plain_ms=time_ms(plain, iters=3),
                   library_ms=time_ms(library, iters=10) if library else sdpa_bwd_ms,
                   library_call="SDPA in f32 (TF32 off)" + ("" if library else
                                                            ", its whole backward (dq, dk, dv)"))
        rec.update(f32_bwd_bounds_ms(b, s, h, dh, tensors, products))
        if which == "fwd":
            rec.update(f32_fwd_body(af, s, dh, af.bwd_vec(dh, q, k, v)))
        else:
            rec["pair_bound_ms"] = f32_bwd_bounds_ms(b, s, h, dh, 7, 5)["bound_ms"]
            rec.update(f32_bwd_body(af, dh, af.bwd_vec(dh, q, k, v, do)))
            if which == "bwd_dkv":  # the di pass and the dK/dV kernel apart
                rec["device_ms_by_kernel"] = device_ms(kernel, by_kernel=True)
        rec["bound_over_device"] = (rec["bound_ms"] / rec["device_ms"] if rec["device_ms"]
                                    else None)  # None: not measured
        log("kernel_f32_attention_time", kernel=which, **rec)
        records[which] = rec
    # The pair alone (dK/dV with its di pass, then dQ) against SDPA's
    # backward, which computes the same three gradients; its bounds count
    # the function's 5 products.
    pair = lambda: (passes["bwd_dkv"][0](), passes["bwd_dq"][0]())  # noqa: E731
    pair_rec = dict(pair_ms=time_ms(pair, iters=10), pair_device_ms=device_ms(pair),
                    library_ms=sdpa_bwd_ms, library_device_ms=device_ms(
                        lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)),
                    **f32_bwd_bounds_ms(b, s, h, dh, 7, 5))
    pair_rec["bound_over_device"] = (pair_rec["bound_ms"] / pair_rec["pair_device_ms"]
                                     if pair_rec["pair_device_ms"] else None)
    log("kernel_f32_attention_time", kernel="pair (dkv + dq)", **pair_rec)
    # The K2/K3 role as the towers call it: the forward again (with its
    # statistics), then dK/dV and dQ; its bound counts the 9 products those
    # three launches run (2 + 4 + 3) beside the 5 of the function alone.
    role = lambda: sa.short_self_attention_bwd(q, k, v, do, batch_heads=False)  # noqa: E731
    role_rec = dict(role_ms=time_ms(role, iters=10), role_device_ms=device_ms(role),
                    role_bound_ms=f32_attention_bound_ms(b, s, h, dh, 7, 9)[0],
                    pair_bound_ms=f32_attention_bound_ms(b, s, h, dh, 7, 5)[0],
                    library_ms=sdpa_bwd_ms)
    log("kernel_f32_attention_time", kernel="K2/K3 role (fwd + dkv + dq)", **role_rec)
    for which in ("bwd_dkv", "bwd_dq"):
        records[which].update(role_ms=role_rec["role_ms"], role_bound_ms=role_rec["role_bound_ms"],
                              pair_ms=pair_rec["pair_ms"], pair_device_ms=pair_rec["pair_device_ms"])
    del out, stats, di, leaves, sdpa_out

    # K7's role at the B/16-512 shape: the forward with its statistics, then
    # the backward from the kernel's own output and statistics.
    b, s, h, dh = F32_ATTENTION_CASES["b16_512"]
    scale = dh ** -0.5
    q, k, v, do = (torch.randn(b, s, h, dh, device="cuda", generator=gen) for _ in range(4))
    err7 = held("K7 fwd", (b, s, h, dh), lambda: fa._forward(q, k, v, False, scale),
                lambda: fa.flash_self_attention_plain(q, k, v, False, scale, fa.BLOCK_K))
    out, stats = fa._forward(q, k, v, False, scale)
    err7 = max(err7, held(
        "K7 bwd", (b, s, h, dh), lambda: fa.flash_self_attention_bwd(q, k, v, out, do, stats),
        lambda: fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, False, scale,
                                                  fa.BLOCK_K), (q, k, v, do)))
    k7_bwd = lambda: fa.flash_self_attention_bwd(q, k, v, out, do, stats)  # noqa: E731
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    dout = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)  # noqa: E731
    k7_fwd = lambda: fa._forward(q, k, v, False, scale)  # noqa: E731
    sdpa_fwd = lambda: F.scaled_dot_product_attention(*leaves)  # noqa: E731
    k7_rec = dict(fwd_ms=time_ms(k7_fwd, iters=5), fwd_device_ms=device_ms(k7_fwd),
                  library_fwd_ms=time_ms(sdpa_fwd, iters=5),
                  library_fwd_device_ms=device_ms(sdpa_fwd),
                  bwd_ms=time_ms(k7_bwd, iters=5), bwd_device_ms=device_ms(k7_bwd),
                  library_bwd_ms=time_ms(sdpa_bwd, iters=5),
                  library_bwd_device_ms=device_ms(sdpa_bwd),
                  library_call="SDPA forward and backward in f32 (TF32 off)",
                  **{f"fwd_{k}": x for k, x in f32_bwd_bounds_ms(b, s, h, dh, 4, 2).items()},
                  **{f"bwd_{k}": x for k, x in f32_bwd_bounds_ms(b, s, h, dh, 7, 5).items()},
                  **{f"fwd_{k}": x for k, x in f32_fwd_body(af, s, dh, af.bwd_vec(dh, q, k, v))
                     .items()})
    for which in ("fwd", "bwd"):
        if k7_rec[f"{which}_device_ms"]:
            k7_rec[f"{which}_bound_over_device"] = (k7_rec[f"{which}_bound_ms"] /
                                                    k7_rec[f"{which}_device_ms"])
    log("kernel_f32_attention_time", role="K7", shape=[b, s, h, dh], **k7_rec)
    records["k7_role"] = k7_rec
    del leaves, sdpa_out, dout
    records["k7_role_max_err_of_max"] = err7
    del q, k, v, do, out, stats
    for name, (b, s, h, dh, causal) in F32_ATTENTION_MORE.items():
        q, k, v, do = (torch.randn(b, s, h, dh, device="cuda", generator=gen) for _ in range(4))
        if name.startswith("k7"):
            scale = dh ** -0.5
            held(f"K7 fwd {name}", (b, s, h, dh), lambda: fa._forward(q, k, v, causal, scale),
                 lambda: fa.flash_self_attention_plain(q, k, v, causal, scale, fa.BLOCK_K))
            out, stats = fa._forward(q, k, v, causal, scale)
            held(f"K7 bwd {name}", (b, s, h, dh),
                 lambda: fa.flash_self_attention_bwd(q, k, v, out, do, stats, causal),
                 lambda: fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, causal,
                                                           scale, fa.BLOCK_K), (q, k, v, do))
            continue
        held(f"K1 {name}", (b, s, h, dh), lambda: (sa.short_self_attention(q, k, v, causal),),
             lambda: (sa.short_self_attention_plain(q, k, v, causal),))
        held(f"K2 {name}", (b, s, h, dh),
             lambda: sa.short_self_attention_bwd(q, k, v, do, causal, batch_heads=False),
             lambda: sa.short_self_attention_bwd_plain(q, k, v, do, causal), (q, k, v, do))
    torch.cuda.empty_cache()
    return records


def run_f32_tower_path(args, sa, ssl, fa) -> dict:
    """SigLIP-B/16 in f32 with ``attn_impl="flash"``: one forward and
    backward at 224 px with K2 as the backward, one with K3, and one at 512
    px (K7's role in the vision tower), all between two reads of the counts:
    every launch is an f32 kernel in the role JAX's dispatch gives it. Then
    each gradient against the model with the plain versions."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_per_shard_loss

    per_shard = make_per_shard_loss(variant="ring")
    runs = []
    for config, batch_heads in (("b16", False), ("b16", True), ("b16_512", False)):
        cfg = siglip_config(config)
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, dtype="float32", attn_impl="flash",
                                            remat=False),
            text=dataclasses.replace(cfg.text, dtype="float32", attn_impl="flash", remat=False))
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 5)
        runs.append((config, batch_heads, cfg, SigLIP(cfg, device="cuda", generator=gen),
                     random_batch(cfg, F32_TOWER_BATCH[config], gen)))
    torch.cuda.synchronize()

    # -- the f32 path, between the two reads of the counts ------------------
    reset_counts(sa, ssl)
    grads = []
    for config, batch_heads, cfg, model, batch in runs:
        sa.set_bwd_batch_heads(batch_heads)
        grads.append(tower_grads(model, per_shard, batch))
    sa.set_bwd_batch_heads(False)
    torch.cuda.synchronize()
    counts = read_counts(sa, ssl)
    # -- end of the f32 path ------------------------------------------------
    expect = dict.fromkeys(counts, 0)
    for config, batch_heads, cfg, _, _ in runs:
        vision = K7 if config == "b16_512" else (
            "short_attention_fwd", "short_attention_bwd_batched" if batch_heads else
            "short_attention_bwd")
        for kernel in vision:
            expect[kernel] += cfg.vision.depth
        expect["short_attention_fwd"] += cfg.text.depth
        expect["short_attention_bwd_batched" if batch_heads else "short_attention_bwd"] += \
            cfg.text.depth
    # Each f32 kernel at its own launch: the forward in the K1 and K7 roles
    # and again inside each K2/K3-role backward (for the output and the
    # statistics it did not save), dK/dV and dQ in every backward role.
    short_bwd = expect["short_attention_bwd"] + expect["short_attention_bwd_batched"]
    expect["attention_f32_fwd"] = \
        expect["short_attention_fwd"] + expect["flash_attention_fwd"] + short_bwd
    expect["attention_f32_bwd_dkv"] = short_bwd + expect["flash_attention_bwd_dkv"]
    expect["attention_f32_bwd_dq"] = short_bwd + expect["flash_attention_bwd_dq"]
    cos = {}
    for (config, batch_heads, _, model, batch), kernel_grads in zip(runs, grads):
        sa.set_bwd_batch_heads(batch_heads)
        with plain_attention(sa, fa):
            plain_grads = tower_grads(model, per_shard, batch)
        sa.set_bwd_batch_heads(False)
        key = f"{config}{'_k3' if batch_heads else ''}"
        cos[key] = {t: float(torch.nn.functional.cosine_similarity(
            kernel_grads[t], plain_grads[t], dim=0)) for t in kernel_grads}
    log("f32_tower", config="SigLIP-B/16 in f32, attn_impl='flash'", batches=F32_TOWER_BATCH,
        launches=counts, expected=expect, grad_cosine_kernel_vs_plain=cos)
    if counts != expect:
        raise AssertionError(f"f32_tower launches {counts} != {expect}")
    if min(c for row in cos.values() for c in row.values()) <= 0.999:
        raise AssertionError(f"f32 towers: kernel vs plain gradient, cosine {cos}")
    del runs, grads
    torch.cuda.empty_cache()
    return counts


def loss_case_inputs(b, n, d, off, dtype, gen):
    """Unit rows; the text row of each positive pair is its image row plus
    noise, so positives score high as trained embeddings do. t′ and bias at
    their inits (log 10, -10)."""
    import torch.nn.functional as F

    zimg = F.normalize(torch.randn(b, d, device="cuda", generator=gen), dim=-1)
    ztxt = F.normalize(torch.randn(n, d, device="cuda", generator=gen), dim=-1)
    rows = torch.arange(b, device="cuda")
    keep = (rows + off >= 0) & (rows + off < n)
    cols = rows[keep] + off
    ztxt[cols] = F.normalize(zimg[rows[keep]] + 0.5 * ztxt[cols], dim=-1)
    tp = torch.tensor(float(np.log(10.0)), device="cuda")
    bias = torch.tensor(-10.0, device="cuda")
    return zimg.to(dtype), ztxt.to(dtype), tp, bias


def loss_bounds_ms(b, n, d, which) -> dict:
    """Both bounds of K4, K5 or K6 (``which`` "fwd", "bwd_img", "bwd_txt";
    ``split_f32_bounds_ms``): the f32 inputs read once and the outputs
    written once (K5 also writes dzimg, K6 dztxt) against the operations the
    function needs: K4's product, 2·b·n·d; K5's and K6's 4·b·n·d (the logits
    again and the gradient product)."""
    own = {"fwd": 0, "bwd_img": b, "bwd_txt": n}[which]
    flops = (2 if which == "fwd" else 4) * b * n * d
    return split_f32_bounds_ms(4 * (b + n) * d + 4 * own * d, flops)


def check_loss_kernels_nan(ssl) -> None:
    """K4, K5 and K6 hand on a NaN as their plain versions do: one entry of
    zimg the card's NaN (``card_nan``) at the ring hop's shape; the loss and
    every gradient NaN exactly where the plain version's are."""
    b, n, d, off, dtype = LOSS_CASES[LOSS_TIMED]
    zimg, ztxt, tp, bias = loss_case_inputs(b, n, d, off, dtype,
                                            torch.Generator(device="cuda").manual_seed(77))
    zimg[1, 3] = card_nan()
    leaves = [t.detach().requires_grad_() for t in (zimg, ztxt, tp, bias)]
    loss = ssl.streaming_block_loss_sum(*leaves, off)
    got = (loss.detach(), *torch.autograd.grad(loss, leaves))
    one = torch.ones((), device="cuda")
    dzi, dtp, dbias = ssl.streaming_loss_bwd_img_plain(zimg, ztxt, tp, bias, off, one)
    want = (ssl.streaming_loss_fwd_plain(zimg, ztxt, tp, bias, off),
            dzi, ssl.streaming_loss_bwd_txt_plain(zimg, ztxt, tp, bias, off, one), dtp, dbias)
    nan_held("loss_kernel_nan", "K4-K6", ("loss", "dzimg", "dztxt", "dt_prime", "dbias"),
             got, want, shape=[b, n, d], nan_at=[1, 3])


def check_loss_kernels(ssl, gen) -> dict:
    """K4, K5 and K6 against their plain versions (TF32 off) in every case of
    LOSS_CASES, through the autograd node a caller uses: the loss and all
    four gradients, twice for bitwise repeatability. Times the three kernels
    at LOSS_TIMED (and LOSS_TIMED_MORE). Returns ``{kernel: record}`` of
    LOSS_TIMED for the JSON line."""
    lib = ssl._library()
    records = {}
    for name, (b, n, d, off, dtype) in LOSS_CASES.items():
        zimg, ztxt, tp, bias = loss_case_inputs(b, n, d, off, dtype, gen)

        def run():
            leaves = [t.detach().requires_grad_() for t in (zimg, ztxt, tp, bias)]
            loss = ssl.streaming_block_loss_sum(*leaves, off)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        (loss, grads), (loss2, grads2) = run(), run()
        torch.cuda.synchronize()
        repeatable = torch.equal(loss, loss2) and all(
            torch.equal(a, c) for a, c in zip(grads, grads2))
        one = torch.ones((), device="cuda")
        ref_loss = ssl.streaming_loss_fwd_plain(zimg, ztxt, tp, bias, off)
        dzi, dtp, dbias = ssl.streaming_loss_bwd_img_plain(zimg, ztxt, tp, bias, off, one)
        dzt = ssl.streaming_loss_bwd_txt_plain(zimg, ztxt, tp, bias, off, one)
        refs = (dzi.to(dtype), dzt.to(dtype), dtp, dbias)
        grad_rtol = BF16_GRAD_RTOL_OF_MAX if dtype == torch.bfloat16 else LOSS_GRAD_RTOL_OF_MAX
        errs = {"loss": abs(loss.item() - ref_loss.item())}
        tols = {"loss": LOSS_RTOL * abs(ref_loss.item())}
        for gname, got, ref in zip(("dzimg", "dztxt", "dt_prime", "dbias"), grads, refs):
            errs[gname] = (got.float() - ref.float()).abs().max().item()
            tols[gname] = grad_rtol * ref.float().abs().max().item()
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
        row = dict(case=name, shape=[b, n, d], pos_offset=off, dtype=str(dtype).split(".")[1],
                   loss=loss.item(), max_abs_err=errs, atol=tols, finite=finite,
                   repeatable=repeatable, smem_bwd=lib.sigmoid_loss_bwd_smem_bytes(d),
                   fwd_steps_a_tile=dict(zip(("f32", "int8"), ssl.fwd_layout(d))),
                   bwd_layout=dict(zip(("slices", "slice", "cluster", "steps_a_tile"),
                                       ssl.bwd_layout(d))),
                   bwd_splits={"img": lib.sigmoid_loss_bwd_splits(b, n, d),
                               "txt": lib.sigmoid_loss_bwd_splits(n, b, d)},
                   bwd_scratch_bytes={"img": 4 * lib.sigmoid_loss_bwd_scratch_floats(b, n, d, 1),
                                      "txt": 4 * lib.sigmoid_loss_bwd_scratch_floats(n, b, d, 0)},
                   blocks_per_sm={"fwd": lib.sigmoid_loss_occupancy(d, 0),
                                  "bwd": lib.sigmoid_loss_occupancy(d, 1)})
        log("loss_kernel", **row)
        if not (finite and repeatable) or any(errs[k] > tols[k] for k in errs):
            raise AssertionError(f"loss kernels disagree with their plain versions: {row}")
        del loss2, grads2
        if name != LOSS_TIMED and name not in LOSS_TIMED_MORE:
            continue
        g = one
        p = torch.randn(b, n, device="cuda", generator=gen)
        calls = {
            "fwd": (lambda: ssl._launch_fwd(zimg, ztxt, tp, bias, off),
                    lambda: ssl.streaming_loss_fwd_plain(zimg, ztxt, tp, bias, off),
                    lambda: zimg @ ztxt.T),
            "bwd_img": (lambda: ssl._launch_bwd_img(zimg, ztxt, tp, bias, off, g),
                        lambda: ssl.streaming_loss_bwd_img_plain(zimg, ztxt, tp, bias, off, g),
                        lambda: (zimg @ ztxt.T, p @ ztxt)),
            "bwd_txt": (lambda: ssl._launch_bwd_txt(zimg, ztxt, tp, bias, off, g),
                        lambda: ssl.streaming_loss_bwd_txt_plain(zimg, ztxt, tp, bias, off, g),
                        lambda: (zimg @ ztxt.T, p.T @ zimg)),
        }
        err_of = {"fwd": errs["loss"], "bwd_img": max(errs["dzimg"], errs["dt_prime"], errs["dbias"]),
                  "bwd_txt": errs["dztxt"]}
        for which, (kernel, plain, library) in calls.items():
            rec = dict(case=name, shape=[b, n, d], max_abs_err=err_of[which],
                       ms=time_ms(kernel, iters=10), device_ms=device_ms(kernel),
                       plain_ms=time_ms(plain, iters=5),
                       library_ms=time_ms(library, iters=10), library_device_ms=device_ms(library),
                       library_call="product only: cuBLAS IEEE-f32 torch.matmul of the same "
                                    + ("product" if which == "fwd" else "two products"))
            rec.update(loss_bounds_ms(b, n, d, which))
            if which == "fwd":
                rec["body"] = LOSS_FWD_BODY
                rec["registers"] = registers(f"sigmoid_loss_fwd_kernel<0, {ssl._vec(zimg, ztxt)}>")
            else:
                rec["body"] = LOSS_BWD_BODY
                rec["registers"] = registers(
                    f"sigmoid_loss_bwd_kernel<{int(which == 'bwd_txt')}, 0>")
            rec["bound_over_device"] = (rec["bound_ms"] / rec["device_ms"]
                                        if rec["device_ms"] else None)
            log("loss_kernel_time", kernel=which, **rec)
            if name == LOSS_TIMED:
                records[which] = rec
        del p
    return records


def loss_int8_bound_ms(b, n, d, which) -> tuple[float, str]:
    """Least time of one int8-mode loss kernel call: the largest of its
    inputs read once (int8 rows and f32 scales; K5/K6 also the other side's
    f32 rows) and outputs written once over the memory rate, its int8
    products (2·b·n·d) at the int8 peak, and its work on the CUDA cores:
    K4's epilogue, K4_EPILOGUE_INSTRUCTIONS a logit, each issued for 32
    lanes at the f32 peak's instruction rate (67 TFLOP/s counts an FMA as
    two operations, so half of it); K5/K6's epilogue (about ten f32
    operations a logit) and their f32 gradient product, 2·b·n·d, at the f32
    peak."""
    int8_bytes = (b + n) * d + 4 * (b + n)
    f32_rows = {"fwd": 0, "bwd_img": 4 * n * d + 4 * b * d, "bwd_txt": 4 * b * d + 4 * n * d}
    t_bytes = (int8_bytes + f32_rows[which]) / HBM_BYTES_PER_S
    t_int8 = 2 * b * n * d / INT8_OP_PER_S
    if which == "fwd":
        t_f32 = K4_EPILOGUE_INSTRUCTIONS * b * n / (FP32_FLOP_PER_S / 2)
    else:
        t_f32 = (10 * b * n + 2 * b * n * d) / FP32_FLOP_PER_S
    return max(t_bytes, t_int8, t_f32) * 1e3, ("bytes" if t_bytes >= max(t_int8, t_f32)
                                               else "operations")


@contextlib.contextmanager
def plain_loss_kernels(ssl):
    """Every loss kernel's launch (K4-K6 in both modes) replaced by its plain
    version inside the block."""
    def plain_bwd_int8(zimg, ztxt, t_prime, bias, off, g):
        dzimg, dtp, dbias = ssl.streaming_loss_bwd_img_plain(zimg, ztxt, t_prime, bias, off, g,
                                                             "int8")
        return dzimg, dtp, dbias, ssl.streaming_loss_bwd_txt_plain(zimg, ztxt, t_prime, bias,
                                                                   off, g, "int8")

    real = (ssl._launch_fwd, ssl._launch_bwd_img, ssl._launch_bwd_txt, ssl._launch_fwd_int8,
            ssl._launch_bwd_int8)
    ssl._launch_fwd = ssl.streaming_loss_fwd_plain
    ssl._launch_bwd_img = ssl.streaming_loss_bwd_img_plain
    ssl._launch_bwd_txt = ssl.streaming_loss_bwd_txt_plain
    ssl._launch_fwd_int8 = lambda *a: ssl.streaming_loss_fwd_plain(*a, "int8")
    ssl._launch_bwd_int8 = plain_bwd_int8
    try:
        yield
    finally:
        (ssl._launch_fwd, ssl._launch_bwd_img, ssl._launch_bwd_txt, ssl._launch_fwd_int8,
         ssl._launch_bwd_int8) = real


def check_loss_kernels_int8(ssl, gen) -> dict:
    """K4, K5 and K6 in the int8 mode against their plain int8 versions (the
    exact int32 product by ``torch._int_mm``, TF32 off; the embedding
    gradients against f64 products of the plain versions' dlogits) in every
    case of LOSS_INT8_CASES, through the autograd node the dispatch calls,
    twice for bitwise repeatability; a non-tileable block must be refused to
    the caller's plain path ("xla") with no launch. Times the three kernels
    at LOSS_INT8_TIMED (and LOSS_INT8_TIMED_MORE) beside the plain versions
    and ``torch._int_mm`` of the two int8 operands (product only). Returns
    ``{kernel: record}`` of LOSS_INT8_TIMED."""
    records = {}
    for name, (b, n, d, off) in LOSS_INT8_CASES.items():
        zimg, ztxt, tp, bias = loss_case_inputs(b, n, d, off, torch.float32, gen)

        def run():
            leaves = [t.detach().requires_grad_() for t in (zimg, ztxt, tp, bias)]
            loss = ssl.streaming_block_loss_sum(*leaves, off, quant="int8")
            return (loss.detach(), *torch.autograd.grad(loss, leaves))

        got, again = run(), run()
        torch.cuda.synchronize()
        repeatable = all(torch.equal(a, c) for a, c in zip(got, again))
        one = torch.ones((), device="cuda")
        ref_loss = ssl.streaming_loss_fwd_plain(zimg, ztxt, tp, bias, off, "int8")
        dzi, dtp, dbias = ssl.streaming_loss_bwd_img_plain(zimg, ztxt, tp, bias, off, one, "int8")
        dzt = ssl.streaming_loss_bwd_txt_plain(zimg, ztxt, tp, bias, off, one, "int8")
        errs, tols = {}, {}
        for gname, g, r in zip(("loss", "dzimg", "dztxt", "dt_prime", "dbias"), got,
                               (ref_loss, dzi, dzt, dtp, dbias)):
            errs[gname] = (g.float() - r.float()).abs().max().item()
            tols[gname] = LOSS_INT8_RTOL * r.float().abs().max().item()
        # dt′ = t·Σ dl·raw cancels to a small part of its b·n terms: its
        # rounding is bounded by t·Σ|dl·raw|, the scale it is held at.
        dl, raw, t = ssl._dlogits(zimg, ztxt, tp, bias, off, one, "int8")
        tols["dt_prime"] = LOSS_INT8_RTOL * float((dl * raw).abs().sum() * t)
        # dzimg and dztxt are held to f64 products of the plain version's own
        # dl (the function's exact gradient at the plain version's dlogits):
        # over the 32,768 text rows of the fused block the plain version's
        # IEEE-f32 sums are themselves ~8e-6 of the largest magnitude off it,
        # most of the contract. Both the kernel's error against the plain
        # version and the plain version's own are recorded beside it.
        vs_plain = {}
        for gname, got_, plain_, exact in (
                ("dzimg", got[1], dzi, lambda: (dl.double() @ ztxt.double()) * t.double()),
                ("dztxt", got[2], dzt, lambda: (dl.double().T @ zimg.double()) * t.double())):
            exact = exact()
            scale = exact.abs().max().item()
            errs[gname] = (got_.double() - exact).abs().max().item()
            tols[gname] = LOSS_INT8_RTOL * scale
            vs_plain[gname] = {
                "kernel_vs_plain": (got_.double() - plain_.double()).abs().max().item() / scale,
                "plain_vs_f64": (plain_.double() - exact).abs().max().item() / scale}
            del exact
        del dl, raw
        f32_loss = ssl.streaming_loss_fwd_plain(zimg, ztxt, tp, bias, off).item()
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        row = dict(case=name, shape=[b, n, d], pos_offset=off, loss=got[0].item(),
                   loss_f32=f32_loss, max_abs_err=errs, atol=tols, finite=finite,
                   repeatable=repeatable, err_of_max_f32_sums=vs_plain)
        log("loss_kernel_int8", **row)
        if not (finite and repeatable) or any(errs[k] > tols[k] for k in errs):
            raise AssertionError(f"int8 loss kernels disagree with their plain versions: {row}")
        if name != LOSS_INT8_TIMED and name not in LOSS_INT8_TIMED_MORE:
            continue
        quantized = ssl._int8_operands("time", zimg, ztxt)
        ziq, ztq_t = quantized[0], quantized[2].t()
        g = one
        calls = {
            "fwd": (lambda: ssl._launch_fwd_int8(zimg, ztxt, tp, bias, off),
                    lambda: ssl.streaming_loss_fwd_plain(zimg, ztxt, tp, bias, off, "int8"),
                    errs["loss"]),
            "bwd_img": (lambda: ssl._launch_bwd_img_int8(zimg, ztxt, tp, bias, off, g, quantized),
                        lambda: ssl.streaming_loss_bwd_img_plain(zimg, ztxt, tp, bias, off, g,
                                                                 "int8"),
                        max(errs["dzimg"], errs["dt_prime"], errs["dbias"])),
            "bwd_txt": (lambda: ssl._launch_bwd_txt_int8(zimg, ztxt, tp, bias, off, g, quantized),
                        lambda: ssl.streaming_loss_bwd_txt_plain(zimg, ztxt, tp, bias, off, g,
                                                                 "int8"),
                        errs["dztxt"]),
        }
        # The library's work of each: the int8 logit product, and for K5/K6
        # also their f32 gradient product (p·ztxt, pᵀ·zimg).
        p = torch.randn(b, n, device="cuda", generator=gen)
        library = {"fwd": lambda: torch._int_mm(ziq, ztq_t),
                   "bwd_img": lambda: (torch._int_mm(ziq, ztq_t), p @ ztxt),
                   "bwd_txt": lambda: (torch._int_mm(ziq, ztq_t), p.T @ zimg)}
        for which, (kernel, plain, err) in calls.items():
            rec = dict(case=name, shape=[b, n, d], max_abs_err=err,
                       ms=time_ms(kernel, iters=10), device_ms=device_ms(kernel),
                       plain_ms=time_ms(plain, iters=5),
                       library_ms=time_ms(library[which], iters=10),
                       library_device_ms=device_ms(library[which]),
                       library_call="product only: torch._int_mm of the two int8 operands" +
                                    ("" if which == "fwd" else
                                     ", and cuBLAS's IEEE-f32 gradient product"))
            rec["bound_ms"], rec["bound_by"] = loss_int8_bound_ms(b, n, d, which)
            if which == "fwd":
                # The device time split into the kernel's own (K4 and its sum
                # of partials) and the quantize passes in front of it.
                by_kernel = device_ms(kernel, by_kernel=True) or {}
                own = sum(v for k, v in by_kernel.items() if "sigmoid_loss" in k)
                rec.update(kernel_device_ms=own if by_kernel else None,
                           quantize_device_ms=(sum(by_kernel.values()) - own
                                               if by_kernel else None),
                           bound_over_device=rec["bound_ms"] / own if own else None,
                           body=LOSS_FWD_INT8_BODY,
                           registers=registers("sigmoid_loss_fwd_kernel<1, 1>"),
                           blocks_per_sm=ssl._library().sigmoid_loss_occupancy(d, 2))
            log("loss_kernel_int8_time", kernel=f"{which}_int8", **rec)
            if name == LOSS_INT8_TIMED:
                records[which] = rec
        del quantized, ziq, ztq_t, p

    # A block JAX's dispatch refuses (b = 100 is no multiple of 32): None,
    # "xla" recorded, nothing launched.
    zimg, ztxt, tp, bias = loss_case_inputs(100, 128, 512, 0, torch.float32, gen)
    ssl.reset_traced_loss_kernels()
    ssl.reset_launches()
    out = ssl.streaming_block_loss_or_none(zimg, ztxt, tp, bias, 0, quant="int8")
    launched = ssl.launches()
    log("loss_kernel_int8", case="untileable_b100", shape=[100, 128, 512], returned=repr(out),
        traced=ssl.traced_loss_kernels(), launches=launched)
    if out is not None or ssl.traced_loss_kernels() != ("xla",) or any(launched.values()):
        raise AssertionError("the int8 dispatch took a block JAX's refuses")
    ssl.reset_traced_loss_kernels()
    torch.cuda.empty_cache()
    return records


def reset_counts(sa, ssl) -> None:
    from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
    from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa

    sa.reset_launches()
    ssl.reset_launches()
    fa.reset_launches()
    af.reset_launches()


def read_counts(sa, ssl) -> dict:
    """Launches of every kernel since :func:`reset_counts`. The attention
    roles (K1, K2, K3, K7) count the f32 kernels' calls in those roles too;
    ``attention_f32_*`` count each f32 kernel at its own launch."""
    from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
    from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa

    loss, flash, f32 = ssl.launches(), fa.launches(), af.launches()
    return {"short_attention_fwd": sa.launches(), "short_attention_bwd": sa.bwd_launches(),
            "short_attention_bwd_batched": sa.bwd_batched_launches(),
            "short_attention_bwd_batched_in_place": sa.bwd_batched_in_place_launches(),
            "short_attention_bwd_batched_wgmma": sa.bwd_batched_wgmma_launches(),
            "sigmoid_loss_fwd": loss["fwd"], "sigmoid_loss_bwd_img": loss["bwd_img"],
            "sigmoid_loss_bwd_txt": loss["bwd_txt"],
            "sigmoid_loss_fwd_int8": loss["fwd_int8"],
            "sigmoid_loss_bwd_img_int8": loss["bwd_img_int8"],
            "sigmoid_loss_bwd_txt_int8": loss["bwd_txt_int8"], "flash_attention_fwd": flash["fwd"],
            "flash_attention_bwd_dkv": flash["bwd_dkv"], "flash_attention_bwd_dq": flash["bwd_dq"],
            "attention_f32_fwd": f32["fwd"], "attention_f32_bwd_dkv": f32["bwd_dkv"],
            "attention_f32_bwd_dq": f32["bwd_dq"]}


def run_serve_path(args, sa, ssl, fa, run: Serving) -> dict:
    """One serving run through the service: the engine warmed, a random
    corpus encoded and indexed, and mixed requests (texts, some repeated
    captions that hit the cache, images, searches) from ``run.clients``
    threads, between two reads of the counts (12 launches of the vision
    tower's attention kernel per image tower call, 12 of K1 per text call,
    nothing else). Then the towers with every attention kernel against its
    plain version, and their times and device breakdowns at the largest
    bucket."""
    from distributed_sigmoid_loss_tpu_torch.eval.retrieval import topk_ids
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.serve import (
        EmbeddingCache,
        EmbeddingService,
        InferenceEngine,
    )

    cfg = siglip_config(run.config)
    seed = args.seed + run.seed_offset
    t0 = time.monotonic()
    model = SigLIP(cfg, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(seed)).eval()
    engine = InferenceEngine.from_model(model, batch_buckets=run.buckets)
    torch.cuda.synchronize()
    hw, ctx, vocab = cfg.vision.image_size, cfg.text.context_length, cfg.text.vocab_size
    log(run.phase, config=run.config, image_size=hw, patches=(hw // cfg.vision.patch_size) ** 2,
        dtype=cfg.vision.dtype, depth=cfg.vision.depth, width=cfg.vision.width,
        params=sum(p.numel() for p in model.parameters()), buckets=run.buckets,
        init_s=time.monotonic() - t0)
    rng = np.random.default_rng(seed)

    # -- the serving path, between the two reads of the launch counts -------
    reset_counts(sa, ssl)
    engine.calls.clear()
    t0 = time.monotonic()
    warmed = engine.warmup()
    t_warm = time.monotonic() - t0
    svc = EmbeddingService(engine, cache=EmbeddingCache(4096), max_wait_ms=5.0,
                           default_timeout=120.0)
    corpus = rng.random((run.corpus, hw, hw, 3), dtype=np.float32)
    t0 = time.monotonic()
    corpus_emb = svc.encode_image(corpus)
    t_corpus = time.monotonic() - t0
    svc.index.add(corpus_emb)
    pool = rng.integers(1, vocab, (16, ctx)).astype(np.int32)  # repeated captions hit the cache
    plans = []
    for i in range(run.requests):
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
            for i in range(worker, len(plans), run.clients):
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
    threads = [threading.Thread(target=client, args=(w,)) for w in range(run.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_requests = time.monotonic() - t0
    torch.cuda.synchronize()
    counts = read_counts(sa, ssl)
    tower_calls = dict(engine.calls)
    # -- end of the serving path --------------------------------------------
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
                raise AssertionError(f"{run.phase}: search ids {ids} != topk_ids oracle {oracle}")
            checked += 1
            continue
        if not np.all(np.isfinite(res)):
            raise AssertionError(f"{run.phase}: non-finite {kind} embedding")
        norms = np.linalg.norm(res, axis=-1)
        if np.abs(norms - 1).max() > 1e-3:
            raise AssertionError(f"{run.phase}: {kind} embeddings not unit-norm: {norms}")
    if not np.all(np.isfinite(corpus_emb)) or np.abs(np.linalg.norm(corpus_emb, axis=-1) - 1).max() > 1e-3:
        raise AssertionError(f"{run.phase}: corpus embeddings not finite and unit-norm")
    if warmed != engine.bucket_space or engine.compile_count != engine.bucket_space:
        raise AssertionError(f"compile_count {engine.compile_count} != bucket_space {engine.bucket_space}")
    expect = dict.fromkeys(counts, 0)
    expect[run.vision_kernel] += cfg.vision.depth * tower_calls.get("image", 0)
    expect["short_attention_fwd"] += cfg.text.depth * tower_calls.get("text", 0)
    svc.close()
    lat_ms = sorted(1e3 * x for x in lat)
    log(run.phase, warmup_s=t_warm, compile_count=engine.compile_count,
        bucket_space=engine.bucket_space, corpus=len(corpus), corpus_s=t_corpus,
        corpus_images_per_s=len(corpus) / t_corpus, requests=len(plans), clients=run.clients,
        requests_s=t_requests,
        request_p50_ms=lat_ms[int(np.ceil(0.50 * len(lat_ms))) - 1],
        request_p95_ms=lat_ms[int(np.ceil(0.95 * len(lat_ms))) - 1],
        searches_checked=checked, tower_calls=tower_calls, launches=counts, expected=expect)
    log(run.phase, service_stats=stats)
    if counts != expect or not expect[run.vision_kernel]:
        raise AssertionError(
            f"{run.phase} launches {counts} != {expect}: 12 of {run.vision_kernel} per image "
            "tower call, 12 of short_attention_fwd per text call, no backward")

    # Outside the counted run: the model with the kernels vs with the plain
    # attention on one batch, and the tower times at the largest bucket.
    b = run.buckets[-1]
    imgs = torch.from_numpy(rng.random((8, hw, hw, 3), dtype=np.float32)).cuda()
    toks = torch.from_numpy(rng.integers(1, vocab, (8, ctx))).cuda()
    with torch.inference_mode():
        kernel_out = (model.encode_image(imgs), model.encode_text(toks))
        with plain_attention(sa, fa):
            plain_out = (model.encode_image(imgs), model.encode_text(toks))
        cos = [float(torch.nn.functional.cosine_similarity(a, c, dim=-1).min())
               for a, c in zip(kernel_out, plain_out)]
        big_img = torch.from_numpy(rng.random((b, hw, hw, 3), dtype=np.float32)).cuda()
        big_tok = torch.from_numpy(rng.integers(1, vocab, (b, ctx))).cuda()
        image_ms = time_ms(lambda: model.encode_image(big_img), iters=5, warmup=2)
        text_ms = time_ms(lambda: model.encode_text(big_tok), iters=5, warmup=2)
        breakdown = {
            "image": device_breakdown(lambda: model.encode_image(big_img), image_ms),
            "text": device_breakdown(lambda: model.encode_text(big_tok), text_ms),
        }
    log(run.phase, min_cosine_kernel_vs_plain={"image": cos[0], "text": cos[1]},
        **{f"tower_ms_b{b}": {"image": image_ms, "text": text_ms},
           f"images_per_s_b{b}": b / image_ms * 1e3, f"texts_per_s_b{b}": b / text_ms * 1e3})
    for tower, row in breakdown.items():
        log("profile", tower=tower, config=run.config, batch=b, **row)
    if min(cos) <= 0.999:
        raise AssertionError(f"{run.phase}: kernels vs plain attention through the model, cosine {cos}")
    if run.reference:
        # The same weights (same seed) in the reference configuration: every
        # image and text row's cosine with it.
        ref = SigLIP(siglip_config(run.reference), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed)).eval()
        fid_imgs = torch.from_numpy(rng.random((64, hw, hw, 3), dtype=np.float32)).cuda()
        fid_toks = torch.from_numpy(rng.integers(1, vocab, (64, ctx))).cuda()
        with torch.inference_mode():
            pairs = ((model.encode_image(fid_imgs), ref.encode_image(fid_imgs)),
                     (model.encode_text(fid_toks), ref.encode_text(fid_toks)))
        rows = [torch.nn.functional.cosine_similarity(a.float(), c.float(), dim=-1)
                for a, c in pairs]
        fidelity = {"image": float(rows[0].min()), "text": float(rows[1].min())}
        log(run.phase, reference=run.reference, min_row_cosine_vs_reference=fidelity,
            rows=[int(r.numel()) for r in rows])
        if min(fidelity.values()) <= INT8_MIN_COSINE:
            raise AssertionError(f"{run.phase}: embeddings vs {run.reference}, cosine {fidelity}")
        del ref
    del model, engine, svc
    torch.cuda.empty_cache()
    return counts


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


def siglip_config(name: str):
    """The smoke's SigLIP-B/16 configurations by name: ``"b16"``
    (``SigLIPConfig.b16()``, 224 px), ``"b16_int8"`` (the same with int8
    projections in both towers, ``quant="int8"``), ``"headline"``
    (:func:`headline_config`) and ``"b16_512"``, the published widths of google/siglip-base-patch16-512
    (ViT-B/16 at 512 px, 1,024 patches; text 64 tokens; 512-d embeddings)
    with ``save_hot`` remat in both towers."""
    from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig, TextConfig, ViTConfig

    if name == "headline":
        return headline_config()
    if name == "b16_512":
        return SigLIPConfig(vision=ViTConfig(image_size=512, remat_policy="save_hot"),
                            text=TextConfig(remat_policy="save_hot"))
    if name == "b16_int8":
        cfg = SigLIPConfig.b16()
        return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, quant="int8"),
                                   text=dataclasses.replace(cfg.text, quant="int8"))
    return SigLIPConfig.b16()



def run_train_path(args, sa, ssl, fa, run: Training) -> dict:
    """``run.steps`` train steps of ``run.accum`` microbatches of
    ``run.micro`` pairs under ``save_hot``, between two reads of the counts
    (one launch of each of ``run.vision_kernels`` per vision layer and
    microbatch, one of K1 and K2 per text layer, so never an attention
    forward again). Then one step on the device by kernel group, the
    optimizer update alone, one microbatch's forward and backward by kernel
    group, the gradient through the whole model with every attention kernel
    against its plain version, and ``run.fit_steps`` steps on one fixed
    batch."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_per_shard_loss
    from distributed_sigmoid_loss_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import TrainConfig

    cfg = siglip_config(run.config)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + run.seed_offset)
    model = SigLIP(cfg, device="cuda", generator=gen)
    tx = make_optimizer(TrainConfig(warmup_steps=100, total_steps=100_000,
                                    adam_mu_dtype=run.adam_mu_dtype))
    state = create_train_state(model, tx)
    step = make_train_step(model, cfg.loss, accum_steps=run.accum, accum_dtype=run.accum_dtype)
    n = run.accum * run.micro
    batches = [random_batch(cfg, n, gen) for _ in range(run.steps)]
    torch.cuda.synchronize()
    log(run.phase, config=run.config, image_size=cfg.vision.image_size,
        remat_policy=cfg.vision.remat_policy, accum_steps=run.accum, microbatch=run.micro,
        steps=run.steps, accum_dtype=run.accum_dtype, adam_mu_dtype=run.adam_mu_dtype,
        loss_variant=cfg.loss.variant, loss_precision=cfg.loss.precision,
        train_config="TrainConfig(warmup_steps=100, total_steps=100_000)")

    # -- the training path, between the two reads of the launch counts -----
    reset_counts(sa, ssl)
    torch.cuda.reset_peak_memory_stats()
    step_s, metrics = [], []
    for batch in batches:
        t0 = time.monotonic()
        state, m = step(state, batch)
        m = {k: v.item() for k, v in m.items()}
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        metrics.append(m)
    counts = read_counts(sa, ssl)
    # -- end of the training path ------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    expect = dict.fromkeys(counts, 0)
    for kernel in run.vision_kernels:
        expect[kernel] += cfg.vision.depth * run.accum * run.steps
    for kernel in ("short_attention_fwd", "short_attention_bwd"):
        expect[kernel] += cfg.text.depth * run.accum * run.steps
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    pairs_per_s = n / steady
    flops = 3.0 * forward_flops_per_pair(cfg)
    for i, (m, t) in enumerate(zip(metrics, step_s)):
        log(run.phase, step=i, step_ms=1e3 * t, pairs_per_s=n / t, **m)
    log(run.phase, steady_step_ms=1e3 * steady, pairs_per_s=pairs_per_s,
        model_tflops_per_pair_basis=flops / 1e12,
        mfu=flops * pairs_per_s / BF16_FLOP_PER_S, max_memory_allocated_gib=peak / 2**30,
        launches=counts, expected=expect,
        launches_per_step={k: v / run.steps for k, v in counts.items()},
        traced_bwd_batch_heads=sa.traced_bwd_batch_heads())
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite {run.phase} metrics: {metrics}")
    if counts != expect:
        raise AssertionError(
            f"{run.phase} launches {counts} != {expect}: one launch of each attention kernel "
            "per layer and microbatch; twice the forwards means the remat policy re-ran them")

    # Outside the counted run: one whole step, the optimizer update alone,
    # and one microbatch's forward+backward, on the device by kernel group.
    log("profile", path=f"{run.phase} step", accum_steps=run.accum, batch=n,
        **device_breakdown(lambda: step(state, batches[0]), 1e3 * steady, host_ops=False))
    zero_grads = [torch.zeros_like(p) for p in state.params]
    update_ms = time_ms(lambda: state.tx.apply(state.params, zero_grads, state.opt_state),
                        iters=3, warmup=1)
    log(run.phase, optimizer_update_ms=update_ms, params=len(zero_grads))
    del zero_grads
    per_shard = make_per_shard_loss(variant=cfg.loss.variant, precision=cfg.loss.precision)
    micro = {k: v[:run.micro] for k, v in batches[0].items()}

    def microstep():
        zimg, ztxt, lp = model(micro["images"], micro["tokens"])
        per_shard(zimg, ztxt, lp["t_prime"], lp["bias"]).backward()
        model.zero_grad(set_to_none=True)

    micro_ms = time_ms(microstep, iters=5, warmup=2)
    log("profile", path=f"{run.phase} microbatch fwd+bwd", batch=run.micro,
        **device_breakdown(microstep, micro_ms))

    # The gradient through the whole model, the kernels vs their plain versions.
    small = {k: v[:8] for k, v in batches[0].items()}
    kernel_grads = tower_grads(model, per_shard, small)
    with plain_attention(sa, fa):
        plain_grads = tower_grads(model, per_shard, small)
    cos = {t: float(torch.nn.functional.cosine_similarity(kernel_grads[t], plain_grads[t], dim=0))
           for t in kernel_grads}
    log(run.phase, grad_cosine_kernel_vs_plain_b8=cos)
    if min(cos.values()) <= 0.999:
        raise AssertionError(f"{run.phase}: kernel vs plain gradient through the model, cosine {cos}")
    del state, step, batches, kernel_grads, plain_grads
    torch.cuda.empty_cache()

    if run.fit_steps:
        # A short fit: steps on one fixed batch at a constant rate. Adam's
        # first steps are about lr·sign(g) on each of 210M parameters, a
        # first-order change of the loss of about lr·‖g‖₁ (‖g‖₂ ≈ 55 at B/16
        # 224 px): at 1e-5 that is several nats and the loss jumps about; at
        # 1e-6 it descends.
        fit_tx = make_optimizer(TrainConfig(learning_rate=1e-6, warmup_steps=0,
                                            schedule="constant", adam_mu_dtype=run.adam_mu_dtype))
        fit_state = create_train_state(model, fit_tx)
        fit_step = make_train_step(model, cfg.loss)
        fixed = random_batch(cfg, run.micro, gen)
        losses = []
        for _ in range(run.fit_steps):
            fit_state, m = fit_step(fit_state, fixed)
            losses.append(m["loss"].item())
        log(run.phase, fit_losses=losses)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")
        del fit_state, fit_step
    del model
    torch.cuda.empty_cache()
    return counts


def run_rank_view(ssl, sa, gen) -> dict:
    """What rank 3 of an 8-GPU all-gather run at 32k global computes after
    its gather: the chunked scan with the streaming kernel over 8 text
    chunks of 4096 (forward and backward), against the plain chunk scan
    (checkpointed logits blocks, IEEE f32). Launches read around the kernel
    run: one K4, K5 and K6 per chunk."""
    import torch.nn.functional as F

    from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import sigmoid_loss_chunk_scan

    b, w, d, pos = RANK_VIEW
    zimg, _, tp, bias = loss_case_inputs(b, b, d, 0, torch.float32, gen)
    chunks = F.normalize(torch.randn(w, b, d, device="cuda", generator=gen), dim=-1)
    chunks[pos] = F.normalize(zimg + 0.5 * chunks[pos], dim=-1)

    def run(use_pallas):
        leaves = [t.detach().requires_grad_() for t in (zimg, chunks, tp, bias)]
        loss = sigmoid_loss_chunk_scan(*leaves, positive_chunk=pos, use_pallas=use_pallas)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    out = {}
    for use_pallas in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        # -- the rank-view path (kernel run), between two reads of the counts
        reset_counts(sa, ssl)
        t0 = time.monotonic()
        loss, grads = run(use_pallas)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts(sa, ssl)
        # -- end of the rank-view path
        out[use_pallas] = dict(loss=loss, grads=grads, counts=counts,
                               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                               first_call_ms=1e3 * wall,
                               ms=time_ms(lambda: run(use_pallas), iters=3, warmup=1))
    kern, plain = out[True], out[False]
    errs = {"loss": abs(kern["loss"].item() - plain["loss"].item())}
    tols = {"loss": LOSS_RTOL * abs(plain["loss"].item())}
    for name, g, r in zip(("dzimg", "dtxt_chunks", "dt_prime", "dbias"), kern["grads"], plain["grads"]):
        errs[name] = (g - r).abs().max().item()
        tols[name] = LOSS_GRAD_RTOL_OF_MAX * r.abs().max().item()
    counts = kern["counts"]
    loss_counts = {k: v for k, v in counts.items() if k.startswith("sigmoid_loss")}
    log("rank_view", config=f"chunked all-gather, rank {pos} of {w}, {w * b} global, d={d}",
        loss=kern["loss"].item(), max_abs_err=errs, atol=tols,
        kernel_ms=kern["ms"], plain_ms=plain["ms"], kernel_first_call_ms=kern["first_call_ms"],
        kernel_peak_gib=kern["peak_gib"], plain_peak_gib=plain["peak_gib"], launches=loss_counts)
    if any(errs[k] > tols[k] for k in errs):
        raise AssertionError(f"rank-view chunk scan: kernel vs plain {errs} over {tols}")
    if any(v != (0 if k.endswith("_int8") else w) for k, v in loss_counts.items()):
        raise AssertionError(f"rank view launched {loss_counts}, expected {w} of each f32 loss "
                             "kernel")
    del out, kern, plain, chunks
    torch.cuda.empty_cache()
    return counts


def run_train_pallas_path(args, sa, ssl, fa, quant_train: str = "") -> dict:
    """The headline step with the streaming loss kernel as its loss body
    (``LossConfig(use_pallas=True)``, ring at W = 1): TRAIN_PALLAS_STEPS
    steps between two reads of the counts, then the gradient through the
    whole model with the loss kernels against their plain versions.
    ``quant_train="int8"`` (``[train_int8]``) trains both towers through the
    int8 STE, so the loss's blocks take the kernels' int8 mode: the steps'
    launches, ``traced_loss_kernels() == ("streaming_int8",)``, the int8
    products (``int_mm_calls``) per step, peak memory, one step's device
    time and idle share, and the gradient against the model with every
    kernel (loss and attention) swapped for its plain version."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.ops import quant
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_per_shard_loss
    from distributed_sigmoid_loss_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from distributed_sigmoid_loss_tpu_torch.train.train_step import resolve_loss_quant
    from distributed_sigmoid_loss_tpu_torch.utils.config import TrainConfig

    phase = "train_int8" if quant_train else "train_pallas"
    steps = TRAIN_INT8_STEPS if quant_train else TRAIN_PALLAS_STEPS
    cfg = headline_config()
    cfg = dataclasses.replace(
        cfg, loss=dataclasses.replace(cfg.loss, use_pallas=True),
        vision=dataclasses.replace(cfg.vision, quant_train=quant_train),
        text=dataclasses.replace(cfg.text, quant_train=quant_train))
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    model = SigLIP(cfg, device="cuda", generator=gen)
    loss_quant = resolve_loss_quant(model, cfg.loss)
    state = create_train_state(model, make_optimizer(
        TrainConfig(warmup_steps=100, total_steps=100_000, adam_mu_dtype="bfloat16")))
    step = make_train_step(model, cfg.loss, accum_steps=ACCUM, accum_dtype="bfloat16")
    batches = [random_batch(cfg, ACCUM * MICRO, gen) for _ in range(steps)]
    torch.cuda.synchronize()

    # -- the use_pallas training path, between the two reads of the counts --
    reset_counts(sa, ssl)
    ssl.reset_traced_loss_kernels()
    quant.reset_int_mm_calls()
    torch.cuda.reset_peak_memory_stats()
    step_s, metrics = [], []
    for batch in batches:
        t0 = time.monotonic()
        state, m = step(state, batch)
        m = {k: v.item() for k, v in m.items()}
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        metrics.append(m)
    counts = read_counts(sa, ssl)
    int_mm = quant.int_mm_calls()
    traced = ssl.traced_loss_kernels()
    # -- end of the use_pallas training path --------------------------------
    peak = torch.cuda.max_memory_allocated()
    for i, (m, t) in enumerate(zip(metrics, step_s)):
        log(phase, step=i, step_ms=1e3 * t, pairs_per_s=ACCUM * MICRO / t, **m)
    suffix = "_int8" if quant_train else ""
    expect = dict.fromkeys(counts, 0)
    for kernel in ("sigmoid_loss_fwd", "sigmoid_loss_bwd_img", "sigmoid_loss_bwd_txt"):
        expect[kernel + suffix] = ACCUM * steps
    for kernel in ("short_attention_fwd", "short_attention_bwd"):
        expect[kernel] = (cfg.vision.depth + cfg.text.depth) * ACCUM * steps
    # Forward projections per microbatch: six per block (q, k, v, out, wi,
    # wo) in both towers; the recompute under save_hot runs some again.
    forward_int8 = 6 * (cfg.vision.depth + cfg.text.depth) * ACCUM * steps if quant_train else 0
    log(phase, loss_config=f"ring, W = 1, use_pallas=True, quant={loss_quant!r}",
        quant_train=quant_train, accum_steps=ACCUM, microbatch=MICRO, launches=counts,
        expected=expect, traced_loss_kernels=traced,
        int8_products_per_step=int_mm / steps,
        int8_products_recomputed_per_step=(int_mm - forward_int8) / steps,
        max_memory_allocated_gib=peak / 2**30,
        steady_step_ms=1e3 * sorted(step_s)[len(step_s) // 2])
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite {phase} metrics: {metrics}")
    if counts != expect:
        raise AssertionError(f"{phase} launches {counts} != {expect}")
    if traced != (("streaming_int8",) if quant_train else ("streaming",)):
        raise AssertionError(f"{phase}: loss blocks traced {traced}")
    if quant_train and int_mm < forward_int8:
        raise AssertionError(f"{phase}: {int_mm} int8 products, fewer than the forwards' "
                             f"{forward_int8}")
    if quant_train:
        log("profile", path=f"{phase} step", accum_steps=ACCUM, batch=ACCUM * MICRO,
            **device_breakdown(lambda: step(state, batches[0]),
                               1e3 * sorted(step_s)[len(step_s) // 2], host_ops=False))

    # The gradient through the whole model, the kernels vs their plain
    # versions (TF32 off, so the plain products are IEEE f32 too): the loss
    # kernels, and under int8 every attention kernel too. 32 pairs: the
    # int8 dispatch takes blocks of a multiple of 32 rows.
    per_shard = make_per_shard_loss(variant=cfg.loss.variant, use_pallas=True, quant=loss_quant)
    small = {k: v[:32] for k, v in batches[0].items()}
    kernel_grads = tower_grads(model, per_shard, small)
    with plain_loss_kernels(ssl), (plain_attention(sa, fa) if quant_train
                                   else contextlib.nullcontext()):
        plain_grads = tower_grads(model, per_shard, small)
    cos = {t: float(torch.nn.functional.cosine_similarity(kernel_grads[t], plain_grads[t], dim=0))
           for t in kernel_grads}
    log(phase, grad_cosine_kernel_vs_plain_b32=cos)
    if min(cos.values()) <= 0.999:
        raise AssertionError(f"{phase}: kernel vs plain gradient through the model: cosine {cos}")
    del state, step, batches, model, kernel_grads, plain_grads
    torch.cuda.empty_cache()
    return counts


def flat_grads(model) -> torch.Tensor:
    """The whole model's gradient as one f32 vector (parameters the loss did
    not reach count as zeros), cleared after."""
    g = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).float().flatten()
                   for p in model.parameters()])
    model.zero_grad(set_to_none=True)
    return g


def run_train_recipes_path(args, sa, ssl) -> dict:
    """The headline step with the item-4 recipes: K3 as the attention
    backward (``set_bwd_batch_heads(True)``), the softmax ring loss,
    GradCache over 16 × 128 with a bf16 stash, the EMA at 0.9999, and
    RECIPE_STEPS steps with Lion, then as many with Adafactor, between two
    reads of the counts. Then GradCache at 4 × 128 against one 512-pair
    batch, and one microbatch's gradient with K3 against K2."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_per_shard_loss
    from distributed_sigmoid_loss_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        run_gradcache,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import TrainConfig

    cfg = headline_config()
    cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, family="softmax"))
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    model = SigLIP(cfg, device="cuda", generator=gen)
    step = make_train_step(model, cfg.loss, accum_steps=ACCUM, accum_dtype="bfloat16",
                           accum_negatives="global", gradcache_embed_dtype="bfloat16",
                           ema_decay=0.9999)
    batches = [random_batch(cfg, ACCUM * MICRO, gen) for _ in range(2 * RECIPE_STEPS)]
    schedule = dict(warmup_steps=100, total_steps=100_000)
    optimizers = {"lion": TrainConfig(optimizer="lion", adam_mu_dtype="bfloat16", **schedule),
                  "adafactor": TrainConfig(optimizer="adafactor", **schedule)}
    torch.cuda.synchronize()
    log("train_recipes", config="SigLIP-B/16", remat_policy=cfg.vision.remat_policy,
        attention_backward="K3 (set_bwd_batch_heads(True))",
        loss="LossConfig(family='softmax', variant='ring', precision='default'), W = 1",
        accum_steps=ACCUM, microbatch=MICRO, accum_negatives="global",
        gradcache_embed_dtype="bfloat16", accum_dtype="bfloat16", ema_decay=0.9999,
        steps={k: RECIPE_STEPS for k in optimizers},
        train_config="TrainConfig(warmup_steps=100, total_steps=100_000); lion: "
                     "adam_mu_dtype='bfloat16'")

    # -- the recipes path, between the two reads of the launch counts -------
    sa.set_bwd_batch_heads(True)
    sa.reset_traced_bwd_batch_heads()
    reset_counts(sa, ssl)
    rows, ema_moved, peaks, state = [], {}, {}, None
    for i, (opt, train_cfg) in enumerate(optimizers.items()):
        del state  # the previous optimizer's state and EMA
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(model, make_optimizer(train_cfg), ema=True)
        start = [p.detach().clone() for p in state.params]
        for batch in batches[i * RECIPE_STEPS:(i + 1) * RECIPE_STEPS]:
            t0 = time.monotonic()
            state, m = step(state, batch)
            m = {k: v.item() for k, v in m.items()}
            torch.cuda.synchronize()
            rows.append(dict(optimizer=opt, step_ms=1e3 * (time.monotonic() - t0), **m))
        # The EMA left its start (the parameters before the first step)
        # toward the parameters: |ema − θ| < |θ_start − θ|.
        to_params = global_norm_of(e - p for e, p in zip(state.ema, state.params))
        start_to_params = global_norm_of(s0 - p for s0, p in zip(start, state.params))
        ema_moved[opt] = dict(ema_to_params=to_params, start_to_params=start_to_params)
        peaks[opt] = torch.cuda.max_memory_allocated() / 2**30
        del start
    counts = read_counts(sa, ssl)
    traced = sa.traced_bwd_batch_heads()
    # -- end of the recipes path --------------------------------------------
    steps = 2 * RECIPE_STEPS
    depth = cfg.vision.depth + cfg.text.depth
    expect = dict.fromkeys(counts, 0)
    expect.update(short_attention_fwd=2 * depth * ACCUM * steps,
                  short_attention_bwd_batched=depth * ACCUM * steps,
                  short_attention_bwd_batched_wgmma=depth * ACCUM * steps)
    for row in rows:
        log("train_recipes", **row, pairs_per_s=ACCUM * MICRO / (row["step_ms"] / 1e3))
    log("train_recipes", launches=counts, expected=expect, per_step={
        k: v / steps for k, v in counts.items()}, traced_bwd_batch_heads=traced,
        ema=ema_moved, max_memory_allocated_gib=peaks)
    if not all(np.isfinite(v) for row in rows for k, v in row.items() if k != "optimizer"):
        raise AssertionError(f"non-finite train_recipes metrics: {rows}")
    if counts != expect:
        raise AssertionError(f"train_recipes launches {counts} != {expect}: per step K1 = "
                             f"{2 * depth * ACCUM} (two forwards), K3 = {depth * ACCUM}")
    if traced != (True,):
        raise AssertionError(f"traced_bwd_batch_heads() = {traced}, expected (True,)")
    for opt, e in ema_moved.items():
        if not 0 < e["ema_to_params"] < e["start_to_params"]:
            raise AssertionError(f"the EMA did not move toward the parameters ({opt}): {e}")

    # Outside the counted run: one whole recipes step (Adafactor, the state
    # the path ended with) on the device by kernel group, then each
    # optimizer's update alone.
    recipe_ms = float(np.mean([r["step_ms"] for r in rows if r["optimizer"] == "adafactor"]))
    log("profile", path="train_recipes step (Adafactor)", accum_steps=ACCUM, batch=ACCUM * MICRO,
        **device_breakdown(lambda: step(state, batches[0]), recipe_ms, host_ops=False))
    del state
    zero_grads = [torch.zeros_like(p) for p in model.parameters()]
    update_ms = {}
    for opt, train_cfg in optimizers.items():
        st = create_train_state(model, make_optimizer(train_cfg))
        update_ms[opt] = time_ms(lambda: st.tx.apply(st.params, zero_grads, st.opt_state),
                                 iters=3, warmup=1)
        del st
    log("train_recipes", optimizer_update_ms=update_ms, params=len(zero_grads))
    del zero_grads

    # GradCache at 4 × 128 against one batch of 512 pairs: the whole model's
    # gradient of the same loss (bf16 stash vs f32 embeddings).
    per_shard = make_per_shard_loss(family="softmax", variant="ring",
                                    precision=cfg.loss.precision)
    m, mb = GRADCACHE_CHECK
    big = {k: v[:m * mb] for k, v in batches[0].items()}
    _, _, gc_grads = run_gradcache(
        model, big["images"].reshape(m, mb, *big["images"].shape[1:]),
        big["tokens"].reshape(m, mb, *big["tokens"].shape[1:]),
        lambda zis, zts, tp, b: per_shard(zis.flatten(0, 1), zts.flatten(0, 1), tp, b),
        m, embed_dtype="bfloat16")
    gc = torch.cat([g.float().flatten() for g in gc_grads])
    del gc_grads
    zimg, ztxt, lp = model(big["images"], big["tokens"])
    per_shard(zimg, ztxt, lp["t_prime"], lp["bias"]).backward()
    del zimg, ztxt
    one = flat_grads(model)
    cos_gc = float(torch.nn.functional.cosine_similarity(gc, one, dim=0))
    del gc, one
    # One microbatch's gradient, K3 against K2.
    micro = {k: v[:MICRO] for k, v in batches[0].items()}
    grads = {}
    for batch_heads in (True, False):
        sa.set_bwd_batch_heads(batch_heads)
        zimg, ztxt, lp = model(micro["images"], micro["tokens"])
        per_shard(zimg, ztxt, lp["t_prime"], lp["bias"]).backward()
        grads[batch_heads] = flat_grads(model)
    sa.set_bwd_batch_heads(False)
    cos_k3 = float(torch.nn.functional.cosine_similarity(grads[True], grads[False], dim=0))
    log("train_recipes", gradcache_vs_one_batch=dict(microbatches=m, microbatch=mb,
                                                      cosine=cos_gc, min=GRADCACHE_MIN_COSINE),
        k3_vs_k2_grad=dict(batch=MICRO, cosine=cos_k3, min=K3_VS_K2_MIN_COSINE))
    if not cos_gc >= GRADCACHE_MIN_COSINE:
        raise AssertionError(f"GradCache vs one batch: gradient cosine {cos_gc}")
    if not cos_k3 >= K3_VS_K2_MIN_COSINE:
        raise AssertionError(f"K3 vs K2 through the model: gradient cosine {cos_k3}")
    del grads, batches, step, model
    torch.cuda.empty_cache()
    return counts


def check_flash_attention(fa, gen) -> dict:
    """K7 fwd, dkv and dq against their plain versions at the kernels' own
    key block (``fa.BLOCK_K``) in every case of FLASH_CASES, each kernel run
    twice for bitwise repeatability; the backward kernels take the forward
    kernel's own (out, stats), so each is held alone. Times the three at
    FLASH_TIMED beside the plain versions and SDPA; the element-wise path
    must match the vectorised one bitwise, and a head dim past 128 must be
    refused. Returns ``{kernel: record}`` for the JSON line."""
    import torch.nn.functional as F

    from distributed_sigmoid_loss_tpu_torch.ops.short_attention import _vec as sa_vec

    lib_f, lib_b = fa._library("flash_attention"), fa._library("flash_attention_bwd")
    records = {}

    def run(q, k, v, do, causal, scale):
        out, stats = fa._launch_fwd(q, k, v, causal, scale)
        dk, dv, di = fa._launch_bwd_dkv(q, k, v, out, do, stats, causal, scale)
        return out, stats, dk, dv, di, fa._launch_bwd_dq(q, k, v, do, stats, di, causal, scale)

    for name, (b, s, h, dh, causal) in FLASH_CASES.items():
        scale = dh ** -0.5
        q, k, v, do = (
            torch.randn(b, s, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(4)
        )
        first, again = run(q, k, v, do, causal, scale), run(q, k, v, do, causal, scale)
        torch.cuda.synchronize()
        repeatable = all(torch.equal(a, c) for a, c in zip(first, again))
        out, stats, dk, dv, di, dq = first
        pout, pstats = fa.flash_self_attention_plain(q, k, v, causal, scale, fa.BLOCK_K)
        pdk, pdv, pdi = fa.flash_attention_bwd_dkv_plain(q, k, v, out, do, stats, causal, scale,
                                                         fa.BLOCK_K)
        pdq = fa.flash_attention_bwd_dq_plain(q, k, v, do, stats, pdi, causal, scale, fa.BLOCK_K)
        pairs = {"out": (out, pout), "dk": (dk, pdk), "dv": (dv, pdv), "dq": (dq, pdq)}
        errs = {n: (g.float() - r.float()).abs().max().item() for n, (g, r) in pairs.items()}
        tols = {n: (K7_OUT_ULPS if n == "out" else K7_GRAD_ULPS) * bf16_ulp(r)
                for n, (_, r) in pairs.items()}
        cos = {n: float(F.cosine_similarity(g.float().flatten(), r.float().flatten(), dim=0))
               for n, (g, r) in pairs.items()}
        stat_errs = {"m": (stats[:, :, 0] - pstats[:, :, 0]).abs().max().item(),
                     "l_rel": ((stats[:, :, 1] - pstats[:, :, 1]).abs()
                               / pstats[:, :, 1]).max().item(),
                     "di": (di - pdi).abs().max().item()}
        finite = all(bool(torch.isfinite(t).all()) for t in (out, stats, dk, dv, dq))
        bodies = {which: flash_body(fa, dh, sa_vec(dh, h * dh, tensors), which)
                  for which, tensors in (("fwd", (q, k, v, out)),
                                         ("dkv", (q, k, v, out, do, dk, dv)),
                                         ("dq", (q, k, v, do, dq)))}
        row = dict(case=name, shape=[b, s, h, dh], causal=causal, max_abs_err=errs, atol=tols,
                   cosine=cos, stats_err=stat_errs, finite=finite, repeatable=repeatable,
                   body={which: body for which, (body, _) in bodies.items()},
                   registers={which: regs for which, (_, regs) in bodies.items()},
                   blocks_per_sm={"fwd": lib_f.flash_attention_fwd_occupancy(dh),
                                  "dkv": lib_b.flash_attention_bwd_occupancy(dh, 0),
                                  "dq": lib_b.flash_attention_bwd_occupancy(dh, 1)})
        log("kernel_flash", **row)
        if not (finite and repeatable) or any(errs[n] > tols[n] or cos[n] <= K7_MIN_COSINE
                                              for n in errs):
            raise AssertionError(f"flash attention kernels disagree with their plain versions: {row}")
        if name != FLASH_TIMED:
            continue
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        dout = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)

        calls = {
            "fwd": (lambda: fa._launch_fwd(q, k, v, causal, scale),
                    lambda: fa.flash_self_attention_plain(q, k, v, causal, scale, fa.BLOCK_K),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                    "SDPA forward", (4, 2)),
            "bwd_dkv": (lambda: fa._launch_bwd_dkv(q, k, v, out, do, stats, causal, scale),
                        lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, out, do, stats, causal,
                                                                 scale, fa.BLOCK_K),
                        sdpa_bwd, "SDPA backward (dq, dk and dv in one call)", (7, 4)),
            "bwd_dq": (lambda: fa._launch_bwd_dq(q, k, v, do, stats, di, causal, scale),
                       lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, stats, di, causal,
                                                               scale, fa.BLOCK_K),
                       sdpa_bwd, "SDPA backward (dq, dk and dv in one call)", (5, 3)),
        }
        err_of = {"fwd": errs["out"], "bwd_dkv": max(errs["dk"], errs["dv"]), "bwd_dq": errs["dq"]}
        for which, (kernel, plain, library, library_call, (tensors, products)) in calls.items():
            rec = dict(case=name, shape=[b, s, h, dh], max_abs_err=err_of[which],
                       ms=time_ms(kernel, iters=10), device_ms=device_ms(kernel),
                       plain_ms=time_ms(plain, iters=3, warmup=1),
                       library_ms=time_ms(library, iters=10), library_device_ms=device_ms(library),
                       library_call=library_call)
            # dkv: q, k, v, out, do read and dk, dv written, four products
            # (sᵀ, dv, dpᵀ, dk); dq: q, k, v, do read and dq written, three.
            # The two kernels' bounds add the two products the split
            # recomputes (sᵀ and dpᵀ again); the backward's own least time is
            # the pair's: 7 tensors and 5 products.
            rec["bound_ms"], rec["bound_by"] = attention_bound_ms(b, s, h, dh, causal, tensors,
                                                                  products)
            if which != "fwd":
                rec["pair_bound_ms"], rec["pair_bound_by"] = attention_bound_ms(
                    b, s, h, dh, causal, 7, 5)
            if which == "bwd_dkv":  # the di pass and the dK/dV kernel apart
                rec["device_ms_by_kernel"] = device_ms(kernel, by_kernel=True)
            short = which.removeprefix("bwd_")
            rec["body"], rec["registers"] = bodies[short]
            rec["blocks_per_sm"] = row["blocks_per_sm"][short]
            if rec["device_ms"]:
                rec["bound_over_device"] = rec["bound_ms"] / rec["device_ms"]
            log("kernel_flash_time", kernel=which, **rec)
            records[which] = rec
        log("kernel_flash_time", kernel="bwd pair (dkv + dq)",
            ms=records["bwd_dkv"]["ms"] + records["bwd_dq"]["ms"],
            bound_ms=records["bwd_dq"]["pair_bound_ms"],
            library_ms=records["bwd_dq"]["library_ms"])
        del leaves, lib_out
    # The element-wise path (copies and stores without 16-byte vectors): the
    # same inputs two bytes off alignment give bitwise the aligned results.
    shape = (2, 100, 2, 64)
    aligned = [torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(4)]
    shifted = []
    for t in aligned:
        buf = torch.empty(t.numel() + 1, device="cuda", dtype=t.dtype)
        shifted.append(buf[1:].view(shape).copy_(t))
    same = all(torch.equal(a, c) for a, c in zip(run(*aligned, True, 0.125),
                                                 run(*shifted, True, 0.125)))
    log("kernel_flash", case="element-wise path", shape=list(shape), causal=True,
        bitwise_equal_to_aligned=same,
        body={which: {"aligned": flash_body(fa, shape[-1], 1, which)[0],
                      "shifted": flash_body(fa, shape[-1], sa_vec(shape[-1], 128, shifted),
                                            which)[0]}
              for which in ("fwd", "dkv", "dq")})
    if not same:
        raise AssertionError("K7 on 2-byte-offset inputs differs from the aligned run")
    q = torch.zeros(1, 64, 2, 136, device="cuda", dtype=torch.bfloat16)
    try:
        fa.flash_self_attention(q, q, q)
    except ValueError as e:
        log("kernel_flash", shape=[1, 64, 2, 136], refused=str(e))
    else:
        raise AssertionError("K7 took head_dim=136")
    torch.cuda.empty_cache()
    return records


@contextlib.contextmanager
def plain_attention(sa, fa):
    """Every attention kernel's launch (K1, K2, K7 fwd, dkv and dq, and the
    f32 kernels in any of those roles) replaced by its plain version (K7's at
    the kernels' key block) inside the block: the model run through it is the
    kernel-free reference."""
    from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af

    real_f32 = (af.launch_fwd, af.launch_bwd_dkv, af.launch_bwd_dq)
    af.launch_fwd = lambda q, k, v, c, sc, with_stats: fa.flash_self_attention_plain(
        q, k, v, c, sc, fa.BLOCK_K)
    af.launch_bwd_dkv = fa.flash_attention_bwd_dkv_plain
    af.launch_bwd_dq = fa.flash_attention_bwd_dq_plain
    real = (sa._launch_fwd, sa._launch_bwd, fa._launch_fwd, fa._launch_bwd_dkv, fa._launch_bwd_dq)
    sa._launch_fwd = lambda q, k, v, c, sc: sa.short_self_attention_plain(q, k, v, c, sc)
    sa._launch_bwd = lambda q, k, v, do, c, sc: sa.short_self_attention_bwd_plain(q, k, v, do, c, sc)
    fa._launch_fwd = lambda q, k, v, c, sc: fa.flash_self_attention_plain(q, k, v, c, sc, fa.BLOCK_K)
    fa._launch_bwd_dkv = lambda q, k, v, o, do, st, c, sc: fa.flash_attention_bwd_dkv_plain(
        q, k, v, o, do, st, c, sc, fa.BLOCK_K)
    fa._launch_bwd_dq = lambda q, k, v, do, st, di, c, sc: fa.flash_attention_bwd_dq_plain(
        q, k, v, do, st, di, c, sc, fa.BLOCK_K)
    try:
        yield
    finally:
        (sa._launch_fwd, sa._launch_bwd, fa._launch_fwd, fa._launch_bwd_dkv,
         fa._launch_bwd_dq) = real
        af.launch_fwd, af.launch_bwd_dkv, af.launch_bwd_dq = real_f32



def run_context(sa, ssl, fa) -> dict:
    """The counterpart of the JAX bench's ``--context`` run: one transformer
    block of width 768 with 12 heads in bf16, forward and backward of
    ``sum(out²)``, at each (s, b) of CONTEXT_CASES, dense attention against
    K7; ms per layer and peak memory. The K7 runs are counted."""
    from distributed_sigmoid_loss_tpu_torch.models.transformer import Block

    gen = torch.Generator(device="cuda").manual_seed(5)
    blocks = {impl: Block(768, 12, 4, torch.bfloat16, attn_impl=impl, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(6))
              for impl in ("dense", "flash")}
    xs = {s: torch.randn(b, s, 768, device="cuda", generator=gen).to(torch.bfloat16)
          for s, b in CONTEXT_CASES}

    def fwd_bwd(impl, x):
        block = blocks[impl]
        block.zero_grad(set_to_none=True)
        out = block(x)
        out.float().square().sum().backward()
        return out

    # -- the context path (K7 runs), between the two reads of the counts ---
    reset_counts(sa, ssl)
    outs = {s: fwd_bwd("flash", x).detach() for s, x in xs.items()}
    torch.cuda.synchronize()
    counts = read_counts(sa, ssl)
    # -- end of the context path --------------------------------------------
    n = len(CONTEXT_CASES)
    if any(counts[k] != n for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq")):
        raise AssertionError(f"context launches {counts}: expected {n} of each K7 kernel")
    for s, b in CONTEXT_CASES:
        x = xs[s]
        row = {"s": s, "b": b}
        for impl in ("dense", "flash"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fwd_bwd(impl, x)
            torch.cuda.synchronize()
            row[f"{impl}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            row[f"{impl}_ms_per_layer"] = time_ms(lambda: fwd_bwd(impl, x), iters=5, warmup=1)
            if impl == "dense":
                dense_out = out.detach()
        row["cosine_flash_vs_dense"] = float(torch.nn.functional.cosine_similarity(
            outs[s].float().flatten(), dense_out.float().flatten(), dim=0))
        row["finite"] = bool(torch.isfinite(outs[s]).all())
        log("context", **row)
        if not row["finite"] or row["cosine_flash_vs_dense"] <= 0.999:
            raise AssertionError(f"context block at s={s}: K7 vs dense {row}")
        del out, dense_out
    del blocks, xs, outs
    torch.cuda.empty_cache()
    return counts

def run_compat(sa, ssl, gen) -> dict:
    """The reference's loss classes (``compat.py``) at W = 1 on COMPAT_ROWS
    × COMPAT_DIM unit rows: each class with ``use_pallas`` on and off,
    forward and backward between two reads of the counts (one K4, K5 and K6
    a call with the kernels, none without); each class bitwise equal to
    ``make_sharded_loss_fn``; the kernels against the plain path for the loss
    and all four gradients (LOSS_RTOL; LOSS_GRAD_RTOL_OF_MAX of each
    gradient's largest magnitude); DDPSigmoidLoss against SigLipLoss."""
    from distributed_sigmoid_loss_tpu_torch.compat import DDPSigmoidLoss, SigLipLoss
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_sharded_loss_fn

    b, d = COMPAT_ROWS, COMPAT_DIM
    zimg, ztxt, _, _ = loss_case_inputs(b, b, d, 0, torch.float32, gen)
    variants = {"ddp": "all_gather", "siglip": "ring"}

    def call(cls, use_pallas):
        leaves = [zimg.detach().clone().requires_grad_(), ztxt.detach().clone().requires_grad_()]
        if cls == "ddp":
            mod = DDPSigmoidLoss(gpu_batch_size=b, use_pallas=use_pallas)
            params = [mod.t_prime, mod.bias]
            loss = mod(*leaves)
        else:
            p = SigLipLoss.init_params()
            params = [p["logit_scale"], p["logit_bias"]]
            loss = SigLipLoss(rank=0, world_size=1, use_pallas=use_pallas)(*leaves, *params)
        grads = torch.autograd.grad(loss, leaves + params)
        return leaves, params, loss.detach(), grads

    out, counts_total = {}, None
    for cls in variants:
        for use_pallas in (True, False):
            torch.cuda.synchronize()
            # -- the class's forward and backward, between the two reads ------
            reset_counts(sa, ssl)
            leaves, params, loss, grads = call(cls, use_pallas)
            torch.cuda.synchronize()
            counts = read_counts(sa, ssl)
            # -- end --------------------------------------------------------------
            expect = dict.fromkeys(counts, 0)
            if use_pallas:
                for k in ("sigmoid_loss_fwd", "sigmoid_loss_bwd_img", "sigmoid_loss_bwd_txt"):
                    expect[k] = 1
                counts_total = counts if counts_total is None else {
                    k: counts_total[k] + v for k, v in counts.items()}
            if counts != expect:
                raise AssertionError(f"[compat] {cls} use_pallas={use_pallas}: launches "
                                     f"{counts} != {expect}")
            fn = make_sharded_loss_fn(variant=variants[cls], use_pallas=use_pallas)
            fn_loss = fn({"t_prime": params[0], "bias": params[1]}, *leaves)
            fn_grads = torch.autograd.grad(fn_loss, leaves + params)
            equal = torch.equal(loss, fn_loss.detach()) and all(
                torch.equal(a, c) for a, c in zip(grads, fn_grads))
            ms = time_ms(lambda: call(cls, use_pallas), iters=5, warmup=1)
            out[cls, use_pallas] = dict(loss=loss, grads=grads)
            log("compat", cls=cls, use_pallas=use_pallas, shape=[b, b, d], loss=loss.item(),
                launches={k: v for k, v in counts.items() if v}, class_equals_function=equal,
                fwd_bwd_ms=ms)
            if not equal:
                raise AssertionError(f"[compat] {cls} use_pallas={use_pallas} != the function")

    def compare(a, ref):
        errs = {"loss": abs(a["loss"].item() - ref["loss"].item())}
        tols = {"loss": LOSS_RTOL * abs(ref["loss"].item())}
        for name, g, r in zip(("dzimg", "dztxt", "dt_prime", "dbias"), a["grads"], ref["grads"]):
            errs[name] = (g - r).abs().max().item()
            tols[name] = LOSS_GRAD_RTOL_OF_MAX * r.abs().max().item()
        return errs, tols

    for what, a, ref in [(f"{cls} kernels vs plain", out[cls, True], out[cls, False])
                         for cls in variants] + [
            (f"ddp vs siglip, use_pallas={up}", out["ddp", up], out["siglip", up])
            for up in (True, False)]:
        errs, tols = compare(a, ref)
        bitwise = all(torch.equal(x, y) for x, y in zip((a["loss"], *a["grads"]),
                                                          (ref["loss"], *ref["grads"])))
        log("compat", compare=what, max_abs_err=errs, atol=tols, bitwise=bitwise)
        if any(not np.isfinite(v) or v > tols[k] for k, v in errs.items()):
            raise AssertionError(f"[compat] {what}: {errs} over {tols}")
    del out, zimg, ztxt
    torch.cuda.empty_cache()
    return counts_total


def run_cli(sa, ssl, argv) -> dict:
    """``cli.main(argv)`` in this process between two reads of the counts:
    its exit code, output, error output, launches and seconds."""
    from distributed_sigmoid_loss_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts(sa, ssl)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = read_counts(sa, ssl)
    return dict(rc=rc, out=out.getvalue(), err=err.getvalue(), counts=counts, seconds=seconds)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path)
               for f in files)


def run_train_cli_path(args, sa, ssl, per_microbatch: dict) -> dict:
    """The ``train`` and ``eval`` commands at full B/16 width and depth
    (TRAIN_CLI_FLAGS), in process: (a) 2 steps saved at step 2 into D, (b)
    resumed from D to 4, (c) 4 steps into E uninterrupted, each between two
    reads of the counts, which must be the loss-kernel path's per-microbatch
    counts (``[train_pallas]``) times the microbatches run, plus K1 for each
    eval forward; D's and E's step-4 states compared; each checkpoint's
    bytes and save seconds; ``eval`` of D with and without --ema; then
    steps timed with and without an asynchronous save in flight."""
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.train import (
        AsyncSaver,
        create_train_state,
        make_optimizer,
        make_train_step,
        restore_latest,
        save_checkpoint,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, TrainConfig

    t_phase = time.monotonic()
    cfg = dataclasses.replace(headline_config(), loss=LossConfig())
    layers = cfg.vision.depth + cfg.text.depth
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_cli")
    d_dir, e_dir = os.path.join(root, "D"), os.path.join(root, "E")
    shutil.rmtree(root, ignore_errors=True)
    report_re = re.compile(r"resilient loop: steps (\d+)->(\d+), checkpoints at \[(.*)\]")
    ckpt_re = re.compile(r"checkpoint (\S+): (\d+) bytes, host snapshot ([\d.]+) s, "
                         r"write ([\d.]+) s")
    totals, runs = None, {}
    try:
        for name, steps, ckpt_every, ckpt_dir, start in (("a", 2, 2, d_dir, 0),
                                                         ("b", 4, 2, d_dir, 2),
                                                         ("c", 4, 4, e_dir, 0)):
            argv = ["train", *TRAIN_CLI_FLAGS, "--steps", str(steps), "--ckpt-every",
                    str(ckpt_every), "--ckpt-dir", ckpt_dir]
            run = run_cli(sa, ssl, argv)
            lines = [json.loads(x) for x in run["out"].splitlines() if x.startswith("{")]
            report = report_re.search(run["err"])
            saves = [dict(path=os.path.relpath(m.group(1), root), bytes=int(m.group(2)),
                          snapshot_s=float(m.group(3)), write_s=float(m.group(4)))
                     for m in ckpt_re.finditer(run["err"])]
            for save in saves:
                save["bytes_on_disk"] = dir_bytes(os.path.join(root, save["path"]))
            evals = sum(1 for s_ in range(start + 1, steps + 1) if s_ % TRAIN_CLI_EVAL_EVERY == 0)
            expect = {k: round(v * TRAIN_CLI_ACCUM * (steps - start))
                      for k, v in per_microbatch.items()}
            expect["short_attention_fwd"] += (evals + 1) * layers  # + the closing retrieval
            log("train_cli", run=name, argv=" ".join(argv[1:]).replace(root + "/", ""),
                rc=run["rc"], seconds=run["seconds"],
                report=report.groups() if report else None, checkpoints=saves,
                launches={k: v for k, v in run["counts"].items() if v},
                expected={k: v for k, v in expect.items() if v},
                lines=lines,
                closing_retrieval=run["err"].strip().splitlines()[-1])
            want_report = (str(start), str(steps),
                           {"a": "2", "b": "2, 4", "c": "4"}[name])
            if run["rc"] != 0 or report is None or report.groups() != want_report:
                raise AssertionError(f"[train_cli] run {name}: rc {run['rc']}, report "
                                     f"{report.groups() if report else None} != {want_report}")
            if run["counts"] != expect or any(run["counts"][k] == 0 for k in TRAIN_CLI_KERNELS):
                raise AssertionError(f"[train_cli] run {name}: launches {run['counts']} != "
                                     f"{expect}")
            losses = {x["step"]: x["loss"] for x in lines if "loss" in x}
            if len(losses) != steps - start or not all(np.isfinite(list(losses.values()))):
                raise AssertionError(f"[train_cli] run {name}: step losses {losses}")
            runs[name] = dict(losses=losses, saves=saves, seconds=run["seconds"])
            totals = run["counts"] if totals is None else {
                k: totals[k] + v for k, v in run["counts"].items()}

        # D's and E's step-4 states.
        got = torch.load(os.path.join(d_dir, "step_00000004", "tensors.pt"), mmap=True)
        want = torch.load(os.path.join(e_dir, "step_00000004", "tensors.pt"), mmap=True)
        if got.keys() != want.keys():
            raise AssertionError("[train_cli] D's and E's checkpoints hold other tensors")
        bitwise = all(torch.equal(got[k], want[k]) for k in want)
        diff = max((got[k].double() - want[k].double()).abs().max().item() for k in want)
        params = [k for k in want if k.startswith("model.")]
        flat = [torch.cat([t[k].double().flatten() for k in params]) for t in (got, want)]
        cosine = float(torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0))
        loss_rel = {s_: abs(runs["b"]["losses"][s_] - runs["c"]["losses"][s_])
                    / abs(runs["c"]["losses"][s_]) for s_ in (3, 4)}
        log("train_cli", compare="D (resumed) vs E (uninterrupted) at step 4", bitwise=bitwise,
            max_abs_diff=diff, param_cosine=cosine, loss_rel_diff_steps_3_4=loss_rel,
            tensors=len(want))
        if not bitwise and (cosine < TRAIN_CLI_MIN_COSINE
                            or max(loss_rel.values()) > TRAIN_CLI_LOSS_RTOL):
            raise AssertionError(f"[train_cli] resumed vs uninterrupted: cosine {cosine}, "
                                 f"loss differences {loss_rel}")
        del got, want, flat

        # eval of D, with and without the EMA weights.
        for ema in (False, True):
            argv = ["eval", "--model", "b16", "--ckpt-dir", d_dir, "--batch",
                    str(TRAIN_CLI_EVAL_BATCH), *(["--ema"] if ema else [])]
            run = run_cli(sa, ssl, argv)
            result = json.loads(run["out"].strip().splitlines()[-1].replace("'", '"'))
            expect = dict.fromkeys(run["counts"], 0)
            # The batch through both towers, then the 20 class prompts
            # through the text tower.
            expect["short_attention_fwd"] = layers + cfg.text.depth
            log("eval_cli", ema=ema, rc=run["rc"], seconds=run["seconds"], metrics=result,
                restored=[x for x in run["err"].splitlines() if x.startswith("restored")],
                launches={k: v for k, v in run["counts"].items() if v})
            which = "ema" if ema else "params"
            if run["rc"] != 0 or f"restored step 4 ({which})" not in run["err"] or not all(
                    np.isfinite(v) and 0.0 <= v <= 1.0 for v in result.values()):
                raise AssertionError(f"[eval_cli] ema={ema}: rc {run['rc']}, {run['err']!r}, "
                                     f"{result}")
            if run["counts"] != expect:
                raise AssertionError(f"[eval_cli] launches {run['counts']} != {expect}")
            totals = {k: totals[k] + v for k, v in run["counts"].items()}

        # Steps with and without an asynchronous save in flight, and one
        # synchronous save, on D's restored state (D and E then go, to keep
        # the disk to two checkpoints' size).
        model = SigLIP(cfg, device="cuda")
        state = create_train_state(model, make_optimizer(
            TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=10)), ema=True)
        t0 = time.monotonic()
        restore_latest(d_dir, state)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        shutil.rmtree(d_dir)
        shutil.rmtree(e_dir)
        step = make_train_step(model, LossConfig(variant="ring", precision="default",
                                                 use_pallas=True),
                               accum_steps=TRAIN_CLI_ACCUM, accum_dtype="bfloat16",
                               ema_decay=0.999)
        batch = random_batch(cfg, 256, torch.Generator(device="cuda").manual_seed(args.seed + 9))

        def timed_step() -> float:
            t = time.monotonic()
            _, m = step(state, batch)
            m["loss"].item()
            torch.cuda.synchronize()
            return 1e3 * (time.monotonic() - t)

        timed_step()
        quiet_ms = [timed_step() for _ in range(SAVE_IN_FLIGHT_STEPS)]
        with AsyncSaver() as saver:
            t0 = time.monotonic()
            saver.save(os.path.join(root, "F", "step_00000001"), state)
            stall_s = time.monotonic() - t0
            in_flight_ms = []
            while saver.pending and len(in_flight_ms) < 50:
                in_flight_ms.append(timed_step())
            saver.wait()
        t0 = time.monotonic()
        save_checkpoint(os.path.join(root, "F", "step_00000002"), state)
        sync_s = time.monotonic() - t0
        log("train_cli", measure="steps with and without a save in flight (B/16, 256 pairs, "
            "2 microbatches)", restore_s=restore_s, step_ms_no_save=quiet_ms,
            step_ms_save_in_flight=in_flight_ms, async_snapshot_stall_s=stall_s,
            async_write_s=saver.timings[-1]["write_s"], checkpoint_bytes=saver.timings[-1]["bytes"],
            sync_save_s=sync_s,
            bytes_on_disk=dir_bytes(os.path.join(root, "F", "step_00000002")))
        if not in_flight_ms:
            raise AssertionError("[train_cli] the asynchronous write ended before a step ran")
        shutil.rmtree(os.path.join(root, "F"))
        check_skip_rollback(state, step, batch, root)
        del state, step, model, batch
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log("train_cli", phase_seconds=time.monotonic() - t_phase, removed=[d_dir, e_dir])
    return totals


def check_skip_rollback(state, step, batch, root) -> None:
    """The resilient loop under ``--watchdog skip`` before the first
    checkpoint, on the B/16 train state: SKIP_LOOP_STEPS steps through
    ``train_resilient`` with ``on_divergence`` "halt" (no host copy) and
    "skip" (a host copy of the state before every step), the latter with a
    NaN batch at SKIP_POISON. Logs the steps' times from ``on_metrics``
    (the first apart: it allocates the pinned buffers), and raises unless
    the rollback gave back the pre-step state bit for bit, counters
    included, and the state stayed finite."""
    from distributed_sigmoid_loss_tpu_torch.train import train_resilient
    from distributed_sigmoid_loss_tpu_torch.train.checkpoint import state_tensors

    poisoned = {**batch, "images": batch["images"] * float("nan")}
    pre, rolled_back = {}, []

    def step_fn(st, b):
        if b is poisoned:
            pre.update(tensors={k: t.clone() for k, t in state_tensors(st).items()},
                       counters=(st.step, st.opt_state.count))
        elif pre and not rolled_back:
            rolled_back.append((st.step, st.opt_state.count) == pre["counters"] and all(
                torch.equal(t, pre["tensors"][k]) for k, t in state_tensors(st).items()))
            pre.clear()
        return step(st, b)

    for mode in ("halt", "skip"):
        batches = [poisoned if mode == "skip" and i == SKIP_POISON else batch
                   for i in range(SKIP_LOOP_STEPS)]
        stamps, losses = [time.monotonic()], {}
        counters = (state.step, state.opt_state.count)

        def on_metrics(s_, m):
            stamps.append(time.monotonic())
            losses[s_] = m["loss"].item()

        _, report = train_resilient(
            state, step_fn, batches, total_steps=SKIP_LOOP_STEPS,
            ckpt_dir=os.path.join(root, f"G_{mode}"), ckpt_every=SKIP_LOOP_STEPS,
            on_divergence=mode, on_metrics=on_metrics)
        shutil.rmtree(os.path.join(root, f"G_{mode}"), ignore_errors=True)
        ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        skipped = mode == "skip"
        advanced = (state.step - counters[0], state.opt_state.count - counters[1])
        finite = all(torch.isfinite(t).all() for t in state_tensors(state).values())
        if not skipped:
            log("train_cli", measure=f"{SKIP_LOOP_STEPS} steps through the resilient loop, "
                "no host copy (on_divergence=halt)", first_step_ms=ms[0], step_ms=ms[1:],
                losses=losses, report=dataclasses.asdict(report))
        else:
            # on_metrics runs at steps 1..SKIP_POISON, then SKIP_POISON + 2..: the
            # interval across the poisoned step holds it, its rollback and the next.
            log("train_cli", measure=f"{SKIP_LOOP_STEPS} steps under --watchdog skip before "
                f"the first checkpoint (a host copy before every step), NaN at step "
                f"{SKIP_POISON + 1}", first_step_ms=ms[0], step_ms=ms[1:SKIP_POISON],
                poisoned_rollback_and_next_step_ms=ms[SKIP_POISON:SKIP_POISON + 1],
                after_ms=ms[SKIP_POISON + 1:], rollback_bitwise=rolled_back,
                updates=advanced, losses=losses, report=dataclasses.asdict(report))
        want = dict(checkpoints=[SKIP_LOOP_STEPS], divergences=int(skipped),
                    updates=(SKIP_LOOP_STEPS - skipped,) * 2, finite=True,
                    rolled_back=[True] if skipped else [])
        got = dict(checkpoints=report.checkpoints, divergences=report.divergences,
                   updates=advanced, finite=finite, rolled_back=rolled_back)
        if got != want:
            raise AssertionError(f"[train_cli] the loop under {mode}: {got} != {want}")


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """(h, w, 3) uint8 RGB as an uncompressed 24-bit BMP (bottom-up rows,
    each padded to 4 bytes), written with ``struct``."""
    h, w, _ = rgb.shape
    stride = (24 * w + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    pixels = rows.tobytes()
    return (struct.pack("<2sIHHI", b"BM", 54 + len(pixels), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pixels), 2835, 2835, 0, 0)
            + pixels)


def write_bmp_shard(path: str, items) -> None:
    """A webdataset-style tar shard of ``(name, rgb, caption)`` items:
    ``name.bmp`` + ``name.txt`` members (the layout of the test suite's
    ``write_tar_shard``)."""
    with tarfile.open(path, "w") as tf:
        for name, rgb, caption in items:
            for member, data in ((f"{name}.bmp", bmp_bytes(rgb)),
                                 (f"{name}.txt", caption.encode())):
                info = tarfile.TarInfo(member)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def sinusoid_images(n: int, hw: tuple[int, int], rng):
    """The JAX package's ``make_synthetic_shards`` images: smooth random
    sinusoid mixes, uint8."""
    h, w = hw
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    for _ in range(n):
        f = rng.uniform(1.0, 6.0, (2, 3)).astype(np.float32)
        ph = rng.uniform(0.0, 6.28, (2, 3)).astype(np.float32)
        img = 63.75 * (2.0 + np.sin(6.28 * f[0] * yy + ph[0]) + np.sin(6.28 * f[1] * xx + ph[1]))
        yield np.clip(img, 0, 255).astype(np.uint8)


def train_lines(out: str) -> list[dict]:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def run_train_data_path(args, sa, ssl, per_microbatch: dict) -> dict:
    """Real image-text data through the commands (``[train_data]``); see the
    module docstring's phase 15. Returns the launches of every run."""
    from distributed_sigmoid_loss_tpu_torch.data import decode_and_resize
    from distributed_sigmoid_loss_tpu_torch.data.native_decode import native_decode_available

    t_phase = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "train_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = headline_config()
    layers = cfg.vision.depth + cfg.text.depth
    totals = {}

    def counted(run):
        for k, v in run["counts"].items():
            totals[k] = totals.get(k, 0) + v

    def expect_b16(steps, forwards):
        """The loss-kernel path's launches per microbatch (``[train_pallas]``)
        times the microbatches, plus K1 for each eval or retrieval forward."""
        expect = {k: round(v * TRAIN_DATA_ACCUM * steps) for k, v in per_microbatch.items()}
        expect["short_attention_fwd"] += forwards * layers
        return expect

    try:
        # 1. BMP tar shards, and decode_and_resize's rate at 224 px.
        rng = np.random.default_rng(args.seed + 16)
        t0 = time.monotonic()
        shards, first_blobs = [], []
        for s_, n in [(i, TRAIN_DATA_PAIRS) for i in range(TRAIN_DATA_SHARDS)] + [
                ("eval", TRAIN_DATA_BATCH)]:
            path = os.path.join(root, f"{'eval' if s_ == 'eval' else 'train'}-{s_}.tar")
            items = [(f"scene-{s_}-{i:04d}", img, f"synthetic scene {s_}-{i} hue {i % 11}")
                     for i, img in enumerate(sinusoid_images(n, TRAIN_DATA_HW, rng))]
            write_bmp_shard(path, items)
            shards.append(path)
            if not first_blobs:
                first_blobs = [bmp_bytes(img) for _, img, _ in items[:TRAIN_DATA_DECODE_TIMED]]
        write_s = time.monotonic() - t0
        decode_and_resize(first_blobs[0], 224)
        t0 = time.perf_counter()
        for blob in first_blobs:
            out = decode_and_resize(blob, 224)
        decode_s = time.perf_counter() - t0
        if out.shape != (224, 224, 3) or not (-1.0 <= out.min() <= out.max() <= 1.0):
            raise AssertionError(f"[train_data] decode_and_resize gave {out.shape}, "
                                 f"[{out.min()}, {out.max()}]")
        log("train_data", shards=[os.path.relpath(p, repo) for p in shards],
            bytes=sum(os.path.getsize(p) for p in shards), write_s=write_s,
            decode=f"BMP {TRAIN_DATA_HW[0]}x{TRAIN_DATA_HW[1]} -> 224 px, decode_and_resize on "
                   "one thread",
            decoded=len(first_blobs), decode_ms_per_image=1e3 * decode_s / len(first_blobs),
            decode_images_per_s=len(first_blobs) / decode_s, cpu_count=os.cpu_count())

        # 2. B/16 trained on the shards, an eval of the held-out shard every
        # 2 steps, then the closing retrieval on the stream's next batch.
        train_glob = os.path.join(root, "train-*.tar")
        argv = ["train", *TRAIN_DATA_FLAGS, "--steps", str(TRAIN_DATA_STEPS),
                "--data-shards", train_glob, "--shuffle-buffer", "64",
                "--eval-data", shards[-1], "--eval-every", str(TRAIN_DATA_EVAL_EVERY)]
        run = run_cli(sa, ssl, argv)
        lines = train_lines(run["out"])
        steps = [x for x in lines if "loss" in x]
        evals = [x for x in lines if "eval/i2t_recall@1" in x]
        expect = expect_b16(TRAIN_DATA_STEPS, len(evals) + 1)
        log("train_data", run="b16 on BMP shards", argv=" ".join(argv[1:]).replace(root + "/", ""),
            rc=run["rc"], seconds=run["seconds"],
            losses=[x["loss"] for x in steps], steps_per_sec=[x.get("steps_per_sec")
                                                              for x in steps],
            input_wait_frac=[x["input_wait_frac"] for x in steps], evals=evals,
            closing_retrieval=run["err"].strip().splitlines()[-1],
            launches={k: v for k, v in run["counts"].items() if v},
            expected={k: v for k, v in expect.items() if v})
        if run["rc"] != 0 or len(steps) != TRAIN_DATA_STEPS or len(evals) != 1 or not all(
                np.isfinite(x["loss"]) for x in steps):
            raise AssertionError(f"[train_data] b16 on BMP shards: rc {run['rc']}, {lines}, "
                                 f"{run['err'][-2000:]}")
        if run["counts"] != expect or any(run["counts"][k] == 0 for k in TRAIN_CLI_KERNELS):
            raise AssertionError(f"[train_data] launches {run['counts']} != {expect}")
        counted(run)

        # 3. The convergence oracle, its shards in BMP.
        orng = np.random.default_rng(7)
        train_items = []
        for _ in range(6):
            for name, color in zip(ORACLE_NAMES, ORACLE_COLORS):
                arr = np.clip(np.asarray(color)[None, None, :] + orng.integers(-12, 13, (16, 16, 3)),
                              0, 255).astype(np.uint8)
                train_items.append((f"t{len(train_items):04d}", arr, f"a {name} square"))
        oracle = os.path.join(root, "oracle")
        os.makedirs(oracle)
        write_bmp_shard(os.path.join(oracle, "train0.tar"), train_items[:48])
        write_bmp_shard(os.path.join(oracle, "train1.tar"), train_items[48:])
        write_bmp_shard(os.path.join(oracle, "eval.tar"),
                        [(f"e{i:02d}", np.full((16, 16, 3), c, np.uint8), f"a {n} square")
                         for i, (n, c) in enumerate(zip(ORACLE_NAMES, ORACLE_COLORS))])
        argv = ["train", "--tiny", "--steps", "80", "--batch", "16",
                "--data-shards", os.path.join(oracle, "train*.tar"), "--shuffle-buffer", "64",
                "--eval-every", "40", "--eval-data", os.path.join(oracle, "eval.tar"),
                "--lr", "3e-3", "--log-every", "40"]
        run = run_cli(sa, ssl, argv)
        evals = [x for x in train_lines(run["out"]) if "eval/i2t_recall@1" in x]
        log("train_data", run="convergence oracle (BMP shards, --tiny, 80 steps)", rc=run["rc"],
            seconds=run["seconds"], evals=evals, chance=1 / len(ORACLE_NAMES),
            launches={k: v for k, v in run["counts"].items() if v})
        if run["rc"] != 0 or [x["step"] for x in evals] != [40, 80] or min(
                evals[-1]["eval/i2t_recall@1"], evals[-1]["eval/t2i_recall@1"]) < ORACLE_MIN_RECALL:
            raise AssertionError(f"[train_data] convergence oracle: rc {run['rc']}, {evals}, "
                                 f"{run['err'][-2000:]}")
        counted(run)

        # 4. B/16 on the native synthetic engine.
        argv = ["train", *TRAIN_DATA_FLAGS, "--steps", str(TRAIN_DATA_NATIVE_STEPS),
                "--native-data"]
        run = run_cli(sa, ssl, argv)
        steps = [x for x in train_lines(run["out"]) if "loss" in x]
        expect = expect_b16(TRAIN_DATA_NATIVE_STEPS, 1)
        log("train_data", run="b16 --native-data", rc=run["rc"], seconds=run["seconds"],
            losses=[x["loss"] for x in steps],
            input_wait_frac=[x["input_wait_frac"] for x in steps],
            launches={k: v for k, v in run["counts"].items() if v})
        if (run["rc"] != 0 or "falling back to the numpy pipeline" in run["err"]
                or len(steps) != TRAIN_DATA_NATIVE_STEPS
                or not all(np.isfinite(x["loss"]) for x in steps)):
            raise AssertionError(f"[train_data] --native-data: rc {run['rc']}, "
                                 f"{run['err'][-2000:]}")
        if run["counts"] != expect:
            raise AssertionError(f"[train_data] --native-data launches {run['counts']} != "
                                 f"{expect}")
        counted(run)

        # 5. data-bench over the train shards.
        argv = ["data-bench", "--model", "b16", "--data-shards", train_glob, "--pil-decode"]
        run = run_cli(sa, ssl, argv)
        records = train_lines(run["out"])
        for rec in records:
            log("train_data", data_bench=rec)
        stages = {r.get("stage"): r for r in records if r["metric"] == "data_bench_stage"}
        if (run["rc"] != 0 or set(stages) != {"shard_read", "decode", "tokenize", "augment",
                                               "h2d_commit"}
                or stages["augment"]["device_kind"] != torch.cuda.get_device_name(0)
                or len(records) != 6):
            raise AssertionError(f"[train_data] data-bench: rc {run['rc']}, {records}, "
                                 f"{run['err'][-2000:]}")
        counted(run)

        # 6. libjpeg (and PIL) on this machine; where libjpeg is, the native
        # decoder on the committed JPEG fixture.
        import ctypes.util
        import importlib.util

        include_dirs = ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu")
        available = native_decode_available()
        log("train_data", native_decode_available=available,
            jpeglib_h=[d for d in include_dirs if os.path.exists(os.path.join(d, "jpeglib.h"))],
            libjpeg=ctypes.util.find_library("jpeg"),
            pil=importlib.util.find_spec("PIL") is not None)
        if available:
            argv = ["train", "--tiny", "--steps", "2", "--batch", "8",
                    "--data-shards", os.path.join(repo, JPEG_FIXTURE), "--native-decode"]
            run = run_cli(sa, ssl, argv)
            steps = [x for x in train_lines(run["out"]) if "loss" in x]
            log("train_data", run="--tiny --native-decode on the JPEG fixture", rc=run["rc"],
                seconds=run["seconds"], losses=[x["loss"] for x in steps])
            if (run["rc"] != 0 or "falling back to PIL decode" in run["err"]
                    or len(steps) != 2 or not all(np.isfinite(x["loss"]) for x in steps)):
                raise AssertionError(f"[train_data] --native-decode: rc {run['rc']}, "
                                     f"{run['err'][-2000:]}")
            counted(run)
        else:
            log("train_data", native_decode="libjpeg is not on this machine: the native "
                "decoder waits for it; JPEG needs PIL or libjpeg here")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log("train_data", phase_seconds=time.monotonic() - t_phase, removed=root)
    return totals


@contextlib.contextmanager
def serve_instrumented(near_ties: list):
    """While the block runs: every ``InferenceEngine`` made is collected
    (their ``calls`` are the tower calls), and every search of a sharded
    ``RetrievalRouter`` is answered again by its version's exact index on
    the host; a differing rank must be a near tie of the exact scores
    (``SERVE_BENCH_NEAR_TIE``), and ``near_ties`` gets one entry a search:
    how many ranks differed."""
    from distributed_sigmoid_loss_tpu_torch.serve.engine import InferenceEngine
    from distributed_sigmoid_loss_tpu_torch.serve.service import RetrievalRouter

    engines, init, search = [], InferenceEngine.__init__, RetrievalRouter.search

    def init_and_collect(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self)

    def search_and_check(self, queries, k=10, **kw):
        out = search(self, queries, k, **kw)
        version = self._current
        if self.tier == "sharded":
            q = np.atleast_2d(queries)
            ids = np.atleast_2d(out[1])
            exact_ids = version.exact.search(q, min(k, version.size))[1]
            differ = ids != exact_ids
            if differ.any():
                blocks, id_blocks, _ = version.exact._snapshot()
                corpus = np.concatenate(blocks)
                pos = {int(i): p for p, i in enumerate(np.concatenate(id_blocks))}
                for r in np.nonzero(differ.any(axis=1))[0]:
                    sims = corpus @ q[r]
                    got = sims[[pos[int(i)] for i in ids[r][differ[r]]]]
                    want = sims[[pos[int(i)] for i in exact_ids[r][differ[r]]]]
                    if np.abs(got - want).max() > SERVE_BENCH_NEAR_TIE:
                        raise AssertionError(f"[serve_bench] sharded ids {ids[r]} != exact "
                                             f"{exact_ids[r]} beyond a near tie: {got} vs {want}")
            near_ties.append(int(differ.sum()))
        return out

    InferenceEngine.__init__ = init_and_collect
    RetrievalRouter.search = search_and_check
    try:
        yield engines
    finally:
        InferenceEngine.__init__ = init
        RetrievalRouter.search = search


def check_sharded_index_at_scale(seed: int) -> dict:
    """``ShardedIndex`` on the card at SHARDED_AT_SCALE: a corpus of small
    integers in f32 (2 GiB at 1M × 512) made on the card and split into
    shards on cuda:0 there, planted exact ties (each of 32 queries copied
    into three rows on different shards, and 32 rows duplicated across
    shards), its ids and scores against the exact ``RetrievalIndex`` on the
    host, and its search time."""
    from distributed_sigmoid_loss_tpu_torch.serve import RetrievalIndex, ShardedIndex

    n, d, shards, nq, k = SHARDED_AT_SCALE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.monotonic()
    corpus = torch.randint(-4, 5, (n, d), generator=gen, device="cuda",
                           dtype=torch.int8).float()
    queries = torch.randint(-4, 5, (nq, d), generator=gen, device="cuda",
                            dtype=torch.int8).float()
    per = n // shards
    for j in range(32):
        for w, off in enumerate((11, 0, 5)):
            corpus[w * per + 97 * j + off] = queries[j]
        corpus[3 * per + 31 * j] = corpus[1000 + j]  # a tie of two corpus rows
    torch.cuda.synchronize()
    made_s = time.monotonic() - t0
    t0 = time.monotonic()
    index = ShardedIndex(corpus, devices=["cuda:0"] * shards, query_buckets=(nq,))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    host_corpus, host_q = corpus.cpu().numpy(), queries.cpu().numpy()
    del corpus
    scores, ids = index.search(host_q, k)  # the first search, off the clock
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        index.search(host_q, k)
        times.append(1e3 * (time.perf_counter() - t0))
    exact = RetrievalIndex()
    exact.add(host_corpus)
    t0 = time.perf_counter()
    want_scores, want_ids = exact.search(host_q, k)
    host_ms = 1e3 * (time.perf_counter() - t0)
    planted = [ids[j][:3].tolist() for j in range(32)]
    want_planted = [[97 * j + 11, per + 97 * j, 2 * per + 97 * j + 5] for j in range(32)]
    rec = {"rows": n, "dim": d, "shards": shards, "devices": ["cuda:0"] * shards,
           "queries": nq, "k": k, "corpus_bytes": n * d * 4, "made_s": made_s,
           "build_s": build_s, "search_ms": times, "search_ms_median": float(np.median(times)),
           "host_exact_search_ms": host_ms, "ids_equal": bool(np.array_equal(ids, want_ids)),
           "scores_equal": bool(np.array_equal(scores, want_scores)),
           "planted_ties_first_lower_id": planted == want_planted,
           "compile_count": index.compile_count}
    del index
    torch.cuda.empty_cache()
    log("serve_bench", sharded_at_scale=rec)
    if not (rec["ids_equal"] and rec["scores_equal"] and rec["planted_ties_first_lower_id"]):
        bad = np.nonzero((ids != want_ids).any(axis=1))[0][:4]
        raise AssertionError(f"[serve_bench] sharded index at scale != exact index: rows {bad}, "
                             f"{ids[bad]} vs {want_ids[bad]}")
    return rec


def run_serve_bench_path(args, sa, ssl) -> dict:
    """The serve-bench command at full B/16 width (``[serve_bench]``), each
    run between two reads of the counts; see the module docstring's phase
    16. Returns the launches of every run."""
    import urllib.request

    from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

    t_phase = time.monotonic()
    cfg = SigLIPConfig.b16()
    totals, near_ties, rows = {}, [], {}
    scraped = {}

    def scrape(err: io.StringIO, done: threading.Event):
        # One scrape of the live /metrics while the run serves.
        while not done.is_set():
            m = re.search(r"live /metrics at (\S+)", err.getvalue())
            if m:
                time.sleep(1.0)
                with urllib.request.urlopen(m.group(1), timeout=10) as resp:
                    scraped["status"] = resp.status
                    scraped["body"] = resp.read().decode()
                return
            done.wait(0.05)

    for name, extra in SERVE_BENCH_RUNS:
        argv = ["serve-bench", *SERVE_BENCH_FLAGS, "--seed", str(args.seed), *extra]
        out, err = io.StringIO(), io.StringIO()
        done = threading.Event()
        scraper = None
        if "--metrics-port" in extra:
            scraper = threading.Thread(target=scrape, args=(err, done), daemon=True)
            scraper.start()
        from distributed_sigmoid_loss_tpu_torch import cli

        torch.cuda.synchronize()
        reset_counts(sa, ssl)
        t0 = time.monotonic()
        with serve_instrumented(near_ties) as engines, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        counts = read_counts(sa, ssl)
        done.set()
        if scraper is not None:
            scraper.join(timeout=30)
        if rc != 0:
            raise AssertionError(f"[serve_bench] {name}: serve-bench exited {rc}: "
                                 f"{err.getvalue()[-3000:]}")
        record = json.loads(out.getvalue().strip().splitlines()[-1])
        calls = {kind: sum(e.calls.get(kind, 0) for e in engines) for kind in ("image", "text")}
        expect = dict.fromkeys(counts, 0)
        expect["short_attention_fwd"] = (cfg.vision.depth * calls["image"]
                                         + cfg.text.depth * calls["text"])
        for key, value in counts.items():
            totals[key] = totals.get(key, 0) + value
        row = {"seconds": seconds, "rc": rc, "metric": record["metric"],
               "tower_calls": calls, "launches": {k: v for k, v in counts.items() if v},
               "expected_k1": expect["short_attention_fwd"]}
        for key in ("qps", "latency_ms", "compile_count", "bucket_space", "shed_rate",
                    "recovery_time_s", "silent_drops", "swap_count", "swap_latency_ms",
                    "recall_at_k", "rerank_k", "shard_count", "search_stage_latency_ms",
                    "over_ceiling_samples", "restarts", "peak_admitted_rate", "ceiling_rate",
                    "value", "cache", "batch_size_hist", "stage_latency_ms", "warmup_s"):
            if key in record:
                row[key] = record[key]
        if "per_tenant" in record:
            row["per_tenant"] = {t: {k: v[k] for k in ("sent", "ok", "shed", "shed_rate",
                                                        "typed_errors", "p50_ms", "p99_ms")}
                                 for t, v in record["per_tenant"].items()}
        rows[name] = row
        log("serve_bench", run=name, argv=argv[1:], **row)
        if counts != expect:
            raise AssertionError(f"[serve_bench] {name}: launches {counts} != {expect} (12 of "
                                 "K1 per tower call, no other kernel)")
        if engines and not (record["compile_count"] == record["bucket_space"] == 8):
            raise AssertionError(f"[serve_bench] {name}: compile_count "
                                 f"{record['compile_count']} != the 8 warmed buckets")
        if record.get("silent_drops") or record.get("over_ceiling_samples"):
            raise AssertionError(f"[serve_bench] {name}: silent drops or over-ceiling samples")
        if name in ("exact", "sharded", "ann", "swap") and not calls["text"]:
            raise AssertionError(f"[serve_bench] {name}: no tower call reached the engine")
        if name == "sharded" and record["shard_count"] != 1:
            raise AssertionError("[serve_bench] sharded: --mesh on one card is one shard")
        if name in ("swap", "swapstorm") and not record["swap_count"]:
            raise AssertionError(f"[serve_bench] {name}: no swap ran")
        if name == "hostloss" and not (record["restarts"] >= 1 and record["recovery_time_s"] > 0):
            raise AssertionError("[serve_bench] hostloss: no measured recovery")
    if scraped.get("status") != 200 or "dsl_serve_qps" not in scraped.get("body", ""):
        raise AssertionError(f"[serve_bench] the /metrics scrape failed: {scraped}")
    body = scraped["body"]
    log("serve_bench", metrics_scrape_bytes=len(body), metrics_series=sum(
        1 for line in body.splitlines() if line and not line.startswith("#")),
        metrics_qps_line=next(line for line in body.splitlines()
                              if line.startswith("dsl_serve_qps")))
    sharded_searches = len(near_ties)
    log("serve_bench", sharded_searches_checked=sharded_searches,
        sharded_ids_identical=sum(1 for x in near_ties if x == 0),
        sharded_near_tie_ranks=sum(near_ties))
    if not sharded_searches:
        raise AssertionError("[serve_bench] no sharded search was checked against the exact tier")
    at_scale = check_sharded_index_at_scale(args.seed + 17)
    seconds = time.monotonic() - t_phase
    log("serve_bench", seconds=seconds, runs={k: v["seconds"] for k, v in rows.items()},
        sharded_at_scale_search_ms=at_scale["search_ms_median"])
    return totals


def global_norm_of(tensors) -> float:
    return float(torch.sqrt(sum(t.float().square().sum() for t in tensors)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda
    from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa
    from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa
    from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl

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
        PTXAS.update(ptxas_usage(info["log"]))
        log("build", library=lib, seconds=info["seconds"], ptxas=ptxas_usage(info["log"]),
            wgmma_serialized=wgmma_serialized(info["log"]))
    log("build", seconds=time.monotonic() - t0, built=sorted(built))
    # K2's warpgroup kernels keep their wgmma chains asynchronous and spill
    # nothing (a spilling consumer corrupted a result in mid-wgmma before).
    if "short_attention_bwd" in built:
        k2_log = built["short_attention_bwd"]["log"]
        usage = ptxas_usage(k2_log)
        wg = {k: u for k, u in usage.items() if "_wgmma_kernel" in k}
        serialized = [k for k in wgmma_serialized(k2_log) if "_wgmma_kernel" in k]
        log("build", library="short_attention_bwd", wgmma_kernels=wg,
            wgmma_serialized=serialized)
        if len(wg) != 4 or serialized or any("spill 0 B" not in u for u in wg.values()):
            raise AssertionError(f"K2's warpgroup kernels spill or serialise: {wg}, {serialized}")
    # K3's warpgroup body (three instantiations: N = 64, 208, 256) likewise;
    # its mma.sync kernels are reported as they are.
    if "short_attention_bwd_batched" in built:
        k3_log = built["short_attention_bwd_batched"]["log"]
        usage = ptxas_usage(k3_log)
        wg = {k: u for k, u in usage.items() if "_wgmma_kernel" in k}
        mma_sync = {k: u for k, u in usage.items()
                    if k.startswith("short_attention_bwd_batched") and k not in wg}
        serialized = [k for k in wgmma_serialized(k3_log) if "_wgmma_kernel" in k]
        log("build", library="short_attention_bwd_batched", wgmma_kernels=wg,
            wgmma_serialized=serialized, mma_sync_kernels=mma_sync)
        if len(wg) != 3 or serialized or any("spill 0 B" not in u for u in wg.values()):
            raise AssertionError(f"K3's warpgroup kernels spill or serialise: {wg}, {serialized}")
    # The f32 kernels' split-f32 products: the backward's (eight
    # instantiations each of dK/dV and dQ, one per 16 head-dim columns) and
    # the forward's (eight: one per 32 head-dim columns, at one and at two
    # warpgroups a block) spill nothing, and the forward's wgmma stay
    # asynchronous.
    if "attention_f32" in built:
        f32_log = built["attention_f32"]["log"]
        usage = ptxas_usage(f32_log)
        bwd = {k: u for k, u in usage.items()
               if k.startswith(("attention_f32_dkv_kernel", "attention_f32_dq_kernel"))}
        fwd = {k: u for k, u in usage.items() if k.startswith("attention_f32_fwd_kernel")}
        serialized = [k for k in wgmma_serialized(f32_log) if k.startswith("attention_f32")]
        log("build", library="attention_f32", bwd_kernels=bwd, fwd_kernels=fwd,
            wgmma_serialized=serialized)
        if len(bwd) != 16 or any("spill 0 B" not in u for u in bwd.values()):
            raise AssertionError(f"the f32 backward kernels spill: {bwd}")
        if len(fwd) != 8 or any("spill 0 B" not in u for u in fwd.values()) or serialized:
            raise AssertionError(f"the f32 forward kernels spill or serialise their wgmma: "
                                 f"{fwd}, {serialized}")
    # K5/K6 (four instantiations: image/text side, f32/int8) hold their
    # gradient rows in registers, K4 (three: f32 with 16- and 4-byte copies,
    # int8) its logits: nothing may spill, and every wgmma stays
    # asynchronous.
    if "sigmoid_loss" in built:
        loss_log = built["sigmoid_loss"]["log"]
        usage = ptxas_usage(loss_log)
        bwd = {k: u for k, u in usage.items() if k.startswith("sigmoid_loss_bwd_kernel")}
        fwd = {k: u for k, u in usage.items() if k.startswith("sigmoid_loss_fwd_kernel")}
        serialized = [k for k in wgmma_serialized(loss_log)
                      if k.startswith(("sigmoid_loss_bwd_kernel", "sigmoid_loss_fwd_kernel"))]
        log("build", library="sigmoid_loss", bwd_kernels=bwd, fwd_kernels=fwd,
            wgmma_serialized=serialized)
        if len(bwd) != 4 or any("spill 0 B" not in u for u in bwd.values()):
            raise AssertionError(f"the K5/K6 kernels spill: {bwd}")
        if len(fwd) != 3 or any("spill 0 B" not in u for u in fwd.values()) or serialized:
            raise AssertionError(f"the K4 kernels spill or serialise their wgmma: {fwd}, "
                                 f"{serialized}")
    for lib, mirror in (("short_attention", sa.short_attention_smem_bytes),
                        ("short_attention_bwd", sa.short_attention_bwd_smem_bytes),
                        ("short_attention_bwd_batched", sa.short_attention_bwd_batched_smem_bytes)):
        smem = getattr(sa._library(lib), f"{lib}_smem_bytes")(196, 64)
        if smem != mirror(196, 64):
            raise AssertionError(f"{lib} smem {smem} != python mirror {mirror(196, 64)}")
    k2_lib = sa._library("short_attention_bwd")
    for s_, dh, vec in ((1, 64, 1), (64, 64, 1), (65, 64, 1), (196, 64, 1), (200, 64, 1),
                        (256, 64, 1), (257, 64, 1), (196, 64, 0), (256, 72, 1), (50, 20, 0)):
        if k2_lib.short_attention_bwd_body(s_, dh, vec) != sa.short_attention_bwd_body(s_, dh, vec) \
                or any(k2_lib.short_attention_bwd_wgmma_smem_bytes(s_, i) !=
                       sa.short_attention_bwd_wgmma_smem_bytes(s_, which)
                       for i, which in enumerate(("dq", "dkdv"))):
            raise AssertionError(f"K2 body or smem at s={s_}, dh={dh}, vec={vec} != python mirror")
    k3_lib = sa._library("short_attention_bwd_batched")
    for s_, dh in ((64, 64), (225, 64), (250, 64), (212, 64), (208, 72), (196, 128), (272, 8)):
        if k3_lib.short_attention_bwd_batched_smem_bytes(s_, dh) != \
                sa.short_attention_bwd_batched_smem_bytes(s_, dh):
            raise AssertionError(f"K3 smem at s={s_}, dh={dh} != python mirror")
    for s_ in (1, 50, 64, 65, 77, 196, 208, 209, 250, 256, 257):
        for dh, vec in ((64, 1), (64, 0), (72, 1), (20, 0)):
            if k3_lib.short_attention_bwd_batched_body(s_, dh, vec) != \
                    sa.short_attention_bwd_batched_body(s_, dh, vec):
                raise AssertionError(f"K3 body at s={s_}, dh={dh}, vec={vec} != python mirror")
        if k3_lib.short_attention_bwd_batched_wgmma_smem_bytes(s_) != \
                sa.short_attention_bwd_batched_wgmma_smem_bytes(s_):
            raise AssertionError(f"K3 warpgroup smem at s={s_} != python mirror")
    from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af

    for dh in (8, 64, 72, 128):
        for which in range(3):
            for s_ in (64, 196):
                if af._library().attention_f32_smem_bytes(dh, which, s_) != \
                        af.smem_bytes(dh, which, s_):
                    raise AssertionError(f"attention_f32 smem at dh={dh}, s={s_}, pass {which} "
                                         "!= mirror")
    for dh in (64, 72, 128):
        if fa._library("flash_attention").flash_attention_fwd_smem_bytes(dh) != \
                fa.flash_attention_smem_bytes(dh) or any(
                    fa._library("flash_attention_bwd").flash_attention_bwd_smem_bytes(dh, i) !=
                    fa.flash_attention_bwd_smem_bytes(dh, which)
                    for i, which in enumerate(("dkv", "dq"))):
            raise AssertionError(f"flash_attention smem at dh={dh} != python mirror")
    loss_lib = ssl._library()
    for d in (200, 512, 1152, 2000):
        if loss_lib.sigmoid_loss_bwd_smem_bytes(d) != ssl.bwd_smem_bytes(d):
            raise AssertionError(f"sigmoid_loss smem at d={d} != python mirror")
    if loss_lib.sigmoid_loss_fwd_partials(100, 300) != ssl.fwd_partials(100, 300):
        raise AssertionError("sigmoid_loss partial count != python mirror")
    for q in (0, 1):
        if loss_lib.sigmoid_loss_fwd_smem_bytes(q) != ssl.fwd_smem_bytes(bool(q)):
            raise AssertionError(f"sigmoid_loss K4 smem (int8 {q}) != python mirror")

    # Phase 3: each kernel against its plain version.
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = check_short_attention(sa, gen)
    k2 = check_short_attention_bwd(sa, gen)
    k3 = check_short_attention_bwd_batched(sa, gen)
    loss_recs = check_loss_kernels(ssl, gen)
    check_loss_kernels_nan(ssl)
    flash_recs = check_flash_attention(fa, gen)
    f32_recs = check_f32_attention(sa, fa, gen)
    int8_recs = check_loss_kernels_int8(ssl, gen)

    # Phases 4-16: the main paths, each between two reads of the counts.
    paths, seconds = {}, {}
    for path, run in (("serve", lambda: run_serve_path(args, sa, ssl, fa, SERVE)),
                      ("train", lambda: run_train_path(args, sa, ssl, fa, TRAIN)),
                      ("rank_view", lambda: run_rank_view(ssl, sa, gen)),
                      ("train_pallas", lambda: run_train_pallas_path(args, sa, ssl, fa)),
                      ("train_recipes", lambda: run_train_recipes_path(args, sa, ssl)),
                      ("serve_512", lambda: run_serve_path(args, sa, ssl, fa, SERVE_512)),
                      ("train_512", lambda: run_train_path(args, sa, ssl, fa, TRAIN_512)),
                      ("context", lambda: run_context(sa, ssl, fa)),
                      ("f32_tower", lambda: run_f32_tower_path(args, sa, ssl, fa)),
                      ("serve_int8", lambda: run_serve_path(args, sa, ssl, fa, SERVE_INT8)),
                      ("train_int8", lambda: run_train_pallas_path(args, sa, ssl, fa, "int8")),
                      ("compat", lambda: run_compat(sa, ssl, gen)),
                      ("train_cli", lambda: run_train_cli_path(args, sa, ssl, {
                          k: v / (ACCUM * TRAIN_PALLAS_STEPS)
                          for k, v in paths["train_pallas"].items()})),
                      ("train_data", lambda: run_train_data_path(args, sa, ssl, {
                          k: v / (ACCUM * TRAIN_PALLAS_STEPS)
                          for k, v in paths["train_pallas"].items()})),
                      ("serve_bench", lambda: run_serve_bench_path(args, sa, ssl))):
        t0 = time.monotonic()
        paths[path] = run()
        seconds[path] = time.monotonic() - t0
    log("paths", seconds=seconds, launches=paths)

    # Phase 17: the records.
    source = "distributed_sigmoid_loss_tpu_torch/csrc/"
    attn = "distributed_sigmoid_loss_tpu/ops/pallas_short_attention.py:"
    loss = "distributed_sigmoid_loss_tpu/ops/pallas_sigmoid_loss.py:"

    def launches(kernel):
        # The attention roles' counters also count the f32 kernels' calls in
        # those roles. [f32_tower] is the one path in f32, and its check held
        # the role counts and attention_f32's own counts to one expectation,
        # so no bf16 kernel ran there: its role counts are not theirs.
        f32_role = kernel.startswith(("short_attention", "flash_attention"))
        by_path = {p: 0 if f32_role and p == "f32_tower" else c[kernel]
                   for p, c in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def timed(rec):
        return {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    attn_shape = "b=128 s=196 h=12 dh=64 bf16"
    b, n, d = LOSS_CASES[LOSS_TIMED][:3]
    loss_shape = f"b={b} n={n} d={d} f32"
    kernels = [
        {"name": "short_attention_fwd", "route": "cuda", "source": source + "short_attention.cu",
         "replaces": attn + "257", **launches("short_attention_fwd"),
         "max_abs_err": k1["max_abs_err"], **timed(k1), "shape": attn_shape},
        {"name": "short_attention_bwd", "route": "cuda",
         "source": source + "short_attention_bwd.cu", "replaces": attn + "278",
         **launches("short_attention_bwd"), "max_abs_err": max(k2["max_abs_err"].values()),
         **timed(k2), "device_ms": k2["device_ms"], "library_device_ms": k2["library_device_ms"],
         "body": k2["body"], "text": k2["text"], "shape": attn_shape},
        {"name": "short_attention_bwd_batched", "route": "cuda",
         "source": source + "short_attention_bwd_batched.cu", "replaces": attn + "185",
         **launches("short_attention_bwd_batched_wgmma"),
         "max_abs_err": max(k3["max_abs_err"].values()), **timed(k3), "k2_ms": k3["k2_ms"],
         **{k: k3[k] for k in ("device_ms", "k2_device_ms", "library_device_ms",
                               "bound_over_device", "body", "registers") if k in k3},
         "text": k3["text"], "s250": {k: k3["long"][k] for k in (
             "ms", "k2_ms", "plain_ms", "library_ms", "device_ms", "k2_device_ms",
             "bound_ms", "bound_by", "bound_over_device") if k in k3["long"]},
         "shape": attn_shape + " (the warpgroup body; text: s=64; s250: b=32 s=250)"},
    ]
    # K3's mma.sync kernels, at the shapes that still take them; the
    # two-array kernel's launches are K3's that took neither other kernel.
    for kernel, rec in k3["mma_sync"].items():
        if kernel.endswith("_in_place"):
            counted = launches(kernel)
        else:
            total, wg, in_place = (launches("short_attention_bwd_batched" + x)["launches_by_path"]
                                   for x in ("", "_wgmma", "_in_place"))
            by_path = {p: total[p] - wg[p] - in_place[p] for p in total}
            counted = {"launches": sum(by_path.values()), "launches_by_path": by_path}
        b, s, h, dh = rec["shape"]
        kernels.append({"name": kernel, "route": "cuda",
                        "source": source + "short_attention_bwd_batched.cu",
                        "replaces": attn + "185", **counted,
                        "max_abs_err": max(rec["max_abs_err"].values()), **timed(rec),
                        "k2_ms": rec["k2_ms"],
                        **{k: rec[k] for k in ("device_ms", "k2_device_ms", "bound_over_device",
                                               "body", "registers") if k in rec},
                        "library_call": "SDPA backward in bf16",
                        "shape": f"b={b} s={s} h={h} dh={dh} bf16"})
    for kernel, which, line in (("sigmoid_loss_fwd", "fwd", "429"),
                                ("sigmoid_loss_bwd_img", "bwd_img", "462"),
                                ("sigmoid_loss_bwd_txt", "bwd_txt", "485")):
        rec = loss_recs[which]
        kernels.append({"name": kernel, "route": "cuda", "source": source + "sigmoid_loss.cu",
                        "replaces": loss + line, **launches(kernel),
                        "max_abs_err": rec["max_abs_err"], **timed(rec),
                        "device_ms": rec["device_ms"], "library_call": rec["library_call"],
                        **{k: rec[k] for k in ("bound_cuda_core_ms", "bound_tensor_core_ms",
                                               "bound_over_device", "body") if k in rec},
                        "shape": loss_shape})
    b, s, h, dh = FLASH_CASES[FLASH_TIMED][:4]
    flash = "distributed_sigmoid_loss_tpu/ops/flash_attention.py:110"
    for kernel, which, src in (("flash_attention_fwd", "fwd", "flash_attention.cu"),
                               ("flash_attention_bwd_dkv", "bwd_dkv", "flash_attention_bwd.cu"),
                               ("flash_attention_bwd_dq", "bwd_dq", "flash_attention_bwd.cu")):
        rec = flash_recs[which]
        kernels.append({"name": kernel, "route": "cuda", "source": source + src,
                        "replaces": flash, **launches(kernel), "max_abs_err": rec["max_abs_err"],
                        **timed(rec), "device_ms": rec["device_ms"],
                        "library_device_ms": rec["library_device_ms"],
                        "library_call": rec["library_call"], "body": rec["body"],
                        **({"pair_bound_ms": rec["pair_bound_ms"]} if which != "fwd" else {}),
                        "shape": f"b={b} s={s} h={h} dh={dh} bf16"})
    for kernel, which, line in (("sigmoid_loss_fwd_int8", "fwd", "148 (in :429)"),
                                ("sigmoid_loss_bwd_img_int8", "bwd_img", "148 (in :462)"),
                                ("sigmoid_loss_bwd_txt_int8", "bwd_txt", "148 (in :485)")):
        rec = int8_recs[which]
        kernels.append({"name": kernel, "route": "cuda", "source": source + "sigmoid_loss.cu",
                        "replaces": loss + line, **launches(kernel),
                        "max_abs_err": rec["max_abs_err"], **timed(rec),
                        "device_ms": rec["device_ms"], "library_call": rec["library_call"],
                        **{k: rec[k] for k in ("kernel_device_ms", "quantize_device_ms",
                                               "bound_over_device", "body") if k in rec},
                        "shape": loss_shape.replace("f32", "int8")})
    # The f32 kernels play K1/K7 (forward) and K2/K3/K7 (backward), each
    # counted at its own launch.
    b, s, h, dh = F32_ATTENTION_CASES["vision"]
    for which, roles in (("fwd", attn + "257 (K1), " + flash + " (K7)"),
                         ("bwd_dkv", attn + "278/185 (K2/K3), " + flash + " (K7 dkv)"),
                         ("bwd_dq", attn + "278/185 (K2/K3), " + flash + " (K7 dq)")):
        rec = f32_recs[which]
        kernels.append({"name": f"attention_f32_{which}", "route": "cuda",
                        "source": source + "attention_f32.cu", "replaces": roles,
                        **launches(f"attention_f32_{which}"),
                        "max_abs_err": rec["max_abs_err"], **timed(rec),
                        "device_ms": rec["device_ms"], "library_call": rec["library_call"],
                        **{k: rec[k] for k in (
                            "pair_bound_ms", "pair_ms", "pair_device_ms", "role_ms",
                            "role_bound_ms", "bound_cuda_core_ms", "bound_tensor_core_ms",
                            "bound_over_device", "body") if k in rec},
                        **({"k7_role": f32_recs["k7_role"]} if which == "bwd_dq" else {}),
                        "shape": f"b={b} s={s} h={h} dh={dh} f32 (max_abs_err: of the "
                                 "largest magnitude)"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
