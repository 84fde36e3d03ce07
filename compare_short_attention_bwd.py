#!/usr/bin/env python3
"""Time K3, the head-batched short-attention backward of this checkout
(``distributed_sigmoid_loss_tpu_torch/csrc/short_attention_bwd_batched.cu``),
beside another version of the same source, on one NVIDIA GPU, in one
process.

    python3 compare_short_attention_bwd.py --other-source PATH/short_attention_bwd_batched.cu

Builds PATH (an earlier commit's source beside its headers, or an edited
copy of this checkout's) with the port's nvcc flags into ``build/`` (the
source must keep the C entry point ``short_attention_bwd_batched``), then
in bf16 at B/16 vision (b=128, s=196, h=12, dh=64), B/16 text (b=128,
s=64), s = 250 at width 768 (b=32) and s = 212 at width 1,024 (b=16, h=16):

- each version's dq, dk and dv held against the plain version
  (``short_self_attention_bwd_batched_plain``) within ``K3_ULPS`` bf16 ulps
  of each gradient's largest magnitude, and run twice for bitwise
  repeatability;
- both timed by CUDA events (and device time) in the order other, this
  checkout, this checkout, other;
- then K2 (``batch_heads=False``: its warpgroup body at these shapes) and
  SDPA's backward on the same inputs.

Prints the card (``nvidia-smi``) and one JSON line per shape. Exits
non-zero without CUDA, and after the shape's line when either version is
off its plain version or not bitwise repeatable.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from chip_smoke import K3_ULPS, bf16_ulp, device_ms, time_ms

SHAPES = {"vision": (128, 196, 12, 64), "text": (128, 64, 12, 64),
          "s250_w768": (32, 250, 12, 64), "s212_w1024": (16, 212, 16, 64)}
ORDER = ("other", "checkout", "checkout", "other")


def load_other(path: Path) -> ctypes.CDLL:
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda

    lib, _ = _cuda.build_other(path, "short_attention_bwd_batched")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.short_attention_bwd_batched.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_float, i, i, p]
    lib.short_attention_bwd_batched.restype = i
    return lib


def backward(lib, q, k, v, do):
    """(dq, dk, dv) through one library's C entry point (16-byte rows)."""
    b, s, h, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    err = lib.short_attention_bwd_batched(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, h, dh, dh ** -0.5, 0, 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return dq, dk, dv


def in_turns(runs) -> list:
    """``[[version, ms, device_ms], ...]`` in ORDER."""
    return [[w, time_ms(runs[w], iters=10), device_ms(runs[w])] for w in ORDER]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-source", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_short_attention_bwd: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {"checkout": sa._library("short_attention_bwd_batched"),
            "other": load_other(args.other_source)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, s, h, dh) in SHAPES.items():
        q, k, v, do = (torch.randn(b, s, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        row = {"shape": name, "b_s_h_dh": [b, s, h, dh],
               "checkout_body": sa.short_attention_bwd_batched_body(s, dh)}
        ref = sa.short_self_attention_bwd_batched_plain(q, k, v, do)
        tols = [K3_ULPS * bf16_ulp(r) for r in ref]
        for which, lib in libs.items():
            got, again = backward(lib, q, k, v, do), backward(lib, q, k, v, do)
            torch.cuda.synchronize()
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
            row[f"{which}_max_abs_err"] = errs
            row[f"{which}_within_ulps"] = all(e <= t for e, t in zip(errs, tols))
            row[f"{which}_repeatable"] = all(torch.equal(a, c) for a, c in zip(got, again))
        row["atol"] = tols
        row["ms_in_turns"] = in_turns(
            {w: (lambda lib=lib: backward(lib, q, k, v, do)) for w, lib in libs.items()})

        def k2():
            return sa.short_self_attention_bwd(q, k, v, do, batch_heads=False)

        row["k2_ms"] = [time_ms(k2, iters=10), device_ms(k2)]
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        dout = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)

        row["sdpa_bwd_ms"] = [time_ms(sdpa_bwd, iters=10), device_ms(sdpa_bwd)]
        print(json.dumps(row), flush=True)
        bad = [key for key, x in row.items()
               if key.endswith(("within_ulps", "repeatable")) and not x]
        if bad:
            print(f"compare_short_attention_bwd: {name}: {bad}", file=sys.stderr)
            return 1
        del q, k, v, do, ref, leaves, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
