#!/usr/bin/env python3
"""Time the f32 attention kernels of this checkout
(``distributed_sigmoid_loss_tpu_torch/csrc/attention_f32.cu``) beside
another version of the same source, on one NVIDIA GPU, in one process.

    python3 compare_attention_f32.py --other-source PATH/attention_f32.cu

Builds PATH (an earlier commit's source beside its headers, or an edited
copy of this checkout's) with the port's nvcc flags into ``build/`` (the
source must keep the C entry points ``attention_f32_fwd``,
``attention_f32_bwd_dkv`` and ``attention_f32_bwd_dq``), then at B/16
vision in f32 (b=128, s=196, h=12, dh=64), at B/16 text (b=128, s=64) and
in K7's role (b=32, s=1,024, h=12, dh=64):

- the forward (with its statistics, as the K7 and K2/K3 roles call it):
  each version's output held against the plain version (TF32 off) as a
  share of its largest magnitude, then timed by CUDA events (and device
  time) in the order other, this checkout, this checkout, other, then
  SDPA's f32 forward on the same inputs;
- the backward pair (the di pass with dK/dV, then dQ) from one forward's
  output and statistics: each version's outputs held the same way, timed
  in the same order, then SDPA's f32 backward.

Prints the card (``nvidia-smi``) and one JSON line per shape. Exits
non-zero without CUDA, and after the shape's line when either version's
forward or pair is off its plain version by more than ``F32_RTOL_OF_MAX``
of the largest magnitude or not bitwise repeatable.
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

from chip_smoke import F32_RTOL_OF_MAX, device_ms, time_ms

SHAPES = {"vision": (128, 196, 12, 64), "text": (128, 64, 12, 64),
          "k7_role": (32, 1024, 12, 64)}
ORDER = ("other", "checkout", "checkout", "other")


def load_other(path: Path) -> ctypes.CDLL:
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda

    lib, _ = _cuda.build_other(path, "attention_f32")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attention_f32_fwd.argtypes = [p] * 5 + [i, i, i, i, f, i, p]
    lib.attention_f32_bwd_dkv.argtypes = [p] * 9 + [i, i, i, i, f, i, p]
    lib.attention_f32_bwd_dq.argtypes = [p] * 7 + [i, i, i, i, f, i, p]
    lib.attention_f32_fwd.restype = i
    lib.attention_f32_bwd_dkv.restype = lib.attention_f32_bwd_dq.restype = i
    return lib


def forward(lib, q, k, v, scale):
    """The forward with its statistics through one library's C entry point."""
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    stats = torch.empty((b, h, 2, s), dtype=torch.float32, device=q.device)
    err = lib.attention_f32_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                stats.data_ptr(), b, s, h, dh, scale, 0,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out, stats


def pair(lib, q, k, v, out, do, stats, scale):
    """dK/dV (with di), then dQ, through one library's C entry points."""
    b, s, h, dh = q.shape
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.attention_f32_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    do.data_ptr(), stats.data_ptr(), di.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), b, s, h, dh, scale, 0, stream)
    err = err or lib.attention_f32_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                          stats.data_ptr(), di.data_ptr(), dq.data_ptr(), b, s, h,
                                          dh, scale, 0, stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return dq, dk, dv


def err_of_max(got, ref) -> float:
    return max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref))


def in_turns(runs) -> list:
    """``[[version, ms, device_ms], ...]`` in ORDER."""
    return [[w, time_ms(runs[w], iters=10), device_ms(runs[w])] for w in ORDER]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-source", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_attention_f32: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_sigmoid_loss_tpu_torch.ops import attention_f32 as af
    from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {"checkout": af._library(), "other": load_other(args.other_source)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, s, h, dh) in SHAPES.items():
        q, k, v, do = (torch.randn(b, s, h, dh, device="cuda", generator=gen) for _ in range(4))
        scale = dh ** -0.5
        row = {"shape": name, "b_s_h_dh": [b, s, h, dh]}
        fwd_ref = fa.flash_self_attention_plain(q, k, v, False, scale, fa.BLOCK_K)
        for which, lib in libs.items():
            got, again = forward(lib, q, k, v, scale), forward(lib, q, k, v, scale)
            torch.cuda.synchronize()
            row[f"{which}_fwd_out_err_of_max"] = err_of_max(got[:1], fwd_ref[:1])
            row[f"{which}_fwd_repeatable"] = all(torch.equal(a, c) for a, c in zip(got, again))
        row["fwd_ms_in_turns"] = in_turns(
            {w: (lambda lib=lib: forward(lib, q, k, v, scale)) for w, lib in libs.items()})
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa_fwd = lambda: F.scaled_dot_product_attention(*leaves)  # noqa: E731
        row["sdpa_f32_fwd_ms"] = [time_ms(sdpa_fwd, iters=10), device_ms(sdpa_fwd)]

        out, stats = af.launch_fwd(q, k, v, False, scale, with_stats=True)
        ref = fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, False, scale, fa.BLOCK_K)
        for which, lib in libs.items():
            got = pair(lib, q, k, v, out, do, stats, scale)
            again = pair(lib, q, k, v, out, do, stats, scale)
            torch.cuda.synchronize()
            row[f"{which}_max_err_of_max"] = err_of_max(got, ref)
            row[f"{which}_pair_repeatable"] = all(torch.equal(a, c) for a, c in zip(got, again))
        row["pair_ms_in_turns"] = in_turns(
            {w: (lambda lib=lib: pair(lib, q, k, v, out, do, stats, scale))
             for w, lib in libs.items()})
        sdpa_out = sdpa_fwd()
        dout = do.transpose(1, 2)
        row["sdpa_f32_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True), iters=10)
        print(json.dumps(row), flush=True)
        bad = [key for key, x in row.items()
               if (key.endswith("err_of_max") and not x <= F32_RTOL_OF_MAX)
               or (key.endswith("repeatable") and not x)]
        if bad:
            print(f"compare_attention_f32: {name}: {bad} off the plain versions or not "
                  "repeatable", file=sys.stderr)
            return 1
        del q, k, v, do, out, stats, ref, fwd_ref, leaves, sdpa_out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
