#!/usr/bin/env python3
"""Time the f32 attention backward pair of this checkout
(``distributed_sigmoid_loss_tpu_torch/csrc/attention_f32.cu``) beside
another version of the same source, on one NVIDIA GPU, in one process.

    python3 compare_attention_f32.py --other-source PATH/attention_f32.cu

Builds PATH with the port's nvcc flags into ``build/`` (the source must keep
the C entry points ``attention_f32_bwd_dkv`` and ``attention_f32_bwd_dq``),
then at B/16 vision in f32 (b=128, s=196, h=12, dh=64) and in K7's role
(b=32, s=1,024, h=12, dh=64) runs both versions' pair (the di pass with
dK/dV, then dQ) from one forward's output and statistics, holds each output
against the plain versions (TF32 off) as a share of its largest magnitude,
and times, by CUDA events, the other version, this checkout, this checkout
again and the other again, then SDPA's f32 backward on the same inputs.
Prints the card (``nvidia-smi``) and one JSON line per shape. Without CUDA
it exits non-zero.
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

from chip_smoke import time_ms

SHAPES = {"vision": (128, 196, 12, 64), "k7_role": (32, 1024, 12, 64)}


def load_other(path: Path) -> ctypes.CDLL:
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda

    lib, _ = _cuda.build_other(path, "attention_f32")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attention_f32_bwd_dkv.argtypes = [p] * 9 + [i, i, i, i, f, i, p]
    lib.attention_f32_bwd_dq.argtypes = [p] * 7 + [i, i, i, i, f, i, p]
    lib.attention_f32_bwd_dkv.restype = lib.attention_f32_bwd_dq.restype = i
    return lib


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
        out, stats = af.launch_fwd(q, k, v, False, scale, with_stats=True)
        ref = fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, False, scale, fa.BLOCK_K)
        row = {"shape": name, "b_s_h_dh": [b, s, h, dh]}
        for which, lib in libs.items():
            got = pair(lib, q, k, v, out, do, stats, scale)
            torch.cuda.synchronize()
            row[f"{which}_max_err_of_max"] = max(
                ((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref))
        runs = {which: (lambda lib=lib: pair(lib, q, k, v, out, do, stats, scale))
                for which, lib in libs.items()}
        order = ("other", "checkout", "checkout", "other")
        times = [time_ms(runs[which], iters=10) for which in order]
        row["pair_ms_in_turns"] = [[w, t] for w, t in zip(order, times)]
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        dout = do.transpose(1, 2)
        row["sdpa_f32_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True), iters=10)
        print(json.dumps(row), flush=True)
        del q, k, v, do, out, stats, ref, leaves, sdpa_out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
