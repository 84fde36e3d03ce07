#!/usr/bin/env python3
"""Time the sigmoid-loss backward pair (K5 and K6, in both modes) of this
checkout (``distributed_sigmoid_loss_tpu_torch/csrc/sigmoid_loss.cu``)
beside another version of the same source, on one NVIDIA GPU, in one
process.

    python3 compare_sigmoid_loss.py --other-source PATH/sigmoid_loss.cu

Builds PATH with the port's nvcc flags into ``build/`` (the source must keep
the C entry points ``sigmoid_loss_bwd_img``, ``_bwd_txt``, their ``_int8``
forms and ``sigmoid_loss_bwd_scratch_floats``) and prints both builds' ptxas
lines for the backward kernels. Then, at the ring hop of a 32k global batch
over 8 ranks (4096 × 4096 × 512), the headline microbatch (128 × 128 × 512),
one rank's block of the fused all-gather with 128 rows a rank (128 × 1024 ×
512) and at 32k global over 8 ranks (4096 × 32768 × 512), and at the shapes
in CHECKED, holds each version's outputs against the plain versions (TF32
off) as a share of each output's largest magnitude, checks that two runs are
bitwise equal and reports each version's scratch bytes per kernel; at the
first four it times, by CUDA events, the other version, this checkout, this
checkout again and the other again, per kernel and mode. Prints the card
(``nvidia-smi``) and one JSON line per shape. Without CUDA it exits
non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from chip_smoke import ptxas_usage, time_ms

NEGATIVE_ONLY_OFFSET = -(2 ** 24)
# (b, n, d, pos_offset): timed, then only held against the plain versions.
TIMED = {"ring_hop_32k_positive": (4096, 4096, 512, 0), "headline_block": (128, 128, 512, 0),
         "allgather_w8_rank3": (128, 1024, 512, 384),
         "fused_allgather_w8_32k_rank3": (4096, 32768, 512, 3 * 4096)}
CHECKED = {"ring_hop_32k_negative": (4096, 4096, 512, NEGATIVE_ONLY_OFFSET),
           "ragged": (100, 300, 200, 7), "so400m_width": (256, 512, 1152, 0),
           "two_slices_of_1000": (64, 96, 2000, 3)}


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sigmoid_loss_bwd_img.argtypes = [p] * 5 + [i] * 5 + [p] * 4
    lib.sigmoid_loss_bwd_txt.argtypes = [p] * 5 + [i] * 5 + [p] * 3
    lib.sigmoid_loss_bwd_img_int8.argtypes = [p] * 8 + [i] * 5 + [p] * 4
    lib.sigmoid_loss_bwd_txt_int8.argtypes = [p] * 8 + [i] * 5 + [p] * 3
    lib.sigmoid_loss_bwd_scratch_floats.argtypes = [i, i, i, i]
    lib.sigmoid_loss_bwd_scratch_floats.restype = ctypes.c_longlong
    for fn in ("img", "txt", "img_int8", "txt_int8"):
        getattr(lib, f"sigmoid_loss_bwd_{fn}").restype = i
    return lib


def backward_ptxas(log: str) -> dict:
    """``{kernel: "N registers, spill S B"}`` of the backward kernels."""
    return {k: v for k, v in ptxas_usage(log).items() if k.startswith("sigmoid_loss_bwd_kernel")}


def load_other(path: Path) -> tuple[ctypes.CDLL, dict]:
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda

    lib, log = _cuda.build_other(path, "sigmoid_loss")
    return typed(lib), backward_ptxas(log)


def inputs(b, n, d, off, gen):
    """Unit rows, positives alike (``chip_smoke.loss_case_inputs``)."""
    zimg = F.normalize(torch.randn(b, d, device="cuda", generator=gen), dim=-1)
    ztxt = F.normalize(torch.randn(n, d, device="cuda", generator=gen), dim=-1)
    rows = torch.arange(b, device="cuda")
    keep = (rows + off >= 0) & (rows + off < n)
    ztxt[rows[keep] + off] = F.normalize(zimg[rows[keep]] + 0.5 * ztxt[rows[keep] + off], dim=-1)
    return (zimg, ztxt, torch.tensor(float(np.log(10.0)), device="cuda"),
            torch.tensor(-10.0, device="cuda"), torch.ones((), device="cuda"))


def run(lib, ssl, which, q, zimg, ztxt, tp, bias, g, off):
    """One version's K5 (``which`` "img": dzimg, dt′, dbias) or K6 ("txt":
    dztxt) through its C entry point; ``q``: the int8 mode's quantized rows
    (``ssl._int8_operands``), or None for the f32 mode."""
    (b, d), n = zimg.shape, ztxt.shape[0]
    own, n_own, n_other = (zimg, b, n) if which == "img" else (ztxt, n, b)
    out = torch.empty_like(own)
    scratch = torch.empty(scratch_floats(lib, which, b, n, d), device="cuda")
    out2 = torch.empty(2, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scalars = (tp.data_ptr(), bias.data_ptr(), g.data_ptr(), b, n, d, off)
    tail = (out.data_ptr(), scratch.data_ptr()) + ((out2.data_ptr(),) if which == "img" else ())
    if q is not None:
        f32 = ztxt if which == "img" else zimg
        err = getattr(lib, f"sigmoid_loss_bwd_{which}_int8")(
            *(t.data_ptr() for t in q), f32.data_ptr(), *scalars, ssl._vec(f32, out), *tail,
            stream)
    else:
        err = getattr(lib, f"sigmoid_loss_bwd_{which}")(
            zimg.data_ptr(), ztxt.data_ptr(), *scalars, ssl._vec(zimg, ztxt, out), *tail, stream)
    if err:
        raise RuntimeError(f"sigmoid_loss_bwd_{which} launch failed: CUDA error {err}")
    return (out, out2[0], out2[1]) if which == "img" else (out,)


def scratch_floats(lib, which, b, n, d) -> int:
    """Scratch floats of one version's K5 (``which`` "img") or K6 ("txt")."""
    own, other = (b, n) if which == "img" else (n, b)
    return lib.sigmoid_loss_bwd_scratch_floats(own, other, d, int(which == "img"))


def errors(got, ref) -> list[float]:
    """Each output's largest error as a share of its largest magnitude (of
    its magnitude for dt′ and dbias)."""
    return [((a - r).abs().max() / r.abs().max()).item() for a, r in zip(got, ref)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-source", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_sigmoid_loss: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda
    from distributed_sigmoid_loss_tpu_torch.ops import streaming_sigmoid_loss as ssl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    built = _cuda.build(["sigmoid_loss"])
    other, other_ptxas = load_other(args.other_source)
    print(json.dumps({"ptxas": {"checkout": backward_ptxas(built.get("sigmoid_loss", {})
                                                           .get("log", "")) or "built before",
                                "other": other_ptxas}}), flush=True)
    libs = {"checkout": typed(ssl._library()), "other": other}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, n, d, off) in {**TIMED, **CHECKED}.items():
        args_ = inputs(b, n, d, off, gen)
        row = {"shape": name, "b_n_d_off": [b, n, d, off]}
        for quant in ("", "int8") if d % 16 == 0 else ("",):
            q = ssl._int8_operands("compare", *args_[:2]) if quant else None
            plain = {"img": ssl.streaming_loss_bwd_img_plain(*args_[:4], off, args_[4], quant),
                     "txt": (ssl.streaming_loss_bwd_txt_plain(*args_[:4], off, args_[4], quant),)}
            for which in ("img", "txt"):
                key = f"bwd_{which}" + ("_int8" if quant else "")
                for version, lib in libs.items():
                    row[f"{key}_{version}_scratch_bytes"] = 4 * scratch_floats(lib, which, b, n, d)
                    got = run(lib, ssl, which, q, *args_, off)
                    again = run(lib, ssl, which, q, *args_, off)
                    torch.cuda.synchronize()
                    row[f"{key}_{version}_err_of_max"] = errors(got, plain[which])
                    row[f"{key}_{version}_repeatable"] = all(
                        torch.equal(x, y) for x, y in zip(got, again))
                if name in TIMED:
                    order = ("other", "checkout", "checkout", "other")
                    row[f"{key}_ms_in_turns"] = [
                        [v, time_ms(lambda v=v: run(libs[v], ssl, which, q, *args_, off),
                                    iters=10)]
                        for v in order]
            del plain, q
        print(json.dumps(row), flush=True)
        del args_
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
