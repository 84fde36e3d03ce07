#!/usr/bin/env python3
"""Time the sigmoid-loss kernels (the forward K4 and the backward pair K5 and
K6, each in both modes) of this checkout
(``distributed_sigmoid_loss_tpu_torch/csrc/sigmoid_loss.cu``) beside another
version of the same source, on one NVIDIA GPU, in one process.

    python3 compare_sigmoid_loss.py --other-source PATH/sigmoid_loss.cu [--count-epilogue]

Builds PATH with the port's nvcc flags into ``build/`` (the source must keep
the C entry points ``sigmoid_loss_fwd``, ``sigmoid_loss_bwd_img``,
``_bwd_txt``, their ``_int8`` forms, ``sigmoid_loss_fwd_partials`` and
``sigmoid_loss_bwd_scratch_floats``) and prints both builds' ptxas lines for
the loss kernels. Then, at the ring hop of a 32k global batch over 8 ranks
(4096 × 4096 × 512), the headline microbatch (128 × 128 × 512), one rank's
block of the fused all-gather with 128 rows a rank (128 × 1024 × 512) and at
32k global over 8 ranks (4096 × 32768 × 512), and at the shapes in CHECKED,
holds each version's outputs against the plain versions (TF32 off): the
loss as a share of itself, each gradient as a share of its largest
magnitude, and each gradient (the plain version's too) against an f64
product of the plain version's dlogits; checks that two runs are bitwise
equal and reports each version's scratch bytes per backward kernel; at the
first four it times the other version, this checkout, this checkout again
and the other again, per kernel and mode, by CUDA events and (K4) by the profiler's device time. K4 in the
int8 mode is timed on rows quantized beforehand: the kernel and its sum of
partials, without the quantize passes. ``--count-epilogue`` also counts the
SASS instructions of K4's epilogue for one logit (``epilogue_sass``). Prints
the card (``nvidia-smi``) and one JSON line per shape. Without CUDA it exits
non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from chip_smoke import device_ms, ptxas_usage, time_ms

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
    lib.sigmoid_loss_fwd.argtypes = [p] * 4 + [i] * 5 + [p] * 3
    lib.sigmoid_loss_fwd_int8.argtypes = [p] * 6 + [i] * 4 + [p] * 3
    lib.sigmoid_loss_fwd_partials.argtypes = [i, i]
    lib.sigmoid_loss_fwd_partials.restype = ctypes.c_longlong
    lib.sigmoid_loss_bwd_img.argtypes = [p] * 5 + [i] * 5 + [p] * 4
    lib.sigmoid_loss_bwd_txt.argtypes = [p] * 5 + [i] * 5 + [p] * 3
    lib.sigmoid_loss_bwd_img_int8.argtypes = [p] * 8 + [i] * 5 + [p] * 4
    lib.sigmoid_loss_bwd_txt_int8.argtypes = [p] * 8 + [i] * 5 + [p] * 3
    lib.sigmoid_loss_bwd_scratch_floats.argtypes = [i, i, i, i]
    lib.sigmoid_loss_bwd_scratch_floats.restype = ctypes.c_longlong
    for fn in ("fwd", "fwd_int8", "bwd_img", "bwd_txt", "bwd_img_int8", "bwd_txt_int8"):
        getattr(lib, f"sigmoid_loss_{fn}").restype = i
    return lib


def backward_ptxas(log: str) -> dict:
    """``{kernel: "N registers, spill S B"}`` of the loss kernels (K4-K6)."""
    return {k: v for k, v in ptxas_usage(log).items()
            if k.startswith(("sigmoid_loss_bwd_kernel", "sigmoid_loss_fwd_kernel"))}


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


def forward(lib, ssl, q, zimg, ztxt, tp, bias, off):
    """One version's K4 through its C entry point, as a call that returns
    the loss (a 0-d tensor): f32, or (``q``: the quantized rows,
    ``ssl._int8_operands``) the int8 mode."""
    (b, d), n = zimg.shape, ztxt.shape[0]
    partials = torch.empty(lib.sigmoid_loss_fwd_partials(b, n), device="cuda")
    out = torch.empty((), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tail = (tp.data_ptr(), bias.data_ptr(), b, n, d, off)

    def call():
        if q is not None:
            err = lib.sigmoid_loss_fwd_int8(*(t.data_ptr() for t in q), *tail,
                                            partials.data_ptr(), out.data_ptr(), stream)
        else:
            err = lib.sigmoid_loss_fwd(zimg.data_ptr(), ztxt.data_ptr(), *tail,
                                       ssl._vec(zimg, ztxt), partials.data_ptr(), out.data_ptr(),
                                       stream)
        if err:
            raise RuntimeError(f"sigmoid_loss_fwd launch failed: CUDA error {err}")
        return out

    return call


# K4's epilogue for one logit in the int8 mode (dequantize, the label,
# logit_of, softplus, the mask and the running sum) and the frame around it
# (the index, a load and a store): the difference in SASS instructions is
# the epilogue's; the f32 mode's lacks the dequantize.
EPILOGUE_PROBE = """
#include "{source}"
extern "C" __global__ void epilogue_probe(const int* q, float* y, float so, float sc, float t,
                                          float bias, int off, int b, float s) {{
  const int i = threadIdx.x;
  const float label = i == off ? 1.f : -1.f;
  const float x = __fmul_rn(__fmul_rn(__int2float_rn(q[i]), so), sc);
  const float v = softplus(-label * logit_of(x, t, bias));
  y[i] = s + (i < b ? v : 0.f);
}}
extern "C" __global__ void epilogue_frame(const int* q, float* y, float so, float sc, float t,
                                          float bias, int off, int b, float s) {{
  const int i = threadIdx.x;
  y[i] = __int_as_float(q[i]);
}}
"""


def epilogue_sass() -> dict:
    """SASS instructions of the probe and the frame (``cuobjdump -sass`` of
    the probe built for sm_90a at -O3, without NOPs and the trailing
    self-branch), their difference (the int8 epilogue of one logit), and the
    probe's branches and special-function (MUFU) instructions."""
    from distributed_sigmoid_loss_tpu_torch.ops import _cuda

    src = _cuda.CSRC / "sigmoid_loss.cu"
    probe = _cuda.BUILD_DIR / "epilogue_probe.cu"
    cubin = probe.with_suffix(".cubin")
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe.write_text(EPILOGUE_PROBE.format(source=src.resolve()))
    nvcc = _cuda._nvcc()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-o", str(cubin), str(probe)], check=True, capture_output=True)
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    counts = {}
    for name in ("epilogue_probe", "epilogue_frame"):
        body = sass.split(f"Function : {name}")[1].split("Function :")[0]
        ops = [m.group(1) for m in
               re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)]
        ops = [o for o in ops if not o.startswith("NOP")]
        while ops and ops[-1].startswith("BRA"):  # the self-branch after EXIT
            ops.pop()
        counts[name] = ops
    probe_ops, frame_ops = counts["epilogue_probe"], counts["epilogue_frame"]
    return {"probe": len(probe_ops), "frame": len(frame_ops),
            "epilogue_int8": len(probe_ops) - len(frame_ops),
            "probe_branches": sum(o.startswith("BRA") for o in probe_ops),
            "probe_mufu": sum(o.startswith("MUFU") for o in probe_ops),
            "probe_ops": probe_ops}


def scratch_floats(lib, which, b, n, d) -> int:
    """Scratch floats of one version's K5 (``which`` "img") or K6 ("txt")."""
    own, other = (b, n) if which == "img" else (n, b)
    return lib.sigmoid_loss_bwd_scratch_floats(own, other, d, int(which == "img"))


def errors(got, ref) -> list[float]:
    """Each output's largest error as a share of its largest magnitude (of
    its magnitude for dt′ and dbias), in the reference's precision."""
    return [((a.to(r.dtype) - r).abs().max() / r.abs().max()).item() for a, r in zip(got, ref)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-source", type=Path, required=True)
    ap.add_argument("--count-epilogue", action="store_true",
                    help="also count the SASS instructions of K4's epilogue for one logit")
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
    if args.count_epilogue:
        print(json.dumps({"epilogue_sass": epilogue_sass()}), flush=True)
    libs = {"checkout": typed(ssl._library()), "other": other}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, n, d, off) in {**TIMED, **CHECKED}.items():
        args_ = inputs(b, n, d, off, gen)
        row = {"shape": name, "b_n_d_off": [b, n, d, off]}
        for quant in ("", "int8") if d % 16 == 0 else ("",):
            q = ssl._int8_operands("compare", *args_[:2]) if quant else None
            key = "fwd" + ("_int8" if quant else "")
            ref = ssl.streaming_loss_fwd_plain(*args_[:4], off, quant).item()
            for version, lib in libs.items():
                call = forward(lib, ssl, q, *args_[:4], off)
                got, again = call().clone(), call().clone()
                row[f"{key}_{version}_err_of_loss"] = abs(got.item() - ref) / abs(ref)
                row[f"{key}_{version}_repeatable"] = torch.equal(got, again)
            if name in TIMED:
                order = ("other", "checkout", "checkout", "other")
                calls = {v: forward(libs[v], ssl, q, *args_[:4], off) for v in libs}
                row[f"{key}_ms_in_turns"] = [[v, time_ms(calls[v], iters=10)] for v in order]
                row[f"{key}_device_ms_in_turns"] = [[v, device_ms(calls[v])] for v in order]
            plain = {"img": ssl.streaming_loss_bwd_img_plain(*args_[:4], off, args_[4], quant),
                     "txt": (ssl.streaming_loss_bwd_txt_plain(*args_[:4], off, args_[4], quant),)}
            # f64 products of the plain version's dl: what each version's
            # gradient and the plain one's own IEEE-f32 sums miss.
            dl, _, t = ssl._dlogits(*args_[:4], off, args_[4], quant)
            exact = {"img": (dl.double() @ args_[1].double()) * t.double(),
                     "txt": (dl.double().T @ args_[0].double()) * t.double()}
            del dl
            for which in ("img", "txt"):
                key = f"bwd_{which}" + ("_int8" if quant else "")
                row[f"{key}_plain_err_of_max_vs_f64"] = errors(plain[which][:1], [exact[which]])[0]
                for version, lib in libs.items():
                    row[f"{key}_{version}_scratch_bytes"] = 4 * scratch_floats(lib, which, b, n, d)
                    got = run(lib, ssl, which, q, *args_, off)
                    again = run(lib, ssl, which, q, *args_, off)
                    torch.cuda.synchronize()
                    row[f"{key}_{version}_err_of_max"] = errors(got, plain[which])
                    row[f"{key}_{version}_err_of_max_vs_f64"] = errors(got[:1], [exact[which]])[0]
                    row[f"{key}_{version}_repeatable"] = all(
                        torch.equal(x, y) for x, y in zip(got, again))
                if name in TIMED:
                    order = ("other", "checkout", "checkout", "other")
                    row[f"{key}_ms_in_turns"] = [
                        [v, time_ms(lambda v=v: run(libs[v], ssl, which, q, *args_, off),
                                    iters=10)]
                        for v in order]
            del plain, q, exact
        print(json.dumps(row), flush=True)
        del args_
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
