#!/usr/bin/env python3
"""Time the eager training step of this checkout beside another checkout of
the port, on one NVIDIA GPU.

    python3 compare_train_step.py --other-root PATH [--steps 3]

Two steps are timed, both the smoke's (``chip_smoke.py``): ``[train]``, the
headline step (SigLIP-B/16, 16 accumulated microbatches of 128 pairs,
``save_hot`` remat, bf16 accumulator and Adam first moment, the ring loss),
and ``[train_pallas]``, the same with ``LossConfig(use_pallas=True)`` (the
streaming loss kernels as the loss body). For each: ``--steps`` steps after
one untimed, on seeded random weights and batches, each step's wall time
with the loss read back, and the optimizer update alone (``AdamW.apply`` on
fixed gradients, CUDA events).

The two packages share a name, so each version runs in a process of its
own, in the order other, this, this, other; each builds its kernels from
its own sources into its own ``build/``. Prints the card (``nvidia-smi``),
one JSON line per run and, last, each version's median over its two runs.
Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ACCUM, MICRO = 16, 128


def worker(root: Path, steps: int) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import distributed_sigmoid_loss_tpu_torch as pkg

    if not Path(pkg.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {root}")
    sys.path.insert(1, str(HERE))
    from chip_smoke import headline_config, random_batch, time_ms
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import TrainConfig

    record = {"root": str(root)}
    for name, use_pallas in (("train", False), ("train_pallas", True)):
        cfg = headline_config()
        cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, use_pallas=use_pallas))
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = SigLIP(cfg, device="cuda", generator=gen)
        tx = make_optimizer(TrainConfig(warmup_steps=100, total_steps=100_000,
                                        adam_mu_dtype="bfloat16"))
        state = create_train_state(model, tx)
        step = make_train_step(model, cfg.loss, accum_steps=ACCUM, accum_dtype="bfloat16")
        step_ms, losses = [], []
        for _ in range(steps + 1):
            batch = random_batch(cfg, ACCUM * MICRO, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        params = list(model.parameters())
        grads = [1e-3 * torch.randn(p.shape, device="cuda", generator=gen) for p in params]
        apply_ms = time_ms(lambda: tx.apply(params, grads, state.opt_state), iters=10, warmup=2)
        record[name] = {"step_ms": step_ms[1:], "first_step_ms": step_ms[0],
                        "median_step_ms": statistics.median(step_ms[1:]),
                        "optimizer_apply_ms": apply_ms, "losses": losses,
                        "tensors": len(params)}
        del model, state, step, tx, params, grads
        torch.cuda.empty_cache()
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-root", type=Path, help="the other checkout's root")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.steps)))
        return 0

    import torch

    if not torch.cuda.is_available() or args.other_root is None:
        print("needs a CUDA device and --other-root", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    runs = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        root = args.other_root.resolve() if label == "other" else HERE
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root),
                               "--steps", str(args.steps)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            return proc.returncode
        record = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"version": label, **record}), flush=True)
        runs[label].append(record)
    summary = {
        phase: {label: {key: statistics.median([r[phase][key] for r in recs])
                        for key in ("median_step_ms", "optimizer_apply_ms")}
                for label, recs in runs.items()}
        for phase in ("train", "train_pallas")}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
