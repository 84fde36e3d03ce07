"""Rank processes of the train-loop slice's multi-process tests (gloo,
spawned by ``_torch_dist_worker.spawn``): the reference's loss classes, the
preemption guard's agreement and sharded retrieval.

Imports only torch, numpy and the port; the JAX side of each comparison runs
in the parent. Each worker writes its results with ``torch.save`` to
``<out_dir>/rank<r>.pt``, keyed by strings.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_worker import _init


def compat_worker(rank, world, init_file, out_dir, configs):
    """Both loss classes (with and without ``use_pallas``) through the
    reference's toy pipeline on this rank's rows at each ``(bz, d)`` of
    ``configs``, gradients averaged over the ranks afterwards; then the
    classes' refusals at this world size."""
    import torch.nn.functional as F

    from distributed_sigmoid_loss_tpu_torch.compat import DDPSigmoidLoss, SigLipLoss
    from distributed_sigmoid_loss_tpu_torch.parallel.api import average_gradients
    from distributed_sigmoid_loss_tpu_torch.utils.parity_data import (
        reference_encoder_weights,
        reference_partition,
    )

    _init(rank, world, init_file)
    try:
        out = {}
        for bz, d in configs:
            img, txt = reference_partition(world, bz, d)
            wi_np, wt_np = reference_encoder_weights(d)
            rows = slice(rank * bz, (rank + 1) * bz)
            for use_pallas in (False, True):
                for cls in ("ddp", "siglip"):
                    wi = torch.tensor(wi_np, requires_grad=True)
                    wt = torch.tensor(wt_np, requires_grad=True)
                    zimg = F.normalize(torch.from_numpy(img[rows]) @ wi.T)
                    ztxt = F.normalize(torch.from_numpy(txt[rows]) @ wt.T)
                    if cls == "ddp":
                        mod = DDPSigmoidLoss(gpu_batch_size=bz, use_pallas=use_pallas,
                                             device="cpu")
                        loss = mod(zimg, ztxt)
                        lp = [mod.t_prime, mod.bias]
                    else:
                        mod = SigLipLoss(rank=rank, world_size=world, use_pallas=use_pallas)
                        p = SigLipLoss.init_params(device="cpu")
                        res = mod(zimg, ztxt, p["logit_scale"], p["logit_bias"],
                                  output_dict=True)
                        assert set(res) == {"contrastive_loss"}
                        loss = res["contrastive_loss"]
                        lp = [p["logit_scale"], p["logit_bias"]]
                    loss.backward()
                    params = [wi, wt, *lp]
                    average_gradients(params)
                    out[f"{bz}/{d}/{cls}/{int(use_pallas)}"] = {
                        "loss": loss.detach(), "wi": wi.grad, "wt": wt.grad,
                        "t_prime": lp[0].grad, "bias": lp[1].grad}
        refusals = {}
        for name, make in (
            ("world_size", lambda: SigLipLoss(world_size=world + 1)),
            ("rank", lambda: SigLipLoss(rank=(rank + 1) % world)),
            ("gpu_batch_size", lambda: DDPSigmoidLoss(gpu_batch_size=bz + 1, device="cpu")(
                zimg.detach(), ztxt.detach())),
        ):
            try:
                make()
                refusals[name] = ""
            except ValueError as e:
                refusals[name] = str(e)
        out["refusals"] = refusals
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def guard_worker(rank, world, init_file, out_dir, signalled_rank, signal_step, steps):
    """``PreemptionGuard.reached_sync_point`` at steps 1..``steps`` on every
    rank, with SIGTERM raised on ``signalled_rank`` only, before its check at
    ``signal_step``."""
    import signal

    from distributed_sigmoid_loss_tpu_torch.train.resilience import PreemptionGuard

    _init(rank, world, init_file)
    try:
        seen = []
        with PreemptionGuard() as guard:
            for step in range(1, steps + 1):
                if rank == signalled_rank and step == signal_step:
                    signal.raise_signal(signal.SIGTERM)
                seen.append(guard.reached_sync_point(step))
            local = guard.preempted_locally
        torch.save({"seen": seen, "local": local}, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def retrieval_worker(rank, world, init_file, out_dir, zimg, ztxt, classifier, labels):
    """``retrieval_metrics`` and ``zeroshot_metrics`` on this rank's rows of
    the global (N, d) embeddings."""
    from distributed_sigmoid_loss_tpu_torch.eval import retrieval_metrics, zeroshot_metrics

    _init(rank, world, init_file)
    try:
        n = zimg.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        rm = retrieval_metrics(torch.from_numpy(zimg[rows]), torch.from_numpy(ztxt[rows]),
                               ks=(1, 2, 5))
        zs = zeroshot_metrics(torch.from_numpy(zimg[rows]), torch.from_numpy(classifier),
                              torch.from_numpy(labels[rows]), ks=(1, 3))
        torch.save({"retrieval": {k: float(v) for k, v in rm.items()},
                    "zeroshot": {k: float(v) for k, v in zs.items()}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)
