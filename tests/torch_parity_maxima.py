"""Print the largest errors the port's distributed-loss parity tests allow for, against
the JAX package, on the CPU: the plain K4-K6 vs the Pallas kernel in
interpret mode (f32 and bf16), the distributed loss at W in {2, 3, 4} over
gloo, and the W = 2 train step. The tests assert tolerances; this reports
the observed maxima behind them.

    JAX_PLATFORMS=cpu python tests/torch_parity_maxima.py    # ~3 min
"""

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (8 virtual CPU devices, the repo on sys.path)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_dist_worker as worker  # noqa: E402
import test_torch_distributed_loss as tdl  # noqa: E402
import test_torch_streaming_loss as tsl  # noqa: E402
import test_torch_train_step_dp as tdp  # noqa: E402
from distributed_sigmoid_loss_tpu_torch.models import params_from_jax  # noqa: E402
from distributed_sigmoid_loss_tpu_torch.utils import config as pc  # noqa: E402

GRADS = ("dzimg", "dztxt", "dt_prime", "dbias")


def blocks():
    for case, (b, n, d, off) in tsl.BLOCKS.items():
        zi, zt, tp, bias = tsl.inputs(b, n, d, seed=sorted(tsl.BLOCKS).index(case))
        ref_loss, ref_g = tsl.jax_block(zi, zt, tp, bias, off)
        loss, g = tsl.port_block(zi, zt, tp, bias, off)
        print(f"block f32 {case}: loss rel {abs(loss - ref_loss) / abs(ref_loss):.2e}; "
              + ", ".join(f"{k} abs {np.abs(a - r).max():.2e} of max {np.abs(r).max():.3g}"
                          for k, a, r in zip(GRADS, g, ref_g)))
    zi, zt, tp, bias = tsl.inputs(8, 32, 128, seed=7)
    ref_loss, ref_g = tsl.jax_block(zi, zt, tp, bias, 8, jnp.bfloat16)
    loss, g = tsl.port_block(zi, zt, tp, bias, 8, torch.bfloat16)
    print(f"block bf16: loss rel {abs(loss - ref_loss) / abs(ref_loss):.2e}; "
          + ", ".join(f"{k} {np.abs(a - r).max() / np.abs(r).max():.2e} of max"
                      for k, a, r in zip(GRADS, g, ref_g)))


def distributed():
    loss_rel = grad_abs = 0.0
    for world in tdl.WORLDS:
        ranks = worker.spawn(worker.loss_worker, world, tdl._data(world), Path(tempfile.mkdtemp()))
        for name, use_pallas in tdl.CASES:
            ref = tdl._jax_result(world, tdl.JAX_COMPOSITION[name], use_pallas)
            for res in ranks:
                got = res[f"{name}/{int(use_pallas)}"]
                loss_rel = max(loss_rel, abs(got["loss"].item() - ref["loss"]) / abs(ref["loss"]))
                for k in ("wi", "wt", "t_prime", "bias"):
                    grad_abs = max(grad_abs, float(np.abs(got[k].numpy() - ref[k]).max()))
    print(f"distributed W {tdl.WORLDS}: loss rel {loss_rel:.2e}, gradients abs {grad_abs:.2e}")


def train_step():
    for name in sorted(tdp.LOSSES):
        jcfg, batch, params0, jmetrics, jparams = tdp.jax_run(name)
        pcfg = tdp.port_config(jcfg)
        args = (params_from_jax(params0, pcfg), pcfg, batch, pc.TrainConfig(**tdp.TRAIN_CFG),
                tdp.STEPS, tdp.ACCUM)
        ranks = worker.spawn(worker.train_worker, tdp.WORLD, args, Path(tempfile.mkdtemp()),
                             timeout_s=180)
        rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(ranks[0]["metrics"], jmetrics)
                  for k in tdp.METRICS if b[k] != 0)
        ref = params_from_jax(jparams, pcfg)
        outside = sum(int((np.abs(ranks[0]["params"][k].numpy() - ref[k].numpy())
                           > 1e-6 + 1e-4 * np.abs(ref[k].numpy())).sum()) for k in ref)
        total = sum(v.numel() for v in ref.values())
        print(f"train step W=2 {name}: metrics rel {rel:.2e}, "
              f"parameters outside rtol 1e-4: {outside} of {total}")


if __name__ == "__main__":
    blocks()
    distributed()
    train_step()
