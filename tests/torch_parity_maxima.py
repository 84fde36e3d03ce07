"""Print the largest errors the port's parity tests allow for, against the
JAX package, on the CPU: the plain K4-K6 vs the Pallas kernel in interpret
mode (f32 and bf16), the distributed loss at W in {2, 3, 4} over gloo, the
W = 2 train step; then the training recipes: the plain K3 vs the Pallas
``_bwd_kernel_batched`` and vs the plain K2, the softmax family (one device
and W in {2, 3, 4}), Lion and Adafactor vs optax, and the whole-step cases
of ``tests/test_torch_train_recipes.py``; then the flash kernel K7: its
plain forward and backward vs the upstream Pallas kernel in the interpreter,
and the tiny towers and one train step with the vision tower on K7
(``tests/test_torch_flash_attention.py``, ``test_torch_towers.py``,
``test_torch_train_step.py``). The tests assert tolerances; this reports the
observed maxima behind them.

    JAX_PLATFORMS=cpu python tests/torch_parity_maxima.py    # ~8 min
    JAX_PLATFORMS=cpu python tests/torch_parity_maxima.py k7   # one part
"""

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (8 virtual CPU devices, the repo on sys.path)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import _torch_dist_worker as worker  # noqa: E402
import test_torch_distributed_loss as tdl  # noqa: E402
import test_torch_flash_attention as tfa  # noqa: E402
import test_torch_short_attention_bwd_batched as tk3  # noqa: E402
import test_torch_softmax_loss as tsm  # noqa: E402
import test_torch_streaming_loss as tsl  # noqa: E402
import test_torch_towers as ttw  # noqa: E402
import test_torch_train_recipes as trc  # noqa: E402
import test_torch_train_step as tts  # noqa: E402
import test_torch_train_step_dp as tdp  # noqa: E402
from distributed_sigmoid_loss_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distributed_sigmoid_loss_tpu_torch.ops import short_attention as sa  # noqa: E402
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


def k3():
    f32 = bf16 = vs_k2 = 0.0
    for case in tk3.CASES:
        b, s, h, dh, causal = case
        arrays = tk3._inputs(0, (b, s, h, dh))
        ref = tk3._jax_batched_bwd(*arrays, causal, jnp.float32)
        got = tk3._port(sa.short_self_attention_bwd_batched_plain, arrays, causal)
        f32 = max(f32, max(float(np.abs(g.numpy() - r).max()) for g, r in zip(got, ref)))
        arrays = tk3._inputs(1, (b, s, h, dh))
        ref = tk3._jax_batched_bwd(*arrays, causal, jnp.bfloat16)
        got = tk3._port(sa.short_self_attention_bwd_batched_plain, arrays, causal, torch.bfloat16)
        bf16 = max(bf16, max(float(np.abs(g.float().numpy() - r).max()) / tk3._bf16_ulp(r)
                             for g, r in zip(got, ref)))
        arrays = tk3._inputs(2, (b, s, h, dh))
        a = tk3._port(sa.short_self_attention_bwd_batched_plain, arrays, causal)
        c = tk3._port(sa.short_self_attention_bwd_plain, arrays, causal)
        vs_k2 = max(vs_k2, max(float((x - y).abs().max()) for x, y in zip(a, c)))
    print(f"K3 plain vs Pallas _bwd_kernel_batched: f32 abs {f32:.2e}, bf16 {bf16:.2f} ulp; "
          f"vs plain K2 abs {vs_k2:.2e}")


def softmax():
    loss_rel = grad_abs = agree = 0.0
    for world in tdl.WORLDS:
        ranks = worker.spawn(worker.contrastive_worker, world, tdl._data(world),
                             Path(tempfile.mkdtemp()))
        for variant in tsm.VARIANTS:
            ref = tsm._jax_result(world, variant)
            for res in ranks:
                got = res[variant]
                loss_rel = max(loss_rel, abs(got["loss"].item() - ref["loss"]) / abs(ref["loss"]))
                for k in ("wi", "wt", "t_prime"):
                    grad_abs = max(grad_abs, float(np.abs(got[k].numpy() - ref[k]).max()))
        for res in ranks:
            agree = max(agree, max(float((res["all_gather"][k] - res["ring"][k]).abs().max())
                                   for k in ("wi", "wt", "t_prime")))
    print(f"softmax W {tdl.WORLDS}: loss rel {loss_rel:.2e}, gradients abs {grad_abs:.2e}; "
          f"all-gather vs ring gradients abs {agree:.2e}")


def optimizers():
    for cfg in (trc.jc.TrainConfig(optimizer="lion", learning_rate=1e-2, weight_decay=0.05,
                                   warmup_steps=2, total_steps=8),
                trc.jc.TrainConfig(optimizer="adafactor", learning_rate=1e-2, weight_decay=0.05,
                                   warmup_steps=2, total_steps=8)):
        names, pparams, _, params, _ = trc._run_optimizer(cfg)
        rel = max(float(np.abs(p.numpy() - np.asarray(params[k])).max()
                        / np.abs(np.asarray(params[k])).max()) for k, p in zip(names, pparams))
        print(f"{cfg.optimizer} vs optax, 5 updates: parameters {rel:.2e} of the largest")


def recipes():
    for case in sorted(trc.STEP_CASES):
        kw = dict(trc.STEP_CASES[case])
        loss = {k: kw.pop(k) for k in ("family", "variant") if k in kw}
        jcfg = trc.tiny(scan_layers=kw.pop("scan_layers", False))
        jcfg = trc.dataclasses.replace(jcfg, loss=trc.dataclasses.replace(jcfg.loss, **loss))
        jm, pm, jfinal, state = trc._run_both(jcfg, **kw)
        rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(pm, jm) if b[k] != 0)
               for k in trc.METRICS}
        ref = params_from_jax(jfinal.params, tdp.port_config(jcfg))
        got = state.model.state_dict()
        outside = sum(int((np.abs(got[k].numpy() - ref[k].numpy())
                           > 1e-6 + 1e-4 * np.abs(ref[k].numpy())).sum()) for k in ref)
        worst = max(rel, key=rel.get)
        print(f"step {case}: metrics rel ≤ {rel[worst]:.2e} ({worst}; loss {rel['loss']:.2e}), "
              f"parameters outside rtol 1e-4: {outside} of {sum(v.numel() for v in ref.values())}")


def k7():
    f32 = bf16 = 0.0
    for case in tfa.CASES:
        _, _, causal, dtype = case
        q, k, v, do = tfa._port_tensors(case)
        out, stats = fa.flash_self_attention_plain(q, k, v, causal, tfa._scale(case))
        grads = fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, causal, tfa._scale(case))
        for g, r in zip((out, *grads), tfa._jax_result(case)):
            err = float(np.abs(g.float().numpy() - r).max())
            if dtype == "float32":
                f32 = max(f32, err / float(np.abs(r).max()))
            else:
                bf16 = max(bf16, err / tfa._bf16_ulp(r))
    print(f"K7 plain vs the Pallas flash kernel: f32 {f32:.2e} of the largest, bf16 {bf16:.2f} ulp")
    worst = {}
    for case in tfa.CASES:
        _, _, causal, _ = case
        q, k, v, do = tfa._port_tensors(case, "bfloat16")
        out, stats = fa.flash_self_attention_plain(q, k, v, causal, tfa._scale(case), fa.BLOCK_K)
        grads = fa.flash_self_attention_bwd_plain(q, k, v, out, do, stats, causal,
                                                  tfa._scale(case), fa.BLOCK_K)
        for name, g, r in zip(("out", "dq", "dk", "dv"), (out, *grads),
                              tfa._jax_result(case, "bfloat16")):
            ulps = float(np.abs(g.float().numpy() - r).max()) / tfa._bf16_ulp(r)
            worst[name] = max(worst.get(name, 0.0), ulps)
    print("K7 plain at the kernels' block vs the Pallas flash kernel, bf16 ulps: "
          + ", ".join(f"{n} {u:.2f}" for n, u in worst.items()))
    for dtype in ("float32", "bfloat16"):
        jcfg = ttw.tiny(v_image_size=ttw.K7_IMAGE_SIZE, dtype=dtype,
                        v_attn_impl="flash" if dtype == "float32" else "auto")
        with pytest.MonkeyPatch.context() as mp:
            ttw.force_vision_onto_k7(mp, jcfg.text.context_length)
            with pltpu.force_tpu_interpret_mode():
                (zimg, ztxt), port, (images, tokens) = ttw.both_towers(jcfg)
            pimg, ptxt = ttw.port_embed(port, images, tokens)
        print(f"towers on K7 {dtype}: image abs {np.abs(pimg - zimg).max():.2e}, "
              f"text abs {np.abs(ptxt - ztxt).max():.2e}")
        jcfg = tts._k7_config(dtype)
        with pytest.MonkeyPatch.context() as mp:
            ttw.force_vision_onto_k7(mp, jcfg.text.context_length)
            with pltpu.force_tpu_interpret_mode():
                jm, _, pm, _ = tts._run_both(jcfg, steps=1)
            ref, got = tts._loss_grads_both(jcfg)
        rel = max(abs(pm[0][k] - jm[0][k]) / abs(jm[0][k]) for k in tts.METRICS if jm[0][k] != 0)
        g = torch.cat([got[k].flatten() for k in ref])
        r = torch.cat([ref[k].flatten() for k in ref])
        worst = max(float((got[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref
                    if "attn.k.bias" not in k)
        print(f"step on K7 {dtype}: metrics rel {rel:.2e}; gradient rel norm "
              f"{float((g - r).norm() / r.norm()):.2e}, cosine "
              f"{float(torch.nn.functional.cosine_similarity(g, r, dim=0)):.6f}, worst tensor "
              f"(k biases aside) {worst:.2e} of its largest")


PARTS = {"blocks": blocks, "distributed": distributed, "train_step": train_step, "k3": k3,
         "softmax": softmax, "optimizers": optimizers, "recipes": recipes, "k7": k7}

if __name__ == "__main__":
    for part in sys.argv[1:] or PARTS:
        PARTS[part]()
