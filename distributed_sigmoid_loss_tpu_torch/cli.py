"""Command-line entry point: ``python -m distributed_sigmoid_loss_tpu_torch <cmd>``
(or ``dsl-torch <cmd>``), with the JAX package's flag names and defaults.

- ``train``: SigLIP training on synthetic data: the towers, the distributed
  sigmoid loss (ring or all-gather; K4-K6 under ``--use-pallas``), the
  optimizer, JSON-lines metrics, prefetch to the device, and with
  ``--ckpt-dir`` checkpoint/resume, preemption (SIGTERM) checkpoints and
  divergence rollback (``train.resilience.train_resilient``).
- ``eval``: retrieval and zero-shot classification of a fresh or
  checkpointed model on held-out synthetic data (``--ema``: the
  checkpoint's EMA weights).
- ``tokenizer``: train a byte-level BPE vocab on a caption corpus.

The commands run on ``cuda``; ``--cpu-devices 1`` runs them on the CPU. A
flag whose path the port does not have yet exits 2 with a message naming
its ROADMAP.md queue A item.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys

__all__ = ["main"]

# Flags of paths not ported yet: (dest, the value that means "off", flag,
# ROADMAP.md queue A item, what the flag needs).
_UNPORTED = (
    ("pp", 1, "--pp", "6.4", "the pipeline-parallel towers"),
    ("pp_microbatches", 0, "--pp-microbatches", "6.4", "the pipeline-parallel towers"),
    ("moe_experts", 0, "--moe-experts", "6.4", "the MoE towers"),
    ("moe_aux_weight", None, "--moe-aux-weight", "6.4", "the MoE towers"),
    ("moe_group_size", 0, "--moe-group-size", "6.4", "the MoE towers"),
    ("ep", 1, "--ep", "6.4", "expert parallelism"),
    ("coordinator", "", "--coordinator", "6.4", "multi-host training"),
    ("num_processes", 0, "--num-processes", "6.4", "multi-host training"),
    ("process_id", -1, "--process-id", "6.4", "multi-host training"),
    ("grad_compression", "", "--grad-compression", "6.3", "compressed gradient sync"),
    ("topk_frac", 0.01, "--topk-frac", "6.3", "compressed gradient sync"),
    ("topk_exact", False, "--topk-exact", "6.3", "compressed gradient sync"),
    ("dcn_budget_mbps", None, "--dcn-budget-mbps", "6.3", "compressed gradient sync"),
    ("controller", None, "--controller", "6.3", "compressed gradient sync"),
    ("emu_dcn_mbps", None, "--emu-dcn-mbps", "6.3", "compressed gradient sync"),
    ("dcn_slices", 1, "--dcn-slices", "6.3", "the multi-slice dcn axis"),
    ("force_dcn_emulation", False, "--force-dcn-emulation", "6.3", "the multi-slice dcn axis"),
    ("zero1", False, "--zero1", "6.3", "sharded updates"),
    ("data_dir", "", "--data-dir", "6.1", "real image data"),
    ("data_shards", "", "--data-shards", "6.1", "real image data"),
    ("shuffle_buffer", 0, "--shuffle-buffer", "6.1", "real image data"),
    ("native_decode", False, "--native-decode", "6.1", "the native decoder"),
    ("native_data", False, "--native-data", "6.1", "the native loader"),
    ("data_workers", 0, "--data-workers", "6.1", "the host worker pools of real data"),
    ("eval_data", "", "--eval-data", "6.1", "real image data"),
    ("obs_dir", "", "--obs-dir", "6.5", "observability (spans, flight recorder)"),
)


def _unported(args) -> str | None:
    """The first flag of an unported path the command line set, as its
    refusal message, or None."""
    for dest, off, flag, item, what in _UNPORTED:
        if getattr(args, dest, off) != off:
            return (f"{flag}: {what} not ported yet: ROADMAP.md queue A item {item}")
    if getattr(args, "update_sharding", "") not in ("", "off"):
        return ("--update-sharding: sharded updates not ported yet: "
                "ROADMAP.md queue A item 6.3")
    if getattr(args, "watchdog", "off") == "warn":
        return ("--watchdog warn: the health watchdog (obs/health.py) not ported yet: "
                "ROADMAP.md queue A item 6.5")
    return None


def _device(args):
    """``(device, None)``, or ``(None, exit code)`` after a message."""
    import torch

    if args.cpu_devices > 1:
        print(f"--cpu-devices {args.cpu_devices}: the port emulates no multi-device mesh; "
              "pass --cpu-devices 1 (one process on the CPU)", file=sys.stderr)
        return None, 2
    if args.cpu_devices == 1:
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        print("CUDA is not available: the commands run on cuda; pass --cpu-devices 1 to run "
              "on the CPU", file=sys.stderr)
        return None, 1
    return torch.device("cuda"), None


def _model_config(args):
    import dataclasses

    from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

    if getattr(args, "tiny", False) and args.model != "b16":
        raise SystemExit(f"--tiny conflicts with --model {args.model}; pass one or the other")
    name = "tiny" if getattr(args, "tiny", False) else args.model
    cfg = {
        "tiny": SigLIPConfig.tiny_test,
        "l14": SigLIPConfig.l14,
        "so400m": SigLIPConfig.so400m,
        "b16": SigLIPConfig.b16,
    }[name]()

    def towers(**kw):
        return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **kw),
                                   text=dataclasses.replace(cfg.text, **kw))

    if getattr(args, "quant", ""):
        cfg = towers(quant=args.quant)  # eval only: inference int8 projections
    if getattr(args, "quant_train", ""):
        cfg = towers(quant_train=args.quant_train)  # the int8 STE
    if getattr(args, "remat_policy", ""):
        if not (cfg.vision.remat or cfg.text.remat):
            raise SystemExit(
                f"--remat-policy {args.remat_policy} is a no-op for "
                f"{name!r}: its towers run without rematerialization"
            )
        cfg = towers(remat_policy=args.remat_policy)
    return cfg


def _byte_tokenize_for(cfg, vocab_path: str = ""):
    """The tokenizer folded into the config's vocab when it is smaller (tiny
    test configs): modulo keeps distinct texts distinct. ``vocab_path``: a
    trained BPE vocab instead of the byte tokenizer."""
    import numpy as np

    from distributed_sigmoid_loss_tpu_torch.data import BpeTokenizer, ByteTokenizer

    tok = BpeTokenizer.load(vocab_path) if vocab_path else ByteTokenizer()

    def tokenize(texts, length):
        ids = np.asarray(tok(texts, length))
        if cfg.text.vocab_size < tok.vocab_size:
            ids = ids % cfg.text.vocab_size
        return ids

    return tokenize


def _train_config_conflicts(args) -> str | None:
    """The ``train`` command's refusals of incoherent flag sets among the
    ported flags (the JAX package's messages): the first, or None."""
    if args.accum_bf16 and args.accum == 1:
        return ("--accum-bf16 requires --accum > 1 (the unaccumulated step "
                "has no accumulator)")
    if args.gradcache_bf16 and (args.accum == 1 or args.accum_negatives != "global"):
        return ("--gradcache-bf16 requires --accum > 1 with "
                "--accum-negatives global (only the GradCache path stashes "
                "embedding tables)")
    if args.loss_impl == "chunked":
        if args.variant == "ring":
            return ("--loss-impl chunked applies to the all_gather variant "
                    "only (the ring already streams negatives one chunk per "
                    "hop); drop --variant ring or pass --variant all_gather")
        if args.ring_overlap:
            return ("--loss-impl chunked (all_gather) and --ring-overlap "
                    "(ring) select different comm variants; pick one")
    if args.ring_overlap and args.variant == "all_gather":
        return ("--ring-overlap applies to the ring variant only (the "
                "all-gather loss has no hop loop to overlap)")
    if args.loss_family == "softmax" and (args.loss_impl != "fused" or args.ring_overlap):
        return ("--loss-impl chunked / --ring-overlap apply to the sigmoid "
                "family only (the softmax ring already streams its logsumexp)")
    if args.use_pallas and args.loss_family != "sigmoid":
        return "--use-pallas applies to the sigmoid family only"
    if args.watchdog == "skip" and not args.ckpt_dir:
        return ("--watchdog skip requires --ckpt-dir (skipping rolls back to "
                "the last good checkpoint; without one there is nothing to "
                "roll back to)")
    if args.async_checkpoint and not args.ckpt_dir:
        return ("--async-checkpoint without --ckpt-dir would be a silent no-op "
                "(there is nothing to save)")
    if args.eval_every < 0 or args.log_every < 1 or args.ckpt_every < 1:
        return "--eval-every must be >= 0, --log-every and --ckpt-every >= 1"
    return None


def cmd_train(args) -> int:
    refusal = _unported(args) or _train_config_conflicts(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    device, code = _device(args)
    if device is None:
        return code

    import dataclasses

    import torch

    from distributed_sigmoid_loss_tpu_torch.data import (
        PrefetchStats,
        SyntheticImageText,
        prefetch,
        put_batch,
        shard_batch,
    )
    from distributed_sigmoid_loss_tpu_torch.eval import retrieval_metrics
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.train import (
        AsyncSaver,
        PreemptionGuard,
        RestoreRequiredError,
        create_train_state,
        latest_step,
        make_optimizer,
        make_train_step,
        train_resilient,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, TrainConfig
    from distributed_sigmoid_loss_tpu_torch.utils.logging import MetricsLogger

    cfg = _model_config(args)
    if args.loss_family != "sigmoid":
        # t_prime's init depends on the family (CLIP: log(1/0.07)).
        cfg = dataclasses.replace(cfg, loss=LossConfig(family=args.loss_family))
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""), file=sys.stderr)
    model = SigLIP(cfg, device=device)
    tx = make_optimizer(TrainConfig(learning_rate=args.lr, warmup_steps=5,
                                    total_steps=max(args.steps, 10), optimizer=args.optimizer))
    source = SyntheticImageText(cfg, args.batch)
    data = iter(source)
    first = next(data)
    resuming = bool(args.ckpt_dir) and latest_step(args.ckpt_dir) is not None
    state = create_train_state(model, tx, ema=args.ema_decay is not None)
    # --loss-impl chunked is an all_gather memory shape; an unset --variant
    # follows it (an explicit ring was refused above).
    variant = args.variant or ("all_gather" if args.loss_impl == "chunked" else "ring")
    step_fn = make_train_step(
        model,
        LossConfig(variant=variant, family=args.loss_family, precision="default",
                   loss_impl=args.loss_impl, ring_overlap=args.ring_overlap,
                   use_pallas=args.use_pallas),
        accum_steps=args.accum,
        accum_negatives=args.accum_negatives,
        accum_dtype="bfloat16" if args.accum_bf16 else None,
        gradcache_embed_dtype="bfloat16" if args.gradcache_bf16 else None,
        ema_decay=args.ema_decay,
    )
    logger = MetricsLogger(every=args.log_every)

    def host_batches(skip: int = 0):
        # The synthetic stream is deterministic per position: on resume, skip
        # the batches the checkpointed steps consumed, so the resumed run sees
        # the stream an uninterrupted run would.
        if skip == 0:
            yield first
        for i, b in enumerate(data, start=1):
            if i >= skip:
                yield b

    # Every rank makes the same global batch and takes its own rows (the
    # reference's recipe); prefetch copies them to the device ahead of the
    # step, and input_wait_frac on every line says whether it kept up.
    input_stats = PrefetchStats()

    def device_batches(skip: int = 0):
        return prefetch(host_batches(skip), device, size=2,
                        put=lambda b, d: put_batch(shard_batch(b), d), stats=input_stats)

    def log_metrics(step_i, m):
        logger.log(step_i, {**{k: float(v) for k, v in m.items()},
                            "input_wait_frac": input_stats.input_wait_frac()})

    eval_hook = None
    if args.eval_every:
        # ONE fixed, held-out batch (shifted seeds) for every in-training
        # eval: the curve measures the model, not data drift, and the
        # training stream's positions stay untouched.
        eval_batch = put_batch(shard_batch(next(iter(SyntheticImageText(
            cfg, args.batch, image_seed=43, text_seed=41)))), device)

        def eval_hook(step_i, st):
            with torch.no_grad():
                zi, zt, _ = model(eval_batch["images"], eval_batch["tokens"])
            rm = retrieval_metrics(zi, zt, ks=(1, 5))
            # force: out of band of --log-every, the steps/sec clock untouched.
            logger.log(step_i, {f"eval/{k}": float(v) for k, v in rm.items()}, force=True)

    if args.ckpt_dir and args.tokenizer:
        # The vocab rides with the checkpoints: eval loads it, so a restored
        # model never tokenizes with another vocab than training did.
        os.makedirs(args.ckpt_dir, exist_ok=True)
        stash = os.path.join(args.ckpt_dir, "tokenizer.json")
        if os.path.abspath(args.tokenizer) != os.path.abspath(stash):
            shutil.copyfile(args.tokenizer, stash)
    if args.ckpt_dir:
        skip = latest_step(args.ckpt_dir) or 0
        saver_ctx = AsyncSaver() if args.async_checkpoint else contextlib.nullcontext()
        stream = device_batches(skip)
        with PreemptionGuard() as guard, saver_ctx as saver:
            try:
                state, report = train_resilient(
                    state, step_fn, stream,
                    total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    guard=guard, saver=saver,
                    # Refuse to train from fresh weights over a checkpoint that
                    # vanished between resume detection and the restore.
                    require_restore=resuming,
                    on_metrics=log_metrics, eval_every=args.eval_every, on_eval=eval_hook,
                    on_divergence="skip" if args.watchdog == "skip" else "halt",
                )
            except RestoreRequiredError as e:
                print(f"--ckpt-dir {args.ckpt_dir}: {e}", file=sys.stderr)
                return 1
            finally:
                # Join the prefetch worker before anything else reads `data`.
                stream.close()
        print(f"resilient loop: steps {report.start_step}->{report.final_step}, "
              f"checkpoints at {report.checkpoints}"
              + (" (preempted)" if report.preempted else ""), file=sys.stderr)
        for t in saver.timings if saver is not None else ():
            print(f"checkpoint {t['path']}: {t['bytes']} bytes, host snapshot "
                  f"{t['snapshot_s']:.3f} s, write {t['write_s']:.3f} s", file=sys.stderr)
    else:
        stream = device_batches()
        try:
            for i, batch in zip(range(1, args.steps + 1), stream):
                state, metrics = step_fn(state, batch)
                log_metrics(i, metrics)
                if eval_hook is not None and i % args.eval_every == 0:
                    eval_hook(i, state)
        finally:
            stream.close()  # joins the worker; `data` is single-reader again

    # Retrieval on a held-out synthetic batch (the embeddings come normalized).
    held_out = put_batch(shard_batch(next(data)), device)
    with torch.no_grad():
        zimg, ztxt, _ = model(held_out["images"], held_out["tokens"])
    rm = retrieval_metrics(zimg, ztxt, ks=(1, 5))
    print({k: round(float(v), 4) for k, v in rm.items()}, file=sys.stderr)
    return 0


def cmd_eval(args) -> int:
    refusal = _unported(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    if args.ema and not args.ckpt_dir:
        print("--ema requires --ckpt-dir (EMA weights live in a train checkpoint; "
              "a fresh model has none)", file=sys.stderr)
        return 2
    device, code = _device(args)
    if device is None:
        return code

    import numpy as np
    import torch

    from distributed_sigmoid_loss_tpu_torch.data import SyntheticImageText, put_batch
    from distributed_sigmoid_loss_tpu_torch.eval import (
        build_classifier,
        retrieval_metrics,
        zeroshot_metrics,
    )
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP

    cfg = _model_config(args)
    if args.ckpt_dir:
        # The vocab stashed by `train --tokenizer` unless the user overrode
        # it: another vocab than training's makes the metrics garbage.
        stashed = os.path.join(args.ckpt_dir, "tokenizer.json")
        if os.path.exists(stashed):
            if not args.tokenizer:
                args.tokenizer = stashed
                print(f"using checkpoint tokenizer {stashed}", file=sys.stderr)
            elif os.path.abspath(args.tokenizer) != os.path.abspath(stashed):
                with open(args.tokenizer) as f1, open(stashed) as f2:
                    if json.load(f1) != json.load(f2):
                        print(f"WARNING: --tokenizer {args.tokenizer} differs from the "
                              f"checkpoint's stashed vocab {stashed}; token ids will not "
                              "match training", file=sys.stderr)
    model = SigLIP(cfg, device=device)
    batch = next(iter(SyntheticImageText(cfg, args.batch, image_seed=7, text_seed=9)))
    if args.ckpt_dir:
        # Train writes the FULL train state; restore the newest into a
        # matching one (the optimizer state only as the restore target) and
        # keep the weights. A checkpoint written with --ema-decay carries the
        # EMA, so on a mismatch try the other shape of target.
        from distributed_sigmoid_loss_tpu_torch.train import (
            create_train_state,
            make_optimizer,
            restore_latest,
        )
        from distributed_sigmoid_loss_tpu_torch.utils.config import TrainConfig

        tx = make_optimizer(TrainConfig(optimizer=args.optimizer))
        try:
            restored = restore_latest(args.ckpt_dir, create_train_state(model, tx, ema=args.ema))
        except ValueError as first_err:
            # If the other shape fails too, the problem is not the EMA (wrong
            # --model or --optimizer): surface the first error.
            try:
                restored = restore_latest(args.ckpt_dir,
                                          create_train_state(model, tx, ema=not args.ema))
            except ValueError:
                raise first_err from None
            if args.ema:
                print(f"--ema requested but the checkpoint at {args.ckpt_dir} has "
                      "no EMA weights (train with --ema-decay)", file=sys.stderr)
                return 2
        if restored is None:
            print(f"no checkpoint found under {args.ckpt_dir}", file=sys.stderr)
            return 2
        state, step = restored
        print(f"restored step {step} ({'ema' if args.ema else 'params'}) from "
              f"{args.ckpt_dir}", file=sys.stderr)
        if args.ema:
            with torch.no_grad():
                for p, e in zip(model.parameters(), state.ema):
                    p.copy_(e)
        del state

    batch = put_batch(batch, device)
    with torch.no_grad():
        zimg, ztxt, _ = model(batch["images"], batch["tokens"])
    out = {k: round(float(v), 4)
           for k, v in retrieval_metrics(zimg, ztxt, ks=(1, 5)).items()}

    # Zero-shot classification: class prompts through the tokenizer and the
    # text tower into a prompt-ensembled classifier; synthetic labels. The
    # class name first: short contexts (tiny: 8 tokens) would truncate a
    # trailing name away.
    n_classes = args.classes
    class_names = [f"c{c}" for c in range(n_classes)]
    rng = np.random.default_rng(0)
    label_values = rng.integers(0, n_classes, zimg.shape[0]).astype(np.int32)
    classifier = build_classifier(
        lambda tokens: model.encode_text(tokens.to(device)),
        class_names,
        _byte_tokenize_for(cfg, args.tokenizer),
        cfg.text.context_length,
        templates=("{} photo.", "{} image."),
    )
    labels = torch.from_numpy(label_values).to(device)
    ks = tuple(k for k in (1, 5) if k <= n_classes)
    zs = zeroshot_metrics(zimg, classifier, labels, ks=ks)
    out.update({f"zeroshot_{k}": round(float(v), 4) for k, v in zs.items()})
    print(out)
    return 0


def cmd_tokenizer(args) -> int:
    """Train a BPE vocab from captions and write it as JSON."""
    import glob

    from distributed_sigmoid_loss_tpu_torch.data import BpeTokenizer

    if bool(args.data_dir) == bool(args.text_file):
        print("pass exactly one of --data-dir or --text-file", file=sys.stderr)
        return 2
    if args.data_dir:
        paths = sorted(glob.glob(os.path.join(args.data_dir, "*.txt")))
        if not paths:
            print(f"no *.txt captions under {args.data_dir!r}", file=sys.stderr)
            return 2
        texts = []
        for path in paths:
            with open(path, encoding="utf-8") as f:
                texts.append(f.read().strip())
    else:
        with open(args.text_file, encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
    if not texts:
        print("corpus is empty (no non-blank captions)", file=sys.stderr)
        return 2
    tok = BpeTokenizer.train(texts, args.vocab_size)
    tok.save(args.out)
    sample = texts[0][:60]
    ratio = len(sample.encode("utf-8")) / max(1, len(tok.encode(sample)) - 2)
    print(f"trained {len(tok.merges)} merges (vocab {tok.vocab_size}) from "
          f"{len(texts)} captions -> {args.out}; ~{ratio:.2f} bytes/token on a sample")
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="distributed_sigmoid_loss_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="end-to-end SigLIP training (synthetic data)")
    tr.add_argument("--steps", type=int, default=20)
    tr.add_argument("--tokenizer", default="",
                    help="trained BPE vocab json (the `tokenizer` command), stashed "
                         "beside the checkpoints; default = byte-level tokenizer")
    tr.add_argument("--batch", type=int, default=64, help="global batch size")
    tr.add_argument("--variant", choices=["all_gather", "ring"], default=None,
                    help="loss comm pattern (default ring; --loss-impl chunked "
                         "selects all_gather)")
    tr.add_argument("--loss-impl", choices=["fused", "chunked"], default="fused",
                    help="all_gather loss shape: one fused block, or the gathered "
                         "negatives chunk by chunk")
    tr.add_argument("--ring-overlap", action="store_true",
                    help="issue the ring's hop k+1 before hop k's block products")
    tr.add_argument("--use-pallas", action="store_true",
                    help="the streaming loss kernel (K4-K6) as every loss block's body; "
                         "its int8 mode under --quant-train int8")
    tr.add_argument("--loss-family", choices=["sigmoid", "softmax"], default="sigmoid",
                    help="sigmoid = SigLIP (reference); softmax = CLIP/InfoNCE")
    tr.add_argument("--lr", type=float, default=1e-3)
    tr.add_argument("--optimizer", choices=["adamw", "lion", "adafactor"], default="adamw")
    tr.add_argument("--model", choices=["b16", "l14", "so400m", "tiny"], default="b16")
    tr.add_argument("--tiny", action="store_true", help="alias for --model tiny")
    tr.add_argument("--accum", type=int, default=1, help="grad-accumulation microsteps")
    tr.add_argument("--accum-bf16", action="store_true",
                    help="bf16 gradient accumulator under --accum (adds stay f32)")
    tr.add_argument("--remat-policy", default="",
                    choices=["", "nothing", "save_hot", "save_all_hot", "save_mlp"],
                    help="override both towers' remat policy")
    tr.add_argument("--quant-train", choices=["", "int8"], default="",
                    help="trainable int8: int8 forward projections through the "
                         "straight-through estimator")
    tr.add_argument("--accum-negatives", choices=["local", "global"], default="local",
                    help="with --accum > 1: 'local' contrasts each microbatch with its "
                         "own texts; 'global' computes the exact full-batch loss "
                         "(GradCache)")
    tr.add_argument("--gradcache-bf16", action="store_true",
                    help="with --accum-negatives global: the GradCache embedding stash in "
                         "bf16")
    tr.add_argument("--ema-decay", type=float, default=None,
                    help="keep an EMA of the params in the train state (e.g. 0.9999)")
    tr.add_argument("--cpu-devices", type=int, default=0,
                    help="1 = run on the CPU (default: cuda)")
    tr.add_argument("--ckpt-dir", default="",
                    help="checkpoint/resume directory: resumes from the newest "
                         "step-numbered checkpoint, saves every --ckpt-every steps and "
                         "on SIGTERM (preemption)")
    tr.add_argument("--async-checkpoint", action="store_true",
                    help="non-blocking checkpoint writes: a host snapshot, then the "
                         "write on a thread while the steps go on")
    tr.add_argument("--ckpt-every", type=int, default=50)
    tr.add_argument("--eval-every", type=int, default=0, metavar="N",
                    help="every N steps, log retrieval metrics (eval/i2t_recall@K ...) "
                         "on one fixed held-out synthetic batch")
    tr.add_argument("--log-every", type=int, default=1)
    tr.add_argument("--watchdog", choices=["off", "warn", "skip"], default="off",
                    help="'skip' routes a non-finite loss into the rollback-and-skip "
                         "path (requires --ckpt-dir); 'off' halts on it. 'warn' (the "
                         "JAX package's default) needs obs/health.py, not ported yet")
    # Flags of paths not ported yet (each exits 2 naming its ROADMAP item).
    tr.add_argument("--moe-experts", type=int, default=0)
    tr.add_argument("--moe-aux-weight", type=float, default=None)
    tr.add_argument("--moe-group-size", type=int, default=0)
    tr.add_argument("--pp", type=int, default=1)
    tr.add_argument("--pp-microbatches", type=int, default=0)
    tr.add_argument("--ep", type=int, default=1)
    tr.add_argument("--data-dir", default="")
    tr.add_argument("--data-shards", default="")
    tr.add_argument("--shuffle-buffer", type=int, default=0)
    tr.add_argument("--native-decode", action="store_true")
    tr.add_argument("--native-data", action="store_true")
    tr.add_argument("--data-workers", type=int, default=0, metavar="N")
    tr.add_argument("--update-sharding", choices=["off", "zero1", "full"], default="")
    tr.add_argument("--zero1", action="store_true")
    tr.add_argument("--dcn-slices", type=int, default=1, metavar="N")
    tr.add_argument("--force-dcn-emulation", action="store_true")
    tr.add_argument("--grad-compression", "--compression",
                    choices=["int8", "topk", "adaptive", "learned"], default="")
    tr.add_argument("--dcn-budget-mbps", type=float, default=None, metavar="MBPS")
    tr.add_argument("--controller", choices=["greedy", "budgeted"], default=None)
    tr.add_argument("--emu-dcn-mbps", type=float, default=None, metavar="MBPS")
    tr.add_argument("--topk-frac", type=float, default=0.01, metavar="F")
    tr.add_argument("--topk-exact", action="store_true")
    tr.add_argument("--eval-data", default="", metavar="PATH_OR_GLOB")
    tr.add_argument("--obs-dir", default="", metavar="DIR")
    tr.add_argument("--coordinator", default="")
    tr.add_argument("--num-processes", type=int, default=0)
    tr.add_argument("--process-id", type=int, default=-1)

    ev = sub.add_parser("eval", help="zero-shot retrieval + classification")
    ev.add_argument("--tokenizer", default="",
                    help="trained BPE vocab json; default = the checkpoint's stashed "
                         "vocab, else byte-level")
    ev.add_argument("--batch", type=int, default=64)
    ev.add_argument("--classes", type=int, default=10)
    ev.add_argument("--model", choices=["b16", "l14", "so400m", "tiny"], default="b16")
    ev.add_argument("--tiny", action="store_true", help="alias for --model tiny")
    ev.add_argument("--optimizer", choices=["adamw", "lion", "adafactor"], default="adamw",
                    help="optimizer the checkpoint was trained with (the restore "
                         "target's optimizer state)")
    ev.add_argument("--cpu-devices", type=int, default=0,
                    help="1 = run on the CPU (default: cuda)")
    ev.add_argument("--ckpt-dir", default="", help="restore params from this checkpoint")
    ev.add_argument("--quant", choices=["", "int8"], default="",
                    help="the towers' projections in dynamic int8 (inference only)")
    ev.add_argument("--ema", action="store_true",
                    help="evaluate the checkpoint's EMA weights (train --ema-decay)")
    # Flags of paths not ported yet (each exits 2 naming its ROADMAP item).
    ev.add_argument("--moe-experts", type=int, default=0)
    ev.add_argument("--data-dir", default="")
    ev.add_argument("--data-shards", default="")

    tk = sub.add_parser("tokenizer", help="train a byte-level BPE vocab on a caption corpus")
    tk.add_argument("out", help="output vocab json path")
    tk.add_argument("--vocab-size", type=int, default=4096)
    tk.add_argument("--data-dir", default="",
                    help="directory of name.txt caption files")
    tk.add_argument("--text-file", default="", help="plain text file, one caption per line")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    return {"train": cmd_train, "eval": cmd_eval, "tokenizer": cmd_tokenizer}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
