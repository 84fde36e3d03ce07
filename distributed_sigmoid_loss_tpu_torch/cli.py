"""Command-line entry point: ``python -m distributed_sigmoid_loss_tpu_torch <cmd>``
(or ``dsl-torch <cmd>``), with the JAX package's flag names and defaults.

- ``train``: SigLIP training on synthetic data (the default, or the native
  C++ engine under ``--native-data``) or on real image-text pairs: a folder
  (``--data-dir``) or webdataset-style tar shards (``--data-shards``), with
  a held-out eval source (``--eval-data``). The towers, the distributed
  sigmoid loss (ring or all-gather; K4-K6 under ``--use-pallas``), the
  optimizer, JSON-lines metrics, prefetch to the device, and with
  ``--ckpt-dir`` checkpoint/resume, preemption (SIGTERM) checkpoints and
  divergence rollback (``train.resilience.train_resilient``).
- ``eval``: retrieval and zero-shot classification of a fresh or
  checkpointed model on held-out synthetic data, or on real pairs (their
  captions are the zero-shot classes); ``--ema``: the checkpoint's EMA
  weights.
- ``tokenizer``: train a byte-level BPE vocab on a caption corpus.
- ``data-bench``: the input pipeline's stages and the composed pipeline
  against the synthetic loader (``data/data_bench.py``).
- ``serve-bench``: concurrent clients through the serving stack (engine,
  batcher, cache, the ``--index-tier`` retrieval router, ``--swap-every``
  hot swaps, ``/metrics`` under ``--metrics-port``), or a chaos scenario
  (``--scenario``, ``--fleet-scenario``); one JSON record with the JAX
  command's keys.

The commands run on ``cuda``; ``--cpu-devices 1`` runs them on the CPU
(serve-bench's ``hostloss`` and fleet drills touch no device and run on the
host either way). A flag whose path the port does not have yet exits 2
with a message naming its ROADMAP.md queue A item.
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


def _resolve_eval_data(path: str):
    """``--eval-data`` as ("dir", path), ("shards", [tars]) or (None, the
    error): one resolution for the early check and the source."""
    import glob

    if os.path.isdir(path):
        return "dir", path
    shards = glob.glob(path)
    if shards:
        return "shards", shards
    return None, f"--eval-data matched nothing: {path!r}"


def _eval_holdout_source(args, cfg, tokenize, native_decode: bool):
    """The ``--eval-data`` source (a directory or a tar-shard glob) of
    ``args.batch`` rows. ``native_decode`` follows the training stream's
    decoder: the two engines' pixels differ in the last bits, and an eval
    batch decoded otherwise would measure another distribution."""
    from distributed_sigmoid_loss_tpu_torch.data import ImageTextFolder, ImageTextShards

    kind, resolved = _resolve_eval_data(args.eval_data)
    if kind == "dir":
        return ImageTextFolder(resolved, cfg, args.batch, tokenize, native_decode=native_decode)
    if kind == "shards":
        return ImageTextShards(resolved, cfg, args.batch, tokenize, native_decode=native_decode)
    print(resolved, file=sys.stderr)
    raise SystemExit(2)


def _data_conflicts(args) -> str | None:
    """The ``train`` command's refusals of incoherent data flags (the JAX
    package's messages): the first, or None. The port runs one process, so
    JAX's multi-process refusals never apply."""
    import glob

    from distributed_sigmoid_loss_tpu_torch.data import resolve_data_workers

    if sum(map(bool, (args.data_dir, args.data_shards, args.native_data))) > 1:
        return "--data-dir, --data-shards and --native-data are mutually exclusive data sources"
    if args.shuffle_buffer and not args.data_shards:
        return ("--shuffle-buffer applies to --data-shards streams only "
                "(--data-dir already shuffles whole epochs)")
    if args.native_decode and not (args.data_dir or args.data_shards):
        return ("--native-decode without --data-dir/--data-shards would be a "
                "silent no-op (synthetic data is not decoded)")
    try:
        resolve_data_workers(args.data_workers)
    except ValueError as e:
        return f"--data-workers: {e}"
    if args.data_shards and not glob.glob(args.data_shards):
        return f"--data-shards matched nothing: {args.data_shards!r}"
    if args.eval_data and not args.eval_every:
        return ("--eval-data without --eval-every would be a silent no-op "
                "(nothing ever evaluates it)")
    if args.eval_data:
        kind, resolved = _resolve_eval_data(args.eval_data)
        if kind is None:
            return resolved
    return None


def _train_source(args, cfg):
    """The training stream: ``(source, tokenize, native_decode)``. File
    sources read one process's whole batch (``shard_index=0,
    num_shards=1``); the host-side fallbacks of ``--native-decode`` and
    ``--native-data`` are the JAX package's, with its warnings."""
    import glob

    from distributed_sigmoid_loss_tpu_torch.data import (
        ImageTextFolder,
        ImageTextShards,
        SyntheticImageText,
        resolve_data_workers,
    )

    # 0 = auto (cpu_count minus the prefetch/main threads): the host pool for
    # decode (file sources) or generation (the native engine).
    data_workers = resolve_data_workers(args.data_workers)
    if args.data_dir or args.data_shards:
        tokenize = _byte_tokenize_for(cfg, args.tokenizer)
        native_decode = False
        if args.native_decode:
            from distributed_sigmoid_loss_tpu_torch.data.native_decode import (
                native_decode_available,
            )

            native_decode = native_decode_available()
            if not native_decode:
                print("--native-decode: libjpeg engine unavailable, falling back to PIL "
                      "decode", file=sys.stderr)
        if args.data_dir:
            source = ImageTextFolder(args.data_dir, cfg, args.batch, tokenize,
                                     native_decode=native_decode, data_workers=data_workers)
        else:
            source = ImageTextShards(glob.glob(args.data_shards), cfg, args.batch, tokenize,
                                     shard_index=0, num_shards=1, native_decode=native_decode,
                                     shuffle_buffer=args.shuffle_buffer,
                                     data_workers=data_workers)
        return source, tokenize, native_decode
    if args.native_data:
        from distributed_sigmoid_loss_tpu_torch.data import (
            NativeSyntheticImageText,
            native_available,
        )

        reason = "no C++ toolchain or prebuilt library"
        if native_available():
            try:
                return NativeSyntheticImageText(cfg, args.batch,
                                                num_threads=data_workers), None, False
            except (RuntimeError, OSError) as e:
                reason = f"engine unusable: {e}"
        print(f"--native-data: {reason}; falling back to the numpy pipeline", file=sys.stderr)
    return SyntheticImageText(cfg, args.batch), None, False


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
    refusal = _unported(args) or _train_config_conflicts(args) or _data_conflicts(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    device, code = _device(args)
    if device is None:
        return code

    import dataclasses

    import torch

    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.train import make_optimizer
    from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, TrainConfig

    cfg = _model_config(args)
    if args.loss_family != "sigmoid":
        # t_prime's init depends on the family (CLIP: log(1/0.07)).
        cfg = dataclasses.replace(cfg, loss=LossConfig(family=args.loss_family))
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""), file=sys.stderr)
    model = SigLIP(cfg, device=device)
    tx = make_optimizer(TrainConfig(learning_rate=args.lr, warmup_steps=5,
                                    total_steps=max(args.steps, 10), optimizer=args.optimizer))
    source, tokenize, native_decode = _train_source(args, cfg)
    try:
        return _train(args, device, cfg, model, tx, source, tokenize, native_decode)
    finally:
        close = getattr(source, "close", None)  # the native engine's threads
        if close is not None:
            close()


def _train(args, device, cfg, model, tx, source, tokenize, native_decode) -> int:
    import torch

    from distributed_sigmoid_loss_tpu_torch.data import (
        PrefetchStats,
        SyntheticImageText,
        prefetch,
        put_batch,
        shard_batch,
    )
    from distributed_sigmoid_loss_tpu_torch.eval import retrieval_metrics
    from distributed_sigmoid_loss_tpu_torch.train import (
        AsyncSaver,
        PreemptionGuard,
        RestoreRequiredError,
        create_train_state,
        latest_step,
        make_train_step,
        train_resilient,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig
    from distributed_sigmoid_loss_tpu_torch.utils.logging import MetricsLogger

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
        # Every stream is deterministic per position (seeded): on resume,
        # draw and drop the batches the checkpointed steps consumed, so the
        # resumed run sees the stream an uninterrupted run would.
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
        # ONE fixed batch for every in-training eval: the curve measures the
        # model, not data drift. It is not drawn from the training stream,
        # whose positions a resume skips by count. Synthetic runs take a
        # held-out batch (shifted seeds), file and native streams the
        # --eval-data holdout, else the position-0 training batch (with
        # JAX's warning: that curve partly measures train-set fit).
        if args.eval_data:
            try:
                # A holdout smaller than a batch raises ValueError: at
                # construction for a folder, at the first draw for shards.
                holdout = _eval_holdout_source(
                    args, cfg, tokenize or _byte_tokenize_for(cfg, args.tokenizer),
                    native_decode=native_decode)
                eval_first = next(iter(holdout))
            except ValueError as e:
                print(f"--eval-data: {e}", file=sys.stderr)
                return 2
            eval_batch = put_batch(eval_first, device)
        elif isinstance(source, SyntheticImageText):
            eval_batch = put_batch(shard_batch(next(iter(SyntheticImageText(
                cfg, args.batch, image_seed=43, text_seed=41)))), device)
        else:
            print("--eval-every without --eval-data on a file/native stream: the fixed eval "
                  "batch is the position-0 TRAINING batch, so the curve partially measures "
                  "train-set fit — pass --eval-data with held-out shards or a directory for "
                  "a true validation curve", file=sys.stderr)
            eval_batch = put_batch(shard_batch(first), device)

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

    # Retrieval on the stream's next batch (the embeddings come normalized).
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
    if args.data_dir and args.data_shards:
        print("--data-dir and --data-shards are mutually exclusive", file=sys.stderr)
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
    captions = None
    if args.data_dir or args.data_shards:
        # Real pairs through the loaders train uses; their captions are the
        # zero-shot class names (below).
        import glob

        from distributed_sigmoid_loss_tpu_torch.data import ImageTextFolder, ImageTextShards

        tokenize = _byte_tokenize_for(cfg, args.tokenizer)
        if args.data_dir:
            source = ImageTextFolder(args.data_dir, cfg, args.batch, tokenize,
                                     keep_captions=True)
        else:
            shards = glob.glob(args.data_shards)
            if not shards:
                print(f"--data-shards matched nothing: {args.data_shards!r}", file=sys.stderr)
                return 2
            source = ImageTextShards(shards, cfg, args.batch, tokenize, keep_captions=True)
        batch = next(iter(source))
        captions = batch.pop("captions")
    else:
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
    # text tower into a prompt-ensembled classifier.
    if captions is not None:
        # Real data: the batch's distinct captions are the label space, each
        # image's class its own caption (retrieval as classification).
        class_names = sorted(set(captions))
        n_classes = len(class_names)
        class_index = {c: i for i, c in enumerate(class_names)}
        label_values = np.asarray([class_index[c] for c in captions], np.int32)
    else:
        # Synthetic labels. The class name first: short contexts (tiny: 8
        # tokens) would truncate a trailing name away.
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


def _emit_serve_record(record: dict, *, strict_zero_drops: bool = False) -> int:
    """The serve-bench emit contract, shared by the snapshot and scenario
    paths: print the record (one JSON line, the JAX command's keys; the port
    keeps no ledger). With ``strict_zero_drops`` a non-zero ``silent_drops``
    count fails the run — the chaos scenarios' every-outcome-is-typed
    gate."""
    print(json.dumps(record), flush=True)
    if strict_zero_drops and record.get("silent_drops"):
        print(f"WARNING: {record['silent_drops']} silent drop(s) — a request ended with "
              "neither a result nor a typed rejection; the degradation contract is broken",
              file=sys.stderr)
        return 1
    return 0


def _serve_bench_refusal(args) -> str | None:
    """The serve-bench command's refusals (exit 2), in the JAX command's
    order: the first, or None."""
    if args.requests < 1 or args.clients < 1:
        return "--requests and --clients must be >= 1"
    if args.swap_every < 0 or args.rerank_k < 0:
        return "--swap-every and --rerank-k must be >= 0"
    if args.index_tier == "sharded" and not args.mesh:
        return ("--index-tier sharded needs --mesh (the devices the corpus partitions "
                "over: the visible GPU, or the CPU with --cpu-devices 1)")
    try:
        tuple(int(b) for b in args.batch_buckets.split(","))
    except ValueError:
        return f"--batch-buckets must be comma-separated ints, got {args.batch_buckets!r}"
    if args.fleet_scenario and args.scenario:
        return "--fleet-scenario and --scenario are mutually exclusive (one drill per run)"
    if not args.fleet_scenario and (args.fleet_replicas or args.lease_ttl_s):
        return "--fleet-replicas/--lease-ttl-s only make sense with --fleet-scenario"
    if args.fleet_scenario and args.fleet_replicas and args.fleet_replicas < 2:
        return ("--fleet-replicas must be >= 2 (with one replica there is no sibling to "
                "reroute to and no wave to order)")
    if (args.scenario or args.fleet_scenario) and (
            args.duration_s <= 0 or args.offered_load <= 0 or args.capacity < 1):
        return "--duration-s/--offered-load must be > 0 and --capacity >= 1"
    return None


def serve_bench_stack(args, model, buckets, shard_devices=None) -> dict:
    """The serving stack serve-bench drives, over ``model``: the synthetic
    pool (``--pool`` items, seeds ``--seed`` + 1 and + 2, as the JAX
    command's), the bucketed engine warmed, the corpus (the first
    ``--index-size`` pool images) encoded straight through the engine and
    published to a :class:`RetrievalRouter` of ``--index-tier``.
    ``shard_devices``: the sharded tier's devices."""
    import time

    import numpy as np

    from distributed_sigmoid_loss_tpu_torch.data import SyntheticImageText
    from distributed_sigmoid_loss_tpu_torch.serve import InferenceEngine, RetrievalRouter

    pool = max(args.pool, 1)
    batch = next(iter(SyntheticImageText(model.cfg, pool, image_seed=args.seed + 1,
                                         text_seed=args.seed + 2)))
    pool_tokens, pool_images = batch["tokens"].numpy(), batch["images"].numpy()
    engine = InferenceEngine.from_model(model, batch_buckets=buckets)
    t0 = time.perf_counter()
    warmed = engine.warmup()
    warmup_s = time.perf_counter() - t0
    # Corpus embeddings straight through the engine (the service clock should
    # measure client traffic, not index build), chunked to the largest bucket.
    step = buckets[-1]
    corpus_emb = np.concatenate([
        engine.encode_image(pool_images[i: i + step])
        for i in range(0, min(args.index_size, pool), step)
    ])
    router = RetrievalRouter(tier=args.index_tier,
                             devices=shard_devices if args.index_tier == "sharded" else None,
                             rerank_k=args.rerank_k or None)
    router.publish(corpus_emb)
    if args.index_tier == "sharded":
        # The first search off the clock, as the engine's warmup.
        router.search(corpus_emb[:1], k=args.topk)
    return dict(engine=engine, router=router, corpus_emb=corpus_emb, pool_tokens=pool_tokens,
                pool_images=pool_images, warmed=warmed, warmup_s=warmup_s)


def cmd_serve_bench(args) -> int:
    """Drive the serve/ stack on synthetic data with concurrent clients and
    print the ``stats()`` snapshot as one JSON record (the JAX command's
    keys). With warmed buckets ``compile_count`` equals the warmed bucket
    count, not the request count (else exit 1); ``--scenario`` and
    ``--fleet-scenario`` print their degradation records instead (exit 1 on
    any silent drop, or on an over-ceiling sample)."""
    import concurrent.futures
    import threading

    import numpy as np

    refusal = _serve_bench_refusal(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    buckets = tuple(int(b) for b in args.batch_buckets.split(","))
    scenario_tenants = None
    if args.scenario or args.fleet_scenario:
        from distributed_sigmoid_loss_tpu_torch.serve import parse_tenant_spec

        try:
            scenario_tenants = parse_tenant_spec(args.tenants)
        except ValueError as e:
            print(f"--tenants: {e}", file=sys.stderr)
            return 2

    if args.fleet_scenario:
        # The fleet drill: leased admission → router → EngineProcess replicas
        # with standard-library surrogate workers, so it drills the fleet's
        # failure semantics (lease reclaim, typed reroute, swap waves) with no
        # tensor involved, before any device is set up. Over-admission fails
        # the run.
        from distributed_sigmoid_loss_tpu_torch.serve import run_fleet_scenario

        record = run_fleet_scenario(
            args.fleet_scenario, replicas=args.fleet_replicas or 3,
            tenants=scenario_tenants, duration_s=args.duration_s,
            offered_load=args.offered_load, lease_ttl_s=args.lease_ttl_s or 0.5,
            seed=args.seed,
        )
        rc = _emit_serve_record(record, strict_zero_drops=True)
        if record.get("over_ceiling_samples"):
            print(f"WARNING: {record['over_ceiling_samples']} window sample(s) exceeded the "
                  "global admission ceiling — the bounded-staleness lease invariant is broken",
                  file=sys.stderr)
            return 1
        return rc

    if args.scenario == "hostloss":
        # The host-loss drill: admission → batcher → EngineProcess with the
        # surrogate worker (kill -9 mid-traffic, typed HostLostError to every
        # in-flight caller, measured recovery); no tensor is involved, so it
        # runs before any device is set up.
        from distributed_sigmoid_loss_tpu_torch.serve import hostloss_drill

        record = hostloss_drill(
            tenants=scenario_tenants, duration_s=args.duration_s,
            offered_load=args.offered_load, capacity=args.capacity, seed=args.seed,
        )
        return _emit_serve_record(record, strict_zero_drops=True)

    device, code = _device(args)
    if device is None:
        return code

    import torch

    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.serve import (
        AdmissionController,
        EmbeddingCache,
        EmbeddingService,
        QueueFullError,
        RequestTimeoutError,
        SwapController,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.logging import MetricsLogger

    shard_devices = None
    if args.mesh:
        shard_devices = ([device] if device.type == "cpu" else
                         [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        if len(shard_devices) > 1:
            print(f"--mesh: {len(shard_devices)} GPUs are visible; the engine's batch split "
                  "over several GPUs is not ported yet: ROADMAP.md queue A item 9 (with one "
                  "visible GPU, --mesh puts the sharded tier's shard on it)", file=sys.stderr)
            return 2

    cfg = _model_config(args)
    model = SigLIP(cfg, device=device,
                   generator=torch.Generator(device=device).manual_seed(args.seed)).eval()
    stack = serve_bench_stack(args, model, buckets, shard_devices)
    engine, router, corpus_emb = stack["engine"], stack["router"], stack["corpus_emb"]
    pool_tokens, pool_images = stack["pool_tokens"], stack["pool_images"]
    warmed, warmup_s = stack["warmed"], stack["warmup_s"]
    pool = len(pool_tokens)
    params = engine.params
    print(f"warmed {warmed} shape buckets in {warmup_s:.1f}s ({args.model} model, "
          f"{len(buckets)} batch buckets, {device})", file=sys.stderr)

    admission = AdmissionController(scenario_tenants, capacity=args.capacity) \
        if args.scenario else None
    service = EmbeddingService(
        engine, cache=EmbeddingCache(args.cache_size), index=router,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue, default_timeout=60.0,
        logger=MetricsLogger(), admission=admission,
    )
    if args.metrics_port >= 0:
        exporter = service.start_metrics_server(port=args.metrics_port)
        print(f"serve-bench: live /metrics at {exporter.url}", file=sys.stderr)

    def compile_gate(snap) -> bool:
        # Steady state: every bucket was warmed before traffic; a request off
        # the grid would show as one more.
        if snap["compile_count"] != warmed:
            print(f"WARNING: compile_count {snap['compile_count']} != warmed buckets "
                  f"{warmed} — a request ran off the warmed bucket grid", file=sys.stderr)
            return False
        return True

    base = {"model": args.model, "clients": args.clients, "batch_buckets": list(buckets),
            "max_wait_ms": args.max_wait_ms, "sharded": bool(shard_devices),
            "index_tier": args.index_tier, "swap_every": args.swap_every,
            "warmup_s": round(warmup_s, 2)}

    if args.scenario:
        # The scenario soak: the chaos harness's shaped offered load replaces
        # the fixed-request client loop, the real engine underneath and
        # admission at the front door; its degradation record merges with the
        # stats() snapshot, and any silent drop fails the run.
        from distributed_sigmoid_loss_tpu_torch.serve import run_scenario

        swap_fn = None
        if args.scenario == "swapstorm":
            storm_controller = SwapController(engine, router)

            def swap_fn() -> None:
                storm_controller.swap(params=params, embeddings=corpus_emb)

        def submit(tenant: str, i: int, *, items: int = 1, fresh: bool = False) -> None:
            if fresh:
                # A deterministic per-i row that always misses the cache.
                rng = np.random.default_rng(args.seed * 100003 + i)
                row = rng.integers(0, cfg.text.vocab_size, cfg.text.context_length,
                                   dtype=np.int32)
                service.encode_text(row, tenant=tenant, timeout=5.0)
            elif items > 1:
                rows = np.stack([pool_tokens[(i + j) % pool] for j in range(items)])
                service.encode_text(rows, tenant=tenant, timeout=5.0)
            else:
                service.encode_text(pool_tokens[i % pool], tenant=tenant, timeout=5.0)

        scen = run_scenario(
            args.scenario, submit=submit, tenants=scenario_tenants, admission=admission,
            duration_s=args.duration_s, offered_load=args.offered_load,
            clients_per_tenant=args.clients, swap_fn=swap_fn, seed=args.seed,
        )
        snap = service.stats()
        service.close()
        rc = _emit_serve_record({**base, **snap, **scen}, strict_zero_drops=True)
        return rc if compile_gate(snap) else 1

    # --swap-every N churn: a swapper thread republishes the weights and
    # freshly built index segments after every N completed client ops, under
    # the traffic the bench measures.
    ops_done = [0]
    swap_done = threading.Event()
    swap_thread = None
    if args.swap_every:
        controller = SwapController(engine, router)

        def swapper():
            next_at = args.swap_every
            while not swap_done.is_set():
                if ops_done[0] >= next_at:
                    controller.swap(params=params, embeddings=corpus_emb)
                    next_at += args.swap_every
                else:
                    swap_done.wait(0.002)

        swap_thread = threading.Thread(target=swapper, name="serve-bench-swapper", daemon=True)
        swap_thread.start()

    def client(cid: int, n_ops: int) -> None:
        rng = np.random.default_rng(args.seed * 1000 + cid)
        for _ in range(n_ops):
            op = rng.random()
            try:
                if op < 0.2:  # image encode from the shared pool (cacheable)
                    service.encode_image(pool_images[rng.integers(pool)])
                elif op < 0.4:  # retrieval query
                    service.search(pool_tokens[rng.integers(pool)], k=args.topk)
                elif op < 0.7:  # repeated text from the pool (cacheable)
                    service.encode_text(pool_tokens[rng.integers(pool)])
                else:  # fresh text (a cache miss: batcher and engine)
                    row = rng.integers(0, cfg.text.vocab_size, cfg.text.context_length,
                                       dtype=np.int32)
                    service.encode_text(row)
            except (QueueFullError, RequestTimeoutError):
                pass  # counted in service.stats()
            ops_done[0] += 1

    per_client = [args.requests // args.clients] * args.clients
    for i in range(args.requests % args.clients):
        per_client[i] += 1
    with concurrent.futures.ThreadPoolExecutor(args.clients) as pool_ex:
        list(pool_ex.map(client, range(args.clients), per_client))
    if swap_thread is not None:
        swap_done.set()
        swap_thread.join(timeout=60)

    snap = service.stats()
    service.close()
    record = {"metric": "serve_bench", "value": snap["qps"], "unit": "req/s",
              "model": args.model, "clients": args.clients, "requests_sent": args.requests,
              **{k: v for k, v in base.items() if k not in ("model", "clients")}, **snap}
    rc = _emit_serve_record(record)
    return rc if compile_gate(snap) else 1


def cmd_data_bench(args) -> int:
    """The input pipeline's stage bench (``data/data_bench.py``)."""
    from distributed_sigmoid_loss_tpu_torch.data.data_bench import run_data_bench

    return run_data_bench(args)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="distributed_sigmoid_loss_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="end-to-end SigLIP training (synthetic or real data)")
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
                         "on one fixed batch: a held-out synthetic batch, the --eval-data "
                         "holdout, or (with a warning) the first training batch of a "
                         "file/native stream")
    tr.add_argument("--data-dir", default="",
                    help="train on a directory of name.jpg + name.txt pairs (real data)")
    tr.add_argument("--data-shards", default="",
                    help="train on webdataset-style tar shards matching this glob (real data)")
    tr.add_argument("--shuffle-buffer", type=int, default=0,
                    help="sample-shuffle reservoir size for --data-shards (webdataset-style; "
                         "0 = stream in tar order)")
    tr.add_argument("--native-decode", action="store_true",
                    help="decode JPEGs with the native libjpeg engine (threaded, off-GIL; "
                         "with --data-dir or --data-shards); falls back to PIL with a notice")
    tr.add_argument("--native-data", action="store_true",
                    help="the C++ synthetic engine (native/dataloader.cc) instead of the "
                         "numpy stream; falls back with a notice where it cannot be built")
    tr.add_argument("--data-workers", type=int, default=0, metavar="N",
                    help="host worker threads for decode / native generation (0 = auto: "
                         "cpu_count minus the prefetch/main threads)")
    tr.add_argument("--eval-data", default="", metavar="PATH_OR_GLOB",
                    help="held-out eval source for --eval-every: a directory "
                         "(ImageTextFolder layout) or a tar-shard glob")
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
    ev.add_argument("--data-dir", default="",
                    help="directory of name.jpg + name.txt pairs: score real pairs "
                         "(retrieval + caption-matching zero-shot) instead of synthetic data")
    ev.add_argument("--data-shards", default="",
                    help="glob of webdataset-style tar shards (the loaders train uses); "
                         "mutually exclusive with --data-dir")
    # Flags of paths not ported yet (each exits 2 naming its ROADMAP item).
    ev.add_argument("--moe-experts", type=int, default=0)

    tk = sub.add_parser("tokenizer", help="train a byte-level BPE vocab on a caption corpus")
    tk.add_argument("out", help="output vocab json path")
    tk.add_argument("--vocab-size", type=int, default=4096)
    tk.add_argument("--data-dir", default="",
                    help="directory of name.txt caption files")
    tk.add_argument("--text-file", default="", help="plain text file, one caption per line")

    db = sub.add_parser("data-bench", help="input-pipeline stage bench: shard read / decode / "
                                           "tokenize / augment / h2d commit alone, and the "
                                           "composed real-data pipeline vs the synthetic loader")
    from distributed_sigmoid_loss_tpu_torch.data.data_bench import add_data_bench_args

    add_data_bench_args(db)
    db.add_argument("--cpu-devices", type=int, default=0,
                    help="1 = run augment and the commits on the CPU (default: cuda)")

    sb = sub.add_parser("serve-bench", help="online serving micro-bench: concurrent clients "
                                            "through the batched/cached/bucketed serve/ stack; "
                                            "prints the stats snapshot as JSON")
    sb.add_argument("--requests", type=int, default=512,
                    help="total client requests across all clients")
    sb.add_argument("--clients", type=int, default=8, help="concurrent client threads")
    sb.add_argument("--model", choices=["b16", "l14", "so400m", "tiny"], default="tiny",
                    help="tower config (default tiny: the CPU-runnable smoke shape)")
    sb.add_argument("--batch-buckets", default="1,8,32", metavar="N,N,...",
                    help="padded batch-size buckets the engine warms (steady state never "
                         "runs outside the grid)")
    sb.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="micro-batcher deadline: max ms a queued request waits for "
                         "coalescing before a partial flush")
    sb.add_argument("--max-queue", type=int, default=1024,
                    help="bounded request queue per modality (full queue rejects with "
                         "backpressure)")
    sb.add_argument("--cache-size", type=int, default=4096,
                    help="LRU embedding cache capacity (entries)")
    sb.add_argument("--pool", type=int, default=64,
                    help="distinct synthetic items clients draw from (repeats exercise "
                         "the cache)")
    sb.add_argument("--index-size", type=int, default=64,
                    help="corpus rows indexed for the search requests")
    sb.add_argument("--index-tier", choices=["exact", "sharded", "ann"], default="exact",
                    help="retrieval tier answering search requests: exact = the host's "
                         "chunked scan (the oracle), sharded = per-shard top-k on the "
                         "--mesh devices + merged candidates, ann = int8 "
                         "quantize-then-rerank with measured recall@k in the record")
    sb.add_argument("--swap-every", type=int, default=0, metavar="N",
                    help="churn mode: hot-swap the weights + freshly built index segments "
                         "after every N completed client ops (0 = off)")
    sb.add_argument("--rerank-k", type=int, default=0, metavar="K",
                    help="ann tier: coarse candidates kept for the exact re-rank (0 = auto: "
                         "max(8·topk, 64))")
    sb.add_argument("--topk", type=int, default=5)
    sb.add_argument("--metrics-port", type=int, default=-1, metavar="PORT",
                    help="expose the live OpenMetrics-style /metrics endpoint during the "
                         "bench on this port (0 = an ephemeral port, printed on stderr; "
                         "-1 = off)")
    sb.add_argument("--scenario", default="",
                    choices=["", "burst", "skew", "slowloris", "hostloss", "swapstorm"],
                    help="chaos soak: replace the fixed-request client loop with a shaped "
                         "overload scenario (multi-tenant admission at the front door) and "
                         "emit the degradation record")
    sb.add_argument("--tenants", default="gold:prio=2,quota=24,slo=500;"
                                         "free:prio=1,rate=80,quota=8",
                    metavar="SPEC",
                    help="scenario tenant policies, ';'-separated name:key=value[,...] rows "
                         "(keys: prio, rate req/s, burst, quota in-flight items, slo ms)")
    sb.add_argument("--duration-s", type=float, default=4.0,
                    help="scenario soak duration (wall seconds of offered load)")
    sb.add_argument("--offered-load", type=float, default=200.0,
                    help="aggregate offered load across tenants (req/s) the scenario shapes")
    sb.add_argument("--capacity", type=int, default=64,
                    help="AdmissionController global in-flight item budget (priority tiers "
                         "partition it under overload)")
    sb.add_argument("--fleet-scenario", default="",
                    choices=["", "fleet-rolling-swap", "fleet-hostloss", "fleet-splitbrain"],
                    help="fleet drill: N EngineProcess-backed replicas behind the fleet "
                         "router with token-lease admission; emits the fleet_siege record")
    sb.add_argument("--fleet-replicas", type=int, default=0, metavar="N",
                    help="replica count for --fleet-scenario (>= 2; 0 = unset: 3)")
    sb.add_argument("--lease-ttl-s", type=float, default=0.0, metavar="S",
                    help="fleet lease TTL: a dead host's quota slices expire and "
                         "redistribute within this bound (0 = unset: 0.5)")
    sb.add_argument("--seed", type=int, default=0)
    sb.add_argument("--mesh", action="store_true",
                    help="put the sharded tier's shards on the visible devices (one GPU, or "
                         "the CPU under --cpu-devices 1; several GPUs: ROADMAP.md queue A "
                         "item 9)")
    sb.add_argument("--cpu-devices", type=int, default=0,
                    help="1 = run on the CPU (default: cuda)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    return {"train": cmd_train, "eval": cmd_eval, "tokenizer": cmd_tokenizer,
            "data-bench": cmd_data_bench, "serve-bench": cmd_serve_bench}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
