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
- ``export``: the train step or the forward as a ``torch.export`` artifact
  that replays through the hand-written kernels (``train/export.py``);
  ``--check`` replays it against the live step.
- ``data-bench``: the input pipeline's stages and the composed pipeline
  against the synthetic loader (``data/data_bench.py``).
- ``serve-bench``: concurrent clients through the serving stack (engine,
  batcher, cache, the ``--index-tier`` retrieval router, ``--swap-every``
  hot swaps, ``/metrics`` under ``--metrics-port``), or a chaos scenario
  (``--scenario``, ``--fleet-scenario``); one JSON record with the JAX
  command's keys.
- ``obs``: offline reports of a run's records: ``obs summarize DIR`` merges
  the host spans a ``train --obs-dir`` run recorded with any device trace
  under DIR (``utils.profiling.trace``), ``obs ledger`` summarizes the run
  ledger's trajectories, ``obs diff A B`` diffs two records or two runs'
  spans. It reads files only and touches no device. ``obs regress`` checks
  the proxy metrics of the step configs and the loss islands against the
  committed baseline (``obs/regress.py``).
- ``lint``: the static analyzers of ``analysis/`` (exit 1 on findings).

The commands run on ``cuda``; ``--cpu-devices 1`` runs them on the CPU
(serve-bench's ``hostloss`` and fleet drills touch no device and run on the
host either way). Run by every rank of an initialized process group
(``train --coordinator HOST:PORT --num-processes N --process-id I`` joins
one, ``parallel/multihost.py``), ``train`` lays the ranks out on a
``parallel.mesh.ProcessGrid`` by JAX's rules: ``(dcn, dp[, pp])`` with
``--dcn-slices``, ``(dp, pp)`` with ``--pp``, ``(dp, ep)`` with ``--ep``,
else ``(dp,)``. ``lint`` and ``obs regress`` trace on the host's CPU, in a
fake process group of their own, and touch no device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys

__all__ = ["main"]

def _device(args):
    """``(device, None)``, or ``(None, exit code)`` after a message. On
    CUDA, each rank of a process group takes device ``rank %
    device_count``."""
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
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count()), None
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

    moe = getattr(args, "moe_experts", 0)
    if moe:
        # Shared by train and eval: a checkpoint trained with --moe-experts
        # restores only into an MoE model of the same shape.
        if moe < 2:
            raise SystemExit(f"--moe-experts must be >= 2, got {moe}")
        group = getattr(args, "moe_group_size", 0)
        tower_kw = {"moe_experts": moe}
        if group:
            if group < 1:
                raise SystemExit(f"--moe-group-size must be >= 1, got {group}")
            tower_kw["moe_group_size"] = group
        cfg = towers(**tower_kw)
    elif getattr(args, "moe_group_size", 0):
        raise SystemExit("--moe-group-size without --moe-experts is a no-op")
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
    if args.ep < 1:
        return f"--ep must be >= 1, got {args.ep}"
    if args.moe_aux_weight is not None and not args.moe_experts:
        return ("--moe-aux-weight without --moe-experts would be a silent "
                "no-op (a dense model has no routers to balance)")
    if args.pp > 1 and args.moe_experts:
        return "--pp with --moe-experts is not supported (pp towers are dense)"
    update_mode = args.update_sharding or ""
    if args.zero1 and update_mode not in ("", "zero1"):
        return (f"--zero1 is the deprecated alias for --update-sharding "
                f"zero1 and contradicts --update-sharding {update_mode}; "
                "drop one of them")
    if args.zero1 and not update_mode:
        update_mode = "zero1"
    if update_mode == "off":
        update_mode = ""
    if args.pp > 1 and update_mode:
        return (f"--pp with --update-sharding {update_mode} is not supported "
                "(the sharded update — zero1's constrain and full's "
                "reduce-scatter alike — would re-shard the stage-local "
                "moments dp-wise every step)")
    if args.pp_microbatches and args.pp <= 1:
        return "--pp-microbatches without --pp > 1 would be a silent no-op"
    if args.pp_microbatches < 0:
        return f"--pp-microbatches must be >= 1, got {args.pp_microbatches}"
    if args.accum_bf16 and args.accum == 1:
        return ("--accum-bf16 requires --accum > 1 (the unaccumulated step "
                "has no accumulator)")
    if args.pp > 1 and args.accum > 1 and args.accum_negatives == "global":
        return ("--accum-negatives global with --pp is not supported (the pp "
                "forward is already whole-batch per accumulation step)")
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
    return _sync_conflicts(args)


def _sync_conflicts(args) -> str | None:
    """The refusals of the gradient-sync flags (JAX ``cli.py``: the dcn
    axis and compression), JAX's messages."""
    if args.dcn_slices > 1 and not args.grad_compression:
        return ("--dcn-slices without --grad-compression is a silent no-op: "
                "the regular step already spans slices when the dp axis is "
                "built dcn-outermost (parallel/multihost.py make_hybrid_mesh); "
                "the separate dcn axis exists to compress its gradient hop")
    if args.grad_compression:
        reasons = []
        if args.dcn_slices < 2:
            reasons.append("--dcn-slices >= 2 (the dcn axis being compressed)")
        if args.variant == "ring":
            reasons.append("--variant all_gather or unset (ring ppermute has "
                           "no joint-(dcn,dp) axis form)")
        if args.ep > 1:
            reasons.append("no --ep (expert parallelism needs the regular step)")
        if args.ring_overlap:
            reasons.append("no --ring-overlap (compressed sync is "
                           "all_gather-only; there is no ring hop loop)")
        if args.ema_decay is not None:
            reasons.append("no --ema-decay")
        if args.grad_compression in ("topk", "adaptive", "learned") and not (
                0 < args.topk_frac <= 1):
            reasons.append(
                f"--topk-frac in (0, 1], got {args.topk_frac} (it is the "
                f"fraction of gradient entries kept per tensor)"
            )
        if args.grad_compression in ("adaptive", "learned") and args.pp > 1:
            reasons.append(
                "no --pp (the adaptive controller's scheme table is per "
                "GLOBAL tensor; pp shards block grads stage-locally — use "
                "int8/topk under pp)"
            )
        if reasons:
            return "--grad-compression requires: " + "; ".join(reasons)
    ladder = ("topk", "adaptive", "learned")
    if args.topk_frac != 0.01 and args.grad_compression not in ladder:
        return "--topk-frac without --grad-compression topk is a silent no-op"
    if args.topk_exact and args.grad_compression not in ladder:
        return "--topk-exact without --grad-compression topk is a silent no-op"
    if args.dcn_budget_mbps is not None and args.grad_compression not in ladder[1:]:
        return ("--dcn-budget-mbps without --grad-compression adaptive is a "
                "silent no-op: only the adaptive bit controller consumes the "
                "bandwidth budget")
    if args.controller and args.grad_compression not in ladder[1:]:
        return ("--controller without --grad-compression adaptive/learned is "
                "a silent no-op: the bit controller only exists inside the "
                "adaptive step wrapper (a fixed scheme has no per-round "
                "policy to select)")
    if args.emu_dcn_mbps is not None and args.dcn_slices < 2:
        return ("--emu-dcn-mbps without --dcn-slices >= 2 is a silent no-op: "
                "the emulated pipe carries the dcn hop's payload, and there "
                "is no dcn mesh axis (or compressed sync round) to emulate")
    return None


def _process_grid(args):
    """The train (and export) command's process grid, by JAX's
    ``_make_training_mesh`` rules over the run's processes: ``(dcn, dp[,
    pp])`` with ``--dcn-slices`` (the dcn axis outermost: slice i is the
    ranks ``[i·W/dcn, (i+1)·W/dcn)``), ``(dp, pp)`` with ``--pp``, ``(dp,
    ep)`` with ``--ep``, else ``(dp,)``. ``(grid, None)`` or ``(None,
    message)``."""
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import ProcessGrid, axis_size

    world = axis_size()
    pp, ep = getattr(args, "pp", 1), args.ep
    if getattr(args, "dcn_slices", 1) > 1:
        dcn = args.dcn_slices
        if ep > 1:
            return None, "--dcn-slices composes with dp/pp only (no --ep)"
        if world % (dcn * pp):
            return None, f"--dcn-slices {dcn} x --pp {pp} must divide process count {world}"
        axes = {"dcn": dcn, "dp": world // (dcn * pp)}
        grid = ProcessGrid({**axes, "pp": pp} if pp > 1 else axes)
    elif pp > 1:
        if ep > 1:
            return None, "--pp with --ep is not supported (pp towers are dense)"
        if world % pp:
            return None, f"--pp {pp} must divide process count {world}"
        grid = ProcessGrid({"dp": world // pp, "pp": pp})
    elif ep > 1:
        if not args.moe_experts:
            return None, ("--ep > 1 without --moe-experts would only shrink data "
                          "parallelism (a dense model has no ep-sharded params)")
        if world % ep:
            return None, f"--ep {ep} must divide process count {world}"
        if args.moe_experts % ep:
            return None, (f"--ep {ep} must divide --moe-experts {args.moe_experts} "
                          f"(expert kernels are stacked (E, ...) and sharded over ep)")
        grid = ProcessGrid({"dp": world // ep, "ep": ep})
    else:
        grid = ProcessGrid({"dp": world})
    if getattr(args, "update_sharding", "") == "full" and grid.shape["dp"] < 2:
        return None, ("update_sharding='full' requires a dp axis of size > 1, got "
                      f"'dp'={grid.shape['dp']} on the process grid {grid.shape}")
    return grid, None


def _join_processes(args) -> int | None:
    """``--coordinator``: JAX's checks (exit 2), then the rendezvous of every
    process of the run (exit 3 if it fails); None when it went through or
    was not asked for."""
    if not args.coordinator:
        return None
    if args.num_processes < 1 or args.process_id < 0:
        print("--coordinator requires --num-processes >= 1 and --process-id >= 0 "
              "(every process runs the same command with its own --process-id)",
              file=sys.stderr)
        return 2
    if args.batch % args.num_processes:
        print(f"--batch {args.batch} must be divisible by --num-processes "
              f"{args.num_processes} (batch is GLOBAL; each process contributes "
              f"batch/num_processes rows)", file=sys.stderr)
        return 2
    from distributed_sigmoid_loss_tpu_torch.parallel.multihost import initialize_multihost

    try:
        initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                             device="cpu" if args.cpu_devices == 1 else "cuda")
    except Exception as e:  # the environment's (ports, devices): its own exit code
        print(f"INIT_FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 3
    return None


def cmd_train(args) -> int:
    refusal = _train_config_conflicts(args) or _data_conflicts(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    code = _join_processes(args)
    if code is not None:
        return code
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
    if args.pp > 1:
        # Pipeline stages need scanned towers (JAX's rule; --tiny's are not).
        from distributed_sigmoid_loss_tpu_torch.parallel.pp_towers import validate_pp_tower

        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, scan_layers=True),
            text=dataclasses.replace(cfg.text, scan_layers=True))
        try:
            validate_pp_tower(cfg.vision, args.pp, "vision")
            validate_pp_tower(cfg.text, args.pp, "text")
        except ValueError as e:
            print(f"--pp {args.pp}: {e}", file=sys.stderr)
            return 2
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""), file=sys.stderr)
    model = SigLIP(cfg, device=device)
    tx = make_optimizer(TrainConfig(learning_rate=args.lr, warmup_steps=5,
                                    total_steps=max(args.steps, 10), optimizer=args.optimizer))
    grid, problem = _process_grid(args)
    if grid is None:
        print(problem, file=sys.stderr)
        return 2
    source, tokenize, native_decode = _train_source(args, cfg)
    try:
        with grid, contextlib.ExitStack() as cleanup:
            return _train(args, device, cfg, model, tx, source, tokenize, native_decode,
                          cleanup)
    finally:
        close = getattr(source, "close", None)  # the native engine's threads
        if close is not None:
            close()


def _adaptive_step(args, step_fn, state, cleanup):
    """JAX's host wrapper around the adaptive step: each step stages the
    controller's table, times the step to a device sync, folds the round
    into the bandwidth EWMA (through the emulated link under
    ``--emu-dcn-mbps``, each rank its own), decides the next table from the
    step's stats (one host copy), and under ``learned`` feeds the block
    moment to the codec trainer; world rank 0's table, error budget and
    codec are then every rank's (``adopt_rank0_decision``). The controller's
    sizes are the compression view's (each rank's rows under ``--update-
    sharding full``). Adds ``dcn_bw_est_mbps``, ``controller_mode`` and
    ``error_budget`` to the metrics, and under emulation
    ``dcn_measured_mbps`` and ``wire_savings_wallclock_ratio``."""
    import time

    import numpy as np
    import torch

    from distributed_sigmoid_loss_tpu_torch.parallel.adaptive_compression import (
        CODEC_BLOCK,
        CODEC_GROUPS,
        BitController,
        CodecTrainer,
        leaf_sizes,
    )
    from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_size
    from distributed_sigmoid_loss_tpu_torch.train.compressed_step import (
        adopt_rank0_decision,
        stage_codec,
        stage_scheme,
    )

    sizes = leaf_sizes(state.ef)
    learned = args.grad_compression == "learned"
    n_dcn = axis_size(axis_group("dcn"))
    controller = BitController(sizes, n_dcn=n_dcn, topk_frac=args.topk_frac,
                               dcn_budget_mbps=args.dcn_budget_mbps,
                               controller=args.controller or "greedy", learned=learned)
    trainer = CodecTrainer() if learned else None
    device = state.params[0].device
    emulator = None
    bf16_ref = {"dt": None}
    if args.emu_dcn_mbps is not None:
        from distributed_sigmoid_loss_tpu_torch.parallel.dcn_emu import DCNEmulator

        emulator = DCNEmulator(args.emu_dcn_mbps).start()
        cleanup.callback(emulator.close)
        # The fixed-bf16 reference payload the wall-clock ratio compares
        # against, measured through the same pipe.
        bf16_ref_bytes = (n_dcn - 1) * 2 * int(sum(sizes))

    def step(st, batch):
        st = stage_scheme(st, controller.scheme)
        t0 = time.perf_counter()
        st, metrics = step_fn(st, batch)
        wire = float(metrics["dcn_wire_bytes"])  # waits for the step's work
        step_dt = time.perf_counter() - t0
        metrics = dict(metrics)
        if emulator is None:
            controller.observe(step_dt, wire)
        else:
            transfer_dt = emulator.transfer(wire)
            controller.observe(transfer_dt, wire)
            if bf16_ref["dt"] is None or emulator.transfers <= 8:
                ref = emulator.transfer(bf16_ref_bytes)
                bf16_ref["dt"] = ref if bf16_ref["dt"] is None else 0.5 * ref + 0.5 * bf16_ref["dt"]
            metrics["dcn_measured_mbps"] = emulator.measured_mbps or 0.0
            metrics["wire_savings_wallclock_ratio"] = (
                (step_dt + bf16_ref["dt"]) / (step_dt + transfer_dt))
        n = len(sizes)
        parts = [st.comp["ef_ratio"], st.comp["gnorm"], st.comp["gvar"]]
        if trainer is not None:
            parts.append(st.comp["blockmoment"].reshape(-1))
        stats = torch.cat(parts).cpu().numpy()  # the controller's one host copy
        controller.decide(stats[:n], gnorm=stats[n:2 * n], gvar=stats[2 * n:3 * n])
        codec = None
        if trainer is not None:
            new_codec = trainer.update(
                stats[3 * n:].reshape(CODEC_GROUPS, CODEC_BLOCK, CODEC_BLOCK))
            if trainer.rounds >= trainer.warmup_rounds:
                codec = new_codec
        codec = adopt_rank0_decision(controller, device, codec)
        if codec is not None:
            st = stage_codec(st, codec)
        metrics["dcn_bw_est_mbps"] = controller.bw_est_mbps or 0.0
        metrics["controller_mode"] = controller.mode
        metrics["error_budget"] = float(controller.last_error_budget)
        return st, metrics

    return step


def _host_values(metrics: dict) -> dict:
    """The metrics as host values: 0-d tensors as floats through one copy,
    vectors as lists of floats, strings and numbers as they are."""
    import torch

    scalars = {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor) and v.dim() == 0}
    out = {}
    if scalars:
        values = torch.stack([v.detach().float() for v in scalars.values()]).tolist()
        out.update(zip(scalars, values))
    for k, v in metrics.items():
        if k in out:
            continue
        if isinstance(v, torch.Tensor):
            out[k] = [float(x) for x in v.detach().float().flatten().tolist()]
        else:
            out[k] = v if isinstance(v, str) else float(v)
    return {k: out[k] for k in metrics}


def _attribution_fields(step_fn, state, batch, device) -> dict:
    """``mfu_est`` and ``comm_bytes_total`` of the step that will run
    (``obs/attribution.py``): a trace on tensors without storage, which
    launches nothing and sends nothing. Empty, with a warning, for a step
    it cannot trace or on a failure: attribution never stops a run."""
    from distributed_sigmoid_loss_tpu_torch.obs.attribution import metrics_line_fields
    from distributed_sigmoid_loss_tpu_torch.train.train_step import step_attribution

    try:
        import time

        import torch

        t0 = time.perf_counter()
        costs = step_attribution(step_fn, state,
                                 {k: torch.as_tensor(v) for k, v in batch.items()})
        if costs is None:
            print("obs attribution: not available for this step; metrics lines carry no "
                  "mfu_est/comm_bytes_total", file=sys.stderr)
            return {}
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        fields = metrics_line_fields(costs, device_kind=kind)
        print("obs attribution: " + " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
              + f" flops_est={costs['flops_est']:.6g} ({time.perf_counter() - t0:.2f} s)",
              file=sys.stderr)
        return fields
    except Exception as e:  # noqa: BLE001 — attribution must never kill a run
        print(f"WARNING: static attribution failed ({type(e).__name__}: {e}); metrics "
              "lines will not carry mfu_est/comm_bytes_total", file=sys.stderr)
        return {}


def _train(args, device, cfg, model, tx, source, tokenize, native_decode, cleanup) -> int:
    import torch

    from distributed_sigmoid_loss_tpu_torch.data import (
        PrefetchStats,
        SyntheticImageText,
        prefetch,
        put_batch,
        shard_batch,
    )
    from distributed_sigmoid_loss_tpu_torch.eval import retrieval_metrics
    from distributed_sigmoid_loss_tpu_torch.parallel.update_shard import (
        opt_mem_bytes_per_replica,
    )
    from distributed_sigmoid_loss_tpu_torch.train import (
        AsyncSaver,
        PreemptionGuard,
        RestoreRequiredError,
        create_train_state,
        latest_step,
        make_train_step,
        train_resilient,
    )
    from distributed_sigmoid_loss_tpu_torch.train.train_step import pp_forward
    from distributed_sigmoid_loss_tpu_torch.train.compressed_step import (
        make_compressed_train_step,
        with_adaptive_compression,
        with_error_feedback,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig
    from distributed_sigmoid_loss_tpu_torch.utils.logging import MetricsLogger

    data = iter(source)
    first = next(data)
    resuming = bool(args.ckpt_dir) and latest_step(args.ckpt_dir) is not None
    update_mode = args.update_sharding or ("zero1" if args.zero1 else "off")
    # JAX's default: twice the stages, which keeps the bubble (S-1)/(S+M-1)
    # under a third.
    pp_micro = (args.pp_microbatches or 2 * args.pp) if args.pp > 1 else 0
    if args.grad_compression and pp_micro:
        from distributed_sigmoid_loss_tpu_torch.parallel.mesh import current_grid

        shape = current_grid().shape
        groups = shape["dcn"] * shape["dp"]
        ok = args.batch % groups == 0
        local = args.batch // groups if ok else 0
        ok = ok and local % args.accum == 0
        micro_rows = local // args.accum if ok else 0
        if not ok or micro_rows % pp_micro:
            print(f"--grad-compression with --pp: global batch {args.batch} "
                  f"must divide as (dcn*dp = {groups}) x accum = {args.accum} "
                  f"x pp-microbatches = {pp_micro}; "
                  f"need batch % {groups * args.accum * pp_micro} == 0", file=sys.stderr)
            return 2
    state = create_train_state(model, tx, ema=args.ema_decay is not None,
                               update_sharding=update_mode,
                               pp_axis="pp" if args.pp > 1 else None,
                               ep_axis="ep" if args.ep > 1 else None)
    # --loss-impl chunked and --grad-compression are all_gather shapes; an
    # unset --variant follows them (an explicit ring was refused above).
    all_gather = args.loss_impl == "chunked" or args.grad_compression
    variant = args.variant or ("all_gather" if all_gather else "ring")
    loss_cfg = LossConfig(variant=variant, family=args.loss_family, precision="default",
                          loss_impl=args.loss_impl, ring_overlap=args.ring_overlap,
                          use_pallas=args.use_pallas)
    # One resolution of the router aux weight for both steps (JAX's: 0.01
    # with experts unless given).
    moe_aux_w = ((0.01 if args.moe_aux_weight is None else args.moe_aux_weight)
                 if args.moe_experts else None)
    accum = dict(accum_steps=args.accum, accum_negatives=args.accum_negatives,
                 accum_dtype="bfloat16" if args.accum_bf16 else None,
                 gradcache_embed_dtype="bfloat16" if args.gradcache_bf16 else None,
                 moe_aux_weight=moe_aux_w, pp_microbatches=pp_micro)
    if args.grad_compression:
        # --topk-exact changes nothing below here: the port's top-k is
        # always exact (ROADMAP.md, deliberate differences).
        adaptive = args.grad_compression in ("adaptive", "learned")
        if adaptive:
            state = with_adaptive_compression(state,
                                              learned=args.grad_compression == "learned")
        else:
            state = with_error_feedback(state)
        step_fn = make_compressed_train_step(
            model, loss_cfg, compression=args.grad_compression, topk_frac=args.topk_frac,
            **accum)
        if adaptive:
            step_fn = _adaptive_step(args, step_fn, state, cleanup)
    else:
        step_fn = make_train_step(model, loss_cfg, ema_decay=args.ema_decay, **accum)
    # Every metrics line of a sharded update carries its mode and the
    # optimizer's bytes on this rank, as JAX's do.
    sharding_fields = {} if update_mode == "off" else {
        "update_sharding": update_mode,
        "opt_mem_bytes_per_replica": opt_mem_bytes_per_replica(state.opt_state)}
    # The observability wiring (JAX's): schema-checked metrics lines, host
    # spans (recorded only under --obs-dir; disabled spans are a shared
    # no-op), the health watchdog and the flight recorder.
    from distributed_sigmoid_loss_tpu_torch.obs import (
        HEALTH_EVENT_FIELDS,
        TRAIN_METRICS_FIELDS,
        TRAIN_METRICS_PREFIXES,
        FlightRecorder,
        HealthWatchdog,
        SpanRecorder,
    )

    logger = MetricsLogger(every=args.log_every, schema=TRAIN_METRICS_FIELDS,
                           schema_prefixes=TRAIN_METRICS_PREFIXES)
    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
    spans = SpanRecorder(enabled=bool(args.obs_dir))
    flight = FlightRecorder(path=os.path.join(args.obs_dir, "flight.json")
                            if args.obs_dir else None)
    watchdog = (None if args.watchdog == "off"
                else HealthWatchdog(policy="warn" if args.watchdog == "warn" else "skip"))
    att_fields = _attribution_fields(step_fn, state, shard_batch(first), device)
    # A pipeline stage holds its blocks only: its evals run the pipeline too.
    embed = pp_forward(model, pp_micro) if pp_micro else model

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

    def put_spanned(b, d):
        # On the prefetch worker's thread: its own track of the host timeline.
        with spans.span("h2d_commit"):
            return put_batch(shard_batch(b), d)

    def device_batches(skip: int = 0):
        return prefetch(host_batches(skip), device, size=2, put=put_spanned,
                        stats=input_stats)

    # Under --obs-dir the newest metrics line is also written to
    # DIR/telemetry.json each log interval (an atomic rename).
    telemetry_env = None
    if args.obs_dir:
        from distributed_sigmoid_loss_tpu_torch.obs.ledger import environment_fingerprint

        telemetry_env = environment_fingerprint()

    def write_telemetry(step_i, line):
        if not args.obs_dir or step_i % args.log_every:
            return
        import time

        from distributed_sigmoid_loss_tpu_torch.obs.telemetry import write_telemetry_file

        try:
            write_telemetry_file(os.path.join(args.obs_dir, "telemetry.json"),
                                 {"step": step_i, "ts": round(time.time(), 3),
                                  "metrics": line, "env": telemetry_env})
        except OSError as e:  # telemetry must never kill a training run
            print(f"WARNING: telemetry write failed: {e}", file=sys.stderr)

    def log_metrics(step_i, m):
        # Scalars as floats (one host copy), the scheme histogram as a list,
        # the controller's mode as a string.
        line = {**_host_values(m), "input_wait_frac": input_stats.input_wait_frac(),
                **att_fields, **sharding_fields}
        if watchdog is not None:
            for ev in watchdog.observe(step_i, line):
                flight.note_event(ev)
                logger.write(ev.record(), schema=HEALTH_EVENT_FIELDS)
        flight.note_metrics(step_i, line)
        logger.log(step_i, line)
        write_telemetry(step_i, line)

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
                zi, zt, _ = embed(eval_batch["images"], eval_batch["tokens"])
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
                    # --watchdog skip routes a non-finite loss into the
                    # rollback-and-skip path; either way the flight recorder
                    # dumps the trajectory.
                    on_divergence="skip" if args.watchdog == "skip" else "halt",
                    spans=spans, flight=flight,
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
        i = 0  # the crash dump names a step even if the first fetch dies
        try:
            for i, batch in zip(range(1, args.steps + 1), stream):
                with spans.span("step"):
                    state, metrics = step_fn(state, batch)
                log_metrics(i, metrics)
                if eval_hook is not None and i % args.eval_every == 0:
                    with spans.span("eval"):
                        eval_hook(i, state)
        except BaseException as e:
            # The resilient loop's black box: a crash leaves the last lines.
            flight.dump(f"crash at step {i}: {type(e).__name__}: {e}")
            raise
        finally:
            stream.close()  # joins the worker; `data` is single-reader again

    if args.obs_dir:
        spans_path = os.path.join(args.obs_dir, "host_spans.trace.json")
        spans.export(spans_path)
        print(f"obs: host spans -> {spans_path} ({len(spans.spans())} spans retained; "
              f"summarize with `python -m distributed_sigmoid_loss_tpu_torch obs summarize "
              f"{args.obs_dir}`)", file=sys.stderr)

    # Retrieval on the stream's next batch (the embeddings come normalized).
    held_out = put_batch(shard_batch(next(data)), device)
    with torch.no_grad():
        zimg, ztxt, _ = embed(held_out["images"], held_out["tokens"])
    rm = retrieval_metrics(zimg, ztxt, ks=(1, 5))
    print({k: round(float(v), 4) for k, v in rm.items()}, file=sys.stderr)
    return 0


def cmd_eval(args) -> int:
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


def cmd_export(args) -> int:
    """Export a traced step (``--what train_step``, the default, or
    ``forward``) to a ``torch.export`` artifact through the hand-written
    kernels' ops (``train/export.py``). The artifact replays with
    ``train.load_exported(path).call(*leaves)`` on the device it was traced
    on, with no model code. ``--check`` reloads the written file and replays
    it on copies of the inputs against the live eager step; a train step
    also past the warmup, where the parameters move."""
    if args.quant and args.what == "train_step":
        print("--quant is inference-only (zero gradients through round); "
              "use it with --what forward", file=sys.stderr)
        return 2
    if args.platform not in ("", "cuda", "cpu"):
        print(f"--platform {args.platform}: the port traces for 'cuda' or 'cpu' (the device "
              "the artifact replays on)", file=sys.stderr)
        return 2
    if args.platform == "cuda" and args.cpu_devices == 1:
        print("--platform cuda conflicts with --cpu-devices 1", file=sys.stderr)
        return 2
    if args.platform == "cpu" and not args.cpu_devices:
        args.cpu_devices = 1
    device, code = _device(args)
    if device is None:
        return code

    import dataclasses
    import time

    import torch
    from torch.utils import _pytree as pytree

    from distributed_sigmoid_loss_tpu_torch.data import SyntheticImageText
    from distributed_sigmoid_loss_tpu_torch.models import SigLIP
    from distributed_sigmoid_loss_tpu_torch.train import (
        create_train_state,
        export_step,
        load_exported,
        make_functional_train_step,
        make_optimizer,
        make_train_step,
        save_exported,
        train_state_tree,
        tree_leaves,
    )
    from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, TrainConfig

    cfg = _model_config(args)
    if args.loss_family != "sigmoid":
        # Same family wiring as train: the model's t_prime init follows it.
        cfg = dataclasses.replace(cfg, loss=LossConfig(family=args.loss_family))
    model = SigLIP(cfg, device=device)
    if args.what == "forward" and args.ep > 1:
        print("--ep applies to --what train_step only (the forward export is "
              "a single-device inference program)", file=sys.stderr)
        return 2
    # The train command's topology rules: --ep must divide the processes
    # (and a grid of more than one process is refused below).
    grid, problem = _process_grid(args)
    if grid is None:
        print(problem, file=sys.stderr)
        return 2
    b = args.batch
    batch = {k: v.to(device) for k, v in next(iter(SyntheticImageText(cfg, b))).items()}

    if args.what == "train_step":
        # The schedule is baked into the artifact: export the values the
        # deployed job trains with (--lr etc.).
        tx = make_optimizer(TrainConfig(learning_rate=args.lr, warmup_steps=args.warmup_steps,
                                        total_steps=args.total_steps))
        state = create_train_state(model, tx)
        loss_cfg = LossConfig(variant=args.variant, family=args.loss_family)
        moe_aux = args.moe_aux_weight if args.moe_experts else None
        fn = make_functional_train_step(model, tx, loss_cfg, moe_aux_weight=moe_aux)
        example = (train_state_tree(state), batch)
        live_step = make_train_step(model, loss_cfg, moe_aux_weight=moe_aux)

        def live(tree, batch):
            new_state, metrics = live_step(state, batch)
            return train_state_tree(new_state), metrics
    else:  # forward
        def fn(params, images, tokens):
            zimg, ztxt, _ = torch.func.functional_call(model, params, (images, tokens))
            return zimg, ztxt

        example = (dict(model.state_dict()), batch["images"], batch["tokens"])
        live = fn

    t0 = time.monotonic()
    exported = export_step(fn, example, platforms=(device.type,))
    save_exported(args.out, exported)
    seconds = time.monotonic() - t0
    size = os.path.getsize(args.out)
    model_name = "tiny" if args.tiny else args.model
    print(f"exported {args.what} ({model_name}, batch {b}, 1 device(s), {device.type}) "
          f"-> {args.out} ({size} bytes, {seconds:.1f} s)")

    if args.check:
        loaded = load_exported(args.out)

        def replays_like_live(example) -> bool:
            # Flat calling convention (train/export.py); the live step updates
            # its state in place, so the artifact replays on copies first.
            got = loaded.call(*tree_leaves(pytree.tree_map(torch.clone, example)))
            with torch.no_grad() if args.what == "forward" else contextlib.nullcontext():
                want = tree_leaves(live(*example))
            if len(want) != len(got):
                print(f"check failed: {len(got)} leaves replayed, {len(want)} live",
                      file=sys.stderr)
                return False
            # On the leaves' device: a B/16 MoE state's ~3 × 0.9B entries
            # would take minutes through host numpy.
            for w, g in zip(want, got):
                torch.testing.assert_close(g.detach().float(), w.detach().float(), rtol=1e-5,
                                           atol=1e-6, equal_nan=True)
            return True

        if not replays_like_live(example):
            return 1
        moved = ""
        if args.what == "train_step":
            # At count 0 the warmup's rate is 0 and no parameter moves: replay
            # once more past the warmup, where the schedule's rate is the peak
            # and AdamW's update moves the parameters.
            state.step = state.opt_state.count = max(args.warmup_steps, 1)
            before = [p.detach().clone() for p in model.parameters()]
            if not replays_like_live((train_state_tree(state), batch)):
                return 1
            delta = max(float((p.detach() - p0).abs().max())
                        for p, p0 in zip(model.parameters(), before))
            if args.lr > 0 and not delta > 0:
                print("check failed: past the warmup the live step left every parameter "
                      "as it was", file=sys.stderr)
                return 1
            moved = f" (past the warmup the parameters moved by up to {delta:.3g})"
        print(f"check ok: reloaded artifact replays identically{moved}")
    return 0


def _emit_serve_record(record: dict, *, strict_zero_drops: bool = False) -> int:
    """The serve-bench emit contract, shared by the snapshot and scenario
    paths: check the record against the declared schema
    (``analysis/bench_schema.py``: a violation warns and never drops it),
    print it (one JSON line, the JAX command's keys) and append it to the
    run ledger (``obs/ledger.py``; never fatal). With ``strict_zero_drops``
    a non-zero ``silent_drops`` count fails the run — the chaos scenarios'
    every-outcome-is-typed gate."""
    from distributed_sigmoid_loss_tpu_torch.analysis.bench_schema import validate_record
    from distributed_sigmoid_loss_tpu_torch.obs.ledger import append_record

    problems = validate_record(record)
    if problems:
        print("WARNING: serve-bench record schema violation: " + "; ".join(problems),
              file=sys.stderr)
    print(json.dumps(record), flush=True)
    append_record(record, source="serve-bench", problems=problems)
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


def _load_host_spans(root: str):
    """(host_trace, host_paths, spans) from every host_spans.trace.json under
    ``root``: shared by `obs summarize` and the span half of `obs diff`."""
    import glob

    from distributed_sigmoid_loss_tpu_torch.obs.spans import Span

    host_trace = None
    host_paths = sorted(glob.glob(os.path.join(root, "**", "host_spans.trace.json"),
                                  recursive=True))
    spans: list = []
    if host_paths:
        host_trace = {"traceEvents": []}
        for path in host_paths:
            with open(path, encoding="utf-8") as f:
                host_trace["traceEvents"].extend(json.load(f).get("traceEvents", []))
        for ev in host_trace["traceEvents"]:
            if ev.get("ph") == "X" and "dur" in ev:
                t0 = ev["ts"] / 1e6
                spans.append(Span(ev["name"], t0, t0 + ev["dur"] / 1e6, ev.get("tid", 0)))
    return host_trace, host_paths, spans


def _add_obs_args(p) -> None:
    """The `obs` arguments: on the subparser (for --help) and on the
    standalone parser ``main`` routes `obs` through, which takes options
    between the operands (``parse_intermixed_args``)."""
    p.add_argument("action", choices=["summarize", "ledger", "diff", "regress"],
                   help="summarize: host spans + device kernel time under DIR; ledger: "
                        "per-metric trajectory summary; diff: field-level diff of two "
                        "records or two run dirs' span summaries; regress: the proxy "
                        "regression gate against the committed baseline")
    p.add_argument("paths", nargs="*",
                   help="summarize: DIR; diff: two operands (metric@N ledger selector, "
                        "entry index, record-JSON path, or run dir); ledger: none")
    p.add_argument("--top", type=int, default=12,
                   help="rows per device-kernel table (obs summarize)")
    p.add_argument("--merged-out", default="", metavar="PATH",
                   help="also write one merged Chrome-trace JSON (host + device events; "
                        "open in ui.perfetto.dev)")
    p.add_argument("--ledger", default="", metavar="PATH",
                   help="ledger file for `obs ledger`/`obs diff` (default: DSL_LEDGER_PATH "
                        "or build/ledger.jsonl at the root of the checkout)")
    p.add_argument("--metric", default="", metavar="NAME",
                   help="restrict `obs ledger` to one metric stream")
    p.add_argument("--backfill", action="store_true",
                   help="the JAX package's backfill from its round files (exits 2: those "
                        "rounds are a TPU's)")
    p.add_argument("--baseline", default="", metavar="PATH",
                   help="`obs regress`: baseline file (default: the committed "
                        "obs/regress_baseline.json)")
    p.add_argument("--update", action="store_true",
                   help="`obs regress`: rewrite the baseline from the current tree instead "
                        "of comparing (commit it with the change that moved it)")
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="`obs regress`: the fake world the step configs are traced in "
                        "(default 8, the world the committed baseline was written in)")


def cmd_obs(args) -> int:
    """Offline reports of a run's records; reads files only, touches no
    device:

    - ``obs summarize DIR``: a run's host spans and any device trace under
      DIR in one report.
    - ``obs ledger``: the per-metric trajectory of the run ledger
      (no-backend, deferred and error entries listed, kept out of the
      baseline statistics).
    - ``obs diff A B``: field-level diff of two records (ledger selectors
      ``metric@-1``, entry indices, or record-JSON paths) or of two run
      directories' span summaries.
    - ``obs regress``: the proxy regression gate (``obs/regress.py``)
      against the committed baseline; ``--update`` rewrites it. It traces
      on the host's CPU and touches no device.
    """
    if args.action == "regress":
        return _obs_regress(args)
    if args.action == "ledger":
        return _obs_ledger(args)
    if args.action == "diff":
        return _obs_diff(args)
    return _obs_summarize(args)


def _trace_world(n: int) -> tuple[int | None, str | None]:
    """The fake world the step configs are traced in (``--cpu-devices``,
    default 8), or an error message."""
    n = n or 8
    if n < 4 or n % 2:
        return None, (f"--cpu-devices {n}: the step configs are traced in an even world of "
                      ">= 4 ranks")
    return n, None


def _obs_regress(args) -> int:
    from distributed_sigmoid_loss_tpu_torch.obs.regress import run_regress

    n, err = _trace_world(args.cpu_devices)
    if err:
        print(err, file=sys.stderr)
        return 2
    return run_regress(baseline_path=args.baseline or None, update=args.update, n_devices=n)


def cmd_lint(args) -> int:
    """The port's lint (``analysis/``): the repo rules, the lock rules, and
    (unless ``--no-jaxpr``) the config-space drift check and the trace audit
    of the sampled step configs, each traced in a fake world of
    ``--cpu-devices`` ranks (default 8) on the host's CPU. Exit 0 = clean,
    1 = findings, 2 = usage error."""
    import json as jsonmod

    from distributed_sigmoid_loss_tpu_torch.analysis import (
        ALL_RULES,
        apply_lint_baseline,
        load_lint_baseline,
        run_lint,
    )

    unknown = [r for r in args.disable if r not in ALL_RULES]
    if unknown:
        print(f"--disable: unknown rule(s) {unknown}; known rules: " + ", ".join(ALL_RULES),
              file=sys.stderr)
        return 2
    n, err = _trace_world(args.cpu_devices)
    if err and not args.no_jaxpr:
        print(err, file=sys.stderr)
        return 2
    baseline_keys = None
    if args.baseline:
        try:
            baseline_keys = load_lint_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"--baseline: {e}", file=sys.stderr)
            return 2
    findings = run_lint(disabled=set(args.disable), jaxpr=not args.no_jaxpr, n_devices=n,
                        full_product=args.full_product)
    if baseline_keys is not None:
        findings = apply_lint_baseline(findings, baseline_keys)
    checked = [r for r in ALL_RULES if r not in args.disable]
    if args.no_jaxpr:
        checked = [r for r in checked if not r.startswith("trace-") and r != "config-space-drift"]
    if baseline_keys is None:
        checked = [r for r in checked if r != "lint-stale-suppression"]
    if args.json:
        print(jsonmod.dumps({
            "rules_checked": checked,
            "disabled": sorted(args.disable),
            "findings": [f.as_dict() for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f)
    print(f"lint: {len(checked)} rules checked, {len(findings)} finding(s)"
          + (f", {len(args.disable)} disabled" if args.disable else ""), file=sys.stderr)
    return 1 if findings else 0


def _obs_ledger(args) -> int:
    from distributed_sigmoid_loss_tpu_torch.obs.ledger import (
        ledger_path,
        read_ledger,
        trajectory,
        trajectory_summary,
    )

    path = args.ledger or None
    if args.backfill:
        print("obs ledger --backfill: the JAX package's BENCH_r*/MULTICHIP_r* round files "
              "record a TPU's runs, not the port's; the port's ledger has no backfill",
              file=sys.stderr)
        return 2
    entries = read_ledger(path)
    if not entries:
        print(f"ledger {ledger_path(path)!r} is empty (serve-bench and data-bench append "
              "automatically)", file=sys.stderr)
        return 2
    traj = trajectory(entries, metric=args.metric or None)
    if not traj:
        print(f"no entries for metric {args.metric!r}", file=sys.stderr)
        return 2
    for metric in sorted(traj):
        points = traj[metric]
        print(f"== {metric} ({len(points)} entr(y/ies))")
        for p in points:
            rnd = f"r{p['round']:02d}" if p.get("round") is not None else "  -"
            val = p.get("value")
            val_s = f"{val:>12.2f}" if isinstance(val, (int, float)) else f"{val!r:>12}"
            print(f"  {rnd:>4} {val_s} {p.get('unit', '') or '':<13}"
                  f"{p['status']:<12}{p['source']:<28}{p.get('device_kind', '')}")
        summary = trajectory_summary(points)
        if summary["n"]:
            last = summary["last"]
            print(f"  -> baseline over {summary['n']} measured (excluded "
                  f"{summary['excluded']} non-measurement): last {last['value']} "
                  f"({last.get('status')}), best {summary['best']}, "
                  f"mean {round(summary['mean'], 2)}")
        else:
            print(f"  -> no measured entries ({summary['excluded']} excluded: "
                  "outages/deferrals are not baselines)")
    return 0


def _resolve_diff_operand(op: str, entries):
    """One `obs diff` operand -> ("record", dict) | ("spans", dir): a run
    directory (span summaries), a JSON file (a raw record, a ledger entry,
    or a file whose ``tail`` holds record lines), ``metric@N`` (the N-th
    ledger entry of that metric, negatives from the end), or a bare
    integer (the global ledger entry index)."""
    from distributed_sigmoid_loss_tpu_torch.obs.ledger import _records_in_tail

    if os.path.isdir(op):
        return "spans", op
    if os.path.exists(op):
        with open(op, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"{op}: not a JSON object")
        if "metric" in data:
            return "record", data
        if isinstance(data.get("record"), dict):
            return "record", data["record"]
        if "tail" in data:
            recs = _records_in_tail(data.get("tail", ""))
            if recs:
                return "record", recs[-1]
        raise ValueError(f"{op}: no record found in the file")
    if "@" in op:
        metric, _, idx_s = op.rpartition("@")
        matching = [e for e in entries if e.get("record", {}).get("metric") == metric]
        if not matching:
            raise ValueError(f"no ledger entries for metric {metric!r}")
        try:
            return "record", matching[int(idx_s)]["record"]
        except (ValueError, IndexError):
            raise ValueError(f"{op}: index {idx_s!r} out of range ({len(matching)} "
                             f"entr(y/ies) for {metric!r})") from None
    try:
        return "record", entries[int(op)]["record"]
    except ValueError:
        raise ValueError(f"{op}: not a path, metric@N selector, or entry index") from None
    except IndexError:
        raise ValueError(f"{op}: ledger has {len(entries)} entr(y/ies)") from None


def _obs_diff(args) -> int:
    from distributed_sigmoid_loss_tpu_torch.obs.ledger import diff_records, read_ledger

    if len(args.paths) != 2:
        print("obs diff needs exactly two operands (ledger selector metric@N, entry index, "
              "record-JSON path, or run dir)", file=sys.stderr)
        return 2
    entries = read_ledger(args.ledger or None)
    try:
        (kind_a, a), (kind_b, b) = (_resolve_diff_operand(op, entries) for op in args.paths)
    except ValueError as e:
        print(f"obs diff: {e}", file=sys.stderr)
        return 2
    if {kind_a, kind_b} == {"spans"}:
        from distributed_sigmoid_loss_tpu_torch.obs.spans import summarize_spans

        rows_a = summarize_spans(_load_host_spans(a)[2])
        rows_b = summarize_spans(_load_host_spans(b)[2])
        if not rows_a or not rows_b:
            print("obs diff: one of the run dirs has no host spans (train with --obs-dir)",
                  file=sys.stderr)
            return 2
        print(f"== span summary diff (A={a} B={b})")
        print(f"  {'span':<28}{'A mean ms':>11}{'B mean ms':>11}{'delta':>9}")
        for name in sorted(set(rows_a) | set(rows_b)):
            ma = rows_a.get(name, {}).get("mean_ms")
            mb = rows_b.get(name, {}).get("mean_ms")
            if ma is None or mb is None:
                only = "A" if mb is None else "B"
                print(f"  {name:<28}{'(only in ' + only + ')':>31}")
                continue
            print(f"  {name:<28}{ma:>11.2f}{mb:>11.2f}{mb - ma:>+9.2f}")
        return 0
    if kind_a != "record" or kind_b != "record":
        print("obs diff: cannot diff a run dir against a record — pass two of the same kind",
              file=sys.stderr)
        return 2
    d = diff_records(a, b)
    print(f"== record diff (A={args.paths[0]} B={args.paths[1]})")
    for k, entry in d["changed"].items():
        delta = ""
        if "rel" in entry:
            delta = f"  ({entry['delta']:+g}, {entry['rel']:+.1%})"
        elif "delta" in entry:
            delta = f"  ({entry['delta']:+g})"
        print(f"  {k:<28}{entry['a']!r} -> {entry['b']!r}{delta}")
    if d["added"]:
        print(f"  only in B: {', '.join(d['added'])}")
    if d["removed"]:
        print(f"  only in A: {', '.join(d['removed'])}")
    if not (d["changed"] or d["added"] or d["removed"]):
        print("  records are identical")
    return 0


def _obs_summarize(args) -> int:
    """``obs summarize DIR``: one report of a run's host spans
    (``host_spans.trace.json`` from ``train --obs-dir``) and of any device
    trace (``*.trace.json.gz`` from ``utils.profiling.trace``) under DIR.
    ``--merged-out`` also writes one combined Chrome trace that opens in
    ui.perfetto.dev with host and device tracks side by side."""
    import glob

    if len(args.paths) != 1:
        print("obs summarize needs exactly one DIR operand", file=sys.stderr)
        return 2
    root = args.paths[0]
    from distributed_sigmoid_loss_tpu_torch.obs.spans import merge_chrome_traces, summarize_spans

    host_trace, host_paths, spans = _load_host_spans(root)
    device_files = glob.glob(os.path.join(root, "**", "*.trace.json.gz"), recursive=True)
    if not spans and not device_files:
        print(f"no host_spans.trace.json or *.trace.json.gz under {root!r} (train with "
              "--obs-dir and/or capture a device trace with utils.profiling.trace)",
              file=sys.stderr)
        return 2
    if spans:
        print(f"== host spans ({len(spans)} retained, {len(host_paths)} file(s))")
        print(f"  {'span':<28}{'count':>7}{'total ms':>11}{'mean ms':>9}"
              f"{'p50':>8}{'p95':>8}{'max':>9}")
        for name, row in summarize_spans(spans).items():
            print(f"  {name:<28}{row['count']:>7}{row['total_ms']:>11.1f}"
                  f"{row['mean_ms']:>9.2f}{row['p50_ms']:>8.2f}"
                  f"{row['p95_ms']:>8.2f}{row['max_ms']:>9.2f}")
    if device_files:
        from distributed_sigmoid_loss_tpu_torch.utils.profiling import (
            print_device_ops,
            summarize_device_ops,
        )

        dev = summarize_device_ops(root, top=args.top)
        if dev["categories"]:
            print_device_ops(dev)
        else:
            print("\n(device trace files found but no device event: a host-only capture?)")
    if args.merged_out:
        from distributed_sigmoid_loss_tpu_torch.utils.profiling import read_trace_files

        device_events = read_trace_files(root) if device_files else ()
        merged = merge_chrome_traces(host_trace or {"traceEvents": []}, device_events)
        with open(args.merged_out, "w", encoding="utf-8") as f:
            json.dump(merged, f)
        print(f"\nmerged chrome trace -> {args.merged_out} "
              f"({len(merged['traceEvents'])} events; open in ui.perfetto.dev)")
    return 0


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
    tr.add_argument("--watchdog", choices=["off", "warn", "skip"], default="warn",
                    help="training health watchdog (obs/health.py): 'warn' (default) "
                         "emits health_event records on NaN/Inf metrics and loss spikes "
                         "against the rolling median; 'skip' also routes a non-finite "
                         "loss into the resilient loop's rollback-and-skip path (requires "
                         "--ckpt-dir); 'off' disables detection")
    tr.add_argument("--moe-experts", type=int, default=0,
                    help="swap tower MLPs for this many experts per block (mixture of "
                         "experts; sharded over --ep ranks)")
    tr.add_argument("--moe-aux-weight", type=float, default=None,
                    help="router load-balancing loss weight (requires --moe-experts; "
                         "default 0.01 when MoE is on)")
    tr.add_argument("--moe-group-size", type=int, default=0,
                    help="GShard routing group size (with --moe-experts; default 512)")
    tr.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: each rank holds depth/pp blocks of each tower")
    tr.add_argument("--pp-microbatches", type=int, default=0,
                    help="pipeline microbatches per step (with --pp > 1; default 2 x pp)")
    tr.add_argument("--ep", type=int, default=1,
                    help="expert-parallel ranks (with --moe-experts): each holds E/ep experts")
    tr.add_argument("--update-sharding", choices=["off", "zero1", "full"], default="")
    tr.add_argument("--zero1", action="store_true")
    tr.add_argument("--dcn-slices", type=int, default=1, metavar="N")
    tr.add_argument("--force-dcn-emulation", action="store_true")
    tr.add_argument("--grad-compression", "--compression",
                    choices=["int8", "topk", "adaptive", "learned"], default="")
    tr.add_argument("--dcn-budget-mbps", type=float, default=None, metavar="MBPS",
                    help="dcn egress budget for --grad-compression adaptive/learned: the "
                         "bit controller narrows tensors until min(measured bandwidth, "
                         "this) fits the sync round")
    tr.add_argument("--controller", choices=["greedy", "budgeted"], default=None,
                    help="bit-controller policy for --grad-compression adaptive/learned "
                         "(default greedy)")
    tr.add_argument("--emu-dcn-mbps", type=float, default=None, metavar="MBPS",
                    help="ship each round's dcn payload through a throttled localhost pipe "
                         "at this rate (parallel/dcn_emu.py); the controller times it")
    tr.add_argument("--topk-frac", type=float, default=0.01, metavar="F")
    tr.add_argument("--topk-exact", action="store_true")
    tr.add_argument("--obs-dir", default="", metavar="DIR",
                    help="record host spans (fetch, h2d_commit, step, eval, checkpoint) "
                         "into DIR/host_spans.trace.json (Chrome-trace JSON: overlays a "
                         "device capture in ui.perfetto.dev; `obs summarize DIR` merges "
                         "them), mirror each logged line into DIR/telemetry.json, and "
                         "dump the flight recorder to DIR/flight.json instead of stderr")
    tr.add_argument("--coordinator", default="", metavar="HOST:PORT",
                    help="join a multi-process run at this TCP rendezvous (NCCL on cuda, "
                         "gloo with --cpu-devices 1); every process runs the same command")
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
    ev.add_argument("--moe-experts", type=int, default=0,
                    help="match a checkpoint trained with --moe-experts")

    tk = sub.add_parser("tokenizer", help="train a byte-level BPE vocab on a caption corpus")
    tk.add_argument("out", help="output vocab json path")
    tk.add_argument("--vocab-size", type=int, default=4096)
    tk.add_argument("--data-dir", default="",
                    help="directory of name.txt caption files")
    tk.add_argument("--text-file", default="", help="plain text file, one caption per line")

    _add_obs_args(sub.add_parser("obs", help="offline reports: host spans + device trace "
                                             "summary, run-ledger trajectory, record diff"))
    db = sub.add_parser("data-bench", help="input-pipeline stage bench: shard read / decode / "
                                           "tokenize / augment / h2d commit alone, and the "
                                           "composed real-data pipeline vs the synthetic loader")
    from distributed_sigmoid_loss_tpu_torch.data.data_bench import add_data_bench_args

    add_data_bench_args(db)
    db.add_argument("--cpu-devices", type=int, default=0,
                    help="1 = run augment and the commits on the CPU (default: cuda)")

    ex = sub.add_parser("export", help="export a traced step (train or forward) to a "
                                       "torch.export artifact through the kernels' ops")
    ex.add_argument("out", help="output artifact path")
    ex.add_argument("--quant", choices=["", "int8"], default="",
                    help="quantize the towers for --what forward artifacts "
                         "(int8 projection matmuls; rejected for train_step)")
    ex.add_argument("--what", choices=["train_step", "forward"], default="train_step")
    ex.add_argument("--model", choices=["b16", "l14", "so400m", "tiny"], default="b16")
    ex.add_argument("--tiny", action="store_true", help="alias for --model tiny")
    ex.add_argument("--moe-experts", type=int, default=0)
    ex.add_argument("--ep", type=int, default=1)
    ex.add_argument("--moe-aux-weight", type=float, default=None)
    ex.add_argument("--moe-group-size", type=int, default=0)
    ex.add_argument("--batch", type=int, default=64,
                    help="global batch the artifact is shaped for")
    ex.add_argument("--variant", choices=["all_gather", "ring"], default="ring")
    ex.add_argument("--loss-family", choices=["sigmoid", "softmax"], default="sigmoid",
                    help="loss family baked into the train_step artifact "
                         "(match the train job's --loss-family)")
    ex.add_argument("--lr", type=float, default=1e-3,
                    help="learning rate baked into the train_step artifact")
    ex.add_argument("--warmup-steps", type=int, default=2000,
                    help="LR warmup steps baked into the train_step artifact")
    ex.add_argument("--total-steps", type=int, default=100_000,
                    help="LR schedule horizon baked into the train_step artifact")
    ex.add_argument("--platform", default="",
                    help="the device the artifact is traced for and replays on: cuda or "
                         "cpu (default: the command's device)")
    ex.add_argument("--check", action="store_true",
                    help="reload the written artifact and replay it against the live "
                         "eager step (a train step twice: at count 0 and past the warmup)")
    ex.add_argument("--cpu-devices", type=int, default=0,
                    help="1 = run on the CPU (default: cuda)")

    ln = sub.add_parser("lint", help="the port's lint: repo rules, lock rules, config-space "
                                     "drift and the trace audit of the sampled step configs "
                                     "(exit 1 on findings)")
    ln.add_argument("--json", action="store_true",
                    help="machine-readable report (rules checked + findings, each with a "
                         "stable rule_id and location) instead of one text line a finding")
    ln.add_argument("--disable", action="append", default=[], metavar="RULE",
                    help="skip this rule id (repeatable); prefer fixing, or allowlisting "
                         "with a rationale, over disabling")
    ln.add_argument("--no-jaxpr", action="store_true",
                    help="the AST rules only: no config-space probe and no step-config "
                         "traces (the JAX command's name for its trace half)")
    ln.add_argument("--full-product", action="store_true",
                    help="trace the pairwise-covering sample of the whole legal config "
                         "product, not only the tier-1 sample")
    ln.add_argument("--baseline", default="", metavar="FILE",
                    help="ratchet mode: suppress the findings recorded in FILE (a saved "
                         "`lint --json` report or a JSON list of {rule, subject}); entries "
                         "that no longer fire become lint-stale-suppression findings")
    ln.add_argument("--cpu-devices", type=int, default=0,
                    help="the fake world the step configs are traced in (default 8, the "
                         "JAX package's emulated mesh)")
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
    argv = sys.argv[1:] if argv is None else list(argv)
    # obs mixes nargs="*" operands with options, which parse_args takes only
    # trailing; parse_intermixed_args cannot traverse subparsers, so obs goes
    # through a parser of its own built from the same _add_obs_args.
    if argv[:1] == ["obs"]:
        obs_ap = argparse.ArgumentParser(prog="distributed_sigmoid_loss_tpu_torch obs")
        _add_obs_args(obs_ap)
        return cmd_obs(obs_ap.parse_intermixed_args(argv[1:]))
    args = _parser().parse_args(argv)
    return {"train": cmd_train, "eval": cmd_eval, "tokenizer": cmd_tokenizer,
            "export": cmd_export, "data-bench": cmd_data_bench,
            "serve-bench": cmd_serve_bench, "obs": cmd_obs, "lint": cmd_lint}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
