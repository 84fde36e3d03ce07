"""The declared schema of train metrics lines and serve ``stats()`` fields:
the port's copy of the JAX package's ``obs/metrics_schema.py`` (standard
library only).

One registry, two consumers here: ``utils.logging.MetricsLogger`` validates
at emit time when given ``schema=...`` (a warning on stderr; the line still
prints, so a metric is never lost to its own validator), and the tests hold
the serving stack's ``stats()`` snapshots to :data:`SERVE_STATS_FIELDS`.
The field sets are JAX's, so a record of either package validates against
either registry.
"""

from __future__ import annotations

__all__ = [
    "TRAIN_METRICS_FIELDS",
    "TRAIN_METRICS_PREFIXES",
    "SERVE_STATS_FIELDS",
    "HEALTH_EVENT_FIELDS",
    "validate_metrics",
]

# Every field a train metrics line may carry, grouped by the layer that owns
# it. Adding a field to a step's metrics dict (or cli.py's log_metrics merge)
# without registering it here fails the repo-metrics-schema lint rule.
TRAIN_METRICS_FIELDS = frozenset({
    # MetricsLogger bookkeeping
    "step", "steps_per_sec",
    # train/train_step.py + train/compressed_step.py step metrics
    "loss", "t", "bias", "grad_norm", "param_norm", "update_ratio",
    "moe_aux", "ef_norm",
    # train/compressed_step.py DCN wire accounting: per-device egress bytes
    # per sync round, payload bits per parameter, the residual-carry norm
    # (ef_norm's registered successor — both emitted), and the adaptive
    # path's per-scheme tensor-count histogram (a small list, not a scalar).
    "dcn_wire_bytes", "bits_per_param", "ef_residual_norm",
    "compression_scheme_hist",
    # parallel/adaptive_compression.py BitController bandwidth EWMA
    # (cli.py's adaptive step wrapper merges it into the line)
    "dcn_bw_est_mbps",
    # data/loader.py prefetch starvation (cli.py log_metrics)
    "input_wait_frac",
    # obs/attribution.py static attribution (cli.py log_metrics)
    "mfu_est", "comm_bytes_total",
    # parallel/update_shard.py (graftshard): the resolved update-sharding
    # mode and the compiler-measured at-rest optimizer bytes per replica
    # (cli.py stamps both on every metrics line when the mode is on).
    "update_sharding", "opt_mem_bytes_per_replica",
    # graftcodec: the learned rung's relative reconstruction error
    # (train/compressed_step.py, compression='learned'), the budgeted
    # controller's spent loss-impact budget + active policy (cli.py adaptive
    # wrapper), and the emulated-DCN measurements — bandwidth from MEASURED
    # transfer time over the throttled pipe (parallel/dcn_emu.py) and the
    # wall-clock step-time ratio vs the fixed-bf16 reference transfer.
    "codec_recon_err", "error_budget", "controller_mode",
    "dcn_measured_mbps", "wire_savings_wallclock_ratio",
})

# Prefix-namespaced families (dynamic keys): the in-training eval hook logs
# eval/i2t_recall@K etc. — any key under a registered prefix validates.
TRAIN_METRICS_PREFIXES = ("eval/",)

# serve/service.py stats() snapshot + the serve_stats/serve-bench records
# built from it (cli.py cmd_serve_bench spreads the snapshot into its
# record, so these are also registered in analysis/bench_schema.py).
SERVE_STATS_FIELDS = frozenset({
    "metric", "uptime_s", "requests", "items", "qps", "items_per_sec",
    "latency_ms", "batch_size_hist", "stage_latency_ms", "rejected",
    "timeouts", "compile_count", "bucket_space", "index_size", "cache",
    # serve/distindex (RetrievalRouter.stats): retrieval tier, versioned
    # hot-swap bookkeeping, measured ann recall, and the per-search-stage
    # (fanout/merge/coarse/rerank/exact) latency percentiles.
    "index_tier", "index_version", "shard_count", "swap_count",
    "swap_latency_ms", "recall_at_k", "rerank_k", "search_stage_latency_ms",
    # serve/admission.py (graftsiege): typed-shed counters distinct from the
    # queue-full "rejected" stream, the trailing-window shed rate that also
    # drives /healthz degraded, the nested AdmissionController.stats() row
    # (capacity/inflight/per_tenant), and the router's mid-swap flag.
    "shed", "shed_rate", "admission", "swap_in_flight",
    "capacity", "inflight", "per_tenant",
    # serve/fleet (graftfleet): the router's replica-health + routing
    # counters, the lease coordinator's epoch/reclaim bookkeeping, and the
    # wave controller's wave counter — every fleet stats() snap emits only
    # these, so the fleet_siege record stays schema-valid end to end.
    "replica_count", "healthy_replicas", "reroutes", "affinity_hits",
    "lease_epoch", "lease_reclaims", "wave_id",
})

# obs/health.py HealthEvent.record() — the structured watchdog events the
# train loop writes through the same logger.
HEALTH_EVENT_FIELDS = frozenset({"metric", "step", "event", "detail"})


def validate_metrics(
    record,
    fields=TRAIN_METRICS_FIELDS,
    prefixes: tuple = TRAIN_METRICS_PREFIXES,
) -> list[str]:
    """Validate one record's field NAMESPACE against a declared field set.

    Returns problem strings (empty = valid). Values are not typed here —
    the namespace is what drifts (the bench_schema convention).
    """
    if not isinstance(record, dict):
        return [f"record must be a dict, got {type(record).__name__}"]
    problems = []
    for key in record:
        if key in fields:
            continue
        if any(key.startswith(p) for p in prefixes):
            continue
        problems.append(
            f"unregistered metric field {key!r} — register it in "
            "obs/metrics_schema.py"
        )
    return problems
