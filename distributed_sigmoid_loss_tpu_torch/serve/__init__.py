"""Online embedding serving: admission → cache → micro-batcher → bucketed
engine → tiered, versioned retrieval, with hot swap, the chaos harness and
the fleet tier.

- :mod:`.engine` — the towers behind fixed padded shape buckets
  (``compile_count`` never passes the warmed bucket count).
- :mod:`.batcher` — thread-safe micro-batcher with bounded-queue
  backpressure.
- :mod:`.cache` — content-hash-keyed LRU embedding cache.
- :mod:`.index` — exact chunked dot-product top-k on the host.
- :mod:`.shard_index` — the same exact top-k over shards on a list of
  devices, merged on the host under the shared tie contract.
- :mod:`.ann` — int8 / sign-sketch coarse pruning, then exact re-rank.
- :mod:`.swap` — zero-downtime hot swap of weights and index segments.
- :mod:`.admission` — per-tenant rate limits, quotas and priority shedding.
- :mod:`.siege` — chaos points, the engine-process host-loss machinery and
  the scenario generator.
- :mod:`.service` — the façade (``encode_text`` / ``encode_image`` /
  ``search``, ``stats()``, ``health()``, ``/metrics``) and
  ``RetrievalRouter``, the tiered/versioned index front end.
- :mod:`.fleet` — token-lease admission, the replica router and swap waves
  across hosts, and the fleet chaos scenarios.

The names of the JAX package's ``serve``. Entry point: ``python -m
distributed_sigmoid_loss_tpu_torch serve-bench``.
"""

from distributed_sigmoid_loss_tpu_torch.serve.admission import (
    AdmissionController,
    ShedError,
    TenantPolicy,
    parse_tenant_spec,
)
from distributed_sigmoid_loss_tpu_torch.serve.ann import AnnIndex
from distributed_sigmoid_loss_tpu_torch.serve.batcher import (
    BatcherClosedError,
    MicroBatcher,
    QueueFullError,
    ShutdownError,
)
from distributed_sigmoid_loss_tpu_torch.serve.cache import EmbeddingCache, content_key
from distributed_sigmoid_loss_tpu_torch.serve.engine import InferenceEngine
from distributed_sigmoid_loss_tpu_torch.serve.fleet import (
    FLEET_SCENARIOS,
    FleetHost,
    FleetRouter,
    LeaseClient,
    LeaseCoordinator,
    LeasedAdmission,
    NoReplicaError,
    OverCommitError,
    ReplicaHandle,
    WaveController,
    build_fleet,
    run_fleet_scenario,
)
from distributed_sigmoid_loss_tpu_torch.serve.index import RetrievalIndex
from distributed_sigmoid_loss_tpu_torch.serve.service import (
    EmbeddingService,
    RequestTimeoutError,
    RetrievalRouter,
)
from distributed_sigmoid_loss_tpu_torch.serve.shard_index import ShardedIndex
from distributed_sigmoid_loss_tpu_torch.serve.siege import (
    CHAOS_POINTS,
    SCENARIOS,
    EngineProcess,
    HostLostError,
    chaos_enabled,
    hostloss_drill,
    inject,
    maybe_inject,
    run_scenario,
)
from distributed_sigmoid_loss_tpu_torch.serve.swap import SwapController

__all__ = [
    "AdmissionController",
    "AnnIndex",
    "BatcherClosedError",
    "CHAOS_POINTS",
    "EmbeddingCache",
    "EmbeddingService",
    "EngineProcess",
    "FLEET_SCENARIOS",
    "FleetHost",
    "FleetRouter",
    "HostLostError",
    "InferenceEngine",
    "LeaseClient",
    "LeaseCoordinator",
    "LeasedAdmission",
    "MicroBatcher",
    "NoReplicaError",
    "OverCommitError",
    "QueueFullError",
    "ReplicaHandle",
    "RequestTimeoutError",
    "RetrievalIndex",
    "RetrievalRouter",
    "SCENARIOS",
    "ShardedIndex",
    "ShedError",
    "ShutdownError",
    "SwapController",
    "TenantPolicy",
    "WaveController",
    "build_fleet",
    "chaos_enabled",
    "content_key",
    "hostloss_drill",
    "inject",
    "maybe_inject",
    "parse_tenant_spec",
    "run_fleet_scenario",
    "run_scenario",
]
