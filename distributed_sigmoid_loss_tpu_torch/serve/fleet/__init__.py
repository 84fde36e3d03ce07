"""The multi-host serving fleet tier.

Three pillars over the single-host serving stack: bounded-staleness
distributed admission via token leases (:mod:`.leases`), a health-driven
replica-group front door with session-affinity pinning (:mod:`.router`),
and coordinated zero-downtime swap waves (:mod:`.waves`) — drilled end to
end by the fleet scenarios (:mod:`.scenarios`). The port of the JAX
package's ``serve/fleet/``: standard library only.
"""

from distributed_sigmoid_loss_tpu_torch.serve.fleet.leases import (
    USE_FRACTION,
    Lease,
    LeaseClient,
    LeaseCoordinator,
    LeasedAdmission,
    OverCommitError,
)
from distributed_sigmoid_loss_tpu_torch.serve.fleet.router import (
    FleetRouter,
    NoReplicaError,
    ReplicaHandle,
)
from distributed_sigmoid_loss_tpu_torch.serve.fleet.scenarios import (
    FLEET_SCENARIOS,
    Fleet,
    FleetHost,
    build_fleet,
    run_fleet_scenario,
)
from distributed_sigmoid_loss_tpu_torch.serve.fleet.waves import WaveController

__all__ = [
    "FLEET_SCENARIOS",
    "Fleet",
    "FleetHost",
    "FleetRouter",
    "Lease",
    "LeaseClient",
    "LeaseCoordinator",
    "LeasedAdmission",
    "NoReplicaError",
    "OverCommitError",
    "ReplicaHandle",
    "USE_FRACTION",
    "WaveController",
    "build_fleet",
    "run_fleet_scenario",
]
