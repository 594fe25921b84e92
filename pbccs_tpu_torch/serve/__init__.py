"""Online CCS serving on the card: long-lived engine, dynamic batching,
NDJSON/TCP, and the replica tier in front of it.

Port of pbccs_tpu.serve.  `engine.CcsEngine` owns the card and batches
concurrent requests into the batch path's lockstep polish;
`server.CcsServer` / `client.CcsClient` speak the streaming protocol
(`protocol`, byte for byte pbccs_tpu's wire); `batcher.DynamicBatcher`
is the socket-free scheduling core; `tenancy` the token file, TLS
contexts and per-tenant fair queuing.  `router.CcsRouter` /
`router.RouterServer` are the health-checked front door over N `ccs
serve` processes (no CUDA context of its own), and
`supervisor.FleetSupervisor` spawns, respawns and rolls those processes.
`ccs serve`, `ccs router` and `ccs fleet` (cli.py) are the process entry
points.
"""

from pbccs_tpu_torch.serve.batcher import Batch, DynamicBatcher, PendingItem
from pbccs_tpu_torch.serve.engine import (
    CcsEngine,
    EngineClosed,
    EngineOverloaded,
    Request,
    ServeConfig,
)
from pbccs_tpu_torch.serve.router import CcsRouter, RouterConfig, RouterServer
from pbccs_tpu_torch.serve.supervisor import FleetSupervisor, SupervisorConfig

__all__ = [
    "Batch",
    "CcsEngine",
    "CcsRouter",
    "DynamicBatcher",
    "EngineClosed",
    "EngineOverloaded",
    "FleetSupervisor",
    "PendingItem",
    "Request",
    "RouterConfig",
    "RouterServer",
    "ServeConfig",
    "SupervisorConfig",
]
