"""Online CCS serving on the card: long-lived engine, dynamic batching,
NDJSON/TCP.

Port of pbccs_tpu.serve without the multi-replica tier (router,
supervisor).  `engine.CcsEngine` owns the card and batches concurrent
requests into the batch path's lockstep polish; `server.CcsServer` /
`client.CcsClient` speak the streaming protocol (`protocol`, byte for
byte pbccs_tpu's wire); `batcher.DynamicBatcher` is the socket-free
scheduling core; `tenancy` the token file, TLS contexts and per-tenant
fair queuing.  `ccs serve` (cli.py) is the process entry point.
"""

from pbccs_tpu_torch.serve.batcher import Batch, DynamicBatcher, PendingItem
from pbccs_tpu_torch.serve.engine import (
    CcsEngine,
    EngineClosed,
    EngineOverloaded,
    Request,
    ServeConfig,
)

__all__ = [
    "Batch",
    "CcsEngine",
    "DynamicBatcher",
    "EngineClosed",
    "EngineOverloaded",
    "PendingItem",
    "Request",
    "ServeConfig",
]
