"""Device-fleet scheduler (port of pbccs_tpu.sched): pipelined dispatch
for the batch CLI's `--devices`.

  * pool.py      DevicePool / per-device executor threads, sticky bucket
                 routing, health-based benching + requeue
  * health.py    StickyMap + HealthTracker: the routing/benching idioms
  * executor.py  ScheduledPipeline: host prepare threads overlapped with
                 in-flight device polishes, ordered result emission
  * warmup.py    `ccs warmup`: build the kernels and drive a declared
                 bucket menu once
"""

from pbccs_tpu_torch.sched.health import (  # noqa: F401
    HealthPolicy,
    HealthTracker,
    StickyMap,
)
from pbccs_tpu_torch.sched.pool import (  # noqa: F401
    DevicePool,
    DevicePoolConfig,
    NoHealthyDevice,
    PoolClosed,
    SchedFuture,
    select_devices,
)
from pbccs_tpu_torch.sched.executor import ScheduledPipeline  # noqa: F401
