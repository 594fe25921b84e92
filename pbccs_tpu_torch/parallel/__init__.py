"""Batched ZMW polishing, on one device or over a ('zmw' x 'read') grid
of devices.

The algorithm has no cross-ZMW coupling (reference parallelism is a
thread-per-ZMW WorkQueue, include/pacbio/ccs/WorkQueue.h:53-217), so the
distribution story is:

  * `zmw` grid axis  -- data parallelism over the ZMW batch dimension
  * `read` grid axis -- intra-ZMW parallelism over subreads; mutation-score
    totals reduce over this axis, gathered on each ZMW row's first device
"""

from pbccs_tpu_torch.parallel.batch import BatchPolisher
from pbccs_tpu_torch.parallel.mesh import make_zmw_mesh, shard_batch

__all__ = ["make_zmw_mesh", "shard_batch", "BatchPolisher"]
