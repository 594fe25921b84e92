"""K1's share of its roofline: the least time of each launch (frozen
k1_work over each read's own lengths, at the launch's band width and
directions, bound_seconds) summed, over K1's device time, in %."""

import numpy as np

import bench_roofline as rf
import devtrace


def read(r):
    device_s = r.kernel_seconds(devtrace.K1_KERNEL)
    launches = [ln for ln in r.launches if ln.kernel == "k1"]
    if not launches or device_s <= 0:
        return None
    least = 0.0
    for ln in launches:
        I = ln.tensors["rlens"].astype(np.float64)
        J = ln.tensors["tlens"].astype(np.float64)
        work = rf.k1_work(1, I, J, ln.shapes["W"], ln.shapes["dirs"])
        least += rf.bound_seconds(*(float(np.sum(w)) for w in work))[0]
    return 100.0 * least / device_s
