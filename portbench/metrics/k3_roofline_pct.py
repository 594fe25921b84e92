"""K3's share of its roofline: the least time of each launch (frozen
k3_work over the (read, position) cells of its live 64-position blocks
inside each read's window, bound_seconds) summed, over K3's device
time, in %."""

import numpy as np

import bench_roofline as rf
import devtrace


def read(r):
    device_s = r.kernel_seconds(devtrace.K3_KERNEL)
    launches = [ln for ln in r.launches if ln.kernel == "k3"]
    if not launches or device_s <= 0:
        return None
    least = 0.0
    for ln in launches:
        s = ln.shapes
        live = ln.tensors["live"] != 0                      # (R, NB)
        first = rf.K3_BLOCK * np.arange(live.shape[1])[None, :]
        wl = ln.tensors["wlens"].astype(np.int64)[:, None]
        cells = np.clip(wl - first, 0, rf.K3_BLOCK) * live
        least += rf.bound_seconds(*rf.k3_work(
            s["R"], s["nc"], s["Imax"], s["Jm"], s["W"],
            positions=int(cells.sum()), blocks=int(live.sum())))[0]
    return 100.0 * least / device_s
