"""The traced run's readings: the profiler's device timeline, the shapes
of every K1 and K3 launch, and the program's spans and counters, reduced
to what the per-layer readers in metrics/ read.

The union and grouping arithmetic is a copy of the port's
tools/profile_main_path.py (`_union_ms`, `kernel_group`)."""

from __future__ import annotations

import dataclasses
import re

import numpy as np

#: name prefixes of the port's hand-written kernels
K1_KERNEL = "arrow_fill_kernel"
K3_KERNEL = "dense_score_kernel"
OUR_KERNELS = (K1_KERNEL, "quiver_fill_kernel", K3_KERNEL)
#: the profiler range the harness opens around the traced window
WINDOW = "portbench.window"


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers."""
    gaps, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [g for g in gaps if g[1] > g[0]]


def kernel_group(name: str) -> str:
    """A short group name for a CUDA kernel: the port's by name,
    PyTorch's by the functor or operator its template names."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith(OUR_KERNELS):
        return name.split("(")[0]
    for pat in (r"where_kernel", r"\w*Functor\w*<\w+>", r"\w+_kernel\w*"):
        m = re.search(pat, name)
        if m:
            return m.group(0)
    return name[:60]


def kernel_is(name: str, prefix: str) -> bool:
    """Whether a CUDA kernel's name is one of the port's, `prefix`."""
    return kernel_group(name).startswith(prefix)


@dataclasses.dataclass
class Launch:
    """One K1 or K3 launch as its wrapper saw it: its static shapes and
    references to the device tensors of its lengths and live blocks,
    read once the window has closed (reading them inside the window
    would make the host wait)."""

    kernel: str
    shapes: dict
    tensors: dict


class LaunchRecorder:
    """Wraps the port's K1 and K3 entry points for the traced window."""

    def __init__(self, fwdbwd_cuda, dense_score_cuda):
        self.mods = (fwdbwd_cuda, dense_score_cuda)
        self.orig = (fwdbwd_cuda.arrow_fill, dense_score_cuda.dense_score)
        self.launches: list[Launch] = []

    def __enter__(self):
        fc, dc = self.mods
        k1, k3 = self.orig
        rec = self.launches

        def arrow_fill(reads, rlens, tpls, trans, tlens, offsets, width,
                       *a, **kw):
            out = k1(reads, rlens, tpls, trans, tlens, offsets, width,
                     *a, **kw)
            dirs = tuple(d for d, o in zip((False, True), out)
                         if o is not None)
            rec.append(Launch("k1", {"W": int(width), "dirs": dirs},
                              {"rlens": rlens, "tlens": tlens}))
            return out

        def dense_score(alpha, beta, offsets, apre, bsuf, reads, rlens,
                        win_tpl, wlens, win_trans, tables, live):
            out = k3(alpha, beta, offsets, apre, bsuf, reads, rlens,
                     win_tpl, wlens, win_trans, tables, live)
            R, nc, W = alpha.shape
            rec.append(Launch("k3", {"R": R, "nc": nc, "W": W,
                                     "Imax": reads.shape[1],
                                     "Jm": win_tpl.shape[1]},
                              {"wlens": wlens, "live": live}))
            return out

        # the entry points count their launches on the name they are
        # bound to in their module, which is the wrapper's while it is on
        arrow_fill.launches = dense_score.launches = 0
        fc.arrow_fill, dc.dense_score = arrow_fill, dense_score
        return self

    def __exit__(self, *exc):
        fc, dc = self.mods
        fc.arrow_fill, dc.dense_score = self.orig
        return False

    def resolved(self) -> list[Launch]:
        """The launches with their tensors read back as numpy."""
        out = []
        for ln in self.launches:
            t = {k: v.detach().cpu().numpy() for k, v in ln.tensors.items()}
            out.append(Launch(ln.kernel, ln.shapes, t))
        return out


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads, all of the traced window.

    kernels: (name, start_us, end_us) of every CUDA kernel; host:
    (name, start_us, end_us) of every host-side event; t0_us, t1_us: the
    window on the profiler's clock; spans: (name, seconds, args) of the
    program's spans; counters: deltas of the program's counters by
    (name, labels); launches: the K1 and K3 launches; zmws: outcomes;
    peak_bytes: torch.cuda.max_memory_allocated over the window."""

    kernels: list
    host: list
    t0_us: float
    t1_us: float
    spans: list
    counters: dict
    launches: list
    zmws: int
    peak_bytes: int

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((max(s, self.t0_us), min(e, self.t1_us))
                        for _, s, e in self.kernels
                        if e > self.t0_us and s < self.t1_us) / 1e6

    def counter(self, name: str, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        return float(self.counters.get(key, 0.0))

    def rounds(self) -> float:
        return self.counter("ccs_refine_rounds_total", source="device")

    def kernel_seconds(self, prefix: str) -> float:
        return sum(e - s for n, s, e in self.kernels
                   if kernel_is(n, prefix)) / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps, each named by the innermost host event open
        at its middle."""
        by: dict[str, float] = {}
        for n, s, e in self.kernels:
            g = kernel_group(n)
            by[g] = by.get(g, 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = idle_gaps([(s, e) for _, s, e in self.kernels],
                         self.t0_us, self.t1_us)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        host = sorted(self.host, key=lambda h: h[1])
        starts = np.array([h[1] for h in host])
        named: dict[str, float] = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            k = int(np.searchsorted(starts, mid, side="right"))
            inner, width = "no host op open", np.inf
            for n, s, e in host[max(0, k - 4000):k]:
                if s <= mid <= e and e - s < width and n != WINDOW:
                    inner, width = n, e - s
            named[inner] = named.get(inner, 0.0) + (g1 - g0) / 1e6
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in
                              sorted(named.items(), key=lambda kv: -kv[1])]}
