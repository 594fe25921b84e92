"""The ('zmw' x 'read') device grid of the sharded batch polish.

Port of pbccs_tpu.parallel.mesh.  A batch of bucketed ZMWs is laid out
on a 2-D grid of torch devices: the 'zmw' axis splits the batch's ZMWs
into rows, the 'read' axis splits each ZMW's subreads into blocks.  One
process drives the grid (parallel.batch.BatchPolisher(mesh=...)): each
cell's block of reads runs on the cell's device, and the read-axis sums
of the refinement loop are gathered on the row's first device, its
lead (parallel.device_refine.run_refine_loop).

One deliberate difference from jax.sharding.Mesh: a device may fill
several cells (`["cpu"] * 8`, `["cuda:0"] * 4`), so a grid runs on one
card, or on the CPU, with every block and reduction of a multi-card
run."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from pbccs_tpu_torch.device import resolve_device

ZMW_AXIS = "zmw"
READ_AXIS = "read"


def as_device(device) -> torch.device:
    """A grid cell's device: resolve_device's, with a card's index made
    explicit (`cuda` is the current card), so two names of one device
    compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (n_zmw, n_read) grid of torch devices.  `shape` maps each axis
    name to its size, as jax.sharding.Mesh.shape does; `devices` is the
    grid as an object array."""

    devices: np.ndarray
    axis_names: tuple[str, str] = (ZMW_AXIS, READ_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> list[torch.device]:
        """The grid's devices, each once, in grid order."""
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def make_zmw_mesh(n_zmw: int | None = None, n_read: int = 1,
                  devices: Sequence | None = None) -> Mesh:
    """A ('zmw', 'read') grid over `devices` (default: every visible
    card, `cuda:0` .. `cuda:N-1`; with no card the caller must name its
    devices, `"cpu"` included).

    By default all devices go to the 'zmw' (data-parallel) axis; pass
    n_read > 1 to dedicate a read-parallel subaxis (useful for high-pass
    ZMWs where R is large and Z is small).  A device may be named more
    than once; a grid that mixes device types is refused."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_zmw_mesh: no CUDA device is visible; name the grid's "
                "devices (devices=['cpu'] * n runs the plain versions)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [as_device(d) for d in devices]
    n = len(devices)
    if n_zmw is None:
        if n % n_read != 0:
            raise ValueError(f"{n} devices not divisible by n_read={n_read}")
        n_zmw = n // n_read
    if n_zmw * n_read > n:
        raise ValueError(f"mesh {n_zmw}x{n_read} needs more than {n} devices")
    if n_zmw < 1 or n_read < 1:
        raise ValueError(f"mesh {n_zmw}x{n_read} has no cell")
    devices = devices[: n_zmw * n_read]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"mesh mixes device types: "
                         f"{sorted({d.type for d in devices})}")
    grid = np.empty(n_zmw * n_read, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_zmw, n_read))


def _blocks(n: int, parts: int) -> list[slice]:
    if n % parts:
        raise ValueError(f"axis of {n} does not split into {parts} blocks")
    b = n // parts
    return [slice(i * b, (i + 1) * b) for i in range(parts)]


def shard_batch(mesh: Mesh, tree, read_axis_of=lambda path: None):
    """Place a tree (dict, list or tuple) of batch arrays on the grid.

    Each array leaf becomes an (n_zmw, n_read) nested list of tensors:
    cell (i, j) holds the i-th block of the array's leading (ZMW) axis
    on the cell's device.  `read_axis_of(path)` (path: the tuple of keys
    and indices from the root to the leaf) names the leaf's read axis,
    split into n_read blocks the same way; a leaf without one is
    replicated over the read axis, as pbccs_tpu's P('zmw') layout is."""
    nz, nr = mesh.devices.shape

    def place(path, x):
        x = np.asarray(x)
        rax = read_axis_of(path)
        zs = _blocks(x.shape[0], nz)
        rs = _blocks(x.shape[rax], nr) if rax is not None else None
        out = []
        for i in range(nz):
            row = []
            for j in range(nr):
                idx = [zs[i]] + [slice(None)] * (x.ndim - 1)
                if rs is not None:
                    idx[rax] = rs[j]
                row.append(torch.as_tensor(
                    np.ascontiguousarray(x[tuple(idx)]),
                    device=mesh.devices[i, j]))
            out.append(row)
        return out

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(path + (i,), v)
                              for i, v in enumerate(node))
        return place(path, node)

    return walk((), tree)


def pad_to(n: int, quantum: int) -> int:
    """Round n up to a multiple of `quantum` (>= quantum)."""
    return max(quantum, int(math.ceil(n / quantum)) * quantum)
