"""The port's sharded polish (parallel.mesh, BatchPolisher(mesh=...))
against its unsharded polish and against pbccs_tpu's mesh.

The port's grids here repeat the CPU device ("cpu" in every cell), as
pbccs_tpu's tests shard over 8 virtual CPU devices (tests/conftest.py).

Tolerances: the sharded polish against the port's unsharded one, equal
(templates, refine results, QVs, setup statistics: every block computes
its reads as the whole batch does, and the read-axis sums are float64,
rounded once); setup statistics against pbccs_tpu's mesh run, statuses
and active equal and baselines within 1e-4 absolute (the fill contract,
pbccs_tpu/ops/fwdbwd_pallas.py:45-47); the refinement against
pbccs_tpu's device loop, templates and convergence equal, QVs within 1."""

import itertools

import jax
import numpy as np
import pytest
import torch

from pbccs_tpu.parallel import BatchPolisher as JPolisher
from pbccs_tpu.parallel import make_zmw_mesh as jmake_zmw_mesh
from pbccs_tpu.parallel.batch import ZmwTask as JTask
from pbccs_tpu.parallel.batch import effective_shapes as jeffective_shapes

from pbccs_tpu_torch.models.arrow.refine import RefineOptions
from pbccs_tpu_torch.obs import flight as obs_flight
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.parallel import (BatchPolisher, make_zmw_mesh,
                                      shard_batch)
from pbccs_tpu_torch.parallel.batch import ZmwTask, effective_shapes
from pbccs_tpu_torch.parallel.mesh import READ_AXIS, ZMW_AXIS
from pbccs_tpu_torch.simulate import simulate_zmw

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

MESHES = [(4, 2), (2, 4), (8, 1), (1, 1)]


def cpu_mesh(nz, nr):
    return make_zmw_mesh(nz, nr, ["cpu"] * (nz * nr))


def make_tasks(rng, n_zmws, tpl_len, n_passes):
    """tests/test_batch.py's draw: simulated ZMWs, full-window reads."""
    out = []
    for z in range(n_zmws):
        tpl, reads, strands, snr = simulate_zmw(rng, tpl_len, n_passes)
        out.append((f"m/{z}", tpl, snr, list(reads), list(strands),
                    [0] * len(reads), [len(tpl)] * len(reads)))
    return out


def corrupted(tasks, pos=30):
    """The drafts with one base substituted at `pos`, so refinement has
    real work."""
    out = []
    for t in tasks:
        tpl = t[1].copy()
        tpl[pos] = (tpl[pos] + 1) % 4
        out.append((t[0], tpl) + t[2:])
    return out


def draw_short():
    return corrupted(make_tasks(np.random.default_rng(20260729), 4, 60, 4))


def draw_multiblock():
    """A 300 bp bucket: several 64-position K3 blocks per read."""
    return corrupted(make_tasks(np.random.default_rng(20260730), 2, 300, 3))


def draw_growth():
    """A draft that is its 64 bp truth with every fourth base deleted (it
    outgrows its 64-column bucket: pbccs_tpu's mesh loop bails there)
    beside a plain 40 bp ZMW of the same bucket."""
    rng = np.random.default_rng(32)
    tpl, reads, strands, snr = simulate_zmw(rng, 64, 5)
    draft = np.delete(tpl, np.arange(3, len(tpl), 4))
    grow = ("grow/0", draft, snr, list(reads), list(strands), [0] * 5,
            [len(draft)] * 5)
    return [grow] + corrupted(make_tasks(rng, 1, 40, 5), pos=20)


def draw_tiny():
    """One read clipped to a 6-column window (edge slots scored by full
    refills: pbccs_tpu's mesh loop bails there) beside a plain ZMW."""
    rng = np.random.default_rng(20260729)
    tpl, reads, strands, snr = simulate_zmw(rng, 60, 5)
    reads = list(reads)
    reads[1] = reads[1][:6]
    tends = [len(tpl)] * 5
    tends[1] = 6
    tiny = ("tiny/0", tpl, snr, reads, list(strands), [0] * 5, tends)
    return [tiny] + corrupted(make_tasks(rng, 1, 60, 5))


DRAWS = {"short": draw_short, "multiblock": draw_multiblock,
         "growth": draw_growth, "tiny": draw_tiny}
OPTS = RefineOptions(max_iterations=8)


def polish(args, **kw):
    """(polisher, its setup's Jmax, refine results, QVs) of the port."""
    pol = BatchPolisher([ZmwTask(*a) for a in args], **kw)
    j0 = pol._Jmax
    res = pol.refine(OPTS)
    return pol, j0, res, pol.consensus_qvs()


_UNSHARDED = {}


def unsharded(name):
    """The port's unsharded polish of a draw, once per worker."""
    if name not in _UNSHARDED:
        _UNSHARDED[name] = polish(DRAWS[name](), device="cpu")
    return _UNSHARDED[name]


# --------------------------------------------------------------------------
# the grid
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_zmw,n_read", [(None, 1), (None, 2), (None, 8),
                                          (4, 2), (2, 4), (8, 1), (1, 8),
                                          (3, 2), (1, 1)])
def test_make_zmw_mesh_matches_jax(n_zmw, n_read):
    """Shapes and defaults of the grid over 8 devices: pbccs_tpu's over
    its 8 virtual devices, the port's over the CPU named 8 times."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    want = jmake_zmw_mesh(n_zmw, n_read, jax.devices()[:8])
    got = make_zmw_mesh(n_zmw, n_read, ["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names) == (ZMW_AXIS, READ_AXIS)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


@pytest.mark.parametrize("n_zmw,n_read", [(None, 3), (4, 4), (9, 1)])
def test_make_zmw_mesh_refuses_like_jax(n_zmw, n_read):
    """pbccs_tpu's two ValueErrors, with its messages."""
    with pytest.raises(ValueError) as want:
        jmake_zmw_mesh(n_zmw, n_read, jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        make_zmw_mesh(n_zmw, n_read, ["cpu"] * 8)
    assert str(got.value) == str(want.value)


def test_make_zmw_mesh_refuses_mixed_types_and_defaults_to_the_cards():
    with pytest.raises(ValueError, match="mixes device types"):
        make_zmw_mesh(2, 1, ["cpu", "meta"])
    if torch.cuda.is_available():
        mesh = make_zmw_mesh()
        assert mesh.devices.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_zmw_mesh()


def test_shard_batch_places_zmw_and_read_blocks():
    """Each leaf becomes an (n_zmw, n_read) grid of blocks: the leading
    axis split over rows, a named read axis split over columns, other
    leaves replicated along the row."""
    mesh = cpu_mesh(2, 3)
    a = np.arange(4 * 6 * 5).reshape(4, 6, 5)
    b = np.arange(4)
    out = shard_batch(mesh, {"a": a, "pair": (b, a)},
                      read_axis_of=lambda path: 1 if path == ("a",) else None)
    for i, j in itertools.product(range(2), range(3)):
        np.testing.assert_array_equal(out["a"][i][j].numpy(),
                                      a[2 * i: 2 * i + 2, 2 * j: 2 * j + 2])
        np.testing.assert_array_equal(out["pair"][0][i][j].numpy(),
                                      b[2 * i: 2 * i + 2])
        np.testing.assert_array_equal(out["pair"][1][i][j].numpy(),
                                      a[2 * i: 2 * i + 2])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(cpu_mesh(3, 1), {"b": b})


@pytest.mark.parametrize("zq,rq", [(1, 1), (2, 1), (4, 2), (2, 4), (1, 8),
                                   (8, 1)])
def test_effective_shapes_match_jax(zq, rq):
    """The (Imax, Jmax, R, Z) of a mesh run, pbccs_tpu's
    effective_shapes(..., min_z, zq, rq) over a grid of inputs (the
    port's fourth `buckets` element is pbccs_tpu's min_z)."""
    for n, reads, rlen, tlen in itertools.product(
            (1, 3, 8, 13), (1, 5, 12, 17), (90, 2100), (60, 2000)):
        for bk in (None, (512, 2112, 12), (4096, 128, 16)):
            for min_z in ((1, 16) if bk else (1,)):
                got = effective_shapes(
                    n, reads, rlen, tlen, zq=zq, rq=rq,
                    buckets=None if bk is None else bk + (min_z,))
                want = jeffective_shapes(n, reads, rlen, tlen, buckets=bk,
                                         min_z=min_z, zq=zq, rq=rq)
                assert got == tuple(want), (n, reads, rlen, tlen, bk, min_z)


def test_polisher_device_must_be_the_meshs_first():
    args = draw_short()[:2]
    mesh = cpu_mesh(2, 1)
    pol = BatchPolisher([ZmwTask(*a) for a in args], mesh=mesh, device="cpu")
    assert pol.device == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        BatchPolisher([ZmwTask(*a) for a in args], mesh=mesh, device="meta")


# --------------------------------------------------------------------------
# the sharded polish against the port's unsharded polish
# --------------------------------------------------------------------------


@pytest.mark.parametrize("draw", list(DRAWS))
@pytest.mark.parametrize("nz,nr", MESHES)
def test_sharded_polish_matches_unsharded(draw, nz, nr):
    """Templates, refine results, QVs and setup statistics of the
    sharded polish equal the unsharded polish's; every block sits on its
    cell's device at Z padded to n_zmw and R to max(4, n_read)."""
    ref, j0, ref_res, ref_qv = unsharded(draw)
    mesh = cpu_mesh(nz, nr)
    pol, _, res, qv = polish(DRAWS[draw](), mesh=mesh)
    assert pol._Z % nz == 0 and pol._R % max(4, nr) == 0
    assert len(pol._grid) == nz and all(len(r) == nr for r in pol._grid)
    assert pol._grid[0][0].reads.shape[:2] == (pol._Z // nz, pol._R // nr)
    n, R = ref.n_zmws, min(ref._R, pol._R)
    for key in ("statuses", "active", "baselines", "zscores"):
        np.testing.assert_array_equal(getattr(pol, key)[:n, :R],
                                      getattr(ref, key)[:n, :R], key)
    np.testing.assert_array_equal(pol.global_zscores(),
                                  ref.global_zscores())
    assert [vars(r) for r in res] == [vars(r) for r in ref_res]
    for z in range(n):
        np.testing.assert_array_equal(pol.tpls[z], ref.tpls[z])
        np.testing.assert_array_equal(qv[z], ref_qv[z])
    assert pol._Jmax == ref._Jmax
    if draw == "growth":
        assert res[0].converged and ref._Jmax > j0   # it re-bucketed


def test_sharded_polish_keeps_the_unsharded_metrics():
    """The batch counters, fill histograms and flight records of a mesh
    run are those of an unsharded polisher of the same Z and R."""
    args = draw_short()
    got = []
    for kw in ({"device": "cpu", "buckets": (0, 0, 4, 4)},
               {"mesh": cpu_mesh(2, 2)}):
        seen = len(obs_flight.default_recorder().snapshot())
        win = default_registry().scope()
        pol = BatchPolisher([ZmwTask(*a) for a in args], **kw)
        pol.refine(OPTS)
        batch = {k: v for k, v in win.delta().items()
                 if k[0].startswith("ccs_batch_")}
        rounds = [(r["round"], r["live"], r["n_zmws"], r["z"]) for r in
                  obs_flight.default_recorder().snapshot()[seen:]]
        got.append((pol._Z, pol._R, batch, rounds))
    assert got[0] == got[1]
    assert got[0][2] and got[0][3], "no batch metric or flight record"


# --------------------------------------------------------------------------
# against pbccs_tpu's mesh and device loop
# --------------------------------------------------------------------------


def test_setup_statistics_match_jax_mesh():
    """BatchPolisher(mesh=4x2) setup against pbccs_tpu's
    BatchPolisher(mesh=make_zmw_mesh(4, 2)) on tests/test_batch.py's
    draw: active and statuses equal, baselines within 1e-4."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    args = make_tasks(np.random.default_rng(20260729), 4, 60, 4)
    want = JPolisher([JTask(*a) for a in args],
                     mesh=jmake_zmw_mesh(n_zmw=4, n_read=2))
    got = BatchPolisher([ZmwTask(*a) for a in args], mesh=cpu_mesh(4, 2))
    assert (got._Z, got._R) == (want._Z, want._R)
    np.testing.assert_array_equal(got.active, want.active)
    np.testing.assert_array_equal(got.statuses, want.statuses)
    np.testing.assert_allclose(got.baselines, want.baselines, atol=1e-4)


@pytest.mark.parametrize("tpl_len",
                         [60, pytest.param(300, marks=pytest.mark.slow)])
def test_sharded_refine_matches_jax_sharded_device_loop(monkeypatch,
                                                        tpl_len):
    """tests/test_batch.py's sharded-refine setup (4 ZMWs, 4 passes, a
    substitution at 30, 6 rounds): the port's polish over a 4 x 2 grid
    against pbccs_tpu's device loop sharded over make_zmw_mesh(4, 2) --
    templates and convergence equal, QVs within 1.  The 300 bp case is
    marked slow, as pbccs_tpu marks its own."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    monkeypatch.setenv("PBCCS_DEVICE_REFINE", "1")
    monkeypatch.setenv("PBCCS_DENSE", "1")
    from pbccs_tpu.models.arrow.refine import RefineOptions as JOptions

    args = corrupted(make_tasks(np.random.default_rng(20260729), 4,
                                tpl_len, 4))
    want = JPolisher([JTask(*a) for a in args],
                     mesh=jmake_zmw_mesh(n_zmw=4, n_read=2))
    rw = want.refine_device(JOptions(max_iterations=6))
    assert rw is not None, "pbccs_tpu's mesh refine fell back to its host loop"
    qw = want.consensus_qvs()
    pol = BatchPolisher([ZmwTask(*a) for a in args], mesh=cpu_mesh(4, 2))
    rs = pol.refine(RefineOptions(max_iterations=6))
    qs = pol.consensus_qvs()
    for z in range(4):
        assert rw[z].converged == rs[z].converged
        np.testing.assert_array_equal(want.tpls[z], pol.tpls[z])
        assert np.abs(qw[z].astype(int) - qs[z].astype(int)).max() <= 1
