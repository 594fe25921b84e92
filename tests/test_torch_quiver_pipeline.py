"""process_chunks with the Quiver model, port against the JAX package.

The same simulated ZMWs (numpy seed) go through both packages on the
CPU: the JAX package's per-ZMW Quiver pipeline (its XLA recursor) and
the port's (the plain version of the K2 scan).  Contract: the same
tally and consensus sequence, QVs within 1, the same mutation counts."""

import numpy as np
import pytest
import torch

import pbccs_tpu.pipeline as jpipe

import pbccs_tpu_torch.pipeline as tpipe
from pbccs_tpu_torch.simulate import simulate_zmw

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

QV_ATOL = 1


# three draws at the floor of the contract's size (100 bp, 4 passes), the
# seeds whose refinement tests the fewest mutations: the JAX reference
# side of a draw costs as much as the port's
@pytest.mark.parametrize("seed,L,passes", [(20, 100, 4), (11, 100, 4),
                                           (24, 100, 4)])
def test_process_chunks_quiver_matches_jax(seed, L, passes):
    rng = np.random.default_rng(seed)
    _, reads, _, snr = simulate_zmw(rng, L, passes)
    ids = [f"q/{seed}/{i}" for i in range(len(reads))]
    jc = [jpipe.Chunk(f"q/{seed}", [jpipe.Subread(i, r)
                                    for i, r in zip(ids, reads)], snr)]
    tc = [tpipe.Chunk(f"q/{seed}", [tpipe.Subread(i, r)
                                    for i, r in zip(ids, reads)], snr)]
    ref = jpipe.process_chunks(jc, jpipe.ConsensusSettings(model="quiver"))
    mine = tpipe.process_chunks(tc, tpipe.ConsensusSettings(model="quiver"),
                                device="cpu")
    assert {f.value: c for f, c in ref.counts.items()} == \
        {f.value: c for f, c in mine.counts.items()}
    assert len(ref.results) == len(mine.results) == 1
    a, b = ref.results[0], mine.results[0]
    assert a.sequence == b.sequence
    assert np.abs(a.qvs.astype(int) - b.qvs.astype(int)).max() <= QV_ATOL
    assert (a.mutations_tested, a.mutations_applied, a.num_passes,
            a.status_counts) == (b.mutations_tested, b.mutations_applied,
                                 b.num_passes, b.status_counts)
    assert np.isnan(b.global_zscore) and np.isnan(b.zscores).all()


def test_serial_arrow_polish_is_not_ported():
    """The serial Arrow polish behind process_chunk (the test's name is
    kept from when it pinned that polish's absence): the model defaults
    to Arrow, and the port's serial scorer gives the JAX package's
    consensus, QVs within 1."""
    rng = np.random.default_rng(6)
    _, reads, _, snr = simulate_zmw(rng, 60, 4)
    ids = [f"a/{i}" for i in range(len(reads))]
    chunk = tpipe.Chunk("a", [tpipe.Subread(i, r)
                              for i, r in zip(ids, reads)], snr)
    jchunk = jpipe.Chunk("a", [jpipe.Subread(i, r)
                               for i, r in zip(ids, reads)], snr)
    failure, got = tpipe.process_chunk(chunk, device="cpu")
    jfailure, want = jpipe.process_chunk(jchunk)
    assert failure.value == jfailure.value == "Success"
    assert got.sequence == want.sequence
    assert np.abs(got.qvs.astype(int) - want.qvs.astype(int)).max() \
        <= QV_ATOL
