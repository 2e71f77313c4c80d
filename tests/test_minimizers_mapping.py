"""Minimizer + mapping infrastructure tests."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.utils import synth
from goldrush_jax.io import fastq
from goldrush_jax.ops.minimizers import batch_minimizers, minimizers_np
from goldrush_jax.stages import mapping

RNG = np.random.default_rng(17)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def test_device_matches_oracle():
    k, w = 16, 10
    lens = [200, 333, 64]
    codes = np.zeros((3, 333), dtype=np.uint8)
    seqs = []
    for i, L in enumerate(lens):
        c = RNG.integers(0, 4, L).astype(np.uint8)
        codes[i, :L] = c
        seqs.append(c)
    got = batch_minimizers(codes, np.array(lens), k, w)
    for (gp, gh), c in zip(got, seqs):
        wp, wh = minimizers_np(c, k, w)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gh, wh)


def test_minimizer_rc_overlap():
    # canonical hashing: a sequence and its revcomp share minimizer hashes
    k, w = 16, 10
    s = synth.random_genome(500, seed=8)
    rc = synth.revcomp(s)
    _, h1 = minimizers_np(fastq.encode(s), k, w)
    _, h2 = minimizers_np(fastq.encode(rc), k, w)
    shared = np.intersect1d(h1, h2)
    assert len(shared) >= 0.8 * min(len(h1), len(h2))


def test_mapping_locates_reads():
    genome = synth.random_genome(40_000, seed=9)
    contigs = [genome[:15_000], genome[15_000:28_000], genome[28_000:]]
    idx = mapping.build_index(contigs, ["c0", "c1", "c2"], k=16, w=32)
    # forward read inside contig 1
    r1 = genome[18_000:21_000]
    # reverse read inside contig 2
    r2 = synth.revcomp(genome[30_000:33_500])
    # read straddling the c0/c1 junction
    r3 = genome[13_000:17_500]
    hits = mapping.map_reads(idx, [r1, r2, r3])
    h1 = hits[0][0]
    assert h1.tid == 1 and h1.strand == 1
    assert abs(h1.t_start - 3_000) < 200 and abs(h1.t_end - 6_000) < 200
    h2 = hits[1][0]
    assert h2.tid == 2 and h2.strand == -1
    assert abs(h2.t_start - 2_000) < 200 and abs(h2.t_end - 5_500) < 200
    tids = {h.tid for h in hits[2][:2]}
    assert tids == {0, 1}


def test_mapping_noisy_read():
    genome = synth.random_genome(30_000, seed=10)
    idx = mapping.build_index([genome], ["c0"], k=16, w=16)
    reads = synth.simulate_reads(genome, 5, 4000, seed=11, err_rate=0.05,
                                 both_strands=True)
    hits = mapping.map_reads(idx, [s for _, s, _ in reads])
    for (rid, s, _), hh in zip(reads, hits):
        start = int(rid.split("_p")[1])
        assert hh, rid
        h = hh[0]
        assert h.t_start >= start - 300 and h.t_end <= start + 4000 + 300


def test_map_reads_batched_equals_per_read():
    """The batched map_reads pipeline (one searchsorted join + lexsort
    grouping over all reads' anchors) must reproduce per-read map_sequence
    exactly, including hit order, offsets and anchor lists."""
    genome = synth.random_genome(60_000, seed=20)
    contigs = [genome[:20_000], genome[18_000:40_000], genome[38_000:]]
    idx = mapping.build_index(contigs, ["a", "b", "c"], k=16, w=24)
    reads = synth.simulate_reads(genome, 40, 3_000, seed=21, err_rate=0.04,
                                 both_strands=True)
    seqs = [s for _, s, _ in reads]
    got = mapping.map_reads(idx, seqs, keep_anchors=True)
    mins = mapping._seq_minimizers(seqs, idx.k, idx.w)
    want = [mapping.map_sequence(idx, p, h, keep_anchors=True)
            for p, h in mins]
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert (g.tid, g.strand, g.q_start, g.q_end, g.t_start,
                    g.t_end, g.n_anchors, g.offset) == \
                   (w.tid, w.strand, w.q_start, w.q_end, w.t_start,
                    w.t_end, w.n_anchors, w.offset)
            import numpy as _np
            _np.testing.assert_array_equal(g.t_anchors, w.t_anchors)
