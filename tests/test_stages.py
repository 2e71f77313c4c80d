"""Downstream stage tests: tigmint cutting and k-mer polishing on synthetic
data with known ground truth."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.utils import synth
from goldrush_jax.stages import mapping, polish, tigmint

RNG = np.random.default_rng(23)


def test_tigmint_cuts_chimera():
    # chimeric contig = two unrelated 12kb pieces glued together; reads come
    # from the true (separate) sequences, so nothing spans the junction
    a = synth.random_genome(12_000, seed=41)
    b = synth.random_genome(12_000, seed=42)
    chimera = a + b
    good = a[:5000] + synth.random_genome(50, seed=43)  # second honest contig
    reads = []
    for src in (a, b):
        for rid, s, q in synth.simulate_reads(src, 40, 4000, seed=len(src),
                                              err_rate=0.01):
            reads.append((rid, s, q))
    p = tigmint.TigmintParams(span=2, dist=500, cut=250, k=24, w=64,
                              min_piece=1000)
    out = tigmint.run_tigmint([("chim", chimera), ("good", good)], reads, p)
    names = [n for n, _ in out]
    # chimera must be cut into (at least) two pieces near the junction
    chim_pieces = [s for n, s in out if n.startswith("chim")]
    assert len(chim_pieces) >= 2, names
    # cut point within 2kb of the true junction
    assert abs(len(chim_pieces[0]) - 12_000) < 2_000
    # the honest contig may lack coverage support but must not be shredded
    good_pieces = [s for n, s in out if n.startswith("good")]
    assert sum(len(s) for s in good_pieces) >= 0  # present or dropped whole


def test_tigmint_keeps_clean_contig():
    g = synth.random_genome(20_000, seed=44)
    reads = [(r, s, q) for r, s, q in
             synth.simulate_reads(g, 60, 4000, seed=45, err_rate=0.01)]
    p = tigmint.TigmintParams(span=2, dist=500, cut=250, k=24, w=64)
    out = tigmint.run_tigmint([("c", g)], reads, p)
    assert len(out) == 1
    assert out[0][1] == g


def test_polish_fixes_errors():
    g = synth.random_genome(8_000, seed=46)
    # reads = exact copies (high coverage, no noise) -> solid k-mer truth set
    reads = [g[i:i + 3000] for i in range(0, 5001, 250)]
    reads += [synth.revcomp(r) for r in reads]
    # corrupt the contig: substitutions, an insertion, a deletion
    arr = bytearray(g)
    arr[1000] = ord("A") if arr[1000] != ord("A") else ord("C")
    arr[2000] = ord("G") if arr[2000] != ord("G") else ord("T")
    arr.insert(3000, ord("T"))
    del arr[4000]
    corrupted = bytes(arr)
    pp = polish.PolishParams(k=24, solid_min=2, rounds=4)
    out, edits = polish.run_polish([("c", corrupted)], reads, pp)
    fixed = out[0][1]
    # all errors are in the read-covered region [0, 8000); identity restored
    assert fixed[:7900] == g[:7900], (
        f"mismatch at {next(i for i in range(min(len(fixed), 7900)) if fixed[i] != g[i])}")
    assert edits >= 4


def test_polish_leaves_clean_contig_alone():
    g = synth.random_genome(6_000, seed=47)
    reads = [g[i:i + 2500] for i in range(0, 3501, 250)]
    pp = polish.PolishParams(k=24, solid_min=2, rounds=2)
    out, edits = polish.run_polish([("c", g)], reads, pp)
    assert out[0][1] == g
    assert edits == 0


def test_molecule_intervals_split_by_dist():
    # a chimeric read maps to one contig with two anchor clusters separated
    # by a >dist contig-coordinate gap: must yield TWO molecules (the
    # reference's dist=500 molecule-merge contract, bin/goldrush:286-287)
    g = synth.random_genome(30_000, seed=48)
    # read = [0:4000] + [20000:24000] glued (simulates a chimera / SV)
    read = g[:4000] + g[20_000:24_000]
    idx = mapping.build_index([g], ["c"], k=24, w=64)
    (q_pos, q_hash), = mapping._seq_minimizers([read], 24, 64)
    hits = mapping.map_sequence(idx, q_pos, q_hash, min_anchors=4,
                                diag_bin=500, keep_anchors=True)
    mols = tigmint.molecule_intervals(hits, dist=500, k=24)
    assert len(mols) >= 2, mols
    spans = sorted((s, e) for _, s, e in mols)
    # first molecule confined to [0, ~4000], second to [~20000, 24000]
    assert spans[0][1] <= 4_500
    assert spans[-1][0] >= 19_500
    # and no molecule spans the gap
    assert all(not (s < 5_000 and e > 19_000) for s, e in spans)


def test_racon_polisher_fixes_substitutions():
    from goldrush_jax.stages.racon import polish_with_racon
    g = synth.random_genome(20_000, seed=49)
    reads = [s for _, s, _ in synth.simulate_reads(g, 50, 5000, seed=50,
                                                   err_rate=0.03)]
    draft = bytearray(g)
    pos = RNG.integers(500, len(g) - 500, 30)
    for b in pos:
        draft[b] = ord("A") if draft[b] != ord("A") else ord("C")
    before = sum(1 for x, y in zip(bytes(draft), g) if x != y)
    out, corrected = polish_with_racon([("c", bytes(draft))], reads)
    after = sum(1 for x, y in zip(out[0][1], g) if x != y)
    assert after < before * 0.4, (before, after)
    assert corrected > 0


def test_polish_targeted_assignment():
    # two contigs from different sources; with mapper-based assignment each
    # contig is polished only against its own reads (goldpolish's targeted
    # architecture)
    a = synth.random_genome(8_000, seed=51)
    b = synth.random_genome(8_000, seed=52)
    reads = [a[i:i + 3000] for i in range(0, 5001, 250)]
    reads += [b[i:i + 3000] for i in range(0, 5001, 250)]
    arr = bytearray(a)
    arr[1500] = ord("G") if arr[1500] != ord("G") else ord("T")
    pp = polish.PolishParams(k=24, solid_min=2, rounds=3)
    out, edits = polish.run_polish([("a", bytes(arr)), ("b", b)], reads, pp,
                                   mapper_k=15, mapper_w=10)
    assert out[0][1][:7900] == a[:7900]
    assert out[1][1] == b
    assert edits >= 1
