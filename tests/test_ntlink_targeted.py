"""ntLink-equivalent scaffolding + targeted polishing tests with known
ground truth."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.utils import synth
from goldrush_jax.stages import ntlink, targeted


def make_fragmented_assembly(genome, breaks, gap=200):
    """Contigs = genome pieces with `gap` bases missing at each break."""
    contigs = []
    prev = 0
    for i, b in enumerate(breaks + [len(genome)]):
        piece = genome[prev + (gap if prev else 0): b]
        contigs.append((f"c{i}", piece))
        prev = b
    return contigs


def test_scaffold_and_gapfill():
    genome = synth.random_genome(36_000, seed=51)
    contigs = make_fragmented_assembly(genome, [12_000, 24_000], gap=300)
    # reverse one contig to exercise orientation
    contigs[1] = (contigs[1][0], ntlink.revcomp(contigs[1][1]))
    reads = [s for _, s, _ in
             synth.simulate_reads(genome, 80, 5000, seed=52, err_rate=0.0)]
    p = ntlink.NtLinkParams(k=24, w=100, z=1000, a=1, rounds=3,
                            end_margin=3000, min_anchors=3)
    out = ntlink.run_ntlink(contigs, reads, p)
    assert len(out) == 1, [s.name for s in out]
    sc = out[0]
    # joined length ~ genome length
    assert abs(len(sc.seq) - 36_000) < 600, len(sc.seq)
    assert len(sc.filled) == 2
    # error-free reads -> fills should reconstruct the genome exactly up to
    # orientation; compare case-insensitively (fills are soft-masked)
    assembled = sc.seq.upper()
    target = genome if assembled[:2000] == genome[:2000] else \
        ntlink.revcomp(genome)
    # allow small boundary slop at the two junctions
    matches = sum(1 for a, b in zip(assembled, target) if a == b)
    assert matches / max(len(target), len(assembled)) > 0.97, matches


def test_no_spurious_joins():
    a = synth.random_genome(15_000, seed=53)
    b = synth.random_genome(15_000, seed=54)
    reads = [s for _, s, _ in synth.simulate_reads(a, 30, 4000, seed=55)]
    reads += [s for _, s, _ in synth.simulate_reads(b, 30, 4000, seed=56)]
    p = ntlink.NtLinkParams(k=24, w=100, z=1000, a=1, rounds=2,
                            end_margin=2000, min_anchors=3)
    out = ntlink.run_ntlink([("a", a), ("b", b)], reads, p)
    assert len(out) == 2
    assert {s.seq for s in out} == {a, b}


def test_targeted_polish_cleans_fill():
    genome = synth.random_genome(20_000, seed=57)
    contigs = make_fragmented_assembly(genome, [10_000], gap=250)
    # noisy reads: the gap fill inherits read errors which targeted polish
    # must clean using k-mer consensus
    noisy = [s for _, s, _ in
             synth.simulate_reads(genome, 120, 4000, seed=58, err_rate=0.02)]
    p = ntlink.NtLinkParams(k=24, w=100, z=1000, a=1, rounds=2,
                            end_margin=3000, min_anchors=3)
    out = ntlink.run_ntlink(contigs, noisy, p)
    assert len(out) == 1 and out[0].filled
    before = out[0].seq.upper()
    polished, edits = targeted.polish_targets(
        out, noisy, targeted.TargetParams(flank=64, k=24, solid_min=3))
    after = polished[0][1]
    # identity vs genome must not decrease; typically improves
    def ident(s):
        tgt = genome if s[:2000] == genome[:2000] else ntlink.revcomp(genome)
        return sum(1 for a, b in zip(s, tgt)) and \
            sum(1 for a, b in zip(s, tgt) if a == b) / max(len(s), len(tgt))
    assert ident(after) >= ident(before) - 1e-9


def test_gap_consensus_rejects_outlier_evidence():
    """Multi-read gap consensus (VERDICT r3 item 6): the junction gap is
    the MEDIAN over supporting reads and evidence deviating > gap_tol is
    discarded — one repeat-confused read can neither set the distance nor
    carry a join on its own at a >= 2."""
    h1 = ntlink.mapping.Hit(tid=0, strand=1, q_start=0, q_end=4000,
                            t_start=8000, t_end=12000, n_anchors=10, offset=0)
    h2 = ntlink.mapping.Hit(tid=1, strand=1, q_start=4300, q_end=8000,
                            t_start=0, t_end=3700, n_anchors=10, offset=0)
    good = [(r, h1, h2, 300, False) for r in range(3)]
    outlier = [(9, h1, h2, 9000, False)]
    key = ((0, "tail"), (1, "head"))
    p = ntlink.NtLinkParams(a=2, gap_tol=500)
    cons = ntlink._consensus({key: good + outlier}, p)
    gap, ev = cons[key]
    assert gap == 300
    assert len(ev) == 3 and all(e[3] == 300 for e in ev)
    # a junction supported ONLY by mutually-inconsistent evidence keeps its
    # largest consistent cluster (here: a single read) and then fails a>=2
    lone = {key: [(0, h1, h2, 300, False), (1, h1, h2, 9000, False)]}
    cons2 = ntlink._consensus(lone, p)
    _, ev2 = cons2[key]
    assert len(ev2) == 1
    assert not ntlink._mutual_best({k: e for k, (_, e) in cons2.items()}, p)
