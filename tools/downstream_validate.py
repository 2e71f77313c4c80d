"""Downstream-stage validation on a 1 Mbp simulated dataset with injected
defects, measuring each stage against ground truth:

  * polish  (GoldPolish equivalent): k-mer identity of error-injected draft
    contigs before/after polishing,
  * tigmint (tigmint-long equivalent): chimeric junctions cut within +-2kb
    (sensitivity) and clean contigs left uncut (precision),
  * ntLink  (scaffolder equivalent): adjacent-contig joins recovered, N50
    growth, gap-fill k-mer identity,
  * targeted polish: identity of gap-filled regions after polishing.

Usage: python tools/downstream_validate.py [--small]
Prints a markdown table; results recorded in ARCHITECTURE.md.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from goldrush_jax.stages import ntlink, polish, targeted, tigmint  # noqa: E402
from goldrush_jax.utils import synth  # noqa: E402
from goldrush_jax.utils.stats import assembly_stats  # noqa: E402

K_ID = 21


def kmer_set(seq: bytes, k: int = K_ID) -> set:
    return {seq[i:i + k] for i in range(0, len(seq) - k + 1)}


def identity(seq: bytes, truth_kmers: set, k: int = K_ID) -> float:
    seq = seq.upper()          # gap fills are soft-masked lowercase
    n = max(len(seq) - k + 1, 1)
    hits = sum(seq[i:i + k] in truth_kmers for i in range(n))
    return hits / n


def inject_errors(seq: bytes, rate: float, seed: int) -> bytes:
    r = synth.simulate_reads(seq, 1, len(seq), seed=seed, err_rate=rate,
                             indel_frac=0.3, both_strands=False)
    return r[0][1]


def main():
    small = "--small" in sys.argv
    G = 300_000 if small else 1_000_000
    genome = synth.random_genome(G, seed=71)
    truth = kmer_set(genome)
    n_contig = 4 if small else 8
    clen = G // n_contig
    gap = 1_500
    t0 = time.time()

    # ---- draft: true slices with 1% errors, small inter-contig gaps ------
    contigs = []
    for i in range(n_contig):
        s, e = i * clen, min((i + 1) * clen - gap, G)
        contigs.append((f"ctg{i}", inject_errors(genome[s:e], 0.01,
                                                 seed=100 + i)))
    # ---- two chimeras: distant regions glued -----------------------------
    j1, j2 = clen // 2, G - clen // 2
    chim1 = genome[j1:j1 + 30_000] + genome[j2:j2 + 30_000]
    chim_junction = 30_000
    contigs_chim = contigs + [("chimera1", inject_errors(chim1, 0.01,
                                                         seed=200))]

    # ---- reads ------------------------------------------------------------
    cov, rlen = (15, 12_000) if small else (20, 15_000)
    reads = synth.simulate_reads(genome, G * cov // rlen, rlen, seed=72,
                                 err_rate=0.05, indel_frac=0.4)
    read_seqs = [r[1] for r in reads]
    read_tuples = [(r[0], r[1], r[2]) for r in reads]

    print(f"# Downstream validation (G={G}, {n_contig} contigs + 1 chimera, "
          f"{len(reads)} reads x {rlen} @5% err)\n")
    print("| stage | metric | value |")
    print("|-------|--------|-------|")

    # ---- polish ------------------------------------------------------------
    id_before = np.mean([identity(c, truth) for _, c in contigs])
    pp = polish.PolishParams(k=32)
    polished, edits = polish.run_polish(contigs, read_seqs, pp,
                                        mapper_k=15, mapper_w=10)
    id_after = np.mean([identity(c, truth) for _, c in polished])
    print(f"| polish | kmer identity before | {id_before:.4f} |")
    print(f"| polish | kmer identity after | {id_after:.4f} |")
    print(f"| polish | edits | {edits} |", flush=True)

    # ---- tigmint ------------------------------------------------------------
    tp = tigmint.TigmintParams(span=2, dist=500, cut=250)
    cut_out = tigmint.run_tigmint(contigs_chim, read_tuples, tp)
    # sensitivity: chimera split near the junction?
    chim_pieces = [s for n, s in cut_out if n.startswith("chimera1")]
    split_ok = (len(chim_pieces) >= 2 and
                any(abs(len(p) - chim_junction) < 2_000
                    for p in chim_pieces))
    # precision: clean contigs uncut (allow end trims)
    overcuts = sum(
        1 for i in range(n_contig)
        if len([s for n, s in cut_out if n.startswith(f"ctg{i}")]) > 1)
    print(f"| tigmint | chimera cut at junction | {split_ok} |")
    print(f"| tigmint | clean contigs overcut | {overcuts}/{n_contig} |",
          flush=True)

    # ---- ntlink -------------------------------------------------------------
    np_ = ntlink.NtLinkParams(k=40, w=250, z=1000, a=1, rounds=5,
                              soft_mask=True)
    scaffolds = ntlink.run_ntlink(polished, read_seqs, np_)
    lens_in = [len(c) for _, c in polished]
    lens_out = [len(s.seq) for s in scaffolds]
    st_in, st_out = assembly_stats(lens_in), assembly_stats(lens_out)
    joins = len(polished) - len(scaffolds)
    fill_id = []
    for s in scaffolds:
        for (a, b) in s.filled:
            if b - a >= K_ID:
                fill_id.append(identity(s.seq[a:b], truth))
    print(f"| ntlink | joins recovered | {joins}/{n_contig - 1} |")
    print(f"| ntlink | N50 before -> after | {st_in['N50']} -> "
          f"{st_out['N50']} |")
    print(f"| ntlink | gap-fill identity | "
          f"{np.mean(fill_id) if fill_id else float('nan'):.4f} "
          f"({len(fill_id)} gaps) |", flush=True)

    # ---- targeted polish ----------------------------------------------------
    tpp = targeted.TargetParams(flank=64)
    final, tedits = targeted.polish_targets(scaffolds, read_seqs, tpp)
    fill_id2 = []
    for (name, seq), s in zip(final, scaffolds):
        for (a, b) in s.filled:
            if b - a >= K_ID and b <= len(seq):
                fill_id2.append(identity(seq[a:b], truth))
    print(f"| targeted | gap identity after | "
          f"{np.mean(fill_id2) if fill_id2 else float('nan'):.4f} |")
    print(f"| targeted | edits | {tedits} |")
    print(f"\ntotal {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
