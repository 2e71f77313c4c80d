"""Throughput-mode operating curve: quality vs (frame_stride, probe_seeds).

Runs the silver-path engine at exact-parity settings and at sampled-query
settings over ONT-like synthetic datasets (1 Mbp genome, ~12x 20 kb reads,
error rates 2/5/10% with 40% indels), and reports per configuration:

  * recruit-set Jaccard vs the exact-parity run,
  * genome coverage of the recruited reads (positional truth from read ids),
  * recruited bases / (r * G * M) — the silver paths' fill factor,
  * wall time of pass 2.

Usage: python tools/quality_sweep.py [--fast]  (fast: 300 kb, 2 configs)
Writes a markdown table to stdout; paste into ARCHITECTURE.md.
"""

import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from goldrush_jax.config import PathConfig  # noqa: E402
from goldrush_jax.io import fastq  # noqa: E402
from goldrush_jax.path.engine import GoldenPathEngine  # noqa: E402
from goldrush_jax.utils import synth  # noqa: E402

PRESET = "1011011110110111101101"


def coverage_frac(recruits, G):
    """Fraction of the genome covered by recruited reads (positional ids)."""
    iv = []
    for rid, length in recruits:
        m = re.search(r"_p(\d+)", rid)
        if m:
            s = int(m.group(1))
            iv.append((s, min(s + length, G)))
    iv.sort()
    covered, end = 0, 0
    for s, e in iv:
        s = max(s, end)
        if e > s:
            covered += e - s
            end = e
    return covered / G


def run_engine(reads_fq, G, workdir, tag, stride, probe_seeds, M=3, r=0.75,
               insert_stride=1):
    cfg = PathConfig(
        input=reads_fq, genome_size=G, kmer_size=22, weight=16, hash_num=3,
        seed_preset=PRESET, silver_path=True, max_paths=M, ratio=r,
        min_length=15_000, prefix_file=os.path.join(workdir, tag),
        frame_stride=stride, probe_seeds=probe_seeds,
        insert_stride=insert_stride,
        recheck="exact" if stride == 1 and insert_stride == 1
        else "optimistic", batch_reads=64)
    eng = GoldenPathEngine(cfg)
    t0 = time.time()
    stats = eng.run()
    wall = time.time() - t0
    recs = []
    for i in range(1, M + 1):
        p = os.path.join(workdir, f"{tag}_{i}.fq")
        if os.path.exists(p):
            recs += [(rec.id.rsplit("_", 1)[0], len(rec.seq))
                     for rec in fastq.read_records(p)]
    return recs, stats, wall


def main():
    fast = "--fast" in sys.argv
    G = 300_000 if fast else 1_000_000
    n_reads = int(G * 12 / 20_000)
    # (frame_stride, probe_seeds, insert_stride); (1, 0, 1) = exact anchor
    configs = ([(1, 0, 1), (8, 1, 1), (8, 1, 4)] if fast else
               [(1, 0, 1), (4, 0, 1), (8, 0, 1), (8, 1, 1),
                (8, 1, 2), (8, 1, 4), (8, 1, 8)])
    print(f"# Throughput-mode operating curve (G={G}, {n_reads} reads x "
          f"20 kb, 40% indel errors)\n")
    print("| err | stride | probe_seeds | ins_stride | jaccard | coverage "
          "| fill | pass2 s |")
    print("|-----|--------|-------------|------------|---------|----------"
          "|------|---------|")
    for err in ([0.05] if fast else [0.02, 0.05, 0.10]):
        workdir = tempfile.mkdtemp(prefix=f"sweep_{int(err*100)}_")
        genome = synth.random_genome(G, seed=51)
        reads = synth.simulate_reads(genome, n_reads, 20_000, seed=52,
                                     err_rate=err, indel_frac=0.4)
        fq = os.path.join(workdir, "reads.fq")
        synth.write_fastq(fq, reads)
        base = None
        for stride, ps, ins in configs:
            tag = f"e{int(err*100)}_s{stride}p{ps}i{ins}"
            recs, stats, wall = run_engine(fq, G, workdir, tag, stride, ps,
                                           insert_stride=ins)
            ids = {rid for rid, _ in recs}
            if stride == 1 and ins == 1:
                base = ids
            jac = (len(ids & base) / max(len(ids | base), 1)) if base else 1.0
            cov = coverage_frac(recs, G)
            fill = sum(ln for _, ln in recs) / (0.75 * G * 3)
            print(f"| {err:.0%} | {stride} | {ps} | {ins} | {jac:.3f} | "
                  f"{cov:.3f} | {fill:.2f} | {stats.wall_assign_s:.1f} |",
                  flush=True)


if __name__ == "__main__":
    main()
