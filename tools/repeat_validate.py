"""Repeat-aware + ONT-error-profile validation of the FULL pipeline.

Builds a repeat-structured genome (tandem arrays + dispersed families,
utils/synth.repeat_genome) with homopolymer-biased indel reads, runs the
complete 6-stage pipeline in exact AND throughput modes, and reports:

  * assembly contiguity (contigs, total bp, NG50 vs the truth G),
  * k-mer identity vs the truth genome,
  * misjoin count: contig anchor walks that jump > 20 kb (or switch
    orientation) in truth coordinates,
  * the silver/golden path stage of the COMPILED REFERENCE binary on the
    same reads (tests/ref_harness) for a path-stage comparison — the
    downstream external tools cannot run here, the path stage can.

Usage: python tools/repeat_validate.py [--fast] [--skip-ref]
Writes a markdown table to stdout; paste into ARCHITECTURE.md (VERDICT r3
item 5).
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from goldrush_jax.config import PipelineConfig, stage_filenames  # noqa: E402
from goldrush_jax.io import fastq  # noqa: E402
from goldrush_jax.pipeline import run_pipeline  # noqa: E402
from goldrush_jax.utils import synth  # noqa: E402
from goldrush_jax.utils.stats import assembly_stats  # noqa: E402

K = 64


def anchor_index(truth: bytes):
    """Positions of UNIQUE truth 64-mers (repeat copies drop out, so anchors
    are reliable positional evidence)."""
    idx = {}
    dup = set()
    step = 16
    for p in range(0, len(truth) - K + 1, step):
        km = truth[p: p + K]
        if km in dup:
            continue
        if km in idx:
            del idx[km]
            dup.add(km)
        else:
            idx[km] = p
    rc = {}
    for km, p in idx.items():
        rc[synth.revcomp(km)] = p
    return idx, rc, dup


def misjoins(contigs, truth: bytes) -> tuple[int, int]:
    """(misjoin count, anchored contigs): walk each contig's unique-anchor
    hits in order; a break = consecutive anchors whose truth distance
    disagrees with their contig distance by > 20 kb or whose orientation
    flips."""
    fwd, rev, _ = anchor_index(truth)
    total_breaks = 0
    anchored = 0
    for _, seq in contigs:
        hits = []
        for cp in range(0, len(seq) - K + 1, 200):
            km = seq[cp: cp + K]
            if km in fwd:
                hits.append((cp, fwd[km], +1))
            elif km in rev:
                hits.append((cp, rev[km], -1))
        if len(hits) < 2:
            continue
        anchored += 1
        for (c0, t0, s0), (c1, t1, s1) in zip(hits, hits[1:]):
            dc = c1 - c0
            dt = (t1 - t0) * s0
            if s0 != s1 or abs(dt - dc) > 20_000:
                total_breaks += 1
    return total_breaks, anchored


def identity(contigs, truth: bytes, k: int = 32) -> float:
    """Fraction of sampled contig k-mers present in the truth genome
    (either strand) — truth is indexed at EVERY position so contig
    sampling offsets cannot alias."""
    tk = {truth[p: p + k] for p in range(0, len(truth) - k + 1)}
    hit = tot = 0
    for _, seq in contigs:
        for p in range(0, len(seq) - k + 1, 97):
            tot += 1
            km = seq[p: p + k]
            hit += km in tk or synth.revcomp(km) in tk
    return hit / max(tot, 1)


def run_mode(workdir, tag, fast_mode: bool, G: int):
    d = os.path.join(workdir, tag)
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(workdir, "reads.fq"), os.path.join(d, "reads.fq"))
    cfg = PipelineConfig(reads="reads", G=G, t=2, m=15_000, M=3, r=0.75,
                        p=f"asm_{tag}", dev=True)
    t0 = time.time()
    out = run_pipeline(cfg, workdir=d, until="final",
                       frame_stride=8 if fast_mode else 1,
                       probe_seeds=1 if fast_mode else 0,
                       engine_extra={"recheck": "optimistic",
                                     "batch_reads": 64} if fast_mode else {})
    wall = time.time() - t0
    final = os.path.join(d, out["final"])
    contigs = [(r.id, r.seq) for r in fastq.read_records(final)]
    return contigs, wall, d, cfg


def ref_path_stage(workdir, G):
    """Compiled reference goldrush-path silver stage on the same reads
    (tests/ref_harness shim build; invocation mirrors test_ref_parity)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    binpath = "/tmp/goldref/goldrush-path-ref"
    if not os.path.exists(binpath):
        r = subprocess.run(
            ["sh", os.path.join(repo, "tests/ref_harness/build.sh"),
             "/tmp/goldref"], capture_output=True, text=True)
        if r.returncode or not os.path.exists(binpath):
            return None
    d = os.path.join(workdir, "refbin")
    os.makedirs(d, exist_ok=True)
    cmd = [binpath, "-i", os.path.join(workdir, "reads.fq"), "-g", str(G),
           "-k", "22", "-w", "16", "-h", "3",
           "-s", "1011011110110111101101", "-j", "2", "-p", "ref_silver",
           "-m", "15000", "-M", "3", "-r", "0.75", "--silver_path"]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=d, capture_output=True, text=True,
                       env=dict(os.environ, OMP_NUM_THREADS="2"),
                       timeout=3600)
    wall = time.time() - t0
    if r.returncode:
        return None
    recs = []
    for i in (1, 2, 3):
        p = os.path.join(d, f"ref_silver_{i}.fq")
        if os.path.exists(p):
            recs += [(rec.id, rec.seq) for rec in fastq.read_records(p)]
    return recs, wall


def main():
    fast = "--fast" in sys.argv
    G = 400_000 if fast else 1_200_000
    n_reads = int(G * 12 / 20_000)
    workdir = tempfile.mkdtemp(prefix="repeatval_")
    truth = synth.repeat_genome(G, seed=91)
    reads = synth.simulate_reads(truth, n_reads, 20_000, seed=92,
                                 err_rate=0.05, indel_frac=0.4,
                                 homopolymer_bias=0.6)
    synth.write_fastq(os.path.join(workdir, "reads.fq"), reads)
    print(f"# Repeat-genome pipeline validation (G={G}, {n_reads} x 20 kb, "
          f"5% err, 40% indel, 60% homopolymer-biased)\n")
    print("| mode | contigs | total | NG50 | identity | misjoins | "
          "anchored | wall s |")
    print("|------|---------|-------|------|----------|----------|"
          "----------|--------|")
    results = {}
    for tag, fast_mode in (("exact", False), ("throughput", True)):
        contigs, wall, d, cfg = run_mode(workdir, tag, fast_mode, G)
        st = assembly_stats([len(s) for _, s in contigs])
        mj, anch = misjoins(contigs, truth)
        ident = identity(contigs, truth)
        print(f"| {tag} | {st['n']} | {st['total']} | {st.get('N50', 0)} | "
              f"{ident:.4f} | {mj} | {anch} | {wall:.0f} |", flush=True)
        results[tag] = dict(contigs=st["n"], total=st["total"],
                            identity=round(ident, 4), misjoins=mj)
    if "--skip-ref" not in sys.argv:
        ref = ref_path_stage(workdir, G)
        if ref:
            recs, wall = ref
            tot = sum(len(s) for _, s in recs)
            mj, anch = misjoins([(i, s) for i, s in recs], truth)
            print(f"| ref-binary silver stage | {len(recs)} reads | {tot} | "
                  f"- | - | {mj} | {anch} | {wall:.0f} |")
            results["ref_silver"] = dict(reads=len(recs), total=tot,
                                         misjoins=mj)
    print()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
