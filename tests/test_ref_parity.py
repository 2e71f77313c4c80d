"""Bit-parity against the COMPILED reference goldrush-path.

tests/ref_harness/build.sh compiles the actual reference sources from
/root/reference (goldrush_path.cpp + read_hashing.cpp + opt.cpp +
spaced_seeds.cpp + calc_phred_average.cpp) against shim btllib/sdsl/
sparsehash headers, producing a deterministic single-threaded oracle binary.
These tests run it and the JAX engine on the same synthetic ONT-like dataset
and require IDENTICAL output path files — the BASELINE.md north star
("bit-identical goldtig set on demo reads").

Parity mode: slot_map="mod" (the reference's hash % size map,
MIBloomFilter.hpp:203/340/451) + mibf_mode="compressed" (reservoir accept
keyed on the rank like MIBFConstructSupport.hpp:274-282).  The default
fastrange/direct mode differs only in the slot permutation / reservoir
tie-break key; equivalence of assembly quality between the modes is covered
by the existing engine tests.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import pytest

from goldrush_jax.utils import synth as us

HERE = os.path.dirname(__file__)
HARNESS = os.path.join(HERE, "ref_harness")
OUT = "/tmp/goldref"
REF = os.environ.get("GOLDRUSH_REF", "/root/reference/goldrush_path")
PRESET = "1011011110110111101101"


def _build() -> bool:
    if not (os.path.isdir(REF) and shutil.which("g++")):
        return False
    binary = os.path.join(OUT, "goldrush-path-ref")
    dump = os.path.join(OUT, "hash_dump")
    if os.path.exists(binary) and os.path.exists(dump):
        return True
    r = subprocess.run(["sh", os.path.join(HARNESS, "build.sh"), OUT],
                       capture_output=True, text=True)
    return r.returncode == 0


pytestmark = pytest.mark.skipif(
    not _build(), reason="reference sources or g++ unavailable")


def test_hash_parity_vs_reference_iterator():
    """JAX/NumPy canonical hashes == the compiled reference
    multiLensfrHashIterator (lockstep + stale tails) on random sequences."""
    from goldrush_jax.ops import nthash_np as nth
    from goldrush_jax.ops.seeds import make_seed_pattern

    rng = np.random.default_rng(3)
    seeds = make_seed_pattern(PRESET, 22, 16, 3)
    for L in (24, 25, 40, 1021, 1500):
        seq = bytes(us.BASES[rng.integers(0, 4, L)])
        r = subprocess.run([os.path.join(OUT, "hash_dump"), seq.decode()]
                           + seeds, capture_output=True, text=True)
        assert r.returncode == 0
        got = np.array([[int(x) for x in line.split()]
                        for line in r.stdout.splitlines()], dtype=np.uint64)
        want = nth.multi_seed_canonical(nth.encode_seq(seq), seeds).T
        assert got.shape == want.shape
        assert (got == want).all()


def _dataset(tmpdir: str) -> tuple[str, int]:
    """~1 Mbp genome, ~11x ONT-like 5%-error reads (>= the demo scale the
    reference's own test uses, tests/goldrush_test_demo.sh:10)."""
    G = 1_000_000
    genome = us.random_genome(G, seed=21)
    reads = us.simulate_reads(genome, 500, 22_000, seed=22, err_rate=0.05)
    path = os.path.join(tmpdir, "reads.fq")
    us.write_fastq(path, reads)
    return path, G


def _run_ref(reads: str, G: int, prefix: str, silver: bool, workdir: str,
             M: int = 3, m: int = 20_000) -> None:
    cmd = [os.path.join(OUT, "goldrush-path-ref"),
           "-i", reads, "-g", str(G), "-k", "22", "-w", "16", "-h", "3",
           "-s", PRESET, "-j", "1", "-p", prefix]
    if silver:
        cmd += ["-m", str(m), "-M", str(M), "-r", "0.9", "--silver_path"]
    else:
        cmd += ["-m", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True,
                       text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-2000:]


def _run_engine(reads: str, G: int, prefix: str, silver: bool, workdir: str,
             M: int = 3, m: int = 20_000):
    from goldrush_jax.config import PathConfig
    from goldrush_jax.path.engine import GoldenPathEngine
    cfg = PathConfig(
        input=reads, genome_size=G, kmer_size=22, weight=16, hash_num=3,
        seed_preset=PRESET, prefix_file=os.path.join(workdir, prefix),
        silver_path=silver, max_paths=M if silver else 1,
        min_length=m if silver else 0,
        slot_map="mod", mibf_mode="compressed",
        # parity requires the untruncated candidate list (the reference keeps
        # every id with count>2, goldrush_path.cpp:616-619); K=160 is checked
        # sufficient by the vote_overflow==0 assert below
        vote_topk=160)
    eng = GoldenPathEngine(cfg)
    eng.run()
    return eng.stats


def _files_equal(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_goldtig_parity_full_pipeline(tmp_path):
    """Silver paths AND golden path bit-identical to the compiled
    reference on a 1 Mbp dataset at reference defaults."""
    wd = str(tmp_path)
    reads, G = _dataset(wd)
    M = 3

    _run_ref(reads, G, "ref_silver", True, wd, M=M)
    stats = _run_engine(reads, G, "eng_silver", True, wd, M=M)
    assert stats.vote_overflow == 0   # vote_topk truncation never engaged

    ref_silvers = sorted(f for f in os.listdir(wd)
                         if f.startswith("ref_silver_") and f.endswith(".fq"))
    assert ref_silvers, "reference produced no silver paths"
    for f in ref_silvers:
        eng = os.path.join(wd, f.replace("ref_", "eng_"))
        assert os.path.exists(eng), f"missing {eng}"
        assert _files_equal(os.path.join(wd, f), eng), f"silver diff: {f}"
    eng_extra = [f for f in os.listdir(wd)
                 if f.startswith("eng_silver_") and f.endswith(".fq")
                 and f.replace("eng_", "ref_") not in ref_silvers]
    assert not [f for f in eng_extra
                if os.path.getsize(os.path.join(wd, f))], \
        f"extra non-empty engine silver paths: {eng_extra}"

    # golden pass over the concatenated silver paths (bin/goldrush:250-251)
    all_fq = os.path.join(wd, "silver_all.fq")
    with open(all_fq, "wb") as out:
        for f in ref_silvers:
            out.write(open(os.path.join(wd, f), "rb").read())
    _run_ref(all_fq, G, "ref_golden", False, wd)
    _run_engine(all_fq, G, "eng_golden", False, wd)
    assert _files_equal(os.path.join(wd, "ref_golden.fa"),
                        os.path.join(wd, "eng_golden.fa")), "goldtig diff"
