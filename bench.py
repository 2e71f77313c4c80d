"""Single-chip benchmark of the golden-path ENGINE (end-to-end pass 2) plus
the classify-kernel microbenchmark.

Primary metric: `GoldenPathEngine.assign` reads/s — the full product path
(host IO + encode + batching + hash -> probe -> vote -> smoothing ->
sequential recruit scan -> path-file writes) on a synthetic ONT-like dataset
(5 Mbp genome, ~12x 20 kb reads, 5% error) in silver-path mode, i.e. the
same work `goldrush-path --silver_path` does (goldrush_path.cpp:1096-1275).
Reported for the SHIPPED production throughput settings — rank-compressed
filter, frame_stride 8, 1 probed seed, all-seed scatter-max insert,
full-resolution trim recheck, optimistic recheck — with the direct-filter
variant and the exact-parity settings (stride 1, all seeds, exact
recheck — bit-identical to the reference binary per
tests/test_ref_parity.py) alongside.

Timing: the first engine run warms the persistent XLA cache; the reported
run is a fresh engine (steady-state compile-free device path, honest host
overheads included).  Prints ONE JSON line.

Baseline (MEASURED, round 3): the reference binary itself
(tests/ref_harness/build.sh compiles /root/reference goldrush-path) run on
THIS EXACT dataset (3,000 x 20 kb reads, 5 Mbp genome, 5% error,
--silver_path -M 5 -r 0.9), host: 2 vCPUs:

    OMP_NUM_THREADS=1: wall 101.9 s (fill 21.7 s, assign ~80.2 s)
                       -> 37.4 reads/s over the assign pass
    OMP_NUM_THREADS=2: wall 126.0 s -- SLOWER than 1 thread (the per-tile
                       OpenMP loop's overhead exceeds its win at 20 tiles)

vs_baseline divides by an IDEALIZED 48-thread linear extrapolation of the
1-thread measurement, 37.4 * 48 = 1,795 reads/s -- deliberately generous
to the reference: its measured 2-thread scaling here is NEGATIVE, and its
published full-pipeline numbers (~6.7M reads x 2 passes in ~1/3 of 16.6 h
at 48 threads, README.md:117-121) imply only ~670 reads/s.
"""

import dataclasses
import json
import math
import os
import tempfile
import time

import numpy as np

import goldrush_jax  # noqa: F401  (enables x64 + compile cache)
import jax
import jax.numpy as jnp

from goldrush_jax.config import PathConfig
from goldrush_jax.mibf import mibf as dm
from goldrush_jax.ops.nthash import build_seed_family
from goldrush_jax.ops.seeds import make_seed_pattern
from goldrush_jax.parallel.mesh import classify_step
from goldrush_jax.path.engine import GoldenPathEngine
from goldrush_jax.utils import device, synth

# measured: 37.4 reads/s at 1 thread on the exact bench dataset (see
# module docstring) x 48 idealized-linear threads
BASELINE_READS_PER_S_1T = 37.4
BASELINE_READS_PER_S = BASELINE_READS_PER_S_1T * 48
PRESET = "1011011110110111101101"

GENOME = 5_000_000
READ_LEN = 20_000
N_READS = 3_000          # ~12x coverage
STRIDE = 8               # production frame stride
PROBE_SEEDS = 1          # production probe-seed count


def make_dataset(workdir: str) -> str:
    path = os.path.join(workdir, "bench_reads.fq")
    genome = synth.random_genome(GENOME, seed=11)
    reads = synth.simulate_reads(genome, N_READS, READ_LEN, seed=12,
                                 err_rate=0.05)
    synth.write_fastq(path, reads)
    return path


def engine_cfg(reads: str, workdir: str, tag: str, **kw) -> PathConfig:
    return PathConfig(
        input=reads, genome_size=GENOME, kmer_size=22, weight=16, hash_num=3,
        seed_preset=PRESET, silver_path=True, max_paths=5, min_length=20_000,
        prefix_file=os.path.join(workdir, f"bench_{tag}"), **kw)


def run_engine(cfg: PathConfig) -> dict:
    eng = GoldenPathEngine(cfg)
    stats = eng.run()
    return {
        "fill_s": round(stats.wall_fill_s, 3),
        "assign_s": round(stats.wall_assign_s, 3),
        "submit_s": round(stats.wall_submit_s, 3),
        "submit_first_s": round(stats.wall_submit_first_s, 3),
        "replay_s": round(stats.wall_replay_s, 3),
        "reads": stats.num_reads,
        "recruits": stats.recruits,
        "reads_per_s": round(stats.num_reads / max(stats.wall_assign_s, 1e-9),
                             2),
    }


def measure_engine(reads: str, workdir: str, tag: str, **kw) -> dict:
    run_engine(engine_cfg(reads, workdir, tag + "_warm", **kw))  # XLA cache
    return run_engine(engine_cfg(reads, workdir, tag, **kw))


def classify_microbench() -> dict:
    """Steady-state classify-kernel throughput (30 kb reads, 50 Mbp-genome
    filter): the device-side ceiling, without host loop/IO/recruit scan."""
    seeds = make_seed_pattern(PRESET, 22, 16, 3)
    fam = build_seed_family(seeds)
    universe = int(min(4 ** 16, 2 * 50_000_000) * 0.5 * 3)
    size = int(-universe / math.log(0.9))
    size += 64 - size % 64
    key = jax.random.PRNGKey(0)
    chunk = 1 << 27
    parts = []
    for lo in range(0, size + 1, chunk):
        n = min(chunk, size + 1 - lo)
        key, k1, k2 = jax.random.split(key, 3)
        r = jax.random.randint(k1, (n,), 0, 1 << 30, dtype=jnp.uint32)
        ids = jax.random.randint(k2, (n,), 1, 200_000, dtype=jnp.uint32)
        present = r < jnp.uint32(int(0.1 * (1 << 30)))
        with_id = r < jnp.uint32(int(0.05 * (1 << 30)))
        w = jnp.where(present, dm.PRESENT_BIT, 0).astype(jnp.uint32)
        parts.append(jnp.where(with_id, w | ids, w))
    words = jnp.concatenate(parts)
    BATCH, TILES, RL = 64, 30, 30_000
    rng = np.random.default_rng(1)
    codes = jnp.asarray(rng.integers(0, 4, (BATCH, RL + 1024)).astype(np.uint8))
    lengths = jnp.full(BATCH, RL, dtype=jnp.int32)
    params = dm.MibfParams(
        size=size, h=3, k=22, spans=(22, 23, 24), tile_length=1000,
        threshold=max(1, 10 // STRIDE), block_size=10, vote_topk=32,
        frame_stride=STRIDE, vote_min=max(1, 2 // STRIDE),
        probe_seeds=PROBE_SEEDS)

    def step(words, c, lengths, acc):
        res, _, votes = classify_step(
            words, c, lengths, fam, params, TILES,
            threshold=params.threshold, unassigned_min=5, assigned_max=1)
        return acc + res.decision.astype(jnp.int32).sum() \
            + res.num_assigned.sum() + votes.queries.sum().astype(jnp.int32)

    jstep = jax.jit(step)
    int(jstep(words, codes, lengths, jnp.int32(0)))      # warm-up
    best = float("inf")
    for _ in range(3):
        acc = jnp.int32(0)
        t0 = time.time()
        for _ in range(16):
            acc = jstep(words, codes, lengths, acc)
        int(acc)                 # host fetch closes the timed window
        best = min(best, (time.time() - t0) / 16)
    rps = BATCH / best
    return {
        "classify_reads_per_s": round(rps, 2),
        "queries_per_s": round(rps * TILES * ((1000 - 21) // STRIDE)),
    }


def main():
    device.require_gpu()
    workdir = tempfile.mkdtemp(prefix="goldrush_bench_")
    reads = make_dataset(workdir)

    # PRIMARY: the rank-compressed (memory-parity) filter at the shipped
    # throughput settings — the at-scale configuration (human G needs it,
    # compressed.py:18-20); its 57 MB rank-indexed id table is 10x smaller
    # than the 570 MB direct array the per-recruit insert scatters into
    throughput = measure_engine(
        reads, workdir, "cz",
        frame_stride=STRIDE, probe_seeds=PROBE_SEEDS, recheck="optimistic",
        batch_reads=64, mibf_mode="compressed")
    direct = measure_engine(
        reads, workdir, "tp",
        frame_stride=STRIDE, probe_seeds=PROBE_SEEDS, recheck="optimistic",
        batch_reads=64)
    parity = measure_engine(reads, workdir, "parity")     # exact defaults

    micro = classify_microbench()
    rps = throughput["reads_per_s"]
    result = {
        "metric": "golden_path_engine_reads_per_s",
        "value": rps,
        "unit": f"reads/s (end-to-end pass 2: 20kb reads, 5Mbp genome, "
                f"5% err, silver mode, rank-compressed filter, stride "
                f"{STRIDE}, {PROBE_SEEDS} probed seed, all-seed insert + "
                f"full-res trim recheck, single chip)",
        # denominator: MEASURED reference binary on this exact dataset,
        # 37.4 reads/s at 1 thread, extrapolated 48x ideal-linear (its
        # measured 2-thread scaling here is negative — see docstring)
        "vs_baseline": round(rps / BASELINE_READS_PER_S, 3),
        "vs_baseline_measured_1t": round(rps / BASELINE_READS_PER_S_1T, 2),
        "direct_reads_per_s": direct["reads_per_s"],
        "direct_fill_s": direct["fill_s"],
        "engine_parity_reads_per_s": parity["reads_per_s"],
        "parity_vs_baseline": round(
            parity["reads_per_s"] / BASELINE_READS_PER_S, 3),
        "parity_vs_baseline_measured_1t": round(
            parity["reads_per_s"] / BASELINE_READS_PER_S_1T, 2),
        "fill_s": throughput["fill_s"],
        "assign_s": throughput["assign_s"],
        "submit_s": throughput["submit_s"],
        "replay_s": throughput["replay_s"],
        "recruits": throughput["recruits"],
        **micro,
        "device": {**device.jax_device(), "cards": device.cards()},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
