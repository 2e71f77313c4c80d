"""Scale validation on the device: a silver-path run at G=140 Mbp
filter sizing — at occupancy 0.1 that is ~4.3e9 slots, just under 2^32
elements per filter array.  Larger genomes route to the banked mode
(model_shards >= 2: each shard stays < 2^32 elements AND within one
device's memory).  Records fill/assign wall, reads/s and the filter's
HBM footprint vs the reference's published RAM curve
(/root/reference/README.md:115-123).

The read set is a 20 Mbp genome at ~2x (2,000 x 20 kb) — enough to
exercise fill, freeze, probe and insert against the full-size rank
structure; the bitrank array is sized by G (7.1e9 slots), the rank-indexed
id/counter arrays by the actually-filled population.  The analytic
footprint at FULL 250 Mbp fill, and the >HBM 500 Mbp+ regime that requires
the banked (model_shards>1) mode, are printed alongside.

Usage: python tools/scale_validate.py [--direct]
"""
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import goldrush_jax  # noqa
from goldrush_jax.config import PathConfig, calc_optimal_size
from goldrush_jax.path.engine import GoldenPathEngine
from goldrush_jax.utils import synth

PRESET = "1011011110110111101101"
G_SIZING = 140_000_000
G_READS = 20_000_000
N_READS = 2_000

workdir = "/tmp/scale_val"
os.makedirs(workdir, exist_ok=True)
fq = os.path.join(workdir, "reads.fq")
if not os.path.exists(fq):
    print("generating dataset...", flush=True)
    genome = synth.random_genome(G_READS, seed=71)
    reads = synth.simulate_reads(genome, N_READS, 20_000, seed=72,
                                 err_rate=0.05)
    synth.write_fastq(fq, reads)

universe = int(min(4 ** 16, 2 * G_SIZING) * 0.5 * 3)
size = calc_optimal_size(universe, 1, 0.1)
print(f"G sizing {G_SIZING:,}: universe {universe:,} -> {size:,} slots")
print(f"  compressed structure: bitrank {size / 32 * 8 / 1e9:.2f} GB "
      f"(+ ids/counts by filled population)")
full_pop = int(universe * (1 - math.exp(-1)) / 1)  # ~occupancy-filled
print(f"  at FULL {G_SIZING/1e6:.0f} Mbp fill: pop ~{universe:,} -> "
      f"ids+counts {2 * universe * 4 / 1e9:.1f} GB "
      f"(total ~{(size / 32 * 8 + 2 * universe * 4) / 1e9:.1f} GB; "
      f"reference RAM at human 3 Gbp: 51.9-54.5 GB)")
for gg in (250_000_000, 500_000_000, 3_000_000_000):
    uu = int(min(4 ** 16, 2 * gg) * 0.5 * 3)
    ss = calc_optimal_size(uu, 1, 0.1)
    shards = max(2, -(-ss // (1 << 32)))
    print(f"  at {gg/1e6:.0f} Mbp sizing: {ss:,} slots "
          f"({(ss / 32 * 8 + 2 * uu * 4) / 1e9:.1f} GB) exceeds the 2^32 "
          f"single-array index limit -> banked mode, model_shards>="
          f"{shards}")

mode = "direct" if "--direct" in sys.argv else "compressed"
cfg = PathConfig(
    input=fq, genome_size=G_SIZING, kmer_size=22, weight=16, hash_num=3,
    seed_preset=PRESET, silver_path=True, max_paths=5, ratio=0.02,
    min_length=20_000, prefix_file=os.path.join(workdir, "sv"),
    frame_stride=8, probe_seeds=1, recheck="optimistic", batch_reads=64,
    mibf_mode=mode, keep_filter=(mode == "compressed"))
eng = GoldenPathEngine(cfg)
t0 = time.time()
st = eng.run()
wall = time.time() - t0
if mode == "compressed":
    ids_gb = eng.cstate.ids.nbytes / 1e9
    br_gb = eng.cstate.bitrank.nbytes / 1e9
    print(f"filled pop arrays: ids/counts {2 * ids_gb:.2f} GB, "
          f"bitrank {br_gb:.2f} GB "
          f"(device total {2 * ids_gb + br_gb:.2f} GB)")
print(f"fill={st.wall_fill_s:.1f}s assign={st.wall_assign_s:.1f}s "
      f"(submit={st.wall_submit_s:.1f} replay={st.wall_replay_s:.1f}) "
      f"wall={wall:.1f}s reads/s={st.num_reads / st.wall_assign_s:.1f} "
      f"recruits={st.recruits} paths={st.paths_completed}")
