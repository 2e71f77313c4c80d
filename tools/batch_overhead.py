"""Measure per-batch host/dispatch overhead: bench-config engine runs at
batch_reads in {32, 64, 128, 256} on the bench dataset (warm cache)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import goldrush_jax  # noqa
from goldrush_jax.config import PathConfig
from goldrush_jax.path.engine import GoldenPathEngine

PRESET = "1011011110110111101101"
READS = "/tmp/bench_ds/bench_reads.fq"
G = 5_000_000

for batch in (64, 128, 256):
    cfg = PathConfig(
        input=READS, genome_size=G, kmer_size=22, weight=16, hash_num=3,
        seed_preset=PRESET, silver_path=True, max_paths=5,
        min_length=20_000, prefix_file=f"/tmp/bo_{batch}",
        frame_stride=8, probe_seeds=1, recheck="optimistic",
        batch_reads=batch)
    eng = GoldenPathEngine(cfg)
    t0 = time.time()
    st = eng.run()
    wall = time.time() - t0
    print(f"batch={batch}: assign={st.wall_assign_s:.1f}s "
          f"(submit={st.wall_submit_s:.1f} first={st.wall_submit_first_s:.1f} "
          f"replay={st.wall_replay_s:.1f}) fill={st.wall_fill_s:.1f}s "
          f"batches={st.num_batches} recruits={st.recruits} "
          f"reads/s={st.num_reads / st.wall_assign_s:.0f}", flush=True)
