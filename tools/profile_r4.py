"""Attribute the round-4 submit-pass cost on the device: run the bench
engine with recheck / insert-seeds / stride toggles and diff assign_s.

Usage: python tools/profile_r4.py [variant ...]
Variants: shipped norech ins1 ins1rech exact2 s16 nolive
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import goldrush_jax  # noqa: F401,E402
from goldrush_jax.config import PathConfig  # noqa: E402
from goldrush_jax.path.engine import GoldenPathEngine  # noqa: E402
from goldrush_jax.utils import synth  # noqa: E402

PRESET = "1011011110110111101101"
GENOME = 5_000_000
VARIANTS = {
    "shipped": dict(frame_stride=8, probe_seeds=1, recheck="optimistic"),
    "norech": dict(frame_stride=8, probe_seeds=1, recheck="optimistic",
                   trim_recheck=False),
    "ins1": dict(frame_stride=8, probe_seeds=1, insert_seeds=1,
                 recheck="optimistic", trim_recheck=False),
    "ins1rech": dict(frame_stride=8, probe_seeds=1, insert_seeds=1,
                     recheck="optimistic"),
    "s16": dict(frame_stride=16, probe_seeds=1, recheck="optimistic"),
    "czship": dict(frame_stride=8, probe_seeds=1, recheck="optimistic",
                   mibf_mode="compressed"),
    "czb128": dict(frame_stride=8, probe_seeds=1, recheck="optimistic",
                   mibf_mode="compressed", batch_reads=128),
    "cznorech": dict(frame_stride=8, probe_seeds=1, recheck="optimistic",
                     trim_recheck=False, mibf_mode="compressed"),
    "czins1": dict(frame_stride=8, probe_seeds=1, insert_seeds=1,
                   recheck="optimistic", trim_recheck=False,
                   mibf_mode="compressed"),
}


def main():
    workdir = tempfile.mkdtemp(prefix="prof_r4_")
    reads = os.path.join(workdir, "reads.fq")
    genome = synth.random_genome(GENOME, seed=11)
    synth.write_fastq(reads, synth.simulate_reads(genome, 3000, 20_000,
                                                  seed=12, err_rate=0.05))
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        kw = VARIANTS[name]
        for rep in ("warm", "meas"):
            cfg = PathConfig(
                input=reads, genome_size=GENOME, kmer_size=22, weight=16,
                hash_num=3, seed_preset=PRESET, silver_path=True,
                max_paths=5, min_length=20_000,
                prefix_file=os.path.join(workdir, f"{name}_{rep}"),
                **{"batch_reads": 64, **kw})
            eng = GoldenPathEngine(cfg)
            st = eng.run()
        print(f"{name:10s} fill={st.wall_fill_s:6.2f} "
              f"assign={st.wall_assign_s:6.2f} submit={st.wall_submit_s:6.2f} "
              f"first={st.wall_submit_first_s:5.2f} "
              f"recruits={st.recruits} reads/s="
              f"{st.num_reads/max(st.wall_assign_s,1e-9):7.1f}", flush=True)


if __name__ == "__main__":
    main()
