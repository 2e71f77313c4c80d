"""A/B the compressed-mode fill regression (BENCH r5 prep): default vs
GOLDRUSH_NO_PREWARM on the bench dataset/settings.  Run on the chip.

Usage: python tools/profile_fill.py [variant ...]
  variants: default noprewarm   (each runs warm + fresh measure)
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def run(tag, **kw):
    workdir = tempfile.mkdtemp(prefix=f"profill_{tag}_")
    reads = bench.make_dataset(workdir)
    t0 = time.time()
    kw.setdefault("mibf_mode", "compressed")
    from goldrush_jax.path.engine import GoldenPathEngine
    cfg = bench.engine_cfg(reads, workdir, tag + "_w", frame_stride=8,
                           probe_seeds=1, recheck="optimistic",
                           batch_reads=64, **kw)
    GoldenPathEngine(cfg).run()               # warm XLA cache
    cfg = bench.engine_cfg(reads, workdir, tag, frame_stride=8,
                           probe_seeds=1, recheck="optimistic",
                           batch_reads=64, **kw)
    eng = GoldenPathEngine(cfg)
    stats = eng.run()
    r = dict(fill_s=round(stats.wall_fill_s, 3),
             fill_stream_s=round(stats.wall_fill_stream_s, 3),
             assign_s=round(stats.wall_assign_s, 3),
             submit_s=round(stats.wall_submit_s, 3),
             submit_first_s=round(stats.wall_submit_first_s, 3),
             reads_per_s=round(stats.num_reads
                               / max(stats.wall_assign_s, 1e-9), 2))
    print(f"[{tag}] wall {time.time()-t0:.1f}s  {r}", flush=True)


if __name__ == "__main__":
    variants = sys.argv[1:] or ["default", "noprewarm"]
    for v in variants:
        os.environ.pop("GOLDRUSH_NO_PREWARM", None)
        os.environ.pop("GOLDRUSH_RANKSCAN", None)
        if v == "noprewarm":
            os.environ["GOLDRUSH_NO_PREWARM"] = "1"
        elif v == "rankscan":
            os.environ["GOLDRUSH_RANKSCAN"] = "1"
        if v == "direct":
            run(v, mibf_mode="direct")
        else:
            run(v)
