"""One-off calibration: Jaccard of sampled configs vs the exact anchor on
the quality-gate dataset (1 Mbp, 600 x 20 kb reads, 5% err, 40% indels).

Usage: python tools/calib_gate.py [tag=key:val,...]...
Each positional arg is a config override set; always runs the exact anchor
first.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from goldrush_jax.config import PathConfig  # noqa: E402
from goldrush_jax.io import fastq  # noqa: E402
from goldrush_jax.path.engine import GoldenPathEngine  # noqa: E402
from goldrush_jax.utils import synth  # noqa: E402

PRESET = "1011011110110111101101"
G = 1_000_000


def run(d, fqp, tag, **over):
    cfg = PathConfig(input=fqp, genome_size=G, kmer_size=22, weight=16,
                     hash_num=3, seed_preset=PRESET, silver_path=True,
                     max_paths=3, ratio=0.75, min_length=15_000,
                     prefix_file=os.path.join(d, tag), batch_reads=64, **over)
    t0 = time.time()
    GoldenPathEngine(cfg).run()
    wall = time.time() - t0
    ids, lens, kind = set(), [], {}
    for i in (1, 2, 3):
        p = os.path.join(d, f"{tag}_{i}.fq")
        if os.path.exists(p):
            for r in fastq.read_records(p):
                rid, _, sfx = r.id.rpartition("_")
                ids.add(rid)
                kind[rid] = sfx
                lens.append(len(r.seq))
    return ids, lens, wall, kind


def main():
    d = tempfile.mkdtemp(prefix="calib_")
    genome = synth.random_genome(G, seed=51)
    reads = synth.simulate_reads(genome, 600, 20_000, seed=52,
                                 err_rate=0.05, indel_frac=0.4)
    fqp = os.path.join(d, "reads.fq")
    synth.write_fastq(fqp, reads)
    cache = "/tmp/calib_anchor.json"
    import json
    if os.path.exists(cache):
        bkind = json.load(open(cache))
        base, base_lens, w0 = set(bkind), [], 0.0
    else:
        base, base_lens, w0, bkind = run(d, fqp, "exact")
        json.dump(bkind, open(cache, "w"))
    print(f"exact anchor: {len(base)} recruits "
          f"({sum(1 for v in bkind.values() if v == 'trimmed')} trimmed), "
          f"wall {w0:.1f}s", flush=True)
    for arg in sys.argv[1:]:
        tag, _, kvs = arg.partition("=")
        over = {}
        for kv in kvs.split(","):
            k, _, v = kv.partition(":")
            over[k] = (v if not v.replace(".", "").lstrip("-").isdigit()
                       else (float(v) if "." in v else int(v)))
        ids, lens, w, kind = run(d, fqp, tag, **over)
        jac = len(ids & base) / max(len(ids | base), 1)
        fill = sum(lens) / (0.75 * G * 3)
        only_a = base - ids
        only_p = ids - base
        ak = {"trimmed": 0, "untrimmed": 0}
        for rid in only_a:
            ak[bkind[rid]] += 1
        pk = {"trimmed": 0, "untrimmed": 0}
        for rid in only_p:
            pk[kind[rid]] += 1
        print(f"{tag:22s} jac={jac:.3f} n={len(ids)} fill={fill:.2f} "
              f"wall={w:.1f}s anchor-only(t={ak['trimmed']},"
              f"w={ak['untrimmed']}) mode-only(t={pk['trimmed']},"
              f"w={pk['untrimmed']}) ({kvs})", flush=True)


if __name__ == "__main__":
    main()
