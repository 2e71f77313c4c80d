"""run_polish_streaming == run_polish (mapper path), with bounded memory.

VERDICT r4 item 5: the polish stage must not hold every read in memory at
scale.  The streaming variant spills per-goldtig read sets to disk; since
read->goldtig assignment is per-read and per-goldtig polishing is
independent, its output must be BYTE-IDENTICAL to the in-memory path.
"""
import os
import tempfile

import numpy as np

from goldrush_jax.stages import polish
from goldrush_jax.utils import synth


def test_streaming_matches_in_memory():
    truth = synth.random_genome(60_000, seed=5)
    recs = synth.simulate_reads(truth, 80, 3_000, seed=6, err_rate=0.04,
                                indel_frac=0.4, homopolymer_bias=0.5)
    reads = [s for _, s, _ in recs]
    contigs = [(f"g{i}", reads[i]) for i in range(3)]
    p = polish.PolishParams(k=24, schedule=((24, 3), (16, 3)),
                            site_spacing=2)

    mem_out, mem_edits = polish.run_polish(contigs, reads, p,
                                           mapper_k=15, mapper_w=10)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "reads.fq")
        synth.write_fastq(path, recs)
        # chunk smaller than the read count so multiple spill batches run
        st_out, st_edits = polish.run_polish_streaming(
            contigs, path, p, mapper_k=15, mapper_w=10, chunk=16)

    assert st_edits == mem_edits
    assert [n for n, _ in st_out] == [n for n, _ in mem_out]
    for (_, a), (_, b) in zip(st_out, mem_out):
        assert a == b
