"""--debug per-pass tile-state dumps (log_tile_states parity)."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.config import PathConfig
from goldrush_jax.path.classify import DEBUG_PASSES
from goldrush_jax.path.engine import GoldenPathEngine
from goldrush_jax.utils import synth


def test_debug_dumps_per_pass(tmp_path, capfd):
    G = 40_000
    genome = synth.random_genome(G, seed=21)
    reads = synth.simulate_reads(genome, 20, 5_000, seed=22, err_rate=0.01)
    fq = str(tmp_path / "r.fq")
    synth.write_fastq(fq, reads)

    def run(debug):
        cfg = PathConfig(
            input=fq, genome_size=G, kmer_size=22, weight=16, hash_num=3,
            seed_preset="1011011110110111101101", min_length=4_000,
            hash_universe=2_000_000, debug=debug,
            prefix_file=str(tmp_path / ("dbg" if debug else "ref")))
        GoldenPathEngine(cfg).run()
        return open(f"{tmp_path}/{'dbg' if debug else 'ref'}.fa",
                    "rb").read()

    ref_out = run(False)
    capfd.readouterr()
    dbg_out = run(True)
    err = capfd.readouterr().err
    # identical assembly with and without --debug
    assert dbg_out == ref_out
    dump_lines = [ln for ln in err.splitlines() if ln.endswith("\t")]
    # 9 passes x 2 lines per classified read
    n_classified = dump_lines and len(dump_lines) // (2 * len(DEBUG_PASSES))
    assert len(dump_lines) == n_classified * 2 * len(DEBUG_PASSES)
    assert n_classified >= 1
    # each dump is a parseable int row; bools rows are 0/1
    for k in range(0, 2 * len(DEBUG_PASSES), 2):
        ids = [int(x) for x in dump_lines[k].split("\t") if x]
        bl = [int(x) for x in dump_lines[k + 1].split("\t") if x]
        assert len(ids) == len(bl) and len(ids) >= 1
        assert set(bl) <= {0, 1}
