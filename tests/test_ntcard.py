"""ntCard F0 estimator sanity: estimates distinct spaced-seed k-mers of a
synthetic genome from reads within reasonable error."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.utils import synth
from goldrush_jax.ops.seeds import make_seed_pattern
from goldrush_jax.utils.ntcard import NtCardParams, estimate_genome_size


def test_f0_estimate(tmp_path):
    genome = synth.random_genome(80_000, seed=91)
    reads = synth.simulate_reads(genome, 160, 3000, seed=92, err_rate=0.0)
    path = str(tmp_path / "r.fq")
    synth.write_fastq(path, reads)
    seeds = make_seed_pattern("1011011110110111101101", 22, 16, 3)
    est = estimate_genome_size(path, seeds,
                               NtCardParams(rbits=18, sbits=5))
    # ~80k distinct canonical k-mers per seed (random genome), 3 seeds
    expect = 3 * 80_000
    assert 0.5 * expect <= est <= 2.0 * expect, est


def test_engine_uses_ntcard(tmp_path):
    # PathConfig.ntcard routes hash-universe sizing through the estimator
    from goldrush_jax.config import PathConfig
    from goldrush_jax.path.engine import GoldenPathEngine
    genome = synth.random_genome(30_000, seed=93)
    reads = synth.simulate_reads(genome, 60, 3000, seed=94)
    path = str(tmp_path / "r.fq")
    synth.write_fastq(path, reads)
    cfg = PathConfig(input=path, genome_size=30_000, kmer_size=22, weight=16,
                     seed_preset="1011011110110111101101", tile_length=250,
                     min_length=1000, phred_min=15, ntcard=True,
                     prefix_file=str(tmp_path / "o"))
    eng = GoldenPathEngine(cfg)
    # universe came from the estimator, not the closed-form heuristic
    assert eng.universe != cfg.derived_hash_universe()
    assert 30_000 <= eng.universe <= 400_000
