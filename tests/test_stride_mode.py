"""Throughput (frame_stride > 1) mode must preserve golden-path quality:
same ~1x coverage property and near-identical recruit set on synthetic data."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.utils import synth
from goldrush_jax.config import PathConfig
from goldrush_jax.io import fastq
from goldrush_jax.path.engine import GoldenPathEngine

CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", tile_length=250,
           min_length=1000, threshold=10, block_size=4, unassigned_min=5,
           assigned_max=1, occupancy=0.1, phred_min=15)


def run(tmp, path, stride):
    cfg = PathConfig(input=path, silver_path=False,
                     prefix_file=str(tmp / f"s{stride}"),
                     batch_reads=16, frame_stride=stride, **CFG)
    eng = GoldenPathEngine(cfg)
    eng.run()
    return list(fastq.read_records(str(tmp / f"s{stride}.fa")))


def test_stride_quality(tmp_path):
    genome = synth.random_genome(60_000, seed=31)
    reads = synth.simulate_reads(genome, 120, 3000, seed=32, err_rate=0.01)
    path = str(tmp_path / "reads.fq")
    synth.write_fastq(path, reads)
    got1 = run(tmp_path, path, 1)
    got5 = run(tmp_path, path, 5)
    b1 = sum(len(r.seq) for r in got1)
    b5 = sum(len(r.seq) for r in got5)
    G = 60_000
    # both modes produce ~1x golden paths
    assert 0.8 * G <= b1 <= 1.8 * G
    assert 0.8 * G <= b5 <= 1.8 * G
    # recruit sets overlap heavily (sampled voting may flip borderline reads)
    ids1 = {r.id for r in got1}
    ids5 = {r.id for r in got5}
    jac = len(ids1 & ids5) / max(len(ids1 | ids5), 1)
    assert jac >= 0.7, (jac, len(ids1), len(ids5))
