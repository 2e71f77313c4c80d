"""Wavefront consume (opt-in parallel throughput mode, path/wavefront.py).

The wavefront must (a) run end-to-end with consistent device/replay
rotation accounting (the engine replay asserts device scalars match its
read-order walk), (b) make identical decisions on the direct and
rank-compressed filters, and (c) stay within a bounded recruit-set drift
of the sequential optimistic scan it parallelizes (the full-size quality
calibration lives in tools/calib_gate.py; the shipped default remains the
sequential scan — see config.PathConfig.wavefront).
"""

import os

import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.config import PathConfig
from goldrush_jax.io import fastq
from goldrush_jax.path.engine import GoldenPathEngine
from goldrush_jax.utils import synth

PRESET = "1011011110110111101101"
G = 60_000


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("wave")
    genome = synth.random_genome(G, seed=7)
    reads = synth.simulate_reads(genome, 80, 6_000, seed=8, err_rate=0.02)
    fqp = str(d / "reads.fq")
    synth.write_fastq(fqp, reads)
    return d, fqp


def _run(d, fqp, tag, **over):
    cfg = PathConfig(input=fqp, genome_size=G, kmer_size=22, weight=16,
                     hash_num=3, seed_preset=PRESET, silver_path=True,
                     max_paths=2, min_length=4_000, ratio=0.5,
                     prefix_file=str(d / tag), hash_universe=3_000_000,
                     batch_reads=16, frame_stride=8, probe_seeds=1,
                     recheck="optimistic", **over)
    st = GoldenPathEngine(cfg).run()
    ids, total = set(), 0
    for i in (1, 2):
        p = str(d / f"{tag}_{i}.fq")
        if os.path.exists(p):
            for r in fastq.read_records(p):
                ids.add(r.id.rsplit("_", 1)[0])
                total += len(r.seq)
    return ids, total, st


def test_wavefront_runs_and_modes_agree(dataset):
    d, fqp = dataset
    w_dir, tot_dir, st_dir = _run(d, fqp, "wdir", wavefront=True)
    w_cz, tot_cz, st_cz = _run(d, fqp, "wcz", wavefront=True,
                               mibf_mode="compressed")
    assert st_dir.recruits > 0 and st_dir.paths_completed == 2
    # slot->rank is a bijection on present slots; both filters must make
    # IDENTICAL decisions under the wavefront too
    assert w_dir == w_cz
    assert tot_dir == tot_cz


def test_wavefront_vs_sequential_drift_bounded(dataset):
    """The wavefront approximates the sequential optimistic scan within the
    reservoir-winner nondeterminism class; on this tiny dataset the recruit
    sets must overlap substantially (the 1 Mbp calibration measures 0.883
    vs the exact anchor — tools/calib_gate.py)."""
    d, fqp = dataset
    seq, _, _ = _run(d, fqp, "seq", wavefront=False)
    wav, _, _ = _run(d, fqp, "wav", wavefront=True)
    jac = len(seq & wav) / max(len(seq | wav), 1)
    assert jac >= 0.5, (jac, len(seq), len(wav))
