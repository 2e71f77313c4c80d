"""Full-pipeline end-to-end test: the demo-equivalent acceptance gate.

Mirrors tests/goldrush_test_demo.sh (reference): run the complete 5-stage
pipeline on synthetic reads and assert the final assembly's contiguity and
identity.  Uses a small genome with engine params scaled accordingly."""

import os
import subprocess
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from tests.conftest import REPO
from goldrush_jax.utils import synth
from goldrush_jax.config import PipelineConfig, stage_filenames
from goldrush_jax.io import fastq
from goldrush_jax.pipeline import run_pipeline
from goldrush_jax.utils.stats import assembly_stats


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    genome = synth.random_genome(60_000, seed=71)
    reads = synth.simulate_reads(genome, 300, 4000, seed=72, err_rate=0.01,
                                 phred=20)
    synth.write_fastq(str(d / "reads.fq"), reads)
    return d, genome


def make_cfg(**kw):
    # dev=True keeps the silver intermediates so the dataflow assertions
    # below can see them (dev=False removes them after the golden pass,
    # bin/goldrush:202-206 — covered by test_dev_cleanup)
    kw.setdefault("dev", True)
    return PipelineConfig(
        reads="reads", G=60_000, t=2,
        k=22, w=16, tile=250, b=4, m=2000, M=3, r=0.5,
        P=15, x=10, u=5, a=1,
        span=2, dist=500, cut=250,
        k_ntLink=24, w_ntLink=100, rounds=3, z=500, **kw,
    )


def test_full_pipeline(workdir):
    d, genome = workdir
    cfg = make_cfg()
    out = run_pipeline(cfg, workdir=str(d), until="final")
    assert "final" in out
    final = d / out["final"]
    assert final.exists()
    entries = [(r.id, r.seq) for r in fastq.read_records(str(final))]
    st = assembly_stats([len(s) for _, s in entries])
    # demo-equivalent acceptance: a few contigs covering ~1x the genome
    assert st["total"] >= 0.8 * 60_000, st
    assert st["total"] <= 1.8 * 60_000, st
    assert st["L50"] <= 4, st
    # stage files exist with the reference's name-encoded dataflow
    files = stage_filenames(cfg)
    for key in ("silver_all", "golden", "polished", "tigmint", "ntlink",
                "final"):
        assert (d / files[key]).exists(), key


def test_dev_cleanup(workdir):
    """dev=False (the default) removes the silver .fq intermediates after
    the golden pass (rm -f $(p1)_*.fq, bin/goldrush:202-206); resume from
    the golden file must not rebuild them (.SECONDARY semantics)."""
    d, genome = workdir
    cfg = make_cfg(dev=False, p="goldrush_dev0")
    out = run_pipeline(cfg, workdir=str(d), until="golden")
    files = stage_filenames(cfg)
    assert (d / files["golden"]).exists()
    for f in files["silver"] + [files["silver_all"]]:
        assert not (d / f).exists(), f
    # resume: silver stage must be skipped (golden exists), not recomputed
    before = (d / files["golden"]).stat().st_mtime
    run_pipeline(cfg, workdir=str(d), until="golden")
    assert (d / files["golden"]).stat().st_mtime == before
    for f in files["silver"]:
        assert not (d / f).exists(), f


def test_pipeline_resume(workdir):
    d, genome = workdir
    cfg = make_cfg()
    files = stage_filenames(cfg)
    # corrupt-resume check: stage outputs exist, so a re-run must be fast and
    # must not recompute (mtime unchanged)
    before = (d / files["golden"]).stat().st_mtime
    out = run_pipeline(cfg, workdir=str(d), until="final")
    assert (d / files["golden"]).stat().st_mtime == before


def test_cli_version_and_help():
    r = subprocess.run([sys.executable, "-m", "goldrush_jax.cli", "version"],
                       capture_output=True, text=True, cwd=str(REPO),
                       env={**os.environ, "JAX_PLATFORMS_FORCE": "0"})
    assert "goldrush-jax version" in r.stdout
    r = subprocess.run([sys.executable, "-m", "goldrush_jax.cli", "help"],
                       capture_output=True, text=True, cwd=str(REPO))
    assert "Commands:" in r.stdout
    r = subprocess.run([sys.executable, "-m", "goldrush_jax.cli", "nope"],
                       capture_output=True, text=True, cwd=str(REPO))
    assert r.returncode != 0
