"""End-to-end parity: the JAX streaming engine vs the sequential oracle
engine on a synthetic genome, plus golden-path quality properties."""

import dataclasses

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.utils import synth
from goldrush_jax.config import PathConfig
from goldrush_jax.path.engine import GoldenPathEngine
from goldrush_jax.path.oracle_engine import OracleEngine

# small config: 60kb genome, 3kb reads, small tiles so smoothing engages
CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", tile_length=250,
           min_length=1000, threshold=10, block_size=4, unassigned_min=5,
           assigned_max=1, occupancy=0.1, phred_min=15)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e")
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path, genome, reads


def run_engine(tmp, path, batch, silver=False, **over):
    cfg = PathConfig(input=path, silver_path=silver,
                     prefix_file=str(tmp / f"eng_b{batch}_{silver}"),
                     batch_reads=batch, keep_filter=True,
                     **{**CFG, **over})
    eng = GoldenPathEngine(cfg)
    stats = eng.run()
    return eng, stats


def run_oracle(tmp, path, silver=False, **over):
    cfg = PathConfig(input=path, silver_path=silver,
                     prefix_file=str(tmp / f"oracle_{silver}"), **{**CFG, **over})
    eng = OracleEngine(cfg)
    all_stats = eng.run()
    return eng, all_stats


def recruited_from_oracle(all_stats):
    return [(rid, sfx, seq) for st in all_stats
            for (rid, sfx, seq, qual, pathno) in st.recruited]


def recruited_from_files(prefix, silver, n_paths=1):
    from goldrush_jax.io import fastq
    out = []
    paths = ([f"{prefix}_{i}.fq" for i in range(1, n_paths + 1)]
             if silver else [f"{prefix}.fa"])
    for p in paths:
        try:
            for rec in fastq.read_records(p):
                out.append(rec)
        except FileNotFoundError:
            pass
    return out


@pytest.fixture(scope="module")
def batch1_run(dataset):
    tmp, path, genome, reads = dataset
    return run_engine(tmp, path, batch=1, silver=False)


def test_golden_path_parity_batch1(dataset, batch1_run):
    """batch_reads=1 is strict sequential parity with the oracle engine."""
    tmp, path, genome, reads = dataset
    oeng, ostats = run_oracle(tmp, path, silver=False)
    teng, tstats = batch1_run
    want = recruited_from_oracle(ostats)
    got = recruited_from_files(str(tmp / "eng_b1_False"), silver=False)
    assert len(got) == len(want), (len(got), len(want))
    for rec, (rid, sfx, seq) in zip(got, want):
        assert rec.id == rid + sfx
        assert rec.seq == seq
    # same filter decisions and counters
    assert teng.filter_out == oeng.filter_out
    total_o = sum(s.queries for s in ostats)
    assert tstats.queries == total_o
    assert tstats.hits == sum(s.hits for s in ostats)
    assert tstats.misses == sum(s.misses for s in ostats)
    # miBF end state identical
    np.testing.assert_array_equal(
        np.asarray(teng.state.words)[: teng.size], oeng.mibf.words[:-1])
    np.testing.assert_array_equal(
        np.asarray(teng.state.counts)[: teng.size], oeng.mibf.counts[:-1])


def test_golden_path_batched_equivalence(dataset, batch1_run):
    """Optimistic batching must give the same golden path on this dataset."""
    tmp, path, genome, reads = dataset
    _, _ = run_engine(tmp, path, batch=16, silver=False)
    got1 = recruited_from_files(str(tmp / "eng_b1_False"), silver=False)
    got16 = recruited_from_files(str(tmp / "eng_b16_False"), silver=False)
    assert [(r.id, r.seq) for r in got16] == [(r.id, r.seq) for r in got1]


def test_golden_path_covers_genome(dataset, batch1_run):
    """Recruited reads should tile ~the whole genome about once (the golden
    path property), not more than ~1.6x."""
    tmp, path, genome, reads = dataset
    got = recruited_from_files(str(tmp / "eng_b1_False"), silver=False)
    total = sum(len(r.seq) for r in got)
    G = len(genome)
    assert 0.8 * G <= total <= 1.7 * G, total
    # coverage: every genome position covered by >= 1 recruited read
    cov = np.zeros(G, dtype=np.int32)
    starts = {rid.split("_p")[0] + "_p" + rid.split("_p")[1]: None
              for rid, _, _ in reads}
    pos_of = {rid: int(rid.split("_p")[1]) for rid, _, _ in reads}
    for rec in got:
        base = rec.id.rsplit("_", 1)[0]
        start = pos_of[base]
        # trimmed reads may not start at the read start; ignore offset detail
        cov[start:start + len(rec.seq)] += 1
    # gaps shorter than unassigned_min*tile_length can never be recruited,
    # so ~90% coverage is the expected regime here (trim offsets also not
    # tracked in this rough coordinate accounting)
    assert (cov > 0).mean() > 0.85, (cov > 0).mean()


def test_silver_paths_rotation(dataset):
    """Silver mode: M paths, each ~ratio*G bases, rotation resets IDs."""
    tmp, path, genome, reads = dataset
    oeng, ostats = run_oracle(tmp, path, silver=True, max_paths=2, ratio=0.5)
    teng, tstats = run_engine(tmp, path, batch=1, silver=True, max_paths=2,
                           ratio=0.5)
    want = recruited_from_oracle(ostats)
    got = recruited_from_files(str(tmp / "eng_b1_True"), silver=True,
                               n_paths=2)
    assert len(got) == len(want)
    for rec, (rid, sfx, seq) in zip(got, want):
        assert rec.id == rid + sfx
        assert rec.seq == seq
    assert tstats.paths_completed == 2


def test_engine_multi_device_parity(dataset, batch1_run):
    """cfg.devices=8: the mesh-sharded engine (data-parallel classify,
    replicated miBF, sequential recruit scan) writes a bit-identical golden
    path and filter state vs single-device."""
    tmp, path, genome, reads = dataset
    teng1, _ = batch1_run
    teng8, _ = run_engine(tmp, path, batch=16, silver=False, devices=8)
    got1 = recruited_from_files(str(tmp / "eng_b1_False"), silver=False)
    got8 = recruited_from_files(str(tmp / "eng_b16_False"), silver=False)
    assert [(r.id, r.seq) for r in got8] == [(r.id, r.seq) for r in got1]
    np.testing.assert_array_equal(np.asarray(teng8.state.words),
                                  np.asarray(teng1.state.words))
    np.testing.assert_array_equal(np.asarray(teng8.state.counts),
                                  np.asarray(teng1.state.counts))


def test_filter_file_excludes_reads(dataset, tmp_path):
    """-f: listed read names are skipped in pass 2 (but still fill presence
    in pass 1 — goldrush_path.cpp:1163-1170)."""
    tmp, path, genome, reads = dataset
    teng1, _ = run_engine(tmp_path, path, batch=8, silver=False)
    got = recruited_from_files(str(tmp_path / "eng_b8_False"), silver=False)
    assert got, "baseline run recruited nothing"
    first = got[0].id.rsplit("_", 1)[0]
    ff = tmp_path / "exclude.txt"
    ff.write_text(first + "\n")
    cfg = PathConfig(input=path, silver_path=False,
                     prefix_file=str(tmp_path / "filtered"),
                     batch_reads=8, filter_file=str(ff), **CFG)
    eng = GoldenPathEngine(cfg)
    eng.run()
    got_f = recruited_from_files(str(tmp_path / "filtered"), silver=False)
    names = {r.id.rsplit("_", 1)[0] for r in got_f}
    assert first not in names
    assert got_f, "filtered run recruited nothing"


def test_recheck_optimistic_smoke(dataset, batch1_run):
    """recheck=optimistic runs and produces a sane golden path (recruit set
    may drift from exact in recruit-dense phases by design)."""
    tmp, path, genome, reads = dataset
    run_engine(tmp, path, batch=16, silver=False, recheck="optimistic")
    got1 = recruited_from_files(str(tmp / "eng_b1_False"), silver=False)
    got = recruited_from_files(str(tmp / "eng_b16_False"), silver=False)
    a = {r.id for r in got1}
    b = {r.id for r in got}
    jacc = len(a & b) / max(len(a | b), 1)
    assert jacc >= 0.7, jacc
    total = sum(len(r.seq) for r in got)
    assert 0.8 * len(genome) <= total <= 1.8 * len(genome)


def test_ultralong_reads_uncapped(tmp_path):
    """Reads beyond the old 256-tile bucket cap classify on their FULL
    length (the reference has no cap, goldrush_path.cpp:529-544): a 90 kb
    read at tile_length=250 spans 360 tiles -> bucket 512; engine ==
    oracle bit-for-bit, and the tile-budget batching keeps read order."""
    G = 120_000
    genome = synth.random_genome(G, seed=31)
    reads = synth.simulate_reads(genome, n_reads=60, read_len=3000, seed=32,
                                 err_rate=0.0, phred=20)
    # interleave three ultralong reads (they must stay in stream order)
    ul = synth.simulate_reads(genome, n_reads=3, read_len=90_000, seed=33,
                              err_rate=0.0, phred=20)
    # the leading ultralong read hits an empty filter -> recruited whole on
    # its full 360-tile grid; the others interleave mid-stream
    mixed = ul[:1] + reads[:30] + ul[1:2] + reads[30:] + ul[2:]
    path = str(tmp_path / "ul.fq")
    synth.write_fastq(path, mixed)
    over = dict(genome_size=G, min_length=1000)
    cfg = PathConfig(input=path, silver_path=False,
                     prefix_file=str(tmp_path / "eng"),
                     batch_reads=8, **{**CFG, **over})
    eng = GoldenPathEngine(cfg)
    tstats = eng.run()
    ocfg = PathConfig(input=path, silver_path=False,
                      prefix_file=str(tmp_path / "oracle"), **{**CFG, **over})
    oeng = OracleEngine(ocfg)
    ostats = oeng.run()
    want = recruited_from_oracle(ostats)
    got = recruited_from_files(str(tmp_path / "eng"), silver=False)
    assert len(got) == len(want), (len(got), len(want))
    for rec, (rid, sfx, seq) in zip(got, want):
        assert rec.id == rid + sfx
        assert rec.seq == seq
    # at least one ultralong read must actually have been classified on a
    # >256-tile grid (the old cap would have truncated it)
    assert any(len(r[2]) > 256 * CFG["tile_length"] for r in want
               if r[0].startswith("r")), "dataset lost its ultralong recruit"
    assert tstats.queries == sum(s.queries for s in ostats)


def test_engine_banked_filter_parity(dataset, batch1_run):
    """model_shards=2 (4x2 data x model mesh): the slot-banked filter
    engine produces a bit-identical golden path and filter state vs
    single-device — the capacity lever for filters beyond one chip's HBM."""
    tmp, path, genome, reads = dataset
    teng1, _ = batch1_run
    tengb, _ = run_engine(tmp, path, batch=16, silver=False, devices=8,
                       model_shards=2)
    got1 = recruited_from_files(str(tmp / "eng_b1_False"), silver=False)
    gotb = recruited_from_files(str(tmp / "eng_b16_False"), silver=False)
    assert [(r.id, r.seq) for r in gotb] == [(r.id, r.seq) for r in got1]
    np.testing.assert_array_equal(np.asarray(tengb.state.words),
                                  np.asarray(teng1.state.words))
    np.testing.assert_array_equal(np.asarray(tengb.state.counts),
                                  np.asarray(teng1.state.counts))


def test_mibf_save_load_resume(dataset, tmp_path):
    """save_mibf after pass 1 + load_mibf resume produce the same golden
    path as a straight run (checkpoint/resume beyond the reference's
    store-only MIBloomFilter::store, MIBloomFilter.hpp:123-160)."""
    tmp, path, genome, reads = dataset
    ckpt = str(tmp_path / "filter.npz")
    cfg1 = PathConfig(input=path, silver_path=False,
                      prefix_file=str(tmp_path / "direct"),
                      batch_reads=8, save_mibf=ckpt, **CFG)
    GoldenPathEngine(cfg1).run()
    cfg2 = PathConfig(input=path, silver_path=False,
                      prefix_file=str(tmp_path / "resumed"),
                      batch_reads=8, load_mibf=ckpt, **CFG)
    GoldenPathEngine(cfg2).run()
    a = recruited_from_files(str(tmp_path / "direct"), silver=False)
    b = recruited_from_files(str(tmp_path / "resumed"), silver=False)
    assert [(r.id, r.seq) for r in a] == [(r.id, r.seq) for r in b]
    assert a
