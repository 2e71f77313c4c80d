"""Async ingest stream: order preservation, native/python equivalence,
early close, error relay."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.io import fastq
from goldrush_jax.io.ingest import ReadStream
from goldrush_jax.io.native_reader import native_available
from goldrush_jax.ops.phred import phred_stats, sum_phred
from goldrush_jax.utils import synth


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    d = tmp_path_factory.mktemp("ing")
    genome = synth.random_genome(30_000, seed=3)
    reads = synth.simulate_reads(genome, 60, 900, seed=4, err_rate=0.02)
    path = str(d / "r.fq")
    synth.write_fastq(path, reads)
    return path


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("prefetch", [0, 3])
def test_stream_matches_sync_reader(fq, use_native, prefetch):
    if use_native and not native_available():
        pytest.skip("native reader unavailable")
    want = list(fastq.read_records(fq))
    with ReadStream(fq, block_records=17, prefetch=prefetch,
                    use_native=use_native) as rs:
        got = list(rs.records())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.id == w.id
        assert g.length == len(w.seq)
        assert g.seq_bytes() == w.seq
        assert g.qual_bytes() == w.qual
        np.testing.assert_array_equal(np.asarray(g.codes),
                                      fastq.encode(w.seq))
        q = np.frombuffer(w.qual, dtype=np.uint8)
        avg, delta = phred_stats(q)
        assert (g.phred_avg, g.phred_delta) == (avg, delta)
        assert g.phred_sum == pytest.approx(sum_phred(q), rel=1e-12)
        assert not g.invalid


def test_native_python_streams_identical(fq):
    if not native_available():
        pytest.skip("native reader unavailable")
    with ReadStream(fq, use_native=False) as a, \
            ReadStream(fq, use_native=True) as b:
        ra, rb = list(a.records()), list(b.records())
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert (x.id, x.length, x.phred_avg, x.phred_delta, x.invalid) == \
            (y.id, y.length, y.phred_avg, y.phred_delta, y.invalid)
        assert x.seq_bytes() == y.seq_bytes()


def test_early_close_stops_producer(fq):
    rs = ReadStream(fq, block_records=5, prefetch=2)
    it = iter(rs)
    next(it)
    rs.close()          # must not deadlock on a full queue
    if rs._thread is not None:
        rs._thread.join(timeout=5)
        assert not rs._thread.is_alive()


def test_error_relayed(tmp_path):
    p = str(tmp_path / "broken.fq")
    with open(p, "wb") as f:
        f.write(b"not a fastq at all\n")
    with pytest.raises(Exception):
        with ReadStream(p, prefetch=2, use_native=False) as rs:
            list(rs.records())
