"""Native C++ seqio reader vs the Python reader and phred oracle."""

import gzip

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_jax.utils import synth
from goldrush_jax.io import fastq
from goldrush_jax.io.native_reader import native_available, read_native_blocks
from goldrush_jax.ops.phred import phred_stats, sum_phred

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="g++/zlib unavailable")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nio")
    genome = synth.random_genome(20_000, seed=5)
    reads = synth.simulate_reads(genome, 40, 800, seed=6, err_rate=0.01)
    fq = str(d / "r.fq")
    synth.write_fastq(fq, reads)
    with open(fq, "rb") as f:
        data = f.read()
    fqgz = str(d / "r.fq.gz")
    with gzip.open(fqgz, "wb") as f:
        f.write(data)
    fa = str(d / "r.fa")
    with open(fa, "wb") as f:
        for rid, seq, _ in reads:
            f.write(b">" + rid.encode() + b" extra comment\n")
            # multi-line fasta
            f.write(seq[:300] + b"\n" + seq[300:] + b"\n")
    return fq, fqgz, fa, reads


def collect(path, **kw):
    out = []
    for blk in read_native_blocks(path, **kw):
        for i in range(len(blk)):
            out.append((blk.names[i], bytes(blk.view(blk.seq, i)),
                        bytes(blk.view(blk.quals, i)) if blk.fastq else None,
                        blk.view(blk.codes, i).copy(),
                        int(blk.phred_avg[i]), int(blk.phred_delta[i]),
                        float(blk.phred_sum[i]), int(blk.invalid[i])))
    return out


@pytest.mark.parametrize("which", ["plain", "gz"])
def test_fastq_matches_python_reader(files, which):
    fq, fqgz, fa, reads = files
    path = fq if which == "plain" else fqgz
    got = collect(path, max_records=7)   # force multiple blocks
    want = list(fastq.read_records(fq))
    assert len(got) == len(want)
    for (name, seq, qual, codes, pa, pd, ps, inv), rec in zip(got, want):
        assert name == rec.id
        assert seq == rec.seq
        assert qual == rec.qual
        np.testing.assert_array_equal(codes, fastq.encode(rec.seq))
        q = np.frombuffer(rec.qual, dtype=np.uint8)
        avg, delta = phred_stats(q)
        assert (pa, pd) == (avg, delta)
        assert ps == pytest.approx(sum_phred(q), rel=1e-12)
        assert inv == 0


def test_fasta(files):
    fq, fqgz, fa, reads = files
    got = collect(fa, max_records=64)
    assert len(got) == len(reads)
    for (name, seq, qual, codes, pa, pd, ps, inv), (rid, rseq, _) in \
            zip(got, reads):
        assert name == rid            # comment stripped
        assert seq == rseq            # multi-line joined


def test_invalid_bases(files, tmp_path):
    p = str(tmp_path / "n.fq")
    with open(p, "wb") as f:
        f.write(b"@a\nACGTNACGT\n+\nIIIIIIIII\n@b\nACGT\n+\nIIII\n")
    got = collect(p)
    assert got[0][7] == 1 and got[1][7] == 0
    assert got[0][3][4] == 255        # N encoded as invalid


def test_native_reader_builds_from_source(tmp_path):
    """With no shared object on disk, the reader compiles from seqio.cpp
    (the .so is never committed) into a loadable library."""
    import ctypes

    from goldrush_jax.io.native import build

    so = tmp_path / "_seqio.so"
    assert not so.exists()
    assert build.build(build._SRC, str(so))
    lib = ctypes.CDLL(str(so))
    assert hasattr(lib, "seqio_open") and hasattr(lib, "seqio_read_block")
    assert [p.name for p in tmp_path.iterdir()] == ["_seqio.so"]
    mtime = so.stat().st_mtime_ns
    assert build.build(build._SRC, str(so))      # up to date: no rebuild
    assert so.stat().st_mtime_ns == mtime
