"""Hash-kernel parity: JAX device hashes vs the NumPy oracle, plus the
algebraic properties the assembler depends on (RC invariance, tile/whole-read
equivalence, stale-tail semantics)."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (JAX platform env)
from goldrush_jax.ops.seeds import make_seed_pattern
from goldrush_jax.ops import nthash_np as oracle
from goldrush_jax.ops.nthash import build_seed_family, hash_positions

RNG = np.random.default_rng(7)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(n, rng=RNG):
    return bytes(BASES[rng.integers(0, 4, n)])


@pytest.fixture(scope="module")
def demo_seeds():
    return make_seed_pattern("1011011110110111101101", 22, 16, 3)


def test_encode():
    codes = oracle.encode_seq("ACGTacgtN")
    assert list(codes[:8]) == [0, 1, 2, 3, 0, 1, 2, 3]
    assert codes[8] == 255
    assert oracle.has_invalid_bases(codes)
    assert not oracle.has_invalid_bases(codes[:8])


def test_rc_invariance(demo_seeds):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    for span, seed in zip((22, 23, 24), demo_seeds):
        s = random_seq(span).decode()
        rc = "".join(comp[c] for c in reversed(s))
        f1, r1 = oracle.seed_hashes(oracle.encode_seq(s), seed)
        f2, r2 = oracle.seed_hashes(oracle.encode_seq(rc), seed)
        assert min(f1[0], r1[0]) == min(f2[0], r2[0])
        assert f1[0] == r2[0] and r1[0] == f2[0]


def test_stale_tail(demo_seeds):
    # shorter-than-longest-seed tail frames repeat the last valid hash
    s = oracle.encode_seq(random_seq(30))
    canon = oracle.multi_seed_canonical(s, demo_seeds)
    assert canon.shape == (3, 9)          # 30 - 22 + 1
    # seed 1 (span 23) has 8 valid frames; frame 8 repeats frame 7
    assert canon[1, 8] == canon[1, 7]
    # seed 2 (span 24) has 7 valid frames; frames 7,8 repeat frame 6
    assert canon[2, 7] == canon[2, 6] == canon[2, 8]
    # seed 0 has no stale frames: all frames generically distinct
    assert len(set(canon[0])) == 9


def test_tile_equals_whole_read(demo_seeds):
    codes = oracle.encode_seq(random_seq(3210))
    tiles = oracle.tile_frame_hashes(codes, demo_seeds, 1000)
    whole = oracle.multi_seed_canonical(codes, demo_seeds)
    assert len(tiles) == 3
    k = 22
    for t, flat in enumerate(tiles):
        tile_len = min(1000 + k - 1, 3210 - t * 1000)
        F = tile_len - k + 1
        per_frame = flat.reshape(F, 3)
        for s in range(3):
            valid = tile_len - len(demo_seeds[s]) + 1
            # valid frames match the whole-read hash at the global position
            np.testing.assert_array_equal(
                per_frame[:valid, s], whole[s, t * 1000: t * 1000 + valid])
            # stale tail repeats last valid frame
            assert (per_frame[valid:, s] == per_frame[valid - 1, s]).all()


@pytest.mark.parametrize("preset,k,w,h", [
    ("1011011110110111101101", 22, 16, 3),
    ("", 22, 16, 3),
    ("", 20, 14, 4),
    ("", 18, 12, 1),
])
def test_jax_matches_oracle(preset, k, w, h):
    seeds = make_seed_pattern(preset, k, w, h)
    fam = build_seed_family(seeds)
    lengths = [k + h, 64, 257, 1100]
    Lmax = max(lengths)
    P = Lmax - k + 1
    codes = np.zeros((len(lengths), Lmax), dtype=np.uint8)
    seqs = []
    for i, L in enumerate(lengths):
        c = oracle.encode_seq(random_seq(L))
        codes[i, :L] = c
        seqs.append(c)
    got = np.asarray(hash_positions(codes, fam, P))
    assert got.dtype == np.uint64
    for i, c in enumerate(seqs):
        for s in range(h):
            span = len(seeds[s])
            n = len(c) - span + 1
            if n <= 0:
                continue
            fwd, rev = oracle.seed_hashes(c, seeds[s])
            np.testing.assert_array_equal(
                got[i, s, :n], np.minimum(fwd, rev),
                err_msg=f"read {i} seed {s}")


def test_jax_batch_consistency(demo_seeds):
    # same read in different batch slots/paddings hashes identically
    fam = build_seed_family(demo_seeds)
    c = oracle.encode_seq(random_seq(500))
    a = np.zeros((1, 500), dtype=np.uint8); a[0] = c
    b = np.zeros((3, 900), dtype=np.uint8); b[1, :500] = c
    ha = np.asarray(hash_positions(a, fam, 479))
    hb = np.asarray(hash_positions(b, fam, 879))
    np.testing.assert_array_equal(ha[0, :, :479], hb[1, :, :479])
