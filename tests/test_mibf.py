"""miBF parity: device kernels (fill/probe/vote/insert) vs the NumPy oracle,
wired through the real hashing pipeline so the tile/frame grid mapping is
covered too."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from goldrush_jax.ops.seeds import make_seed_pattern
from goldrush_jax.ops import nthash_np as onthash
from goldrush_jax.ops.nthash import build_seed_family, hash_positions
from goldrush_jax.mibf import mibf as dm
from goldrush_jax.mibf.mibf_np import MibfOracle, fastrange64

RNG = np.random.default_rng(123)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
SEEDS = make_seed_pattern("1011011110110111101101", 22, 16, 3)
FAM = build_seed_family(SEEDS)
SIZE = 100003          # deliberately not a power of two
TL = 100               # small tiles keep the oracle fast
PARAMS = dm.MibfParams(size=SIZE, h=3, k=22, spans=(22, 23, 24),
                       tile_length=TL, threshold=4, block_size=3, vote_topk=8)


def rand_codes(n):
    return RNG.integers(0, 4, n).astype(np.uint8)


def make_batch(lengths, pad=None):
    pad = pad or max(lengths)
    codes = np.zeros((len(lengths), pad), dtype=np.uint8)
    reads = []
    for i, L in enumerate(lengths):
        c = rand_codes(L)
        codes[i, :L] = c
        reads.append(c)
    return codes, np.array(lengths, dtype=np.int32), reads


def device_grid(codes, lengths, T):
    P = T * TL
    hashes = hash_positions(codes, FAM, P)
    return dm.tile_slot_grid(hashes, jnp.asarray(lengths), PARAMS, T)


def test_fastrange_parity():
    h = RNG.integers(0, 2 ** 63, 1000, dtype=np.int64).astype(np.uint64)
    got = np.asarray(dm.fastrange(jnp.asarray(h), SIZE))
    np.testing.assert_array_equal(got, fastrange64(h, SIZE))
    assert got.max() < SIZE


def test_slot_grid_matches_oracle_tiling():
    lengths = [505, 423, 150]
    codes, lens, reads = make_batch(lengths)
    T = max(lengths) // TL
    F = TL
    slots, frame_ok = device_grid(codes, lens, T)
    slots, frame_ok = np.asarray(slots), np.asarray(frame_ok)
    for b, read in enumerate(reads):
        tiles = onthash.tile_frame_hashes(read, SEEDS, TL)
        assert len(tiles) == lengths[b] // TL
        for t in range(T):
            lo = t * F
            if t < len(tiles):
                flat = tiles[t]
                F_t = len(flat) // 3
                want = fastrange64(flat, SIZE).reshape(F_t, 3)
                assert frame_ok[b, lo:lo + F_t].all()
                assert not frame_ok[b, lo + F_t:lo + F].any()
                for s in range(3):
                    np.testing.assert_array_equal(
                        slots[b, s, lo:lo + F_t], want[:, s])
                assert (slots[b, :, lo + F_t:lo + F] == SIZE).all()
            else:
                assert not frame_ok[b, lo:lo + F].any()
                assert (slots[b, :, lo:lo + F] == SIZE).all()


def test_fill_presence_parity():
    codes, lens, reads = make_batch([505, 333])
    P = 505 - 21
    hashes = hash_positions(codes, FAM, P)
    # validity of whole-read positions: stale-tail clamping applies at the
    # read level for pass 1 (insertBV iterates the lockstep iterator)
    oracle = MibfOracle(SIZE)
    for read in reads:
        canon = onthash.multi_seed_canonical(read, SEEDS)
        oracle.fill_presence(canon)
    # device: emulate lockstep by clamping per-seed positions the same way
    valid = np.zeros((2, 3, P), dtype=bool)
    hs = np.asarray(hashes).copy()
    for b, read in enumerate(reads):
        for s in range(3):
            n = len(read) - len(SEEDS[s]) + 1
            ptot = len(read) - 22 + 1
            valid[b, s, :ptot] = True
            hs[b, s, n:ptot] = hs[b, s, n - 1]   # stale tail
    words = dm.fill_presence(jnp.zeros(SIZE + 1, dtype=jnp.uint32),
                             jnp.asarray(hs), jnp.asarray(valid), SIZE)
    np.testing.assert_array_equal(np.asarray(words)[:SIZE],
                                  oracle.words[:SIZE])


def _oracle_vote_summary(oracle, tile_flat, K, threshold):
    votes = oracle.tile_votes(tile_flat, 3)
    if votes:
        best = max(votes.items(), key=lambda kv: (kv[1], -kv[0]))
        curr_id, top_count = best[0], best[1]
    else:
        curr_id, top_count = 0, 0
    cand = sorted(((i, c) for i, c in votes.items() if c > 2),
                  key=lambda kv: (-kv[1], kv[0]))
    return curr_id, top_count, cand[:K], max(len(cand) - K, 0)


def test_probe_vote_and_insert_parity():
    # build state: presence from a pool of reads, then interleave inserts and
    # queries, comparing against the oracle at every step
    pool = [rand_codes(400) for _ in range(6)]
    oracle = MibfOracle(SIZE)
    for r in pool:
        oracle.fill_presence(onthash.multi_seed_canonical(r, SEEDS))
    state = dm.init_state(PARAMS)
    words = state.words
    for r in pool:
        canon = onthash.multi_seed_canonical(r, SEEDS)
        words = dm.fill_presence(words, jnp.asarray(canon),
                                 jnp.ones(canon.shape, bool), SIZE)
    state = dm.MibfState(words=words, counts=state.counts)
    np.testing.assert_array_equal(np.asarray(state.words)[:SIZE],
                                  oracle.words[:SIZE])

    T = 4
    base_id = 1
    for step in range(4):
        read = pool[step]                      # reads overlapping the pool
        codes = read[None, :]
        lens = np.array([len(read)], dtype=np.int32)
        slots, frame_ok = device_grid(codes, lens, T)
        # --- votes must match oracle ---
        res = dm.probe_and_vote(state.words, slots, frame_ok, PARAMS,
                                num_tiles=T)
        tiles = onthash.tile_frame_hashes(read, SEEDS, TL)
        oq = oh = om = 0
        for t, flat in enumerate(tiles):
            cid, tc, cand, over = _oracle_vote_summary(
                oracle, flat, PARAMS.vote_topk, PARAMS.threshold)
            assert int(res.curr_id[0, t]) == cid, (step, t)
            assert int(res.top_count[0, t]) == tc, (step, t)
            got_cand = [(int(i), int(c)) for i, c in
                        zip(np.asarray(res.cand_ids[0, t]),
                            np.asarray(res.cand_counts[0, t])) if c > 0]
            assert got_cand == cand, (step, t)
            assert int(res.overflow[0, t]) == over
            want_bool = tc > 2 and tc > PARAMS.threshold
            assert bool(res.bool_init[0, t]) == want_bool
            q, h, m = oracle.counters_for_tile(flat, 3)
            oq, oh, om = oq + q, oh + h, om + m
        assert int(res.queries[0]) == oq
        assert int(res.hits[0]) == oh
        assert int(res.misses[0]) == om
        # --- insert the read whole (untrimmed path) ---
        num_tiles = len(read) // TL
        bs = PARAMS.block_size
        m = 0
        while m * bs < num_tiles:
            lo, hi = m * bs, min((m + 1) * bs, num_tiles)
            flat = np.concatenate(tiles[lo:hi])
            oracle.insert_block(flat, base_id + m)
            m += 1
        state = dm.insert_read(
            state, slots[0], jnp.int32(0), jnp.int32(num_tiles - 1),
            jnp.uint32(base_id), jnp.asarray(False), PARAMS, max_blocks=4,
            num_tiles=T)
        base_id += (num_tiles + bs - 1) // bs + 3   # arbitrary id gaps
        np.testing.assert_array_equal(np.asarray(state.words)[:SIZE],
                                      oracle.words[:SIZE], err_msg=f"s{step}")
        np.testing.assert_array_equal(np.asarray(state.counts)[:SIZE],
                                      oracle.counts[:SIZE], err_msg=f"s{step}")

    # --- trimmed insert path with bs edge semantics ---
    read = pool[0]
    tiles = onthash.tile_frame_hashes(read, SEEDS, TL)
    slots, _ = device_grid(read[None, :], np.array([len(read)], np.int32), T)
    lo, hi = 1, 3
    bid = 500
    # oracle emulation of the trimmed loop (goldrush_path.cpp:1041-1053)
    bs = PARAMS.block_size
    block_start = lo
    while block_start <= hi:
        block_end = min(block_start + bs - 1, hi)
        cid = bid + (block_start - lo + 1) // bs
        oracle.insert_block(np.concatenate(tiles[block_start:block_end + 1]),
                            cid)
        block_start += bs
    state = dm.insert_read(state, slots[0], jnp.int32(lo), jnp.int32(hi),
                           jnp.uint32(bid), jnp.asarray(True), PARAMS,
                           max_blocks=4, num_tiles=T)
    np.testing.assert_array_equal(np.asarray(state.words)[:SIZE],
                                  oracle.words[:SIZE])
    np.testing.assert_array_equal(np.asarray(state.counts)[:SIZE],
                                  oracle.counts[:SIZE])

    # --- rotation reset keeps presence only ---
    oracle.reset_ids()
    state = dm.reset_ids(state)
    np.testing.assert_array_equal(np.asarray(state.words)[:SIZE],
                                  oracle.words[:SIZE])
    assert int(np.asarray(state.counts).sum()) == 0


def test_probe_seeds_subset_matches_truncated_grid():
    """probe_seeds=m must equal probing a grid that only contains the first
    m seeds (gathers, atRank gate, votes, counters all restricted)."""
    import dataclasses
    codes, lengths, _ = make_batch([450, 300])
    T = 5
    slots, ok = device_grid(jnp.asarray(codes), lengths, T)
    words = jnp.asarray(
        RNG.integers(0, 1 << 31, SIZE + 1).astype(np.uint32))
    p1 = dataclasses.replace(PARAMS, probe_seeds=1)
    got = dm.probe_and_vote(words, slots, ok, p1, num_tiles=T)
    want = dm.probe_and_vote(words, slots[:, :1, :], ok, PARAMS, num_tiles=T)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
