"""Parity of the sampled (strided-hash) probe grid vs the dense path.

The sampled path (hash_positions(stride=S) + hash_at clamps +
tile_slot_grid_sampled) must produce bit-identical (slots, frame_ok) to the
dense path (hash_positions + tile_slot_grid) for any read lengths, including
partial last tiles whose stale-tail clamp frames are data-dependent
(multiLensfrHashIterator.hpp:49-67 lockstep semantics).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from goldrush_jax.mibf import mibf as dm
from goldrush_jax.ops.nthash import build_seed_family, hash_at, hash_positions
from goldrush_jax.ops.seeds import make_seed_pattern

SEEDS = make_seed_pattern("10111011", 8, 6, 3)
FAM = build_seed_family(SEEDS)


def _params(stride, size=4093, tile_length=40):
    return dm.MibfParams(size=size, h=3, k=8, spans=(8, 9, 10),
                         tile_length=tile_length, threshold=2, block_size=3,
                         frame_stride=stride)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_sampled_grid_matches_dense(stride):
    rng = np.random.default_rng(7)
    B, T = 5, 6
    TL = 40
    P = T * TL
    L = P + TL
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    # lengths exercise: exact multiples, partial tails of every residue class
    lengths = np.array([P, P - 1, 3 * TL + 17, TL + stride, 2 * TL + 39],
                       dtype=np.int32)
    p = _params(stride, tile_length=TL)
    dense = hash_positions(jnp.asarray(codes), FAM, P)
    slots_d, ok_d = dm.tile_slot_grid(dense, jnp.asarray(lengths), p, T)

    hs = hash_positions(jnp.asarray(codes), FAM, P, stride=stride)
    _, _, clamp_pos = dm.clamp_tile_geometry(jnp.asarray(lengths), p, T)
    hc = hash_at(jnp.asarray(codes), FAM, clamp_pos)
    slots_s, ok_s = dm.tile_slot_grid_sampled(hs, hc, jnp.asarray(lengths),
                                              p, T)
    np.testing.assert_array_equal(np.asarray(ok_d), np.asarray(ok_s))
    np.testing.assert_array_equal(np.asarray(slots_d), np.asarray(slots_s))


def test_strided_hashes_match_dense_subsample():
    rng = np.random.default_rng(3)
    B, P, S = 3, 256, 8
    codes = rng.integers(0, 4, (B, P + 64)).astype(np.uint8)
    dense = np.asarray(hash_positions(jnp.asarray(codes), FAM, P))
    strided = np.asarray(hash_positions(jnp.asarray(codes), FAM, P, stride=S))
    np.testing.assert_array_equal(dense[:, :, ::S], strided)


def test_hash_at_matches_dense_points():
    rng = np.random.default_rng(11)
    B, P = 4, 200
    codes = rng.integers(0, 4, (B, P + 64)).astype(np.uint8)
    dense = np.asarray(hash_positions(jnp.asarray(codes), FAM, P))
    pos = rng.integers(0, P, (B, 3, 17)).astype(np.int32)
    got = np.asarray(hash_at(jnp.asarray(codes), FAM, jnp.asarray(pos)))
    want = np.take_along_axis(dense, pos, axis=2)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("stride", [4, 8])
def test_lasttile_fastpath_matches_dense(stride):
    """stride >= h path: clamp fix-ups restricted to the last tile must stay
    bit-identical to the dense grid for every length residue class."""
    from goldrush_jax.ops.nthash import hash_sampled
    rng = np.random.default_rng(17)
    B, T, TL = 8, 5, 40
    P = T * TL
    codes = rng.integers(0, 4, (B, P + TL)).astype(np.uint8)
    lengths = np.array([P, P - 1, P - 2, 4 * TL + 1, 3 * TL + 39,
                        2 * TL + 5, TL, TL + stride - 1], dtype=np.int32)
    p = _params(stride, tile_length=TL)
    dense = hash_positions(jnp.asarray(codes), FAM, P)
    slots_d, ok_d = dm.tile_slot_grid(dense, jnp.asarray(lengths), p, T)
    clamp = dm.clamp_last_tile_positions(jnp.asarray(lengths), p)
    hs, hc = hash_sampled(jnp.asarray(codes), FAM, P, stride, clamp)
    slots_s, ok_s = dm.tile_slot_grid_sampled_lt(
        hs, hc, jnp.asarray(lengths), p, T)
    np.testing.assert_array_equal(np.asarray(ok_d), np.asarray(ok_s))
    np.testing.assert_array_equal(np.asarray(slots_d), np.asarray(slots_s))


def test_hash_sampled_matches_separate():
    from goldrush_jax.ops.nthash import hash_sampled
    rng = np.random.default_rng(23)
    B, P, S = 3, 240, 8
    codes = rng.integers(0, 4, (B, P + 64)).astype(np.uint8)
    pos = rng.integers(0, P, (B, 3, 5)).astype(np.int32)
    hs, hc = hash_sampled(jnp.asarray(codes), FAM, P, S, jnp.asarray(pos))
    np.testing.assert_array_equal(
        np.asarray(hash_positions(jnp.asarray(codes), FAM, P, stride=S)),
        np.asarray(hs))
    np.testing.assert_array_equal(
        np.asarray(hash_at(jnp.asarray(codes), FAM, jnp.asarray(pos))),
        np.asarray(hc))


def test_build_slot_grid_dispatch():
    rng = np.random.default_rng(5)
    B, T, TL = 2, 4, 40
    codes = rng.integers(0, 4, (B, T * TL + TL)).astype(np.uint8)
    lengths = np.array([T * TL, 2 * TL + 13], dtype=np.int32)
    p1 = _params(1, tile_length=TL)
    p4 = _params(4, tile_length=TL)
    s1, ok1 = dm.build_slot_grid(jnp.asarray(codes), jnp.asarray(lengths),
                                 FAM, p1, T)
    s4, ok4 = dm.build_slot_grid(jnp.asarray(codes), jnp.asarray(lengths),
                                 FAM, p4, T)
    # stride-4 grid == stride-1 grid subsampled at multiples of 4 within tiles
    F1 = TL
    idx = np.add.outer(np.arange(T) * F1, np.arange(0, TL, 4)).reshape(-1)
    np.testing.assert_array_equal(np.asarray(s1)[:, :, idx], np.asarray(s4))
    np.testing.assert_array_equal(np.asarray(ok1)[:, idx], np.asarray(ok4))
