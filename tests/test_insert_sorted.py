"""One-pass sorted-key insert == sequential per-block insert (bit-exact)."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from goldrush_jax.mibf import mibf as dm
from goldrush_jax.mibf import compressed as cz


def make_params(size=10_007, T=12, TL=50):
    return dm.MibfParams(size=size, h=3, k=22, spans=(22, 23, 24),
                         tile_length=TL, threshold=3, block_size=4,
                         vote_topk=8)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lo,hi,trimmed", [(0, 11, False), (3, 9, True),
                                           (1, 0, False), (5, 5, True)])
def test_sorted_insert_matches_blockwise(seed, lo, hi, trimmed):
    params = make_params()
    T, TL = 12, 50
    F = TL
    rng = np.random.default_rng(seed)
    # duplicate-heavy slot grid incl. sentinel padding
    slots = rng.integers(0, params.size // 50, (3, T * F)).astype(np.int32)
    slots[:, -37:] = params.size
    slots[1, 100:140] = slots[0, 100:140]       # cross-seed duplicates
    state0 = dm.MibfState(
        words=jnp.asarray(rng.integers(0, 1 << 31, params.size + 1,
                                       dtype=np.uint32)),
        counts=jnp.asarray(rng.integers(0, 5, params.size + 1,
                                        dtype=np.uint32)))
    base = np.uint32(7)
    ref = dm.insert_read(state0, jnp.asarray(slots), jnp.int32(lo),
                         jnp.int32(hi), base, jnp.asarray(trimmed),
                         params, max_blocks=T // 4 + 1, num_tiles=T)
    keys = dm.build_insert_keys(jnp.asarray(slots), T)
    got = dm.insert_read_sorted(state0, keys, jnp.int32(lo), jnp.int32(hi),
                                base, jnp.asarray(trimmed),
                                jnp.asarray(True), params, num_tiles=T)
    # the sentinel slot differs only by historical scribbles; compare reals
    np.testing.assert_array_equal(np.asarray(got.words)[:params.size],
                                  np.asarray(ref.words)[:params.size])
    np.testing.assert_array_equal(np.asarray(got.counts)[:params.size],
                                  np.asarray(ref.counts)[:params.size])


def test_sorted_insert_inactive_is_noop():
    params = make_params()
    T = 12
    rng = np.random.default_rng(3)
    slots = rng.integers(0, params.size, (3, T * 50)).astype(np.int32)
    state0 = dm.init_state(params)
    keys = dm.build_insert_keys(jnp.asarray(slots), T)
    got = dm.insert_read_sorted(state0, keys, jnp.int32(0), jnp.int32(T - 1),
                                jnp.uint32(1), jnp.asarray(False),
                                jnp.asarray(False), params, num_tiles=T)
    np.testing.assert_array_equal(np.asarray(got.words),
                                  np.asarray(state0.words))
    np.testing.assert_array_equal(np.asarray(got.counts),
                                  np.asarray(state0.counts))


@pytest.mark.parametrize("lo,hi,trimmed", [(0, 9, False), (2, 7, True)])
def test_sorted_insert_compressed_matches_blockwise(lo, hi, trimmed):
    params = make_params(size=5_003, T=10)
    T, TL = 10, 50
    rng = np.random.default_rng(4)
    presence = np.zeros(params.size + 1, dtype=np.uint8)
    occupied = rng.choice(params.size, size=params.size // 8, replace=False)
    presence[occupied] = 1
    state0 = cz.freeze(presence, params.size)
    state0 = cz.CompressedState(
        bitrank=state0.bitrank, supers=state0.supers,
        ids=jnp.asarray(rng.integers(0, 1 << 20, state0.ids.shape[0],
                                     dtype=np.uint32)),
        counts=jnp.asarray(rng.integers(0, 4, state0.counts.shape[0],
                                        dtype=np.uint32)))
    slots = rng.integers(0, params.size, (3, T * TL)).astype(np.int32)
    slots[:, -20:] = params.size
    base = np.uint32(11)
    ref = cz.insert_read(state0, jnp.asarray(slots), jnp.int32(lo),
                         jnp.int32(hi), base, jnp.asarray(trimmed),
                         params, max_blocks=T // 4 + 1, num_tiles=T)
    keys = cz.build_insert_keys(state0, jnp.asarray(slots), params, T)
    got = cz.insert_read_sorted(state0, keys, jnp.int32(lo), jnp.int32(hi),
                                base, jnp.asarray(trimmed),
                                jnp.asarray(True), params, num_tiles=T)
    pop = state0.ids.shape[0] - 1
    np.testing.assert_array_equal(np.asarray(got.ids)[:pop],
                                  np.asarray(ref.ids)[:pop])
    np.testing.assert_array_equal(np.asarray(got.counts)[:pop],
                                  np.asarray(ref.counts)[:pop])
