"""Rank-compressed miBF: memory parity with the reference at genome scale.

The direct mode stores a uint32 word per *slot* (4 bytes/slot — simple and
fastest, but 32x the reference's bit-per-slot presence structure).  This
mode reproduces the reference layout (MIBloomFilter.hpp: interleaved
bitvector + rank -> dense ID array indexed by rank):

  construction: presence fills a transient byte-per-slot array (sharded at
    scale), then ``freeze`` packs it into 32-bit words with an interleaved
    per-word relative rank and per-2^32-slot superblock ranks — the analog
    of MIBFConstructSupport::setup() (hpp:165-170);
  query: slot -> one uint64 gather fetches (bits32 | rel_rank32), rank =
    super + rel + popcount(bits below slot), then one uint32 gather of
    ids[rank];
  insert: identical reservoir rule, with the counter/accept keyed on the
    *rank* exactly like the reference (MIBFConstructSupport.hpp:274-282).

Memory at human scale (G=3e9, o=0.1): ~61e9 slots -> 15.3 GB bit+rank
array + 2 x 24.4 GB rank-indexed ids/counts, banked across several
devices (model_shards); the direct mode would need 488 GB.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .mibf import (ID_MASK, PRESENT_BIT, SAT_BIT, MibfParams, VoteResult,
                   slot_of)

SUPER_BITS = 32          # slots per superblock = 2^32


class CompressedState(NamedTuple):
    bitrank: jax.Array     # uint64 [ceil(size/32)+1]: lo32 bits, hi32 rel rank
    supers: jax.Array      # uint64 [n_super]
    ids: jax.Array         # uint32 [pop+1]  (rank-indexed; last = sentinel)
    counts: jax.Array      # uint32 [pop+1]


FILL_COLS = 1 << 26     # transient presence row width (64 MB): rows keep
                        # every dimension far below 2^32 elements at
                        # billion-slot genome sizings


def fill_rows(size: int) -> int:
    return -(-(size + 2) // FILL_COLS)


def rank_alloc(size: int) -> int:
    """Deterministic rank-array allocation for a filter sized at the
    calcOptimalSize occupancy target (0.1): pop rarely exceeds 0.105*size;
    the 1024 rounding keeps mesh axes dividing the banked sharding.  A
    deterministic shape lets the consume executable be compiled (prewarmed)
    before pass 1 finishes."""
    return -(-int(size * 0.105 + 2) // 1024) * 1024


def fill_bytes(presence: jax.Array, hashes: jax.Array, valid: jax.Array,
               size: int, slot_mode: str = "fastrange") -> jax.Array:
    """Pass-1 presence into a transient 2-D byte-per-slot array
    [rows, FILL_COLS] (flat slot s lives at [s >> 26, s & (2^26-1)]);
    sorted + deduped so the scatter writes each slot once per batch.

    The scatter itself is 1-D over the flattened array: XLA's 2-D
    row/col scatter lowers to the general path, while the flat index IS
    the slot."""
    R, C = presence.shape
    # 32-bit sort/scatter indices whenever the flat array allows (half
    # the key bytes of an i64 sort); beyond 2^31 flat slots the filter is
    # banked anyway
    dt = jnp.int32 if R * C < 2 ** 31 else jnp.int64
    slots = slot_of(hashes.reshape(-1), size, slot_mode)
    slots = jnp.where(valid.reshape(-1), slots, jnp.uint64(size))
    s = jax.lax.sort(slots.astype(dt))
    prev = jnp.concatenate([jnp.full((1,), -1, dtype=s.dtype), s[:-1]])
    u_first = s != prev
    idx = jnp.where(u_first, s, jnp.asarray(R, dt) * C)
    flat = presence.reshape(-1).at[idx].max(jnp.uint8(1), mode="drop")
    return flat.reshape(R, C)


def freeze(presence: np.ndarray | jax.Array, size: int) -> CompressedState:
    """Pack presence bytes -> (bits | rel-rank) words + superblocks and
    allocate the rank-indexed ID/counter arrays (setup() + getEmptyMIBF)."""
    b = np.asarray(presence[:size]).astype(np.uint32)
    nw = -(-size // 32)
    pad = nw * 32 - size
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint32)])
    b = b.reshape(nw, 32)
    bits = (b << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32)
    return _freeze_from_bits(bits, size)


def freeze_device(presence_dev: jax.Array, size: int) -> CompressedState:
    """freeze() for the DEVICE-resident 2-D presence transient — fully on
    device: byte->bit packing, per-word popcounts, the exclusive rank
    cumsum, superblocks and the (bits | rel-rank) assembly are dense XLA
    ops; the host fetches ONE scalar (the total popcount) to size the
    rank-indexed id/counter allocation.

    Beyond 2^32 total slots the filter routes to the banked mode
    (model_shards >= 2) where each shard stays under the index limits."""
    nw = -(-size // 32)

    @jax.jit
    def pack(presence):
        flat = (presence.reshape(-1) != 0)
        n32 = flat.shape[0] // 32
        b = flat[: n32 * 32].reshape(n32, 32)
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
        bits = (b.astype(jnp.uint32) * weights[None, :]).sum(
            axis=1, dtype=jnp.uint32)[:nw]
        return _rank_from_bits(bits, size, nw)

    bitrank, supers, pop_d = pack(presence_dev)
    return _assemble_state(bitrank, supers, int(pop_d), size)


def freeze_device_words(words: jax.Array, size: int) -> CompressedState:
    """freeze() from a DIRECT-layout presence fill: ``words`` is the flat
    uint32 slot array whose bit 30 (PRESENT_BIT) was scatter-filled by
    mibf.fill_presence.  The non-banked compressed engine fills through
    this path — one flat u32 presence scatter instead of the byte-row
    transient — then packs/ranks on device like freeze_device."""
    nw = -(-size // 32)

    @jax.jit
    def pack(words):
        # words.alloc is a multiple of 1024 >= size+1, hence >= nw*32
        b = ((words[: nw * 32] >> jnp.uint32(30)) & 1).reshape(nw, 32)
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
        bits = (b * weights[None, :]).sum(axis=1, dtype=jnp.uint32)
        return _rank_from_bits(bits, size, nw)

    bitrank, supers, pop_d = pack(words)
    return _assemble_state(bitrank, supers, int(pop_d), size)


def _rank_from_bits(bits, size, nw):
    """Device-side rank structure from packed presence bits (traced)."""
    if size % 32:
        mask = jnp.uint32((1 << (size % 32)) - 1)
        bits = bits.at[-1].set(bits[-1] & mask)
    pops = jax.lax.population_count(bits).astype(jnp.int64)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int64), jnp.cumsum(pops)[:-1]])
    pop = cum[-1] + pops[-1]
    words_per_super = 1 << (SUPER_BITS - 5)
    n_super = max(-(-nw // words_per_super), 1)
    super_base = cum[:: words_per_super][:n_super]
    rel = (cum - jnp.repeat(super_base, words_per_super,
                            total_repeat_length=n_super *
                            words_per_super)[:nw]).astype(jnp.uint64)
    bitrank = rel << jnp.uint64(32) | bits.astype(jnp.uint64)
    bitrank = jnp.concatenate([bitrank, jnp.zeros(1, jnp.uint64)])
    return bitrank, super_base.astype(jnp.uint64), pop


def _assemble_state(bitrank, supers, pop: int, size: int) -> CompressedState:
    # prefer the size-DETERMINISTIC allocation (rank_alloc) so the consume
    # executable's shapes are known before pass 1 finishes — the fill-time
    # prewarm compiles against them; an unusually dense fill falls back to
    # the pop-based size (different shape -> no prewarm reuse, still works)
    alloc = max(rank_alloc(size), -(-(pop + 1) // 1024) * 1024)
    return CompressedState(
        bitrank=bitrank, supers=supers,
        ids=jnp.zeros(alloc, dtype=jnp.uint32),
        counts=jnp.zeros(alloc, dtype=jnp.uint32),
    )


def _popcount_u32(v: np.ndarray) -> np.ndarray:
    """Vectorized SWAR popcount (no numpy>=2 bitwise_count dependency)."""
    v = v.astype(np.uint32)
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


def _freeze_from_bits(bits: np.ndarray, size: int) -> CompressedState:
    nw = bits.shape[0]
    pops = _popcount_u32(bits)
    cum = np.zeros(nw, dtype=np.int64)
    np.cumsum(pops[:-1], out=cum[1:])
    pop = int(cum[-1] + pops[-1]) if nw else 0
    words_per_super = 1 << (SUPER_BITS - 5)
    n_super = max(-(-nw // words_per_super), 1)
    super_base = cum[::words_per_super][:n_super].copy()
    rel = (cum - np.repeat(super_base, words_per_super)[:nw]).astype(np.uint64)
    bitrank = rel << np.uint64(32) | bits.astype(np.uint64)
    bitrank = np.concatenate([bitrank, np.zeros(1, np.uint64)])
    # rank arrays padded to a 1024 multiple so mesh axes divide the banked
    # sharding; the sentinel rank is the LAST index (ids.shape[0]-1 -- all
    # consumers derive it from the shape), real ranks stay < pop
    alloc = -(-(pop + 1) // 1024) * 1024
    return CompressedState(
        bitrank=jnp.asarray(bitrank),
        supers=jnp.asarray(super_base.astype(np.uint64)),
        ids=jnp.zeros(alloc, dtype=jnp.uint32),
        counts=jnp.zeros(alloc, dtype=jnp.uint32),
    )


def _rank_lookup(state: CompressedState, slots: jax.Array, size: int):
    """(present bool, rank) for slot indices (sentinel -> not present,
    rank = pop sentinel).  Ranks and word indices are int32 whenever the
    arrays allow (half the index bytes of int64)."""
    nw1 = state.bitrank.shape[0]
    widx_dt = jnp.int32 if nw1 < 2 ** 31 else jnp.int64
    word_idx = (slots >> 5).astype(widx_dt)
    in_range = slots < size
    word_idx = jnp.where(in_range, word_idx, jnp.asarray(nw1 - 1, widx_dt))
    e = state.bitrank[word_idx]
    bits = (e & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    bit = (slots & 31).astype(jnp.uint32)
    present = in_range & (((bits >> bit) & 1) == 1)
    below = bits & ((jnp.uint32(1) << bit) - 1)
    rank_dt = jnp.int32 if state.ids.shape[0] < 2 ** 31 else jnp.int64
    rel = (e >> jnp.uint64(32)).astype(rank_dt)
    if state.supers.shape[0] > 1:
        sup = state.supers[(slots >> SUPER_BITS).astype(jnp.int64)
                           .clip(0, state.supers.shape[0] - 1)
                           ].astype(rank_dt)
    else:
        sup = jnp.asarray(0, rank_dt)
    rank = sup + rel + jax.lax.population_count(below).astype(rank_dt)
    pop_sentinel = state.ids.shape[0] - 1
    return present, jnp.where(present, rank,
                              jnp.asarray(pop_sentinel, rank_dt))


@partial(jax.jit, static_argnames=("params", "num_tiles"))
def probe_and_vote(state: CompressedState, slots: jax.Array,
                   frame_ok: jax.Array, params: MibfParams, num_tiles: int
                   ) -> VoteResult:
    """Compressed-mode probe+vote with identical vote semantics to the
    direct kernel (see mibf.probe_and_vote)."""
    B, H_all, TF = slots.shape
    H = params.probe_seeds or H_all          # seeds actually probed (mirrors
    # the direct kernel; see mibf.probe_and_vote probe_seeds semantics)
    # translate each probe into a direct-mode-style word: PRESENT|id
    words = []
    for s in range(H):
        present, rank = _rank_lookup(state, slots[:, s, :], params.size)
        idw = state.ids[rank]
        w = jnp.where(present, PRESENT_BIT | idw, 0).astype(jnp.uint32)
        words.append(w)
    # feed the shared vote pipeline by building a tiny "virtual" gather: the
    # direct kernel gathers words[slot]; here we inline its body post-gather
    return _vote_from_words(words, frame_ok, params, num_tiles, B, H, TF)


def _vote_from_words(ws, frame_ok, params, num_tiles, B, H, TF):
    # mirror of mibf.probe_and_vote after its gathers (kept in sync)
    T = num_tiles
    F = TF // T
    K = params.vote_topk
    present = ws[0] & PRESENT_BIT
    for s in range(1, H):
        present = present & ws[s]
    frame_present = ((present & PRESENT_BIT) != 0) & frame_ok
    id_list = []
    for s in range(H):
        w = ws[s]
        ids = jnp.where(w > SAT_BIT, w & jnp.uint32(~SAT_BIT), w) & ID_MASK
        id_list.append(jnp.where(frame_present, ids, 0))
    queries = frame_ok.sum(axis=1, dtype=jnp.int64)
    hits = jnp.zeros(B, dtype=jnp.int64)
    misses = jnp.zeros(B, dtype=jnp.int64)
    for s in range(H):
        hits += (frame_present & (id_list[s] != 0)).sum(axis=1,
                                                        dtype=jnp.int64)
        misses += (frame_present & (id_list[s] == 0)).sum(axis=1,
                                                          dtype=jnp.int64)
    for j in range(1, H):
        dup = jnp.zeros_like(id_list[j], dtype=bool)
        for i in range(j):
            dup = dup | (id_list[j] == id_list[i])
        id_list[j] = jnp.where(dup, 0, id_list[j])
    votes = jnp.concatenate([v.reshape(B * T, F) for v in id_list], axis=1)
    votes = jnp.sort(votes, axis=1)
    prev = jnp.pad(votes[:, :-1], ((0, 0), (1, 0)))
    is_start = (votes != 0) & (votes != prev)
    idx = jnp.arange(F * H, dtype=jnp.int32)[None, :]
    start_pos = jnp.where(is_start, idx, F * H)
    next_start = jnp.concatenate(
        [jnp.flip(jax.lax.cummin(jnp.flip(start_pos[:, 1:], 1), axis=1), 1),
         jnp.full((B * T, 1), F * H, dtype=jnp.int32)], axis=1)
    run_len = jnp.where(is_start, next_start - idx, 0)
    FH = F * H
    key = jnp.where(
        is_start,
        (jnp.uint64(FH + 1) - run_len.astype(jnp.uint64)) << jnp.uint64(32)
        | votes.astype(jnp.uint64),
        jnp.uint64(0xFFFFFFFFFFFFFFFF))
    key = jax.lax.sort(key, dimension=1)
    top_ids = (key & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    top_counts = jnp.where(
        key == jnp.uint64(0xFFFFFFFFFFFFFFFF), 0,
        (jnp.uint64(FH + 1) - (key >> jnp.uint64(32))).astype(jnp.int64)
    ).astype(jnp.int32)
    top_ids = jnp.where(top_counts > 0, top_ids, 0)
    curr_id = top_ids[:, 0]
    top_count = top_counts[:, 0]
    over2 = top_counts > params.vote_min
    cand_ids = jnp.where(over2[:, :K], top_ids[:, :K], 0)
    cand_counts = jnp.where(over2[:, :K], top_counts[:, :K], 0)
    overflow = jnp.maximum(over2.sum(axis=1) - K, 0).astype(jnp.int32)
    bool_init = (top_count > params.vote_min) & \
        (top_count > params.threshold)
    return VoteResult(
        curr_id=curr_id.reshape(B, T),
        top_count=top_count.reshape(B, T),
        cand_ids=cand_ids.reshape(B, T, K),
        cand_counts=cand_counts.reshape(B, T, K),
        bool_init=bool_init.reshape(B, T),
        overflow=overflow.reshape(B, T),
        queries=queries, hits=hits, misses=misses,
    )


@partial(jax.jit, static_argnames=("params", "max_blocks", "num_tiles"))
def insert_read(state: CompressedState, slots: jax.Array, tile_lo: jax.Array,
                tile_hi: jax.Array, base_id: jax.Array, trimmed: jax.Array,
                params: MibfParams, max_blocks: int, num_tiles: int
                ) -> CompressedState:
    """Sequential per-block reservoir insertion on rank-indexed arrays.

    The accept rule keys on the rank like the reference
    (MIBFConstructSupport.hpp:275: randomSeed = rank ^ id)."""
    H, TF = slots.shape
    T = num_tiles
    F = TF // T
    bs = params.block_size
    pop_sentinel = state.ids.shape[0] - 1

    # slot -> rank once for the whole read (invalid -> sentinel rank)
    present, ranks = _rank_lookup(state, slots, params.size)
    ranks = jnp.where(present, ranks, pop_sentinel)

    def body(m, carry):
        ids_arr, counts = carry
        lo = tile_lo + m * bs
        hi = jnp.minimum(lo + bs - 1, tile_hi)
        block_id = jnp.where(
            trimmed, base_id + (m * bs + 1) // bs, base_id + m
        ).astype(jnp.uint32)
        # slice the block's contiguous frame window (see mibf.insert_read)
        W = min(bs, T) * F
        start = jnp.clip(lo * F, 0, TF - W)
        win = jax.lax.dynamic_slice(ranks, (jnp.int32(0), start), (H, W))
        t_of = (start + jnp.arange(W, dtype=jnp.int32)) // F
        in_block = (t_of >= lo) & (t_of <= hi)
        r = jnp.where(in_block[None, :], win,
                      jnp.asarray(pop_sentinel, dtype=ranks.dtype)).reshape(-1)
        r = jax.lax.sort(r)
        prev = jnp.concatenate([jnp.full((1,), -1, dtype=r.dtype), r[:-1]])
        u_first = (r != prev) & (r != pop_sentinel)
        # rejected writes -> distinct out-of-bounds dummies (dropped): all
        # indices unique, so XLA uses the vectorized scatter (see
        # mibf.insert_read)
        dummy = (jnp.asarray(pop_sentinel + 1, dtype=r.dtype)
                 + jnp.arange(r.shape[0], dtype=r.dtype))
        add_idx = jnp.where(u_first, r, dummy)
        counts = counts.at[add_idx].add(jnp.uint32(1), mode="drop",
                                        unique_indices=True)
        cnt = counts[r]
        rand = (r.astype(jnp.uint32) ^ block_id)
        accept = u_first & ((rand % jnp.maximum(cnt, 1)) == cnt - 1)
        old = ids_arr[r]
        new_word = (old & SAT_BIT) | block_id
        w_idx = jnp.where(accept, r, dummy)
        ids_arr = ids_arr.at[w_idx].set(new_word, mode="drop",
                                        unique_indices=True)
        return ids_arr, counts

    ids_arr, counts = jax.lax.fori_loop(0, max_blocks, body,
                                        (state.ids, state.counts))
    return CompressedState(bitrank=state.bitrank, supers=state.supers,
                           ids=ids_arr, counts=counts)


def build_insert_keys(state: CompressedState, slots: jax.Array,
                      params: MibfParams, num_tiles: int) -> jax.Array:
    """Rank-domain twin of mibf.build_insert_keys: map the full-res slot
    grid to ranks once, pack (rank, tile) sort keys, sort."""
    from .mibf import TILE_BITS
    H, TF = slots.shape[-2], slots.shape[-1]
    F = TF // num_tiles
    pop_sentinel = state.ids.shape[0] - 1
    present, ranks = _rank_lookup(state, slots, params.size)
    ranks = jnp.where(present, ranks, pop_sentinel)
    t_of = (jnp.arange(TF, dtype=jnp.int32) // F).astype(jnp.uint64)
    keys = (ranks.astype(jnp.uint64) << jnp.uint64(TILE_BITS)) | t_of
    return jax.lax.sort(keys.reshape(*slots.shape[:-2], H * TF),
                        dimension=-1)


@partial(jax.jit, static_argnames=("params", "num_tiles", "assume_present"))
def insert_read_sorted(state: CompressedState, keys: jax.Array,
                       tile_lo: jax.Array, tile_hi: jax.Array,
                       base_id: jax.Array, trimmed: jax.Array,
                       active: jax.Array, params: MibfParams,
                       num_tiles: int,
                       assume_present: bool = False) -> CompressedState:
    """One-pass sorted-key insert on rank-indexed arrays (see
    mibf.insert_read_sorted for the algorithm and the in-place scatter
    discipline; accept rule keys on the rank like the reference,
    MIBFConstructSupport.hpp:275).  ``assume_present=True`` writes the
    block id without reading the old entry (saturation is never set by
    goldrush-path)."""
    from .mibf import TILE_BITS
    N = keys.shape[0]
    bs = params.block_size
    pop_sentinel = state.ids.shape[0] - 1
    r = (keys >> jnp.uint64(TILE_BITS)).astype(jnp.int64)
    t = (keys & jnp.uint64((1 << TILE_BITS) - 1)).astype(jnp.int32)
    valid = (r < pop_sentinel) & (t >= tile_lo) & (t <= tile_hi) & active
    m = jnp.where(valid, (t - tile_lo) // bs, 0)
    block_id = jnp.where(
        trimmed, base_id + ((m * bs + 1) // bs).astype(jnp.uint32),
        base_id + m.astype(jnp.uint32))
    prev_valid = jnp.concatenate([jnp.zeros(1, bool), valid[:-1]])
    prev_r = jnp.concatenate([jnp.full(1, -1, jnp.int64), r[:-1]])
    prev_m = jnp.concatenate([jnp.full(1, -1, jnp.int32), m[:-1]])
    new_run = valid & (~prev_valid | (prev_r != r))
    u_first = new_run | (valid & (prev_m != m))
    run_end = valid & jnp.concatenate(
        [~valid[1:] | (r[1:] != r[:-1]), jnp.ones(1, bool)])
    c = jnp.cumsum(u_first.astype(jnp.int32))
    run_base = jax.lax.cummax(jnp.where(new_run, c - 1, jnp.int32(-1)))
    j = jnp.where(valid, c - run_base, 0)
    BIG = jnp.int64(N + 2)
    fseg = jnp.cumsum(jnp.flip(run_end).astype(jnp.int64))
    c_end = jnp.flip(jax.lax.cummax(fseg * BIG + jnp.flip(c)) - fseg * BIG)
    j_total = jnp.where(valid, c_end - run_base, 0)
    ids_arr, counts = state.ids, state.counts
    gather_idx = jnp.where(valid, r, pop_sentinel)
    idx = jnp.arange(N, dtype=jnp.int64)
    dummy = jnp.int64(pop_sentinel + 1) + idx
    # plain scatter-add everywhere (no unique_indices, no .set), as in
    # mibf.insert_read_sorted
    c_idx = jnp.where(run_end, r, dummy)
    counts = counts.at[c_idx].add(j_total.astype(jnp.uint32), mode="drop")
    post = counts[gather_idx]
    cnt = post - j_total.astype(jnp.uint32) + j.astype(jnp.uint32)
    rand = r.astype(jnp.uint32) ^ block_id
    accept = u_first & ((rand % jnp.maximum(cnt, 1)) == cnt - 1)
    enc = fseg * BIG + jnp.flip(jnp.where(accept, idx + 1, 0))
    smax = jnp.flip(jax.lax.cummax(enc) - fseg * BIG) - 1
    is_last = accept & (smax == idx)
    w_idx = jnp.where(is_last, r, dummy)
    old = ids_arr[gather_idx]
    if assume_present:
        new_word = block_id
    else:
        new_word = (old & SAT_BIT) | block_id
    ids_arr = ids_arr.at[w_idx].add(new_word - old, mode="drop")
    return CompressedState(bitrank=state.bitrank, supers=state.supers,
                           ids=ids_arr, counts=counts)


@partial(jax.jit, static_argnames=("params", "num_tiles"))
def insert_read_max(state: CompressedState, slots_ins: jax.Array,
                    tile_lo: jax.Array, tile_hi: jax.Array,
                    base_id: jax.Array, trimmed: jax.Array,
                    params: MibfParams, num_tiles: int) -> jax.Array:
    """Throughput-mode insert on the rank-indexed ids array: one rank
    lookup (gather) + one scatter-max of the block id (max-id-wins; see
    mibf.insert_read_max for the semantics trade).  Returns the new ids
    array only — bitrank/supers/counts are untouched."""
    H, TF = slots_ins.shape
    F = TF // num_tiles
    bs = params.block_size
    pop_sentinel = state.ids.shape[0] - 1
    present, ranks = _rank_lookup(state, slots_ins, params.size)
    t_of = jnp.arange(TF, dtype=jnp.int32) // F
    in_range = (t_of >= tile_lo) & (t_of <= tile_hi)
    valid = in_range[None, :] & present
    m = jnp.where(in_range, (t_of - tile_lo) // bs, 0)
    block_id = jnp.where(
        trimmed, base_id + ((m * bs + 1) // bs).astype(jnp.uint32),
        base_id + m.astype(jnp.uint32))
    idx = jnp.where(valid, ranks,
                    jnp.asarray(pop_sentinel + 1, ranks.dtype))
    vals = jnp.broadcast_to(block_id[None, :], (H, TF))
    return state.ids.at[idx.reshape(-1)].max(vals.reshape(-1), mode="drop")


def rank_grid(state: CompressedState, slots: jax.Array, size: int
              ) -> jax.Array:
    """Map a slot grid through the FROZEN rank structure once: int32 ranks
    with the pop sentinel for absent/invalid slots.

    The rank structure never changes after freeze(), so grids mapped here
    feed any number of later probes/inserts as pure id-table gathers and
    scatters — the sequential consume scan's per-read rank lookups (~40%
    of its per-recruit cost) move into one batched data-parallel pass."""
    sent = state.ids.shape[0] - 1
    present, ranks = _rank_lookup(state, slots, size)
    return jnp.where(present, ranks, sent).astype(jnp.int32)


def probe_and_vote_ranks(ids_table: jax.Array, ranks: jax.Array,
                         frame_ok: jax.Array, params: MibfParams,
                         num_tiles: int) -> VoteResult:
    """probe_and_vote fed by a PRE-RANKED grid: one uint32 gather per seed
    into the (small) id table, then the shared vote pipeline."""
    B, H_all, TF = ranks.shape
    H = params.probe_seeds or H_all
    sent = ids_table.shape[0] - 1
    ws = []
    for s in range(H):
        r = ranks[:, s, :]
        w = jnp.where(r < sent, PRESENT_BIT | ids_table[r], 0)
        ws.append(w.astype(jnp.uint32))
    return _vote_from_words(ws, frame_ok, params, num_tiles, B, H, TF)


def insert_ranks_max(ids_table: jax.Array, ranks: jax.Array,
                     tile_lo: jax.Array, tile_hi: jax.Array,
                     base_id: jax.Array, trimmed: jax.Array,
                     params: MibfParams, num_tiles: int) -> jax.Array:
    """insert_read_max on a PRE-RANKED grid: the insert reduces to ONE
    scatter-max of block ids into the id table with zero per-recruit rank
    work."""
    H, TF = ranks.shape
    F = TF // num_tiles
    bs = params.block_size
    sent = ids_table.shape[0] - 1
    t_of = jnp.arange(TF, dtype=jnp.int32) // F
    in_range = (t_of >= tile_lo) & (t_of <= tile_hi)
    m = jnp.where(in_range, (t_of - tile_lo) // bs, 0)
    block_id = jnp.where(
        trimmed, base_id + ((m * bs + 1) // bs).astype(jnp.uint32),
        base_id + m.astype(jnp.uint32))
    valid = in_range[None, :] & (ranks < sent)
    idx = jnp.where(valid, ranks, jnp.int32(ids_table.shape[0]))
    vals = jnp.broadcast_to(block_id[None, :], (H, TF))
    return ids_table.at[idx.reshape(-1)].max(vals.reshape(-1), mode="drop")


def reset_ids(state: CompressedState) -> CompressedState:
    return CompressedState(bitrank=state.bitrank, supers=state.supers,
                           ids=jnp.zeros_like(state.ids),
                           counts=jnp.zeros_like(state.counts))
