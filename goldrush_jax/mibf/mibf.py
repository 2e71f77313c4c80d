"""Device-side multi-index Bloom filter: flat HBM arrays + batched kernels.

Device-first redesign of the reference miBF (MIBloomFilter.hpp /
MIBFConstructSupport.hpp).  The pointer-chasing interleaved-bitvector +
rank-select structure becomes two dense uint32 arrays indexed directly by
slot ("direct" mode; a rank-compressed mode for memory parity at human scale
is layered on later):

  words[slot]  = [31: saturation][30: presence][29..0: block ID]
  counts[slot] = reservoir counter (MIBFConstructSupport.hpp m_counts)

Queries are pure gathers; pass-1 construction is a scatter-max of the
presence bit; insertion is a per-block sort/dedupe + scatter that reproduces
the reference's deterministic reservoir accept rule exactly (see
mibf_np.MibfOracle, the behavioral oracle these kernels are tested against).

Vote counting (goldrush_path.cpp:529-634) is reformulated as a batched
sort + run-length pass over each tile's [frames x h] vote matrix, yielding
for every tile: the max-count ID (smallest ID wins ties, matching std::map
iteration order), the count>2 candidate list truncated to K slots, and the
query/hit/miss counter deltas.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

SAT_BIT = np.uint32(1 << 31)
PRESENT_BIT = np.uint32(1 << 30)
ID_MASK = np.uint32((1 << 30) - 1)


@dataclasses.dataclass(frozen=True)
class MibfParams:
    """Static geometry of the filter + classifier (jit-static)."""
    size: int                  # number of real slots (slot `size` = sentinel)
    h: int                     # number of seed patterns
    k: int                     # span of seed 0
    spans: tuple[int, ...]     # per-seed spans
    tile_length: int = 1000
    threshold: int = 10        # -x
    block_size: int = 10       # -b
    vote_topk: int = 16
    # throughput mode: probe every frame_stride-th frame of a tile instead of
    # all tile_length frames (the reference brute-forces every position,
    # goldrush_path.cpp:559-561; the probe gathers bound the classify
    # rate, and sampled voting with proportionally scaled thresholds keeps
    # the classifier's operating point).  Insertion always uses every frame,
    # so sampled queries of later reads still hit recruited regions at any
    # alignment offset.  stride=1 == exact reference semantics.
    frame_stride: int = 1
    vote_min: int = 2          # candidate gate "count > vote_min"
                               # (reference: count > 2, goldrush_path.cpp:616)
    # throughput mode: probe only the first `probe_seeds` seed patterns per
    # frame (0 = all h).  Within a frame the reference DEDUPES same-ID votes
    # across seeds (std::set unique_ids, goldrush_path.cpp:570-605), so for
    # a true matching region the extra seeds contribute ~nothing to the
    # per-tile count — they exist for the atRank AND-gate strictness and for
    # error redundancy.  Probing fewer seeds scales the gather count (the
    # single-chip reads/s ceiling) by probe_seeds/h with the same per-tile
    # vote operating point; thresholds need no rescaling.  Insertion always
    # uses all h seeds, so sampled queries still see every recruited region.
    # Tradeoff: probing M<h seeds also weakens the h-way presence AND-gate,
    # raising per-frame Bloom false positives from ~occ^h toward ~occ^M; the
    # engine keeps vote_min >= 1 whenever it samples (stride>1) so a single
    # spurious frame vote cannot become a smoothing candidate.
    probe_seeds: int = 0
    # hash -> slot map: "fastrange" (floor(h*size/2^64), one u32-pair multiply
    # — the default) or "mod" (hash % size — the reference's map,
    # MIBloomFilter.hpp:203/340/451; bit-parity mode for diffing goldtigs
    # against the compiled reference binary, see tests/ref_harness/).
    slot_map: str = "fastrange"

    @property
    def idx_dtype(self):
        return jnp.int32 if self.size + 1 < 2 ** 31 else jnp.int64

    @property
    def alloc(self):
        """Array length: size real slots + 1 sentinel, padded to a 1024
        multiple so any mesh axis divides the banked-filter sharding.
        Padding slots are never probed (sentinel stays `size`) and never
        written (rejected scatters route past the array length)."""
        return -(-(self.size + 1) // 1024) * 1024


class MibfState(NamedTuple):
    words: jax.Array           # uint32 [size + 1]
    counts: jax.Array          # uint32 [size + 1]


def init_state(params: MibfParams) -> MibfState:
    return MibfState(
        words=jnp.zeros(params.alloc, dtype=jnp.uint32),
        counts=jnp.zeros(params.alloc, dtype=jnp.uint32),
    )


def fastrange(h: jax.Array, size: int) -> jax.Array:
    """floor(h * size / 2**64) for size < 2**32 — the default slot map
    (multiplies and shifts in place of the reference's 64-bit modulo)."""
    h = h.astype(jnp.uint64)
    s = jnp.uint64(size)
    p1 = (h >> jnp.uint64(32)) * s
    p2 = ((h & jnp.uint64(0xFFFFFFFF)) * s) >> jnp.uint64(32)
    return (p1 + p2) >> jnp.uint64(32)


def slot_of(h: jax.Array, size: int, mode: str = "fastrange") -> jax.Array:
    """hash -> slot under the configured map (see MibfParams.slot_map)."""
    if mode == "mod":
        return h.astype(jnp.uint64) % jnp.uint64(size)
    return fastrange(h, size)


def fill_presence(words: jax.Array, hashes: jax.Array, valid: jax.Array,
                  size: int, idx_dtype=jnp.int32,
                  slot_mode: str = "fastrange") -> jax.Array:
    """Pass-1 presence fill (MIBFConstructSupport.hpp:134-147): set the
    presence bit for every valid hash's slot.

    Slots are sorted + deduped first so the scatter has provably unique
    indices — XLA's vectorized scatter path instead of the serialized
    general one (duplicate slots are the common case: every repeated k-mer
    in the batch hits the same slots)."""
    slots = slot_of(hashes.reshape(-1), size, slot_mode)
    slots = jnp.where(valid.reshape(-1), slots, jnp.uint64(size))
    s = jax.lax.sort(slots.astype(idx_dtype))
    prev = jnp.concatenate([jnp.full((1,), -1, dtype=s.dtype), s[:-1]])
    u_first = s != prev
    # rejected writes route past the array length (mode="drop"); the
    # sentinel slot (size) itself may be set by invalid frames — harmless,
    # it is never probed as present (frame_ok masks it)
    dummy = (jnp.asarray(words.shape[0], dtype=s.dtype)
             + jnp.arange(s.shape[0], dtype=s.dtype))
    idx = jnp.where(u_first, s, dummy)
    return words.at[idx].max(jnp.uint32(PRESENT_BIT), mode="drop")


# ---------------------------------------------------------------------------
# tile/frame slot grid
# ---------------------------------------------------------------------------

def position_slots(hashes: jax.Array, size: int, idx_dtype,
                   slot_mode: str = "fastrange") -> jax.Array:
    """Slot-map the whole-read hash array once: uint64 [B,h,P] -> slot
    indices [B,h,P] (no sentinel; masking happens downstream)."""
    return slot_of(hashes, size, slot_mode).astype(idx_dtype)


@partial(jax.jit, static_argnames=("params", "num_tiles_max"))
def tile_slot_grid(hashes: jax.Array, lengths: jax.Array,
                   params: MibfParams, num_tiles_max: int
                   ) -> tuple[jax.Array, jax.Array]:
    """Map whole-read position hashes to the per-tile probe grid.

    hashes: uint64 [B, h, P] canonical hashes (P >= num_tiles_max*tile_length)
    lengths: int32 [B] true read lengths.
    Returns (slots [B, H, T*F] idx_dtype with sentinel for invalid,
             frame_ok [B, T*F] bool) — seed-major so every array keeps a
    large minor dimension (a [..., h] minor axis of size 3 makes every
    vector access mostly padding).

    Tile t covers read[t*TL : t*TL + TL + k - 1] (read_hashing.cpp:44-46);
    frame f of seed s probes global position t*TL + min(f, L_t - span_s) —
    the clamp reproduces the stale-tail lockstep of
    multiLensfrHashIterator.hpp:49-67.  Because that position map is the
    identity everywhere except the <= (span_s - k) stale frames at each
    tile's end, the grid is a plain slice plus a [B, T]-sized fix-up gather
    instead of a full [B, T*F] gather.
    """
    TL, k = params.tile_length, params.k
    S = params.frame_stride
    B = hashes.shape[0]
    T, F, H = num_tiles_max, TL // S, params.h
    P = hashes.shape[2]
    spos = position_slots(hashes, params.size, params.idx_dtype,
                          params.slot_map)
    sentinel = jnp.asarray(params.size, dtype=params.idx_dtype)
    t_idx = jnp.arange(T, dtype=jnp.int32)[:, None]              # [T,1]
    f_idx = jnp.arange(F, dtype=jnp.int32)[None, :] * S          # [1,F] actual
    L = lengths.astype(jnp.int32)[:, None]                       # [B,1]
    tile_len = jnp.minimum(TL + k - 1, L - t_idx.T * TL)         # [B,T]
    num_tiles = L // TL                                          # [B,1]
    frames_t = tile_len - k + 1                                  # [B,T]
    in_read = t_idx.T < num_tiles                                # [B,T]
    frame_ok = (in_read[:, :, None]
                & (f_idx[None, :, :] < frames_t[:, :, None])
                ).reshape(B, T * F)
    slot_list = []
    for s in range(H):
        # strided slice of the identity position map (tile t frame j probes
        # global position t*TL + j*S)
        base = spos[:, s, : T * TL: S]                           # [B, T*F]
        F_ts = frames_t - (params.spans[s] - k)                  # [B,T]
        clamp_idx = jnp.clip(t_idx.T * TL + F_ts - 1, 0, P - 1)
        vals = jnp.take_along_axis(spos[:, s, :], clamp_idx, axis=1)  # [B,T]
        fix = (f_idx[None, :, :] >= jnp.maximum(F_ts, 0)[:, :, None]
               ).reshape(B, T * F)
        vals_exp = jnp.broadcast_to(vals[:, :, None],
                                    (B, T, F)).reshape(B, T * F)
        arr = jnp.where(fix, vals_exp, base)
        slot_list.append(jnp.where(frame_ok, arr, sentinel))
    slots = jnp.stack(slot_list, axis=1)                         # [B, H, TF]
    return slots, frame_ok


def clamp_tile_geometry(lengths: jax.Array, params: MibfParams,
                        num_tiles_max: int):
    """Shared [B, T] tile geometry: (frames_t, in_read, clamp frame pos per
    seed [B, h, T])."""
    TL, k = params.tile_length, params.k
    T = num_tiles_max
    t_idx = jnp.arange(T, dtype=jnp.int32)[None, :]               # [1,T]
    L = lengths.astype(jnp.int32)[:, None]                        # [B,1]
    tile_len = jnp.minimum(TL + k - 1, L - t_idx * TL)            # [B,T]
    num_tiles = L // TL
    frames_t = tile_len - k + 1                                   # [B,T]
    in_read = t_idx < num_tiles
    clamp = []
    for s in range(params.h):
        F_ts = frames_t - (params.spans[s] - k)
        clamp.append(jnp.clip(t_idx * TL + F_ts - 1, 0, None))
    return frames_t, in_read, jnp.stack(clamp, axis=1)            # [B,h,T]


@partial(jax.jit, static_argnames=("params", "num_tiles_max"))
def tile_slot_grid_sampled(h_strided: jax.Array, h_clamp: jax.Array,
                           lengths: jax.Array, params: MibfParams,
                           num_tiles_max: int
                           ) -> tuple[jax.Array, jax.Array]:
    """Sampled-query twin of tile_slot_grid fed by strided hashes.

    h_strided: uint64 [B, h, >= T*F] hashes at global positions 0, S, 2S, ...
    (hash_positions(..., stride=S)); h_clamp: uint64 [B, h, T] hashes at the
    per-tile clamp positions from clamp_tile_geometry (hash_at).  Produces
    bit-identical (slots, frame_ok) to tile_slot_grid on dense hashes, with
    the hashing work reduced ~S-fold upstream.
    """
    TL, k, S = params.tile_length, params.k, params.frame_stride
    B = h_strided.shape[0]
    T, F, H = num_tiles_max, TL // S, params.h
    sentinel = jnp.asarray(params.size, dtype=params.idx_dtype)
    f_idx = jnp.arange(F, dtype=jnp.int32)[None, None, :] * S     # [1,1,F]
    frames_t, in_read, _ = clamp_tile_geometry(lengths, params, T)
    frame_ok = (in_read[:, :, None]
                & (f_idx < frames_t[:, :, None])).reshape(B, T * F)
    spos = slot_of(h_strided[:, :, : T * F], params.size, params.slot_map
                   ).astype(params.idx_dtype)                     # [B,H,TF]
    cvals = slot_of(h_clamp, params.size,
                    params.slot_map).astype(params.idx_dtype)
    slot_list = []
    for s in range(H):
        F_ts = frames_t - (params.spans[s] - k)                   # [B,T]
        fix = (f_idx >= jnp.maximum(F_ts, 0)[:, :, None]).reshape(B, T * F)
        vals_exp = jnp.broadcast_to(cvals[:, s, :, None],
                                    (B, T, F)).reshape(B, T * F)
        arr = jnp.where(fix, vals_exp, spos[:, s, :])
        slot_list.append(jnp.where(frame_ok, arr, sentinel))
    return jnp.stack(slot_list, axis=1), frame_ok


def clamp_last_tile_positions(lengths: jax.Array, params: MibfParams
                              ) -> jax.Array:
    """Clamp frame positions of each read's LAST tile only: int32 [B, h, 1].

    Valid companion to the stride >= h fast path: every non-last in-read
    tile is full (tile_len == TL+k-1), and a full tile's stale-tail frames
    [TL-(span_s-k), TL) contain no multiple of the stride when
    stride > span_s - k for all seeds (i.e. stride >= h)."""
    TL, k = params.tile_length, params.k
    L = lengths.astype(jnp.int32)[:, None]                        # [B,1]
    t = jnp.maximum(L // TL, 1) - 1                               # [B,1]
    tile_len = jnp.minimum(TL + k - 1, L - t * TL)
    frames_t = tile_len - k + 1
    pos = [jnp.clip(t * TL + (frames_t - (params.spans[s] - k)) - 1, 0, None)
           for s in range(params.h)]
    return jnp.stack(pos, axis=1)                                 # [B,h,1]


@partial(jax.jit, static_argnames=("params", "num_tiles_max"))
def tile_slot_grid_sampled_lt(h_strided: jax.Array, h_clamp_last: jax.Array,
                              lengths: jax.Array, params: MibfParams,
                              num_tiles_max: int
                              ) -> tuple[jax.Array, jax.Array]:
    """tile_slot_grid_sampled specialised to stride >= h: clamp fix-ups can
    only occur in each read's last tile, so h_clamp_last is [B, h, 1]."""
    TL, k, S = params.tile_length, params.k, params.frame_stride
    assert S >= params.h
    B = h_strided.shape[0]
    T, F, H = num_tiles_max, TL // S, params.h
    sentinel = jnp.asarray(params.size, dtype=params.idx_dtype)
    f_idx = jnp.arange(F, dtype=jnp.int32)[None, None, :] * S     # [1,1,F]
    t_idx = jnp.arange(T, dtype=jnp.int32)[None, :]               # [1,T]
    L = lengths.astype(jnp.int32)[:, None]
    tile_len = jnp.minimum(TL + k - 1, L - t_idx * TL)
    num_tiles = L // TL
    frames_t = tile_len - k + 1                                   # [B,T]
    in_read = t_idx < num_tiles
    is_last = t_idx == (num_tiles - 1)                            # [B,T]
    frame_ok = (in_read[:, :, None]
                & (f_idx < frames_t[:, :, None])).reshape(B, T * F)
    spos = slot_of(h_strided[:, :, : T * F], params.size, params.slot_map
                   ).astype(params.idx_dtype)
    cvals = slot_of(h_clamp_last[:, :, 0], params.size,
                    params.slot_map).astype(params.idx_dtype)     # [B,H]
    slot_list = []
    for s in range(H):
        F_ts = frames_t - (params.spans[s] - k)
        fix = ((f_idx >= jnp.maximum(F_ts, 0)[:, :, None])
               & is_last[:, :, None]).reshape(B, T * F)
        arr = jnp.where(fix, cvals[:, s, None], spos[:, s, :])
        slot_list.append(jnp.where(frame_ok, arr, sentinel))
    return jnp.stack(slot_list, axis=1), frame_ok


def build_slot_grid(codes: jax.Array, lengths: jax.Array, fam,
                    params: MibfParams, num_tiles_max: int
                    ) -> tuple[jax.Array, jax.Array]:
    """Front-end: codes -> (slots, frame_ok) probe grid, picking the dense or
    sampled hash path by params.frame_stride."""
    from ..ops.nthash import hash_positions, hash_sampled
    P = num_tiles_max * params.tile_length
    S = params.frame_stride
    if S == 1:
        hashes = hash_positions(codes, fam, P)
        return tile_slot_grid(hashes, lengths, params, num_tiles_max)
    if S >= params.h:
        clamp_pos = clamp_last_tile_positions(lengths, params)
        hs, hc = hash_sampled(codes, fam, P, S, clamp_pos)
        return tile_slot_grid_sampled_lt(hs, hc, lengths, params,
                                         num_tiles_max)
    _, _, clamp_pos = clamp_tile_geometry(lengths, params, num_tiles_max)
    hs, hc = hash_sampled(codes, fam, P, S, clamp_pos)
    return tile_slot_grid_sampled(hs, hc, lengths, params, num_tiles_max)


# ---------------------------------------------------------------------------
# probe + vote
# ---------------------------------------------------------------------------

class VoteResult(NamedTuple):
    curr_id: jax.Array      # uint32 [B, T]  max-count id (ties -> smallest)
    top_count: jax.Array    # int32  [B, T]  its count
    cand_ids: jax.Array     # uint32 [B, T, K]  ids with count>2, count desc
    cand_counts: jax.Array  # int32  [B, T, K]
    bool_init: jax.Array    # bool   [B, T]  initial assignment (count>x gate)
    overflow: jax.Array     # int32  [B, T]  candidates dropped beyond K
    queries: jax.Array      # int64  [B]     counter deltas for log parity
    hits: jax.Array         # int64  [B]
    misses: jax.Array       # int64  [B]


@partial(jax.jit, static_argnames=("params", "num_tiles"))
def probe_and_vote(words: jax.Array, slots: jax.Array, frame_ok: jax.Array,
                   params: MibfParams, num_tiles: int) -> VoteResult:
    """Batched miBF probe + per-tile ID voting (goldrush_path.cpp:544-634).

    slots: [B, H, T*F] seed-major probe grid; frame_ok: [B, T*F]."""
    B, H_all, TF = slots.shape
    T = num_tiles
    F = TF // T
    K = params.vote_topk
    H = params.probe_seeds or H_all              # seeds actually probed
    ws = [words[slots[:, s, :]] for s in range(H)]       # H gathers [B, TF]
    present = ws[0] & PRESENT_BIT
    for s in range(1, H):
        present = present & ws[s]
    frame_present = ((present & PRESENT_BIT) != 0) & frame_ok    # atRank gate
    id_list = []
    for s in range(H):
        w = ws[s]
        ids = jnp.where(w > SAT_BIT, w & jnp.uint32(~SAT_BIT), w) & ID_MASK
        id_list.append(jnp.where(frame_present, ids, 0))
    # counters (goldrush_path.cpp:567-594): queries per frame; hit/miss only
    # counted inside present frames
    queries = frame_ok.sum(axis=1, dtype=jnp.int64)
    hits = jnp.zeros(B, dtype=jnp.int64)
    misses = jnp.zeros(B, dtype=jnp.int64)
    for s in range(H):
        hits += (frame_present & (id_list[s] != 0)).sum(axis=1,
                                                        dtype=jnp.int64)
        misses += (frame_present & (id_list[s] == 0)).sum(axis=1,
                                                          dtype=jnp.int64)
    # dedupe ids within a frame (the per-frame unique_ids set)
    for j in range(1, H):
        dup = jnp.zeros_like(id_list[j], dtype=bool)
        for i in range(j):
            dup = dup | (id_list[j] == id_list[i])
        id_list[j] = jnp.where(dup, 0, id_list[j])
    # per-tile rows: [B*T, H*F] (seed blocks concatenated; within-row order
    # is irrelevant to counting)
    votes = jnp.concatenate(
        [v.reshape(B * T, F) for v in id_list], axis=1)
    votes = jnp.sort(votes, axis=1)                      # ascending, 0s first
    prev = jnp.pad(votes[:, :-1], ((0, 0), (1, 0)))
    is_start = (votes != 0) & (votes != prev)
    idx = jnp.arange(F * H, dtype=jnp.int32)[None, :]
    # next start (or end) index after each position -> run length at starts
    start_pos = jnp.where(is_start, idx, F * H)
    next_start = jnp.concatenate(
        [jnp.flip(jax.lax.cummin(jnp.flip(start_pos[:, 1:], 1), axis=1), 1),
         jnp.full((B * T, 1), F * H, dtype=jnp.int32)], axis=1)
    run_len = jnp.where(is_start, next_start - idx, 0)   # count per unique id
    # sort unique (count desc, id asc): single u64 key
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


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("params", "max_blocks", "num_tiles"))
def insert_read(state: MibfState, slots: jax.Array, tile_lo: jax.Array,
                tile_hi: jax.Array, base_id: jax.Array, trimmed: jax.Array,
                params: MibfParams, max_blocks: int, num_tiles: int
                ) -> MibfState:
    """Insert one read's tile blocks (process_read, goldrush_path.cpp:983-994
    untrimmed / :1041-1053 trimmed).

    slots: [H, T*F] seed-major probe grid of the read (sentinel-padded);
    tiles in [tile_lo, tile_hi] (inclusive) are grouped into blocks of
    ``block_size`` consecutive tiles; block m gets ID base_id + m (the
    trimmed path's ``(m*bs+1)/bs`` index reduces to m for bs>1; for bs==1
    it is m+1 — reproduced exactly below).  Blocks are inserted
    sequentially, matching the reference's per-read insertion order so
    cross-block counter updates on shared slots agree with the oracle.
    """
    H, TF = slots.shape
    T = num_tiles
    F = TF // T
    bs = params.block_size
    W = min(bs, T) * F          # static per-block window (frames)
    sentinel = jnp.asarray(params.size, dtype=slots.dtype)
    # rejected writes route to DISTINCT out-of-bounds dummy indices: with
    # mode="drop" they vanish, and because every index in the scatter is
    # then globally unique, XLA takes the vectorized unique-indices scatter
    # path instead of the serialized general scatter
    dummy = (jnp.asarray(params.alloc, dtype=slots.dtype)
             + jnp.arange(H * W, dtype=slots.dtype))
    words0, counts0 = state

    def body(m, carry):
        words, counts = carry
        lo = tile_lo + m * bs
        hi = jnp.minimum(lo + bs - 1, tile_hi)
        block_id = jnp.where(
            trimmed,
            base_id + (m * bs + 1) // bs,
            base_id + m).astype(jnp.uint32)
        # a block's tiles are contiguous in the frame axis: slice only its
        # window instead of masking/sorting the whole read (the sort is the
        # insert's dominant cost and would otherwise scale with read length
        # per block)
        start = jnp.clip(lo * F, 0, TF - W)
        win = jax.lax.dynamic_slice(slots, (jnp.int32(0), start), (H, W))
        t_of = (start + jnp.arange(W, dtype=jnp.int32)) // F
        in_block = (t_of >= lo) & (t_of <= hi)
        s = jnp.where(in_block[None, :], win, sentinel).reshape(-1)
        s = jax.lax.sort(s)
        prev = jnp.concatenate([jnp.full((1,), -1, dtype=s.dtype), s[:-1]])
        u_first = (s != prev) & (s != sentinel)
        # per-slot counter bump (each unique slot exactly once)
        add_idx = jnp.where(u_first, s, dummy)
        counts = counts.at[add_idx].add(jnp.uint32(1), mode="drop",
                                        unique_indices=True)
        cnt = counts[s]                       # post-increment value
        rand = (s.astype(jnp.uint32) ^ block_id)
        accept = u_first & ((rand % jnp.maximum(cnt, 1)) == cnt - 1)
        old = words[s]
        new_word = (old & (SAT_BIT | PRESENT_BIT)) | block_id
        w_idx = jnp.where(accept, s, dummy)
        words = words.at[w_idx].set(new_word, mode="drop",
                                    unique_indices=True)
        # blocks past tile_hi are natural no-ops: in_block is empty, so every
        # element routes to a dropped dummy index
        return words, counts

    # number of blocks actually needed is data-dependent; loop the static
    # maximum and no-op past the end (guarded by `active` above)
    words, counts = jax.lax.fori_loop(0, max_blocks, body, (words0, counts0))
    return MibfState(words=words, counts=counts)


TILE_BITS = 16      # tile index bits packed into the low end of a sort key


def build_insert_keys(slots: jax.Array, num_tiles: int) -> jax.Array:
    """Pack a read's full-res probe grid into sorted (slot, tile) keys.

    slots: [..., H, T*F] (sentinel-padded).  Key = slot << 16 | tile, sorted
    ascending along the flattened (H, T*F) axis — the whole per-read sort the
    sequential insert needs, done once and batched, so the per-read scan step
    reduces to segment ops over an already-sorted array."""
    H, TF = slots.shape[-2], slots.shape[-1]
    F = TF // num_tiles
    t_of = (jnp.arange(TF, dtype=jnp.int32) // F).astype(jnp.uint64)
    keys = (slots.astype(jnp.uint64) << jnp.uint64(TILE_BITS)) | t_of
    return jax.lax.sort(keys.reshape(*slots.shape[:-2], H * TF),
                        dimension=-1)


@partial(jax.jit, static_argnames=("params", "num_tiles", "assume_present"))
def insert_read_sorted(state: MibfState, keys: jax.Array, tile_lo: jax.Array,
                       tile_hi: jax.Array, base_id: jax.Array,
                       trimmed: jax.Array, active: jax.Array,
                       params: MibfParams, num_tiles: int,
                       assume_present: bool = False) -> MibfState:
    """One-pass equivalent of insert_read on presorted (slot, tile) keys.

    Replaces the sequential per-block fori_loop (which forces XLA to copy
    the filter arrays every iteration) with segment ops over the sorted
    keys: for every (slot, block) pair the rank j of the block within the
    slot's run gives the exact post-increment reservoir counter the
    sequential insert would have seen (cnt = counts[slot] + j), the accept
    rule is evaluated per pair, and the LAST accepting block in sequential
    order wins the slot — bit-identical to block-by-block insertion
    (MIBFConstructSupport.hpp:247-283 semantics, process_read block loop
    goldrush_path.cpp:983-994/1041-1053).  ``active=False`` masks the whole
    insert (used after a silver rotation inside a batch).

    Written to mutate the state IN PLACE inside a scan carry: exactly two
    scatters (counts, words), both with provably unique indices, and no
    gather of a carried buffer ever precedes a scatter to it — counts are
    scatter-added first and the post-values gathered back (cnt = post -
    J_total + j), so XLA's copy-insertion sees only true dependencies.
    ``assume_present=True`` (the engine's pass-2 path) writes
    PRESENT | id without reading the old word: every slot the engine
    inserts was presence-filled in pass 1, and goldrush-path never sets
    the saturation bit (setSatIfMissing is never called — C9 in SURVEY
    §2); the generic path gathers the old bits like the reference.
    """
    N = keys.shape[0]
    bs = params.block_size
    size = params.size
    idx_dtype = params.idx_dtype
    slot = (keys >> jnp.uint64(TILE_BITS)).astype(idx_dtype)
    t = (keys & jnp.uint64((1 << TILE_BITS) - 1)).astype(jnp.int32)
    valid = (slot < jnp.asarray(size, idx_dtype)) & (t >= tile_lo) & \
        (t <= tile_hi) & active
    m = jnp.where(valid, (t - tile_lo) // bs, 0)
    block_id = jnp.where(
        trimmed, base_id + ((m * bs + 1) // bs).astype(jnp.uint32),
        base_id + m.astype(jnp.uint32))
    prev_valid = jnp.concatenate([jnp.zeros(1, bool), valid[:-1]])
    prev_slot = jnp.concatenate([jnp.full(1, -1, idx_dtype), slot[:-1]])
    prev_m = jnp.concatenate([jnp.full(1, -1, jnp.int32), m[:-1]])
    new_run = valid & (~prev_valid | (prev_slot != slot))
    u_first = new_run | (valid & (prev_m != m))
    run_end = valid & jnp.concatenate(
        [~valid[1:] | (slot[1:] != slot[:-1]), jnp.ones(1, bool)])
    # rank of the distinct block within its slot run (segmented cumsum)
    c = jnp.cumsum(u_first.astype(jnp.int32))
    run_base = jax.lax.cummax(
        jnp.where(new_run, c - 1, jnp.int32(-1)))
    j = jnp.where(valid, c - run_base, 0)
    # per-run total distinct blocks, broadcast to every element: suffix
    # segment-max of c (c is non-decreasing, so the run-end value is the
    # max), via a prefix cummax over the flipped array with segment resets
    # encoded into the key (enc strictly increases across segment starts,
    # so the running max never leaks across runs)
    BIG = jnp.int64(N + 2)
    fseg = jnp.cumsum(jnp.flip(run_end).astype(jnp.int64))
    c_end = jnp.flip(jax.lax.cummax(fseg * BIG + jnp.flip(c)) - fseg * BIG)
    j_total = jnp.where(valid, c_end - run_base, 0)
    words, counts = state
    gather_idx = jnp.where(valid, slot, jnp.asarray(size, idx_dtype))
    dummy = (jnp.asarray(params.alloc, idx_dtype)
             + jnp.arange(N, dtype=idx_dtype))
    # counts: scatter-add the run totals FIRST, then gather the post values
    # back — the gather depends on the scatter (no anti-dependency copy) and
    # the pre-value every block saw is reconstructed as post - J_total + j.
    # Scatters throughout use PLAIN add (no unique_indices, never .set):
    # an add of a delta stands in for each .set (whether that still pays on
    # the GPU awaits an A/B, tools/profile_scan.py micro)
    c_idx = jnp.where(run_end, slot, dummy)
    counts = counts.at[c_idx].add(j_total.astype(jnp.uint32), mode="drop")
    post = counts[gather_idx]
    cnt = post - j_total.astype(jnp.uint32) + j.astype(jnp.uint32)
    rand = slot.astype(jnp.uint32) ^ block_id
    accept = u_first & ((rand % jnp.maximum(cnt, 1)) == cnt - 1)
    # last accepting block per slot run wins the write (sequential order)
    idx = jnp.arange(N, dtype=jnp.int64)
    enc = fseg * BIG + jnp.flip(jnp.where(accept, idx + 1, 0))
    smax = jnp.flip(jax.lax.cummax(enc) - fseg * BIG) - 1
    is_last = accept & (smax == idx)
    w_idx = jnp.where(is_last, slot, dummy)
    # the id overwrite as a scatter-ADD of (new - old) deltas at the winning
    # entries (unique by construction, so add == set; uint32 wraparound makes
    # the delta exact), which keeps every filter scatter on the fast path
    old = words[gather_idx]
    if assume_present:
        new_word = PRESENT_BIT | block_id
    else:
        new_word = (old & (SAT_BIT | PRESENT_BIT)) | block_id
    words = words.at[w_idx].add(new_word - old, mode="drop")
    return MibfState(words=words, counts=counts)


@partial(jax.jit, static_argnames=("params", "num_tiles"))
def insert_read_max(words: jax.Array, slots_ins: jax.Array,
                    tile_lo: jax.Array, tile_hi: jax.Array,
                    base_id: jax.Array, trimmed: jax.Array,
                    params: MibfParams, num_tiles: int) -> jax.Array:
    """Throughput-mode insert: ONE scatter-max of ``PRESENT | block_id`` over
    the read's (unsorted) insert grid.

    Replaces the reservoir accept rule with deterministic max-id-wins at
    shared slots: block ids grow monotonically within a silver path, so the
    most recent block claims a contested slot.  The reference itself accepts
    nondeterministic winners under thread interleavings ("return values will
    not be the same run to run", MIBloomFilter.hpp:105-107); bit-parity mode
    keeps the sequential reservoir path (insert_read_sorted).  What this
    buys: no per-read key sort, no counter array traffic, no old-word
    gather — the insert is a single combiner scatter over H*T*F indices
    (one table op where the reservoir insert does four), and the counts
    array is untouched.

    slots_ins: [H, T*F] insert grid (sentinel-padded) at full insert
    resolution.  The engine builds it with fam_ins — ALL insert seeds
    (default: all h), not just the probed prefix: ids at unprobed seeds'
    slots are invisible to the sampled tier's direct hits, but they set
    the filter's background vote statistics that the reference's trim
    flank heuristics read, and the full-resolution trim recheck probes
    all insert seeds (measured in tools/calib_gate.py: 1-seed-everything
    loses 0.07 Jaccard vs exact with no threshold rescue).
    """
    H, TF = slots_ins.shape
    F = TF // num_tiles
    bs = params.block_size
    idx_dtype = params.idx_dtype
    sentinel = jnp.asarray(params.size, dtype=slots_ins.dtype)
    t_of = jnp.arange(TF, dtype=jnp.int32) // F
    in_range = (t_of >= tile_lo) & (t_of <= tile_hi)
    valid = in_range[None, :] & (slots_ins < sentinel)
    m = jnp.where(in_range, (t_of - tile_lo) // bs, 0)
    block_id = jnp.where(
        trimmed, base_id + ((m * bs + 1) // bs).astype(jnp.uint32),
        base_id + m.astype(jnp.uint32))
    new_word = PRESENT_BIT | block_id                       # [TF]
    # rejected writes route past the array length (mode="drop"); duplicate
    # slots are fine — max is commutative, the winning id is deterministic
    idx = jnp.where(valid, slots_ins.astype(idx_dtype),
                    jnp.asarray(params.alloc, idx_dtype))
    vals = jnp.broadcast_to(new_word[None, :], (H, TF))
    return words.at[idx.reshape(-1)].max(vals.reshape(-1), mode="drop")


def reset_ids(state: MibfState) -> MibfState:
    """Silver-path rotation (goldrush_path.cpp:156-187): zero IDs + counters,
    keep presence bits."""
    return MibfState(words=state.words & PRESENT_BIT,
                     counts=jnp.zeros_like(state.counts))


def save_state(state: MibfState, params: MibfParams, path: str) -> None:
    """Persist the filter (parity feature for MIBloomFilter::store,
    MIBloomFilter.hpp:123-160 — which the reference has no load for; here
    both directions work, giving mid-pipeline checkpoint/resume)."""
    np.savez_compressed(
        path, words=np.asarray(state.words), counts=np.asarray(state.counts),
        size=params.size, h=params.h, k=params.k,
        spans=np.asarray(params.spans), tile_length=params.tile_length)


def load_state(path: str) -> tuple[MibfState, dict]:
    z = np.load(path)
    state = MibfState(words=jnp.asarray(z["words"]),
                      counts=jnp.asarray(z["counts"]))
    meta = {k: (int(z[k]) if z[k].ndim == 0 else tuple(int(x) for x in z[k]))
            for k in ("size", "h", "k", "spans", "tile_length")}
    return state, meta
