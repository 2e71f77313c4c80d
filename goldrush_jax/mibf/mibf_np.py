"""NumPy oracle of the multi-index Bloom filter semantics.

Mirrors the reference miBF behavior (MIBloomFilter.hpp +
MIBFConstructSupport.hpp) in the exact form the golden-path flow exercises it:

 - pass-1 presence fill (MIBFConstructSupport.hpp:134-147),
 - frame query: all-h-present gate then ID fetch with saturation unmasking
   (MIBloomFilter.hpp:448-459, 614-623; goldrush_path.cpp:570-594),
 - per-tile ID voting with per-frame unique-ID sets, max-count winner with
   smallest-id tie-break, and the count>2 candidate list
   (goldrush_path.cpp:597-634),
 - block insertion with per-slot counters and the deterministic
   reservoir-sampling accept rule  ``(uint32)(slot ^ id) % count == count-1``
   (MIBFConstructSupport.hpp:247-283; ``std::hash<uint32_t>`` is the identity
   in libstdc++, verified in tests/fixtures/glibc_rand_123.json harness),
 - silver-path reset: IDs and counters zeroed, presence kept
   (MIBloomFilter.hpp:679-682, MIBFConstructSupport.hpp:183-186).

Deviations from the reference, shared by oracle and device implementation:
 - slot = fastrange64(hash, size) instead of ``hash % size`` (no 64-bit
   modulo; same uniformity, same filter size),
 - direct slot addressing: presence is a bit *in the slot word*
   (bit30, the otherwise-unused strand bit slot) instead of a separate
   rank-compressed bitvector; bit31 stays the saturation bit and the low 30
   bits the ID, so query semantics are unchanged.  The reservoir accept rule
   keys on the slot index where the reference keys on the rank index —
   equivalent pseudo-randomness.
"""

from __future__ import annotations

import numpy as np

SAT_BIT = np.uint32(1 << 31)
PRESENT_BIT = np.uint32(1 << 30)
ID_MASK = np.uint32((1 << 30) - 1)
U32 = np.uint32(0xFFFFFFFF)


def fastrange64(h: np.ndarray, size: int) -> np.ndarray:
    """Exact floor(h * size / 2**64) for size < 2**32 (Lemire fastrange)."""
    h = h.astype(np.uint64, copy=False)
    s = np.uint64(size)
    p1 = (h >> np.uint64(32)) * s
    p2 = ((h & np.uint64(0xFFFFFFFF)) * s) >> np.uint64(32)
    return (p1 + p2) >> np.uint64(32)


class MibfOracle:
    def __init__(self, size: int, key_mode: str = "slot"):
        self.size = size
        # slot `size` is the sentinel for padded probes
        self.words = np.zeros(size + 1, dtype=np.uint32)
        self.counts = np.zeros(size + 1, dtype=np.uint32)
        # reservoir accept keying: "slot" (direct mode) or "rank" (the
        # reference / compressed mode, MIBFConstructSupport.hpp:275)
        self.key_mode = key_mode

    def rank(self, slot: int) -> int:
        """# of present slots strictly below `slot` (frozen-presence rank)."""
        return int(((self.words[:slot] & PRESENT_BIT) != 0).sum())

    # --- construction pass 1 ---
    def fill_presence(self, hashes: np.ndarray) -> None:
        slots = fastrange64(hashes.reshape(-1), self.size)
        self.words[slots] |= PRESENT_BIT

    # --- query/vote ---
    def frame_query(self, frame_hashes: np.ndarray) -> list[int]:
        """Unique nonzero IDs voted by one frame's h hashes; empty if any
        probe position lacks the presence bit (atRank gate)."""
        slots = fastrange64(frame_hashes, self.size)
        w = self.words[slots]
        if not (w & PRESENT_BIT).all():
            return []
        ids = w.copy()
        sat = ids > SAT_BIT
        ids = np.where(sat, ids & ~SAT_BIT, ids)
        ids &= ID_MASK  # strip the presence bit; low 30 bits are the ID
        return sorted(set(int(i) for i in ids if i != 0))

    def tile_votes(self, tile_flat_hashes: np.ndarray, h: int
                   ) -> dict[int, int]:
        """id -> count over all frames of one tile (flat frame-major array of
        h hashes per frame, as produced by read_hashing.cpp:43-54)."""
        counts: dict[int, int] = {}
        n_frames = len(tile_flat_hashes) // h
        for f in range(n_frames):
            for uid in self.frame_query(tile_flat_hashes[f * h:(f + 1) * h]):
                counts[uid] = counts.get(uid, 0) + 1
        return counts

    def counters_for_tile(self, tile_flat_hashes: np.ndarray, h: int
                          ) -> tuple[int, int, int]:
        """(queries, hits, misses) counter deltas (goldrush_path.cpp:567-594)."""
        n_frames = len(tile_flat_hashes) // h
        queries = n_frames
        hits = misses = 0
        for f in range(n_frames):
            slots = fastrange64(tile_flat_hashes[f * h:(f + 1) * h], self.size)
            w = self.words[slots]
            if not (w & PRESENT_BIT).all():
                continue
            ids = np.where(w > SAT_BIT, w & ~SAT_BIT, w) & ID_MASK
            misses += int((ids == 0).sum())
            hits += int((ids != 0).sum())
        return queries, hits, misses

    # --- insertion ---
    def insert_block(self, block_hashes: np.ndarray, block_id: int) -> None:
        """One block's hashes inserted under one ID
        (MIBFConstructSupport.hpp:247-283): dedupe slots, bump per-slot
        counter, reservoir-accept, overwrite preserving saturation."""
        slots = np.unique(fastrange64(block_hashes.reshape(-1), self.size))
        for slot in slots:
            self.counts[slot] += 1
            count = int(self.counts[slot])
            key = int(slot) if self.key_mode == "slot" else self.rank(slot)
            rand = (key ^ int(block_id)) & 0xFFFFFFFF
            if rand % count == count - 1:
                old = self.words[slot]
                self.words[slot] = np.uint32(
                    (old & (SAT_BIT | PRESENT_BIT)) | np.uint32(block_id))

    def reset_ids(self) -> None:
        """Silver-path rotation: zero IDs and counters, keep presence."""
        self.words &= PRESENT_BIT
        self.counts[:] = 0

    def occupancy(self) -> float:
        return float((self.words[:-1] & PRESENT_BIT != 0).mean())
