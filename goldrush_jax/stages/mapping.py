"""Minimizer-anchor mapping: the device-side replacement for the reference's
external mappers (minimap2 map-ont at bin/goldrush:275-276, ntLink minimizer
mapping).  Device computes minimizers; anchors join by sorted-hash merge and
chain by diagonal voting — a minimap2-lite sufficient for molecule spans
(tigmint), polish targeting, and scaffolding joins.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import fastq
from ..ops.minimizers import batch_minimizers

MAX_SEQ = (1 << 20) - 1   # position packing limit per sequence chunk


@dataclass
class MinimizerIndex:
    k: int
    w: int
    hashes: np.ndarray      # uint64 sorted
    tid: np.ndarray         # int32 target id per entry
    pos: np.ndarray         # int32 target position per entry
    lengths: np.ndarray     # int64 target lengths
    names: list


def _seq_minimizers(seqs: list[bytes], k: int, w: int, batch: int = 32):
    """Minimizers for arbitrary-length sequences (device-hashed, chunked to
    the position-packing limit)."""
    CH = MAX_SEQ - k - 1
    jobs = []           # (seq_idx, chunk_offset, codes)
    for i, s in enumerate(seqs):
        for off in range(0, max(len(s) - k + 1, 1), CH):
            jobs.append((i, off, fastq.encode(s[off:off + CH + k - 1])))
    out = [[] for _ in seqs]
    jobs.sort(key=lambda j: len(j[2]))
    b = 0
    while b < len(jobs):
        grp = jobs[b:b + batch]
        b += batch
        L = max(max(len(c) for _, _, c in grp), k + w)
        # pad to power-of-two length buckets and a fixed batch width: one
        # compiled executable per bucket instead of one per distinct max
        # length (each compile takes seconds)
        L = 1 << max(10, (L - 1).bit_length())
        if len(grp) < batch:
            grp = grp + [(-1, 0, np.zeros(0, np.uint8))] * (batch - len(grp))
        codes = np.zeros((len(grp), L), dtype=np.uint8)
        lens = np.zeros(len(grp), dtype=np.int64)
        for j, (_, _, c) in enumerate(grp):
            cc = np.where(c > 3, 0, c)      # Ns hash as A; fine for anchors
            codes[j, :len(cc)] = cc
            lens[j] = len(cc)
        res = batch_minimizers(codes, lens, k, w)
        for (i, off, _), (pos, h) in zip(grp, res):
            if i >= 0 and len(pos):
                out[i].append((pos + off, h))
    final = []
    for chunks in out:
        if not chunks:
            final.append((np.zeros(0, np.int64), np.zeros(0, np.uint64)))
        else:
            p = np.concatenate([c[0] for c in chunks])
            h = np.concatenate([c[1] for c in chunks])
            final.append((p, h))
    return final


def build_index(seqs: list[bytes], names: list[str], k: int, w: int
                ) -> MinimizerIndex:
    mins = _seq_minimizers(seqs, k, w)
    tids, poss, hs = [], [], []
    for i, (p, h) in enumerate(mins):
        tids.append(np.full(len(p), i, dtype=np.int32))
        poss.append(p.astype(np.int32))
        hs.append(h)
    h = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
    tid = np.concatenate(tids) if tids else np.zeros(0, np.int32)
    pos = np.concatenate(poss) if poss else np.zeros(0, np.int32)
    order = np.argsort(h, kind="stable")
    return MinimizerIndex(k=k, w=w, hashes=h[order], tid=tid[order],
                          pos=pos[order],
                          lengths=np.array([len(s) for s in seqs]),
                          names=list(names))


@dataclass
class Hit:
    tid: int
    strand: int             # +1 / -1
    q_start: int
    q_end: int
    t_start: int
    t_end: int
    n_anchors: int
    offset: int             # t = q + offset (fwd) / t = offset - q (rev)
    t_anchors: np.ndarray | None = None   # anchor target positions (sorted
    # ascending; populated when map_sequence(keep_anchors=True) — tigmint
    # molecule splitting needs the intra-hit gap structure)


def _merge_hits(hits: list[Hit], diag_bin: int, keep_anchors: bool
                ) -> list[Hit]:
    """Merge hits of the same (target, strand) whose diagonals are within
    two bins — one alignment's anchors straddling a bin boundary otherwise
    shows up as several fragments."""
    hits.sort(key=lambda h: -h.n_anchors)
    merged: list[Hit] = []
    for h in hits:
        for m in merged:
            if m.tid == h.tid and m.strand == h.strand and \
                    abs(m.offset - h.offset) <= 2 * diag_bin:
                m.q_start = min(m.q_start, h.q_start)
                m.q_end = max(m.q_end, h.q_end)
                m.t_start = min(m.t_start, h.t_start)
                m.t_end = max(m.t_end, h.t_end)
                m.n_anchors += h.n_anchors
                if keep_anchors:
                    m.t_anchors = np.sort(
                        np.concatenate([m.t_anchors, h.t_anchors]))
                break
        else:
            merged.append(h)
    merged.sort(key=lambda h: -h.n_anchors)
    return merged


def map_sequence(index: MinimizerIndex, q_pos: np.ndarray, q_hash: np.ndarray,
                 min_anchors: int = 4, diag_bin: int = 500,
                 max_hits: int = 8, keep_anchors: bool = False) -> list[Hit]:
    """Map one query's minimizer set against the index by diagonal voting."""
    if len(q_hash) == 0 or len(index.hashes) == 0:
        return []
    lo = np.searchsorted(index.hashes, q_hash, side="left")
    hi = np.searchsorted(index.hashes, q_hash, side="right")
    counts = hi - lo
    # skip ultra-repetitive minimizers
    keep = counts <= 64
    reps = np.repeat(np.arange(len(q_hash))[keep], counts[keep])
    if len(reps) == 0:
        return []
    flat = np.concatenate([np.arange(l, h) for l, h in
                           zip(lo[keep], hi[keep])])
    qp = q_pos[reps].astype(np.int64)
    tp = index.pos[flat].astype(np.int64)
    tid = index.tid[flat].astype(np.int64)
    # two strand hypotheses per anchor
    hits: list[Hit] = []
    for strand in (1, -1):
        diag = (qp - tp) if strand == 1 else (qp + tp)
        key = tid * (1 << 24) + (diag + (1 << 22)) // diag_bin
        uniq, inv, cnt = np.unique(key, return_inverse=True,
                                   return_counts=True)
        good = np.nonzero(cnt >= min_anchors)[0]
        # stable: ties keep ascending (tid, diag-bin) order — deterministic
        # and identical between this per-read path and the batched map_reads
        order = good[np.argsort(-cnt[good], kind="stable")][:max_hits]
        for g in order:
            m = inv == g
            t = int(tid[m][0])
            qs, qe = int(qp[m].min()), int(qp[m].max()) + index.k
            ts, te = int(tp[m].min()), int(tp[m].max()) + index.k
            off = int(np.median(diag[m]))
            hits.append(Hit(tid=t, strand=strand, q_start=qs, q_end=qe,
                            t_start=ts, t_end=te, n_anchors=int(cnt[g]),
                            offset=off,
                            t_anchors=np.sort(tp[m]) if keep_anchors
                            else None))
    return _merge_hits(hits, diag_bin, keep_anchors)


def map_reads(index: MinimizerIndex, reads: list[bytes],
              min_anchors: int = 4, diag_bin: int = 500, max_hits: int = 8,
              keep_anchors: bool = False,
              mins: list | None = None) -> list[list[Hit]]:
    """Map ALL reads in one batched pass (bit-identical to per-read
    map_sequence, proven in tests/test_minimizers_mapping.py).

    The round-2 engine looped map_sequence per read (a Python-rate wall at
    the reference's millions-of-reads scale); here every per-anchor step is
    one vectorized pass over the concatenation of all reads' anchors: a
    single searchsorted join against the sorted index, one lexsort per
    strand to group (read, target, diagonal-bin), and reduceat segment
    reductions for the per-group extents/medians.  Python touches only the
    surviving hit groups (~ a few per read).  ``mins`` may supply
    precomputed per-read (positions, hashes) to avoid re-hashing."""
    if mins is None:
        mins = _seq_minimizers(reads, index.k, index.w)
    out: list[list[Hit]] = [[] for _ in reads]
    if len(index.hashes) == 0:
        return out
    q_read = np.concatenate(
        [np.full(len(p), i, dtype=np.int64) for i, (p, _) in enumerate(mins)]
        or [np.zeros(0, np.int64)])
    q_pos = np.concatenate([p for p, _ in mins] or [np.zeros(0, np.int64)])
    q_hash = np.concatenate([h for _, h in mins] or [np.zeros(0, np.uint64)])
    if len(q_hash) == 0:
        return out
    lo = np.searchsorted(index.hashes, q_hash, side="left")
    hi = np.searchsorted(index.hashes, q_hash, side="right")
    counts = hi - lo
    keep = (counts > 0) & (counts <= 64)   # skip ultra-repetitive minimizers
    ck = counts[keep]
    tot = int(ck.sum())
    if tot == 0:
        return out
    # expand each kept query minimizer to its index-entry range
    reps = np.repeat(np.nonzero(keep)[0], ck)
    csum = np.concatenate([[0], np.cumsum(ck)[:-1]])
    flat = np.repeat(lo[keep], ck) + (np.arange(tot) - np.repeat(csum, ck))
    rd = q_read[reps]
    qp = q_pos[reps].astype(np.int64)
    tp = index.pos[flat].astype(np.int64)
    tid = index.tid[flat].astype(np.int64)
    hits_per_read: list[list[Hit]] = [[] for _ in reads]
    for strand in (1, -1):
        diag = (qp - tp) if strand == 1 else (qp + tp)
        bin_ = (diag + (1 << 22)) // diag_bin
        order = np.lexsort((bin_, tid, rd))
        r_s, t_s, b_s = rd[order], tid[order], bin_[order]
        qp_s, tp_s, dg_s = qp[order], tp[order], diag[order]
        new = np.empty(tot, dtype=bool)
        new[0] = True
        new[1:] = (r_s[1:] != r_s[:-1]) | (t_s[1:] != t_s[:-1]) \
            | (b_s[1:] != b_s[:-1])
        starts = np.nonzero(new)[0]
        ends = np.concatenate([starts[1:], [tot]])
        cnt = ends - starts
        qmin = np.minimum.reduceat(qp_s, starts)
        qmax = np.maximum.reduceat(qp_s, starts)
        tmin = np.minimum.reduceat(tp_s, starts)
        tmax = np.maximum.reduceat(tp_s, starts)
        # per-group median diagonal: sort anchors within groups once
        grp_of = np.cumsum(new) - 1
        order2 = np.lexsort((dg_s, grp_of))
        dg_g = dg_s[order2]
        mlo = dg_g[starts + (cnt - 1) // 2]
        mhi = dg_g[starts + cnt // 2]
        med = ((mlo + mhi) / 2).astype(np.int64)   # == int(np.median(...))
        good = np.nonzero(cnt >= min_anchors)[0]
        if len(good) == 0:
            continue
        if keep_anchors:
            order3 = np.lexsort((tp_s, grp_of))
            tp_g = tp_s[order3]
        # per read: groups are contiguous ascending (tid, bin) like
        # np.unique's key order in map_sequence; stable argsort(-cnt)
        # tie-breaks identically
        g_read = r_s[starts[good]]
        for r in np.unique(g_read):
            sel = good[g_read == r]
            top = sel[np.argsort(-cnt[sel], kind="stable")][:max_hits]
            for g in top:
                h = Hit(tid=int(t_s[starts[g]]), strand=strand,
                        q_start=int(qmin[g]), q_end=int(qmax[g]) + index.k,
                        t_start=int(tmin[g]), t_end=int(tmax[g]) + index.k,
                        n_anchors=int(cnt[g]), offset=int(med[g]),
                        t_anchors=(tp_g[starts[g]:ends[g]]
                                   if keep_anchors else None))
                hits_per_read[int(r)].append(h)
    for i in range(len(reads)):
        if hits_per_read[i]:
            out[i] = _merge_hits(hits_per_read[i], diag_bin, keep_anchors)
    return out
