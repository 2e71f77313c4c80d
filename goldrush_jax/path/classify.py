"""Batched tile classifier: the 8 smoothing passes, longest-stretch search,
flank evaluation and recruit decision as vectorized JAX over [B, T] tiles.

Semantics are an exact re-expression of goldrush_path.cpp:628-888 (smoothing),
:195-233 (find_longest_stretch), :341-527 (eval_flanks) and :943-1081
(decision), batched over reads with per-read tile counts ``n`` and padded
tiles masked out.  Sequential passes run as lax.scan over the tile axis with
[B]-wide carries; run/interval passes use scatter-delta + cumsum interval
painting; the by-ID gap bridging scans over each read's unique assigned IDs.
Held to parity with goldrush_jax.path.oracle (itself fixture-verified against
the compiled reference) — see tests/test_classify_jax.py.

Candidate-table lookups use the top-K (id,count) list from
mibf.probe_and_vote; the reference keeps every id with count>2, so results
are exact whenever a tile has <= K such ids (overflow is surfaced by the vote
kernel and counted by the engine).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class ClassifyResult(NamedTuple):
    decision: jax.Array      # int32 [B]: 0 drop, 1 whole, 2 trimmed
    trim_start: jax.Array    # int32 [B] (valid when decision==2)
    trim_end: jax.Array      # int32 [B]
    num_assigned: jax.Array  # int32 [B]
    ids: jax.Array           # int32 [B, T] smoothed id vector
    bools: jax.Array         # int32 [B, T] smoothed assignment vector


def _lookup(cand_ids, cand_counts, key):
    """count of `key` in a tile's candidate table (0 if absent); key==0 never
    matches (empty slots hold id 0 with count 0)."""
    m = (cand_ids == key[..., None]) & (cand_counts > 0)
    return m.any(-1), jnp.where(m, cand_counts, 0).sum(-1)


def _adj(a, b):
    """id adjacency a==b, a==b+1, a==b-1 under the reference's unsigned
    arithmetic (b==0 makes b-1 unreachable)."""
    return (a == b) | (a == b + 1) | ((b > 0) & (a == b - 1))


def _scan_T(f, carry, xs_list, reverse=False):
    """scan over the tile axis; xs_list arrays are [B, T] -> per-step [B]."""
    xs = [x.swapaxes(0, 1) for x in xs_list]
    carry, ys = jax.lax.scan(f, carry, xs, reverse=reverse)
    return carry, [y.swapaxes(0, 1) for y in ys]


def _ffill_value(seed_mask, seed_vals, T):
    """Per-row forward fill: value at j = seed_vals at the latest seeded
    position <= j (0 where none).  seed_vals must be < 2^30."""
    idx = jnp.arange(T, dtype=jnp.int64)[None, :]
    combo = jnp.where(seed_mask, (idx + 1) << 30 | seed_vals.astype(jnp.int64),
                      jnp.int64(0))
    filled = jax.lax.cummax(combo, axis=1)
    return (filled & ((1 << 30) - 1)).astype(jnp.int32)


# per-pass debug snapshot labels, matching the reference's 9
# log_tile_states sites (goldrush_path.cpp:637,664,685,737,769,796,824,
# 853,880)
DEBUG_PASSES = ("initial", "recon_fwd", "recon_bwd", "neighbor_fill",
                "hole_fill", "lone_suppress", "gap_bridge",
                "endfix_noncontig", "short_run")


@partial(jax.jit, static_argnames=("threshold", "unassigned_min",
                                   "assigned_max", "debug"))
def classify_batch(curr_id, top_count, cand_ids, cand_counts, n_tiles,
                   threshold: int, unassigned_min: int, assigned_max: int,
                   debug: bool = False):
    """Full per-read classification from vote tables.

    curr_id:   uint32/int32 [B, T] initial max-count id per tile
    top_count: int32 [B, T]
    cand_ids/cand_counts: [B, T, K] count>2 candidates (count desc)
    n_tiles:   int32 [B] true tile counts (padded tiles beyond are ignored)

    With ``debug=True`` returns (result, ids_trace [B, 9, T], bools_trace
    [B, 9, T]): the tile states after each smoothing pass, one snapshot per
    reference log_tile_states site (goldrush_path.cpp:109-124; see
    DEBUG_PASSES).
    """
    B, T = curr_id.shape
    trace = []                  # (ids, bools) snapshots when debug
    ids = curr_id.astype(jnp.int32)
    cand_ids = cand_ids.astype(jnp.int32)
    cand_counts = cand_counts.astype(jnp.int32)
    n = n_tiles.astype(jnp.int32)
    t_idx = jnp.arange(T, dtype=jnp.int32)[None, :]
    in_read = t_idx < n[:, None]
    ids = jnp.where(in_read, ids, 0)
    bools = jnp.where(
        in_read & (cand_counts[:, :, 0] > 0)
        & (cand_counts[:, :, 0] > threshold), 1, 0).astype(jnp.int32)

    smooth = n >= 3          # [B] gate for all smoothing passes
    if debug:
        trace.append((ids, bools))          # 637: initial assignment

    # ---- pass 1/2: ID reconciliation, forward then backward -------------
    def recon(reverse):
        def step(prev_id, xs):
            t, i, b, ci, cc = xs
            if reverse:
                active = smooth & (t <= n - 2)
            else:
                active = smooth & (t >= 1) & (t < n)
            found, cnt = _lookup(ci, cc, prev_id)
            hit = active & (i != prev_id) & found
            new_i = jnp.where(hit, prev_id, i)
            new_b = jnp.where(hit, (cnt > threshold).astype(jnp.int32), b)
            return new_i, (new_i, new_b)
        return step

    tcol = jnp.broadcast_to(t_idx, (B, T))
    # forward: prev carry starts as ids[:,0] at step 0 (inactive step yields
    # carry = own id)
    _, (ids, bools) = _scan_T(recon(False), jnp.zeros(B, jnp.int32),
                              [tcol, ids, bools, cand_ids, cand_counts])
    if debug:
        trace.append((ids, bools))          # 664: forward reconciliation
    _, (ids, bools) = _scan_T(recon(True), jnp.zeros(B, jnp.int32),
                              [tcol, ids, bools, cand_ids, cand_counts],
                              reverse=True)
    if debug:
        trace.append((ids, bools))          # 685: backward reconciliation

    # ---- pass 3/4: neighbor fill, forward then backward -----------------
    def nfill_fwd(carry, xs):
        prev_i, prev_b = carry
        t, i, b, nxt_i, nxt_b = xs
        active = smooth & (t >= 1) & (t <= n - 2) & (b == 0)
        c1 = ((i == prev_i) & (prev_b == 1)) | ((i == nxt_i) & (nxt_b == 1))
        c2 = ((i == prev_i + 1) & (prev_b == 1)) | \
             ((i == nxt_i + 1) & (nxt_b == 1))
        c3 = ((prev_i > 0) & (i == prev_i - 1) & (prev_b == 1)) | \
             ((nxt_i > 0) & (i == nxt_i - 1) & (nxt_b == 1))
        c4 = (prev_i == nxt_i) & (prev_b == 1) & (nxt_b == 1)
        new_b = jnp.where(active & (c1 | c2 | c3 | c4), 1, b)
        new_i = jnp.where(active & ~c1 & ~c2 & ~c3 & c4, prev_i, i)
        return (new_i, new_b), (new_i, new_b)

    nxt_ids = jnp.pad(ids[:, 1:], ((0, 0), (0, 1)))
    nxt_bools = jnp.pad(bools[:, 1:], ((0, 0), (0, 1)))
    _, (ids, bools) = _scan_T(
        nfill_fwd, (jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32)),
        [tcol, ids, bools, nxt_ids, nxt_bools])

    def nfill_bwd(carry, xs):
        nxt_i, nxt_b = carry
        t, i, b, prev_i, prev_b = xs
        active = smooth & (t >= 1) & (t <= n - 2) & (b == 0)
        c1 = ((i == prev_i) & (prev_b == 1)) | ((i == nxt_i) & (nxt_b == 1))
        c2 = ((i == prev_i + 1) & (prev_b == 1)) | \
             ((i == nxt_i + 1) & (nxt_b == 1))
        c3 = ((prev_i > 0) & (i == prev_i - 1) & (prev_b == 1)) | \
             ((nxt_i > 0) & (i == nxt_i - 1) & (nxt_b == 1))
        c4 = (prev_i == nxt_i) & (prev_b == 1) & (nxt_b == 1)
        new_b = jnp.where(active & (c1 | c2 | c3 | c4), 1, b)
        new_i = jnp.where(active & ~c1 & ~c2 & ~c3 & c4, prev_i, i)
        return (new_i, new_b), (new_i, new_b)

    prev_ids = jnp.pad(ids[:, :-1], ((0, 0), (1, 0)))
    prev_bools = jnp.pad(bools[:, :-1], ((0, 0), (1, 0)))
    _, (ids, bools) = _scan_T(
        nfill_bwd, (jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32)),
        [tcol, ids, bools, prev_ids, prev_bools], reverse=True)
    if debug:
        trace.append((ids, bools))          # 737: neighbor fill

    # ---- pass 5: hole fill between compatible flank ids ------------------
    def hole_fill(ids, bools):
        b = bools
        pb = jnp.pad(b[:, :-1], ((0, 0), (1, 0)))
        interior = (t_idx >= 1) & (t_idx <= n[:, None] - 2) & smooth[:, None]
        start_f = interior & (b == 0) & (pb == 1)          # run starts
        close_f = interior & (b == 1) & (pb == 0)          # run closes at i
        # latest start position at/before each i (0 if none -> matches the
        # reference's stale start_idx=0 which pass 5 then skips via a==0)
        a_of = jax.lax.cummax(jnp.where(start_f, t_idx, 0), axis=1)
        left_pos = jnp.clip(a_of - 1, 0, T - 1)
        left = jnp.take_along_axis(ids, left_pos, axis=1)
        right = ids                                         # id at close pos
        ok = close_f & (a_of > 0) & _adj(left, right)
        # paint [a, i-1]: +1 at a, -1 at i
        starts = jnp.zeros((B, T), bool).at[
            jnp.arange(B)[:, None], jnp.where(ok, a_of, 0)].max(ok)
        endsp1 = ok                                        # -1 applied at i
        delta = starts.astype(jnp.int32) - endsp1.astype(jnp.int32)
        fill = jnp.cumsum(delta, axis=1) > 0
        fill_val = _ffill_value(starts, _scatter_vals(B, T, ok, a_of, left), T)
        new_ids = jnp.where(fill, fill_val, ids)
        new_bools = jnp.where(fill, 1, bools)
        return new_ids, new_bools

    def _scatter_vals(B, T, ok, pos, vals):
        out = jnp.zeros((B, T), jnp.int32)
        return out.at[jnp.arange(B)[:, None],
                      jnp.where(ok, pos, 0)].max(jnp.where(ok, vals, 0))

    ids, bools = hole_fill(ids, bools)
    if debug:
        trace.append((ids, bools))          # 769: hole fill

    # ---- pass 6: lone-tile suppression fwd/bwd ---------------------------
    def lone_fwd(prev_b, xs):
        t, b, nxt_b = xs
        active = smooth & (t >= 2) & (t <= n - 3)
        new_b = jnp.where(active & (b == 1) & (prev_b == 0) & (nxt_b == 0),
                          0, b)
        return new_b, (new_b,)

    nxt_bools = jnp.pad(bools[:, 1:], ((0, 0), (0, 1)))
    _, (bools,) = _scan_T(lone_fwd, jnp.zeros(B, jnp.int32),
                          [tcol, bools, nxt_bools])

    def lone_bwd(nxt_b, xs):
        t, b, prev_b = xs
        active = smooth & (t >= 2) & (t <= n - 3)
        new_b = jnp.where(active & (b == 1) & (prev_b == 0) & (nxt_b == 0),
                          0, b)
        return new_b, (new_b,)

    prev_bools = jnp.pad(bools[:, :-1], ((0, 0), (1, 0)))
    _, (bools,) = _scan_T(lone_bwd, jnp.zeros(B, jnp.int32),
                          [tcol, bools, prev_bools], reverse=True)
    if debug:
        trace.append((ids, bools))          # 796: lone-tile suppression

    # ---- pass 7: gap bridging by ID --------------------------------------
    member0 = (bools == 1) & smooth[:, None] & in_read   # membership snapshot
    ids0 = ids
    # per-read unique assigned ids in ascending order, padded with MAXID
    MAXID = jnp.int32((1 << 30) - 1)
    uid_sorted = jnp.sort(jnp.where(member0, ids0, MAXID), axis=1)
    first = jnp.pad(uid_sorted[:, 1:] != uid_sorted[:, :-1], ((0, 0), (1, 0)),
                    constant_values=True)
    uniq = jnp.sort(jnp.where(first & (uid_sorted < MAXID), uid_sorted, MAXID),
                    axis=1)                                # [B, T]

    def bridge_step(cur_ids, g):
        mask = member0 & (ids0 == g[:, None])              # fixed membership
        prev_m = jax.lax.cummax(jnp.where(mask, t_idx, -T), axis=1)
        prev_m_excl = jnp.pad(prev_m[:, :-1], ((0, 0), (1, 0)),
                              constant_values=-T)
        has_prev = prev_m_excl >= 0
        gap = mask & has_prev & (t_idx > prev_m_excl + 1)
        # a member re-reads the current id array ("head") when it is the
        # first member or adjacent to the previous one; gap members inherit
        # the value painted over them by the preceding fill
        head = mask & (~has_prev | (t_idx == prev_m_excl + 1))
        # value carried through gaps: forward-fill of cur_ids at heads over
        # members; gap members inherit, adjacent members re-read cur
        v = _ffill_value(head, jnp.where(head, cur_ids, 0), T)
        # fill (prev_m_excl, t] for gap members with v at the previous member
        v_prev = jnp.take_along_axis(v, jnp.clip(prev_m_excl, 0, T - 1),
                                     axis=1)
        fill_start = _scatter_mask(B, T, gap, prev_m_excl + 1)
        fill_val_seed = _scatter_vals(B, T, gap, prev_m_excl + 1, v_prev)
        ends = jnp.pad(gap[:, :-1], ((0, 0), (1, 0)))      # -1 at t+1
        delta = fill_start.astype(jnp.int32) - ends.astype(jnp.int32)
        infill = jnp.cumsum(delta, axis=1) > 0
        fv = _ffill_value(fill_start, fill_val_seed, T)
        new_ids = jnp.where(infill, fv, cur_ids)
        return new_ids, None

    def _scatter_mask(B, T, ok, pos):
        out = jnp.zeros((B, T), bool)
        return out.at[jnp.arange(B)[:, None],
                      jnp.where(ok, jnp.clip(pos, 0, T - 1), 0)].max(ok)

    def bridge_all(ids_in):
        def body(c, g):
            return bridge_step(c, g)
        out, _ = jax.lax.scan(body, ids_in, uniq.swapaxes(0, 1))
        return out

    ids = jnp.where(smooth[:, None], bridge_all(ids), ids)
    if debug:
        trace.append((ids, bools))          # 824: gap bridging

    # ---- pass 8: end-tile fix --------------------------------------------
    def gat(arr, pos):
        return jnp.take_along_axis(arr, jnp.clip(pos, 0, T - 1)[:, None],
                                   axis=1)[:, 0]
    last = gat(ids, n - 1)
    second_last = gat(ids, n - 2)
    start0 = ids[:, 0]
    second0 = ids[:, 1] if T > 1 else ids[:, 0]
    fix_last = smooth & _adj(last, second_last)
    fix_first = smooth & _adj(start0, second0)
    bools = bools.at[jnp.arange(B), jnp.clip(n - 1, 0, T - 1)].set(
        jnp.where(fix_last, 1, gat(bools, n - 1)))
    bools = bools.at[:, 0].set(jnp.where(fix_first, 1, bools[:, 0]))

    # ---- pass 9: non-contiguous-ID suppression ---------------------------
    pi = jnp.pad(ids[:, :-1], ((0, 0), (1, 0)))
    ni = jnp.pad(ids[:, 1:], ((0, 0), (0, 1)))
    interior = (t_idx >= 1) & (t_idx <= n[:, None] - 2) & smooth[:, None]
    iso = interior & ~_adj(ids, ni) & ~_adj(ids, pi)
    bools = jnp.where(iso, 0, bools)
    if debug:
        trace.append((ids, bools))          # 853: end fix + non-contiguous

    # ---- pass 10: short-run suppression (<=5) ----------------------------
    pb = jnp.pad(bools[:, :-1], ((0, 0), (1, 0)))
    interior = (t_idx >= 1) & (t_idx <= n[:, None] - 2) & smooth[:, None]
    rstart = interior & (bools == 1) & (pb == 0)
    rclose = interior & (bools == 0) & (pb == 1)           # run ended at i-1
    a_of = jax.lax.cummax(jnp.where(rstart, t_idx, 0), axis=1)
    short = rclose & ((t_idx - 1) - a_of + 1 <= 5)
    starts = _scatter_mask(B, T, short, a_of)
    delta = starts.astype(jnp.int32) - short.astype(jnp.int32)
    suppress = jnp.cumsum(delta, axis=1) > 0
    bools = jnp.where(suppress & smooth[:, None], 0, bools)

    bools = jnp.where(in_read, bools, 0)
    if debug:
        trace.append((ids, bools))          # 880: short-run suppression
    num_assigned = bools.sum(axis=1).astype(jnp.int32)

    # ---- find_longest_stretch (goldrush_path.cpp:195-233) ----------------
    def stretch_step(carry, xs):
        t, b, pb = xs
        start, end, cur, longest, ls, le = carry
        active = (t >= 1) & (t <= n - 2)
        c1 = (b == 0) & (pb == 1)
        c2 = (b == 0) & (b == pb) & (t + 1 != n - 1)
        c3 = (b == 1) & (b != pb)
        c4 = (t + 1 == n - 1) & (end < start)
        sel1 = active & c1
        sel2 = active & ~c1 & c2
        sel3 = active & ~c1 & ~c2 & c3
        sel4 = active & ~c1 & ~c2 & ~c3 & c4
        n_start = jnp.where(sel1, t, start)
        n_cur = jnp.where(sel1, 1, jnp.where(sel2 | sel4, cur + 1, cur))
        n_end = jnp.where(sel3, t - 1, jnp.where(sel4, t, end))
        upd = (sel3 | sel4) & (longest < n_cur)
        n_longest = jnp.where(upd, n_cur, longest)
        n_ls = jnp.where(upd, n_start, ls)
        n_le = jnp.where(upd, n_end, le)
        return (n_start, n_end, n_cur, n_longest, n_ls, n_le), ()

    z = jnp.zeros(B, jnp.int32)
    pb_full = jnp.pad(bools[:, :-1], ((0, 0), (1, 0)))
    (s_, e_, c_, lg_, ls, le), _ = _scan_T(
        stretch_step, (z, z, z, z, z, z), [tcol, bools, pb_full])

    # ---- eval_flanks (goldrush_path.cpp:341-527) -------------------------
    def flank_top2(lo, hi):
        """top-2 (count, id) over id positions lo <= t < hi, count desc then
        id asc."""
        rng = (t_idx >= lo[:, None]) & (t_idx < hi[:, None])
        eq = (ids[:, :, None] == ids[:, None, :])
        cnt = jnp.where(rng[:, :, None] & rng[:, None, :], eq, False)\
            .sum(axis=2).astype(jnp.int32)                 # [B, T]
        cnt = jnp.where(rng, cnt, 0)
        key = cnt.astype(jnp.int64) * (1 << 31) + (MAXID - ids)
        k1 = jnp.max(jnp.where(rng, key, 0), axis=1)
        c1 = (k1 >> 31).astype(jnp.int32)
        i1 = jnp.where(c1 > 0, MAXID - (k1 & ((1 << 31) - 1)).astype(jnp.int32), 0)
        k2 = jnp.max(jnp.where(rng & (ids != i1[:, None]), key, 0), axis=1)
        c2 = (k2 >> 31).astype(jnp.int32)
        i2 = jnp.where(c2 > 0, MAXID - (k2 & ((1 << 31) - 1)).astype(jnp.int32), 0)
        return c1, i1, c2, i2, (hi > lo)

    MIN_F = 2            # MIN_IDS_IN_FLANK
    trim_start0 = jnp.where(ls != 0, ls - 1, ls)
    trim_end0 = le + 1

    # small-read branch (n < 15)
    lc1, li1, lc2, li2, lne = flank_top2(jnp.zeros(B, jnp.int32), ls)
    good_left_s = lne & ((lc1 >= MIN_F) |
                         ((lc2 > 0) & (lc1 + lc2 > MIN_F + 1)
                          & ((li1 == li2 + 1) | (li2 == li1 + 1))))
    good_left_s = good_left_s | (trim_start0 == 0)
    rc1, ri1, rc2, ri2, rne = flank_top2(le + 1, n)
    good_right_s = rne & ((rc1 >= MIN_F) |
                          ((rc2 > 0) & (rc1 + rc2 > MIN_F + 1)
                           & ((ri1 == ri2 + 1) | (ri2 == ri1 + 1))))
    good_right_s = good_right_s | (trim_end0 == n - 1)
    good_small = good_left_s & good_right_s
    trim_start_small, trim_end_small = trim_start0, trim_end0

    # large-read branch (n >= 15): window of 5 tiles each side
    has_lwin = ls - 5 >= 1
    Lc1, Li1, Lc2, Li2, _ = flank_top2(jnp.maximum(ls - 5, 0), ls)
    good_l = has_lwin & ((Lc1 >= MIN_F) |
                         ((Lc1 + Lc2 > MIN_F + 1)
                          & ((Li1 == Li2 + 1) | (Li2 == Li1 + 1))))
    has_rwin = le + 5 < n - 1
    Rc1, Ri1, Rc2, Ri2, _ = flank_top2(le + 1, jnp.minimum(le + 6, n))
    good_r = has_rwin & ((Rc1 >= MIN_F) |
                         ((Rc1 + Rc2 > MIN_F + 1)
                          & ((Ri1 == Ri2 + 1) | (Ri2 == Ri1 + 1))))
    good_large = good_l | good_r | ~has_lwin | ~has_rwin
    trim_start_large = jnp.where(~has_lwin, 0, trim_start0)
    trim_end_large = jnp.where(~has_rwin, n - 1,
                               jnp.where(good_r, le + 1, trim_end0))

    small = n < 15
    good_flank = jnp.where(small, good_small, good_large)
    trim_start = jnp.where(small, trim_start_small, trim_start_large)
    trim_end = jnp.where(small, trim_end_small, trim_end_large)

    # ---- decision (process_read :968-1081) -------------------------------
    num_unassigned = n - num_assigned
    whole = (num_unassigned >= unassigned_min) & (num_assigned <= assigned_max)
    fully = num_assigned == n
    trimmed = ~whole & ~fully & good_flank
    decision = jnp.where(whole, 1, jnp.where(trimmed, 2, 0)).astype(jnp.int32)
    result = ClassifyResult(decision=decision,
                            trim_start=trim_start.astype(jnp.int32),
                            trim_end=trim_end.astype(jnp.int32),
                            num_assigned=num_assigned,
                            ids=ids, bools=bools)
    if debug:
        return (result, jnp.stack([t[0] for t in trace], axis=1),
                jnp.stack([t[1] for t in trace], axis=1))
    return result
