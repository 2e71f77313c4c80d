"""Profile the consume-scan components on the device.

Measures, per read, the cost of:
  A. batched classify (probe+vote+classify for the whole batch at once)
  B. scan with insert only (cond always takes use_batch)
  C. scan with live re-probe only (no insert)
  D. full current scan (live + insert)
  E. chunk-level multi-read insert (one batched segmented insert for the
     whole batch) -- prototype of the rearchitecture
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import goldrush_jax  # noqa
import jax
import jax.numpy as jnp
from functools import partial

from goldrush_jax.config import PathConfig, calc_optimal_size
from goldrush_jax.mibf import mibf as dm
from goldrush_jax.ops.nthash import build_seed_family
from goldrush_jax.ops.seeds import make_seed_pattern
from goldrush_jax.path.classify import classify_batch

PRESET = "1011011110110111101101"
G = 5_000_000
B, T = 64, 32
RL = 20_000

MODE = "parity"   # parity: stride1 h3; tp: stride 8, 1 seed
import sys
if len(sys.argv) > 1:
    MODE = sys.argv[1]

seeds = make_seed_pattern(PRESET, 22, 16, 3)
fam = build_seed_family(seeds)
universe = int(2 * G * 0.5 * 3)
size = calc_optimal_size(universe, 1, 0.1)
if MODE == "smallfilt":
    size = calc_optimal_size(universe // 8, 1, 0.1)
print("filter size", size, "words MB", size * 4 / 1e6)

S = 1 if MODE in ("parity", "micro", "smallfilt") else 8
PS = 0 if MODE in ("parity", "micro", "smallfilt") else 1
params = dm.MibfParams(size=size, h=3, k=22, spans=tuple(len(s) for s in seeds),
                       tile_length=1000, threshold=max(1, 10 // S),
                       block_size=10, vote_topk=16, frame_stride=S,
                       vote_min=2 if S == 1 else max(1, 2 // S),
                       probe_seeds=PS)
params_full = dm.MibfParams(size=size, h=3, k=22,
                            spans=tuple(len(s) for s in seeds),
                            tile_length=1000, threshold=10, block_size=10,
                            vote_topk=16, frame_stride=1, vote_min=2)
TL = 1000
x_eff = params.threshold

rng = np.random.default_rng(0)
codes = rng.integers(0, 4, (B, T * TL + TL), dtype=np.uint8)
lengths = np.full(B, RL, dtype=np.int32)

state = dm.init_state(params)
# pre-fill some presence so probes look realistic
pre = rng.integers(0, size, 14_000_000, dtype=np.int64)
state = dm.MibfState(
    words=state.words.at[jnp.asarray(pre)].set(dm.PRESENT_BIT),
    counts=state.counts)

codes_d = jnp.asarray(codes)
lengths_d = jnp.asarray(lengths)


def probe(filt, s, ok):
    return dm.probe_and_vote(filt.words, s, ok, params, num_tiles=T)


def classify(votes, n_tiles):
    return classify_batch(votes.curr_id, votes.top_count, votes.cand_ids,
                          votes.cand_counts, n_tiles, x_eff, 5, 1)


@jax.jit
def batched_classify(filt, codes, lengths):
    n_tiles = (lengths // TL).astype(jnp.int32)
    slots_q, frame_ok = dm.build_slot_grid(codes, lengths, fam, params, T)
    votes0 = probe(filt, slots_q, frame_ok)
    res0 = classify(votes0, n_tiles)
    keys = (slots_q if S == 1 else
            dm.build_slot_grid(codes, lengths, fam, params_full, T)[0])
    keys = dm.build_insert_keys(keys, T)
    return res0.decision, keys


def make_scan_cond(recruit_frac):
    """Scan with the insert under lax.cond(dec>0): only recruits pay the
    table ops.  recruit_frac forces the decision rate to isolate cost."""
    def consume(filt, codes, lengths):
        n_tiles = (lengths // TL).astype(jnp.int32)
        slots_q, frame_ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        votes0 = probe(filt, slots_q, frame_ok)
        res0 = classify(votes0, n_tiles)
        if S == 1:
            g = slots_q
        else:
            g, _ = dm.build_slot_grid(codes, lengths, fam, params_full, T)
        keys = dm.build_insert_keys(g, T)
        thresh = int(B * recruit_frac)

        def body(carry, xs):
            filt, ids_ins, i = carry
            kz, n_t, dec0 = xs
            dec = jnp.where(i < thresh, 1, 0)

            def do_ins(f):
                base = (ids_ins + 1).astype(jnp.uint32)
                return dm.insert_read_sorted(
                    f, kz, jnp.int32(0), n_t - 1, base,
                    jnp.asarray(False), jnp.asarray(True), params_full,
                    num_tiles=T, assume_present=True)

            filt = jax.lax.cond(dec > 0, do_ins, lambda f: f, filt)
            ids_ins = ids_ins + jnp.where(dec > 0, 1 + RL // (TL * 10), 0)
            return (filt, ids_ins, i + 1), dec
        xs = (keys, n_tiles, res0.decision)
        (filt, _, _), out = jax.lax.scan(
            body, (filt, jnp.int64(0), jnp.int32(0)), xs)
        return filt, out
    return jax.jit(consume, donate_argnums=(0,))


def make_scan(do_live, do_insert):
    def consume(filt, codes, lengths):
        n_tiles = (lengths // TL).astype(jnp.int32)
        slots_q, frame_ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        votes0 = probe(filt, slots_q, frame_ok)
        res0 = classify(votes0, n_tiles)
        if S == 1:
            g = slots_q
        else:
            g, _ = dm.build_slot_grid(codes, lengths, fam, params_full, T)
        keys = dm.build_insert_keys(g, T)

        def body(carry, xs):
            filt, ids_ins, changed = carry
            sq, ok, kz, n_t, dec0 = xs
            if do_live:
                def use_live(_):
                    v = probe(filt, sq[None], ok[None])
                    r = classify(v, n_t[None])
                    return r.decision[0]
                def use_batch(_):
                    return dec0
                dec = jax.lax.cond(changed, use_live, use_batch, None)
            else:
                dec = dec0
            if do_insert:
                base = (ids_ins + 1).astype(jnp.uint32)
                filt = dm.insert_read_sorted(
                    filt, kz, jnp.int32(0), n_t - 1, base,
                    jnp.asarray(False), dec > 0, params_full, num_tiles=T,
                    assume_present=True)
            ids_ins = ids_ins + jnp.where(dec > 0, 1 + RL // (TL * 10), 0)
            changed = changed | (dec > 0)
            return (filt, ids_ins, changed), dec.astype(jnp.int32)

        xs = (slots_q, frame_ok, keys, n_tiles, res0.decision)
        (filt, ids_ins, _), out = jax.lax.scan(
            body, (filt, jnp.int64(0), jnp.bool_(False)), xs)
        return filt, out
    return jax.jit(consume, donate_argnums=(0,))


@jax.jit
def _to_scalar(x):
    leaves = jax.tree_util.tree_leaves(x)
    return sum(jnp.asarray(l).astype(jnp.float32).sum() for l in leaves
               if jnp.asarray(l).size < 10_000_000)


def timeit(name, fn, filt, n=8):
    # close the timing window with a host fetch of a SMALL scalar computed
    # by a separate executable (fn's own outputs include the filter)
    filt, out = fn(filt, codes_d, lengths_d)   # warm (compile)
    float(_to_scalar(out))
    t0 = time.time()
    for _ in range(n):
        filt, out = fn(filt, codes_d, lengths_d)
    float(_to_scalar(out))
    best = (time.time() - t0) / n
    print(f"{name:35s} {best*1000:9.2f} ms/batch  {best/B*1000:8.3f} ms/read"
          f"  {B/best:9.1f} reads/s")
    return filt


@jax.jit
def bc2(filt, codes, lengths):
    d, k = batched_classify(filt, codes, lengths)
    return filt, (d, k)


print("mode:", MODE)
if MODE == "micro":
    # isolate: sort, scatter, gather, cumsum at chunk scale; and the
    # filter-size dependence of the scan insert
    N = B * 3 * T * TL
    keys64 = jnp.asarray(rng.integers(0, 1 << 60, N, dtype=np.uint64))
    pay = jnp.arange(N, dtype=jnp.int32)
    idxs = jnp.asarray(rng.integers(0, size, N, dtype=np.int64))
    vals = jnp.ones(N, dtype=jnp.uint32)

    def t_small(name, fn, *args, n=8):
        out = fn(*args)
        float(_to_scalar(out))
        t0 = time.time()
        for _ in range(n):
            out = fn(*args)
        float(_to_scalar(out))
        dt = (time.time() - t0) / n
        print(f"{name:35s} {dt*1000:9.2f} ms")

    idxs32 = idxs.astype(jnp.int32)

    @partial(jax.jit, donate_argnums=(0,))
    def scat32_add(words, idxs, vals):
        return words.at[idxs].add(vals, mode="drop")

    @partial(jax.jit, donate_argnums=(0,))
    def scat32_set(words, idxs, vals):
        return words.at[idxs].set(vals, mode="drop")

    @jax.jit
    def gath32(words, idxs):
        return words[idxs].sum()

    w2 = state.counts
    out = scat32_add(w2, idxs32, vals); float(_to_scalar(out.sum()))
    t0 = time.time()
    for _ in range(4):
        out = scat32_add(out, idxs32, vals)
    float(_to_scalar(out.sum()))
    print(f"{'scatter-add 6.1M i32 idx':35s} {(time.time()-t0)/4*1000:9.2f} ms")
    t0 = time.time()
    for _ in range(4):
        out = scat32_set(out, idxs32, vals)
    float(_to_scalar(out.sum()))
    print(f"{'scatter-set 6.1M i32 idx':35s} {(time.time()-t0)/4*1000:9.2f} ms")
    t_small("gather 6.1M i32 idx from 570MB", gath32, out, idxs32)
    small_tab = jnp.arange(1 << 22, dtype=jnp.uint32)     # 16 MB
    t_small("gather 6.1M i32 from 16MB",
            gath32, small_tab, idxs32 & jnp.int32((1 << 22) - 1))
    med_tab = jnp.arange(1 << 25, dtype=jnp.uint32)       # 128 MB
    t_small("gather 6.1M i32 from 128MB",
            gath32, med_tab, idxs32 & jnp.int32((1 << 25) - 1))
    tab64 = jnp.zeros(size + 1, dtype=jnp.uint64)         # 1.14 GB u64
    t_small("gather 6.1M i32 from u64 1.1GB", gath32, tab64, idxs32)
    q = idxs32[: N // 24]                                 # stride-8 1-seed
    t_small("gather 256k i32 from 570MB", gath32, out, q)
    t_small("sort 6.1M u64", jax.jit(lambda k: jax.lax.sort(k)), keys64)
    t_small("sort 6.1M u64 + payload",
            jax.jit(lambda k, p: jax.lax.sort((k, p), num_keys=1)),
            keys64, pay)
    t_small("row-sort [64, 96k] u64",
            jax.jit(lambda k: jax.lax.sort(k.reshape(B, -1), dimension=1)),
            keys64)
    t_small("cumsum 6.1M i32",
            jax.jit(lambda p: jnp.cumsum(p)), pay)
    t_small("cummax 6.1M i64",
            jax.jit(lambda p: jax.lax.cummax(p.astype(jnp.int64))), pay)

    @partial(jax.jit, donate_argnums=(0,))
    def scat(words, idxs, vals):
        return words.at[idxs].add(vals, mode="drop")

    @partial(jax.jit, donate_argnums=(0,))
    def scat_unique(words, idxs, vals):
        return words.at[idxs].add(vals, mode="drop", unique_indices=True)

    @jax.jit
    def gath(words, idxs):
        return words[idxs].sum()

    w = state.counts
    t_small("scatter-add 6.1M -> 570MB", lambda i, v: None, idxs, vals) \
        if False else None
    out = scat(w, idxs, vals); float(_to_scalar(out.sum()))
    t0 = time.time()
    for _ in range(4):
        out = scat(out, idxs, vals)
    float(_to_scalar(out.sum()))
    print(f"{'scatter-add 6.1M->570MB (dup ok)':35s} "
          f"{(time.time()-t0)/4*1000:9.2f} ms")
    t0 = time.time()
    for _ in range(4):
        out = scat_unique(out, idxs, vals)
    float(_to_scalar(out.sum()))
    print(f"{'scatter-add 6.1M->570MB (unique)':35s} "
          f"{(time.time()-t0)/4*1000:9.2f} ms")
    t_small("gather 6.1M from 570MB", gath, out, idxs)
    import sys as _s
    _s.exit(0)

if MODE == "stages":
    # breakdown of the batched classify path
    @jax.jit
    def s_hash(filt, codes, lengths):
        from goldrush_jax.ops.nthash import hash_positions as hp
        return filt, hp(codes, fam, T * TL).sum()

    @jax.jit
    def s_grid(filt, codes, lengths):
        s, ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        return filt, (s.sum(), ok.sum())

    @jax.jit
    def s_gather(filt, codes, lengths):
        s, ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        H = params.probe_seeds or params.h
        tot = jnp.uint32(0)
        for i in range(H):
            tot += filt.words[s[:, i, :]].sum()
        return filt, tot

    @jax.jit
    def s_vote(filt, codes, lengths):
        s, ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        v = probe(filt, s, ok)
        return filt, (v.curr_id.sum(), v.top_count.sum())

    @jax.jit
    def s_classify(filt, codes, lengths):
        n_tiles = (lengths // TL).astype(jnp.int32)
        s, ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        v = probe(filt, s, ok)
        r = classify(v, n_tiles)
        return filt, (r.decision, r.num_assigned)

    @jax.jit
    def s_keys(filt, codes, lengths):
        s, ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        return filt, dm.build_insert_keys(s, T).sum()

    state = timeit("hash only", s_hash, state)
    state = timeit("hash+grid", s_grid, state)
    state = timeit("hash+grid+gather", s_gather, state)
    state = timeit("hash+grid+gather+vote", s_vote, state)
    state = timeit("full classify", s_classify, state)
    state = timeit("grid+rowsort keys", s_keys, state)
    import sys as _s
    _s.exit(0)

def make_scan_piece(piece):
    """Scan with a stripped-down insert body to localize the per-read cost:
    piece in {logic, counts, words, traffic, all}."""
    def consume(filt, codes, lengths):
        n_tiles = (lengths // TL).astype(jnp.int32)
        slots_q, frame_ok = dm.build_slot_grid(codes, lengths, fam, params, T)
        votes0 = probe(filt, slots_q, frame_ok)
        res0 = classify(votes0, n_tiles)
        if S == 1:
            g = slots_q
        else:
            g, _ = dm.build_slot_grid(codes, lengths, fam, params_full, T)
        keys = dm.build_insert_keys(g, T)

        def body(carry, xs):
            words, counts, tot = carry
            kz, n_t, dec0 = xs
            N = kz.shape[0]
            idx_dtype = params_full.idx_dtype
            slot = (kz >> jnp.uint64(dm.TILE_BITS)).astype(idx_dtype)
            t = (kz & jnp.uint64((1 << dm.TILE_BITS) - 1)).astype(jnp.int32)
            valid = (slot < size) & (t < n_t) & (dec0 > 0)
            if piece in ("logic", "all"):
                bs = 10
                m = jnp.where(valid, t // bs, 0)
                prev_valid = jnp.concatenate([jnp.zeros(1, bool), valid[:-1]])
                prev_slot = jnp.concatenate(
                    [jnp.full(1, -1, idx_dtype), slot[:-1]])
                prev_m = jnp.concatenate([jnp.full(1, -1, jnp.int32), m[:-1]])
                new_run = valid & (~prev_valid | (prev_slot != slot))
                u_first = new_run | (valid & (prev_m != m))
                run_end = valid & jnp.concatenate(
                    [~valid[1:] | (slot[1:] != slot[:-1]), jnp.ones(1, bool)])
                c = jnp.cumsum(u_first.astype(jnp.int32))
                run_base = jax.lax.cummax(
                    jnp.where(new_run, c - 1, jnp.int32(-1)))
                j = jnp.where(valid, c - run_base, 0)
                BIG = jnp.int64(N + 2)
                fseg = jnp.cumsum(jnp.flip(run_end).astype(jnp.int64))
                c_end = jnp.flip(
                    jax.lax.cummax(fseg * BIG + jnp.flip(c)) - fseg * BIG)
                j_total = jnp.where(valid, c_end - run_base, 0)
                tot = tot + j_total.sum() + j.sum()
            dummy = (jnp.asarray(params_full.alloc, idx_dtype)
                     + jnp.arange(N, dtype=idx_dtype))
            w_idx = jnp.where(valid, slot, dummy)
            if piece in ("counts", "traffic", "all"):
                counts = counts.at[w_idx].add(jnp.uint32(1), mode="drop")
                tot = tot + counts[w_idx].sum().astype(jnp.int64)
            if piece in ("words", "traffic", "all"):
                old = words[jnp.where(valid, slot, size)]
                words = words.at[w_idx].add(jnp.uint32(7) - old, mode="drop")
            return (words, counts, tot), dec0

        carry0 = (filt.words, filt.counts, jnp.int64(0))
        (w, c, tot), out = jax.lax.scan(
            body, carry0, (keys, n_tiles, res0.decision))
        return dm.MibfState(w, c), (out, tot)
    return jax.jit(consume, donate_argnums=(0,))


state = timeit("A batched classify+keys", bc2, state)
state = timeit("B1 scan seg-logic only", make_scan_piece("logic"), state)
state = timeit("B2 scan counts-traffic only", make_scan_piece("counts"),
               state)
state = timeit("B3 scan words-traffic only", make_scan_piece("words"), state)
state = timeit("B4 scan all traffic", make_scan_piece("traffic"), state)
state = timeit("B5 scan logic+traffic", make_scan_piece("all"), state)
state = timeit("B scan insert-only (real)", make_scan(False, True), state)
state = timeit("C scan live-probe-only", make_scan(True, False), state)
state = timeit("D scan full (live+insert)", make_scan(True, True), state)
state = timeit("F cond-insert 0% recruit", make_scan_cond(0.0), state)
state = timeit("F cond-insert 12% recruit", make_scan_cond(0.125), state)
state = timeit("F cond-insert 50% recruit", make_scan_cond(0.5), state)
state = timeit("F cond-insert 100% recruit", make_scan_cond(1.0), state)

# E: chunk-level multi-read insert: concatenate all reads' keys with read
# index packed in, one segmented pass.
REID_BITS = 8


@partial(jax.jit, donate_argnums=(0,), static_argnames=())
def chunk_insert(filt, codes, lengths, decisions, base_ids):
    n_tiles = (lengths // TL).astype(jnp.int32)
    if S == 1:
        g, _ = dm.build_slot_grid(codes, lengths, fam, params, T)
    else:
        g, _ = dm.build_slot_grid(codes, lengths, fam, params_full, T)
    # key = slot << (16+8) | read << 16 | tile
    H, TF = g.shape[-2], g.shape[-1]
    F = TF // T
    t_of = (jnp.arange(TF, dtype=jnp.int32) // F).astype(jnp.uint64)
    r_of = jnp.arange(B, dtype=jnp.uint64)[:, None, None]
    keys = ((g.astype(jnp.uint64) << jnp.uint64(24))
            | (r_of << jnp.uint64(16)) | t_of[None, None, :])
    keys = jax.lax.sort(keys.reshape(-1))
    slot = (keys >> jnp.uint64(24)).astype(jnp.int32)
    r = ((keys >> jnp.uint64(16)) & jnp.uint64(0xFF)).astype(jnp.int32)
    t = (keys & jnp.uint64(0xFFFF)).astype(jnp.int32)
    valid = (slot < size) & (decisions[r] > 0) & (t < n_tiles[r])
    bs = 10
    m = jnp.where(valid, t // bs, 0)
    block_id = base_ids[r] + m.astype(jnp.uint32)
    N = keys.shape[0]
    prev_valid = jnp.concatenate([jnp.zeros(1, bool), valid[:-1]])
    prev_slot = jnp.concatenate([jnp.full(1, -1, jnp.int32), slot[:-1]])
    prev_r = jnp.concatenate([jnp.full(1, -1, jnp.int32), r[:-1]])
    prev_m = jnp.concatenate([jnp.full(1, -1, jnp.int32), m[:-1]])
    new_run = valid & (~prev_valid | (prev_slot != slot))
    u_first = new_run | (valid & ((prev_m != m) | (prev_r != r)))
    run_end = valid & jnp.concatenate(
        [~valid[1:] | (slot[1:] != slot[:-1]), jnp.ones(1, bool)])
    c = jnp.cumsum(u_first.astype(jnp.int32))
    run_base = jax.lax.cummax(jnp.where(new_run, c - 1, jnp.int32(-1)))
    j = jnp.where(valid, c - run_base, 0)
    BIG = jnp.int64(N + 2)
    fseg = jnp.cumsum(jnp.flip(run_end).astype(jnp.int64))
    c_end = jnp.flip(jax.lax.cummax(fseg * BIG + jnp.flip(c)) - fseg * BIG)
    j_total = jnp.where(valid, c_end - run_base, 0)
    words, counts = filt
    gather_idx = jnp.where(valid, slot, size)
    dummy = size + 1 + jnp.arange(N, dtype=jnp.int32)
    c_idx = jnp.where(run_end, slot, dummy)
    counts = counts.at[c_idx].add(j_total.astype(jnp.uint32), mode="drop",
                                  unique_indices=True)
    post = counts[gather_idx]
    cnt = post - j_total.astype(jnp.uint32) + j.astype(jnp.uint32)
    rand = slot.astype(jnp.uint32) ^ block_id
    accept = u_first & ((rand % jnp.maximum(cnt, 1)) == cnt - 1)
    idx = jnp.arange(N, dtype=jnp.int64)
    enc = fseg * BIG + jnp.flip(jnp.where(accept, idx + 1, 0))
    smax = jnp.flip(jax.lax.cummax(enc) - fseg * BIG) - 1
    is_last = accept & (smax == idx)
    w_idx = jnp.where(is_last, slot, dummy)
    new_word = dm.PRESENT_BIT | block_id
    words = words.at[w_idx].set(new_word, mode="drop", unique_indices=True)
    return dm.MibfState(words, counts)


dec = jnp.ones(B, dtype=jnp.int32)
bids = jnp.arange(1, B * 3, 3, dtype=jnp.uint32)[:B]


def e_fn(filt, codes, lengths):
    filt = chunk_insert(filt, codes, lengths, dec, bids)
    return filt, filt.counts[0]


state = timeit("E chunk insert (all 64 recruit)", e_fn, state)
