"""Measure insert-variant cost inside a consume-style scan on the real chip.

Variants per scan step (carry = filter state, cond-guarded insert like the
engine's consume scan):
  A  current insert_read_sorted: 4 random streams over the table
     (counts scatter-add, counts gather, words gather, words scatter-add)
  P  packed u64 table [word<<32 | count]: gather pre-values once, compute
     accept from pre-count + rank, ONE combined scatter-add = 2 streams
  P3 packed, scatter-counts-first ordering (3 streams) — isolates whether
     a gather-before-scatter on the carried buffer forces a copy
Also: raw gather/scatter-add rates for u32 vs u64 at the bench filter size.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import goldrush_jax  # noqa
import jax
import jax.numpy as jnp

SIZE = 142_400_000          # bench filter slots (5 Mbp, occ 0.1)
ALLOC = SIZE + 64
N = 96_000                  # keys per read (3 seeds x 32 tiles x 1000 frames)
B = 16                      # scan steps

rng = np.random.default_rng(0)
slots_np = np.sort(rng.integers(0, SIZE, (B, N), dtype=np.int64), axis=1)
slots_b = jnp.asarray(slots_np, dtype=jnp.int32)
recruit = jnp.asarray(rng.random(B) < 0.55)

words0 = jnp.zeros(ALLOC, dtype=jnp.uint32)
counts0 = jnp.zeros(ALLOC, dtype=jnp.uint32)
packed0 = jnp.zeros(ALLOC, dtype=jnp.uint64)


def bench(name, fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / n
    print(f"{name:44s} {dt*1000:9.2f} ms  ({dt/B*1000:6.2f} ms/step)")
    return dt


# ---------------- raw rates -------------------------------------------------
def raw(table, idx):
    return table[idx].astype(jnp.uint32).sum()


def raw_scat(table, idx):
    return table.at[idx].add(jnp.asarray(1, table.dtype))


i0 = slots_b[0]
for nm, tab in (("u32", words0), ("u64", packed0)):
    f = jax.jit(raw)
    t = bench(f"raw gather {nm} N=96k", f, tab, i0, n=10)
    print(f"    -> {N/t/1e6:.1f} M elem/s")
    g = jax.jit(raw_scat, donate_argnums=(0,))
    tab2 = tab
    out = g(tab2, i0); jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(10):
        out = g(out, i0)
    jax.block_until_ready(out)
    t = (time.time() - t0) / 10
    print(f"raw scatter-add {nm} N=96k                    {t*1000:9.2f} ms"
          f"  -> {N/t/1e6:.1f} M elem/s")


# ---------------- variant A: current 4-stream ------------------------------
def step_A(carry, xs):
    words, counts = carry
    s, rec = xs

    def ins(wc):
        words, counts = wc
        prev = jnp.concatenate([jnp.full(1, -1, s.dtype), s[:-1]])
        u_first = s != prev
        dummy = ALLOC + jnp.arange(N, dtype=s.dtype)
        c_idx = jnp.where(u_first, s, dummy)
        counts = counts.at[c_idx].add(jnp.uint32(1), mode="drop")
        post = counts[s]
        accept = u_first & ((s.astype(jnp.uint32) % jnp.maximum(post, 1))
                            == post - 1)
        old = words[s]
        new = jnp.uint32(1 << 30) | jnp.uint32(7)
        w_idx = jnp.where(accept, s, dummy)
        words = words.at[w_idx].add(new - old, mode="drop")
        return words, counts

    carry = jax.lax.cond(rec, ins, lambda wc: wc, (words, counts))
    return carry, jnp.uint32(0)


# ---------------- variant P: packed 2-stream -------------------------------
def step_P(carry, xs):
    tab = carry
    s, rec = xs

    def ins(tab):
        prev = jnp.concatenate([jnp.full(1, -1, s.dtype), s[:-1]])
        u_first = s != prev
        dummy = ALLOC + jnp.arange(N, dtype=s.dtype)
        pre = tab[s]                               # ONE gather: word|count
        pre_cnt = pre.astype(jnp.uint32)
        cnt = pre_cnt + 1
        accept = u_first & ((s.astype(jnp.uint32) % jnp.maximum(cnt, 1))
                            == cnt - 1)
        old_w = (pre >> jnp.uint64(32)).astype(jnp.uint32)
        new_w = jnp.uint32(1 << 30) | jnp.uint32(7)
        w_delta = jnp.where(accept, new_w - old_w, jnp.uint32(0))
        delta = ((w_delta.astype(jnp.uint64) << jnp.uint64(32))
                 | jnp.where(u_first, jnp.uint64(1), jnp.uint64(0)))
        idx = jnp.where(u_first | accept, s, dummy)
        return tab.at[idx].add(delta, mode="drop")

    tab = jax.lax.cond(rec, ins, lambda t: t, tab)
    return tab, jnp.uint32(0)


# ---------------- variant P3: packed, scatter-first ------------------------
def step_P3(carry, xs):
    tab = carry
    s, rec = xs

    def ins(tab):
        prev = jnp.concatenate([jnp.full(1, -1, s.dtype), s[:-1]])
        u_first = s != prev
        dummy = ALLOC + jnp.arange(N, dtype=s.dtype)
        c_idx = jnp.where(u_first, s, dummy)
        tab = tab.at[c_idx].add(jnp.uint64(1), mode="drop")
        post = tab[s]
        cnt = post.astype(jnp.uint32)
        accept = u_first & ((s.astype(jnp.uint32) % jnp.maximum(cnt, 1))
                            == cnt - 1)
        old_w = (post >> jnp.uint64(32)).astype(jnp.uint32)
        new_w = jnp.uint32(1 << 30) | jnp.uint32(7)
        w_delta = (new_w - old_w).astype(jnp.uint64) << jnp.uint64(32)
        w_idx = jnp.where(accept, s, dummy)
        return tab.at[w_idx].add(w_delta, mode="drop")

    tab = jax.lax.cond(rec, ins, lambda t: t, tab)
    return tab, jnp.uint32(0)


def run_scan(step, carry0):
    def scan(carry, slots, rec):
        return jax.lax.scan(step, carry, (slots, rec))
    fn = jax.jit(scan, donate_argnums=(0,))
    carry = carry0
    out = fn(carry, slots_b, recruit)
    jax.block_until_ready(out)
    carry = out[0]
    t0 = time.time()
    R = 5
    for _ in range(R):
        out = fn(out[0], slots_b, recruit)
    jax.block_until_ready(out)
    return (time.time() - t0) / R


def step_none(carry, xs):
    return carry, jnp.uint32(0)


def step_A_nocond(carry, xs):
    words, counts = carry
    s, rec = xs
    prev = jnp.concatenate([jnp.full(1, -1, s.dtype), s[:-1]])
    u_first = s != prev
    dummy = ALLOC + jnp.arange(N, dtype=s.dtype)
    c_idx = jnp.where(u_first & rec, s, dummy)
    counts = counts.at[c_idx].add(jnp.uint32(1), mode="drop")
    post = counts[s]
    accept = rec & u_first & ((s.astype(jnp.uint32)
                               % jnp.maximum(post, 1)) == post - 1)
    old = words[s]
    new = jnp.uint32(1 << 30) | jnp.uint32(7)
    w_idx = jnp.where(accept, s, dummy)
    words = words.at[w_idx].add(new - old, mode="drop")
    return (words, counts), jnp.uint32(0)


def step_A_sort(carry, xs):
    words, counts = carry
    s, rec = xs

    def ins(wc):
        words, counts = wc
        s2 = jax.lax.sort(s)
        prev = jnp.concatenate([jnp.full(1, -1, s2.dtype), s2[:-1]])
        u_first = s2 != prev
        dummy = ALLOC + jnp.arange(N, dtype=s2.dtype)
        c_idx = jnp.where(u_first, s2, dummy)
        counts = counts.at[c_idx].add(jnp.uint32(1), mode="drop")
        post = counts[s2]
        accept = u_first & ((s2.astype(jnp.uint32)
                             % jnp.maximum(post, 1)) == post - 1)
        old = words[s2]
        new = jnp.uint32(1 << 30) | jnp.uint32(7)
        w_idx = jnp.where(accept, s2, dummy)
        words = words.at[w_idx].add(new - old, mode="drop")
        return words, counts

    carry = jax.lax.cond(rec, ins, lambda wc: wc, (words, counts))
    return carry, jnp.uint32(0)


def fresh(kind):
    if kind == "wc":
        return (jnp.zeros(ALLOC, dtype=jnp.uint32),
                jnp.zeros(ALLOC, dtype=jnp.uint32))
    return jnp.zeros(ALLOC, dtype=jnp.uint64)


for nm, step, kind in (("0  no-op step", step_none, "wc"),
                       ("A  4-stream cond (current)", step_A, "wc"),
                       ("An 4-stream no-cond masked", step_A_nocond, "wc"),
                       ("As 4-stream cond + in-step sort", step_A_sort, "wc"),
                       ("P  packed 2-stream cond", step_P, "u64"),
                       ("P3 packed 3-stream cond", step_P3, "u64")):
    dt = run_scan(step, fresh(kind))
    nrec = float(recruit.sum())
    print(f"scan {nm:36s} {dt*1000:9.2f} ms  "
          f"({dt/B*1000:6.2f} ms/step, {nrec:.0f}/{B} recruit)")
