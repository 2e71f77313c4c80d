"""Isolate WHERE the ~8 ms/recruit goes inside a consume-style scan.

Hypothesis: XLA copy-insertion duplicates the carried filter buffer whenever
a gather of it precedes a scatter to it in the same scan iteration (WAR);
scatter-before-gather (RAW) and gather-free scatters are in-place.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import goldrush_jax  # noqa
import jax
import jax.numpy as jnp

SIZE = 142_400_000
ALLOC = SIZE + 64
N = 96_000
B = 16

rng = np.random.default_rng(0)
slots_b = jnp.asarray(
    np.sort(rng.integers(0, SIZE, (B, N), dtype=np.int64), axis=1),
    dtype=jnp.int32)
recruit = jnp.asarray(rng.random(B) < 0.55)


def run_scan(step, n_arrays=1, dtype=jnp.uint32):
    def scan(carry, slots, rec):
        return jax.lax.scan(step, carry, (slots, rec))
    fn = jax.jit(scan, donate_argnums=(0,))
    carry = tuple(jnp.zeros(ALLOC, dtype=dtype) for _ in range(n_arrays))
    if n_arrays == 1:
        carry = carry[0]
    out = fn(carry, slots_b, recruit)
    jax.block_until_ready(out)
    t0 = time.time()
    R = 5
    for _ in range(R):
        out = fn(out[0], slots_b, recruit)
    jax.block_until_ready(out)
    return (time.time() - t0) / R


def v_scatter_only(carry, xs):
    s, rec = xs
    carry = carry.at[s].add(jnp.uint32(1), mode="drop")
    return carry, jnp.uint32(0)


def v_scatter_then_gather(carry, xs):       # RAW
    s, rec = xs
    carry = carry.at[s].add(jnp.uint32(1), mode="drop")
    g = carry[s].sum()
    return carry, g


def v_gather_then_scatter(carry, xs):       # WAR
    s, rec = xs
    g = carry[s]
    carry = carry.at[s].add(g ^ jnp.uint32(1), mode="drop")
    return carry, jnp.uint32(0)


def v_scatter_max(carry, xs):
    s, rec = xs
    carry = carry.at[s].max(jnp.uint32(5), mode="drop")
    return carry, jnp.uint32(0)


def v_gather_then_max(carry, xs):           # probe then max-insert (WAR)
    s, rec = xs
    g = carry[s].sum()
    carry = carry.at[s].max(g & jnp.uint32(31), mode="drop")
    return carry, g


def v_pipelined(carry, xs):                 # insert(prev) then probe(curr)
    s, rec = xs
    # scatter first (prev read's insert), gather after (curr read's probe)
    carry = carry.at[s].max(jnp.uint32(5), mode="drop")
    g = carry[s].sum()
    return carry, g


def v_pipelined_cond(carry, xs):
    s, rec = xs
    carry = jax.lax.cond(
        rec, lambda c: c.at[s].max(jnp.uint32(5), mode="drop"),
        lambda c: c, carry)
    g = carry[s].sum()
    return carry, g


def v_set_unique(carry, xs):
    s, rec = xs
    carry = carry.at[s].set(jnp.uint32(5), mode="drop", unique_indices=True)
    return carry, jnp.uint32(0)


for nm, step in (("scatter-add only", v_scatter_only),
                 ("scatter then gather (RAW)", v_scatter_then_gather),
                 ("gather then scatter (WAR)", v_gather_then_scatter),
                 ("scatter-max only", v_scatter_max),
                 ("gather then scatter-max (WAR)", v_gather_then_max),
                 ("pipelined: max then gather (RAW)", v_pipelined),
                 ("pipelined + cond", v_pipelined_cond),
                 ("scatter-set unique", v_set_unique)):
    dt = run_scan(step)
    print(f"{nm:40s} {dt/B*1000:8.3f} ms/step")


# ---- round 2: find the culprit inside step_A ------------------------------
def v_oob_dummy(carry, xs):
    s, rec = xs
    dummy = ALLOC + jnp.arange(N, dtype=s.dtype)
    idx = jnp.where(s > SIZE // 2, s, dummy)
    carry = carry.at[idx].add(jnp.uint32(1), mode="drop")
    return carry, jnp.uint32(0)


def v_modulo(carry, xs):
    s, rec = xs
    g = carry[s]
    m = s.astype(jnp.uint32) % jnp.maximum(g, 1)
    carry = carry.at[s].add(m, mode="drop")
    return carry, jnp.uint32(0)


def v_cond_pair(carry2, xs):
    s, rec = xs

    def ins(wc):
        w, c = wc
        c = c.at[s].add(jnp.uint32(1), mode="drop")
        w = w.at[s].add(jnp.uint32(1), mode="drop")
        return w, c

    carry2 = jax.lax.cond(rec, ins, lambda wc: wc, carry2)
    return carry2, jnp.uint32(0)


def v_sort_in_step(carry, xs):
    s, rec = xs
    s2 = jax.lax.sort(s)
    carry = carry.at[s2].add(jnp.uint32(1), mode="drop")
    return carry, jnp.uint32(0)


def v_cumsum_chain(carry, xs):
    s, rec = xs
    u = jnp.cumsum((s != 0).astype(jnp.int32))
    rb = jax.lax.cummax(jnp.where(s > 100, u - 1, jnp.int32(-1)))
    fseg = jnp.cumsum(jnp.flip((s > 200)).astype(jnp.int64))
    ce = jnp.flip(jax.lax.cummax(fseg * jnp.int64(N + 2)
                                 + jnp.flip(u)) - fseg * jnp.int64(N + 2))
    carry = carry.at[s].add((rb + ce.astype(jnp.int32)).astype(jnp.uint32),
                            mode="drop")
    return carry, jnp.uint32(0)


for nm, step, na in (("OOB dummy-routed scatter", v_oob_dummy, 1),
                     ("u32 modulo in step", v_modulo, 1),
                     ("cond over (words,counts) pair", v_cond_pair, 2),
                     ("lax.sort 96k in step", v_sort_in_step, 1),
                     ("cumsum/cummax chain in step", v_cumsum_chain, 1)):
    dt = run_scan(step, n_arrays=na)
    print(f"{nm:40s} {dt/B*1000:8.3f} ms/step")
