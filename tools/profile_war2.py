"""Bisect step_A (3.9 ms/step) down from fast primitives (0.004 ms/step)."""
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


def run_scan(step, pair=True, hlo=False):
    def scan(carry, slots, rec):
        return jax.lax.scan(step, carry, (slots, rec))
    fn = jax.jit(scan, donate_argnums=(0,))
    carry = (jnp.zeros(ALLOC, dtype=jnp.uint32),
             jnp.zeros(ALLOC, dtype=jnp.uint32))
    if not pair:
        carry = carry[0]
    if hlo:
        txt = fn.lower(carry, slots_b, recruit).compile().as_text()
        big = [ln.strip()[:120] for ln in txt.splitlines()
               if ("copy" in ln and "u32[142400064]" in ln)]
        print(f"  HLO big-buffer copies: {len(big)}")
        for ln in big[:6]:
            print("   ", ln)
    out = fn(carry, slots_b, recruit)
    jax.block_until_ready(out)
    t0 = time.time()
    R = 5
    for _ in range(R):
        out = fn(out[0], slots_b, recruit)
    jax.block_until_ready(out)
    return (time.time() - t0) / R


def mk(variant):
    def step(carry, xs):
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
            if variant == "novote":          # no accept logic at all
                accept = u_first
            elif variant == "nomod":         # accept w/o modulo
                accept = u_first & (post > 0)
            else:                            # full
                accept = u_first & ((s.astype(jnp.uint32)
                                     % jnp.maximum(post, 1)) == post - 1)
            if variant == "noold":           # scatter-max, no old gather
                w_idx = jnp.where(accept, s, dummy)
                words = words.at[w_idx].max(jnp.uint32(1 << 30) | 7,
                                            mode="drop")
            else:
                old = words[s]
                new = jnp.uint32(1 << 30) | jnp.uint32(7)
                w_idx = jnp.where(accept, s, dummy)
                words = words.at[w_idx].add(new - old, mode="drop")
            return words, counts

        carry = jax.lax.cond(rec, ins, lambda wc: wc, (words, counts))
        return carry, jnp.uint32(0)
    return step


for v in ("full", "nomod", "novote", "noold"):
    dt = run_scan(mk(v), hlo=(v in ("full", "noold")))
    print(f"step_A[{v}]                     {dt/B*1000:8.3f} ms/step")
