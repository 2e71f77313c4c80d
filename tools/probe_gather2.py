"""Why are the classify-path gathers ~20x faster than toy gathers?

Isolates: index provenance (input vs on-device-computed), consumer
(materialized vs reduced), and dtype/width, on the SAME 570 MB table.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import goldrush_jax  # noqa
import jax
import jax.numpy as jnp

SIZE = 142_368_384
N = 6_144_000
B = 64

rng = np.random.default_rng(0)
table = jnp.zeros(SIZE + 1, dtype=jnp.uint32)
h64 = jnp.asarray(rng.integers(0, 1 << 63, (B, N // B), dtype=np.int64)
                  .astype(np.uint64))
idx_in = jnp.asarray(rng.integers(0, SIZE, (B, N // B), dtype=np.int32))


@jax.jit
def _sc(x):
    return x.astype(jnp.float32).sum()


def t(name, fn, *args, n=6):
    out = fn(*args)
    float(_sc(out))
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    float(_sc(out))
    print(f"{name:52s} {(time.time()-t0)/n*1000:9.2f} ms")


def fastrange(h):
    h = h.astype(jnp.uint64)
    s = jnp.uint64(SIZE)
    p1 = (h >> jnp.uint64(32)) * s
    p2 = ((h & jnp.uint64(0xFFFFFFFF)) * s) >> jnp.uint64(32)
    return ((p1 + p2) >> jnp.uint64(32)).astype(jnp.int32)


t("gather idx=input  -> sum", jax.jit(lambda tb, i: tb[i].sum()),
  table, idx_in)
t("gather idx=input  -> materialize", jax.jit(lambda tb, i: tb[i]),
  table, idx_in)
t("gather idx=computed(fastrange) -> sum",
  jax.jit(lambda tb, h: tb[fastrange(h)].sum()), table, h64)
t("gather idx=computed(fastrange) -> materialize",
  jax.jit(lambda tb, h: tb[fastrange(h)]), table, h64)
t("gather idx=input^0 -> sum",
  jax.jit(lambda tb, i: tb[i ^ jnp.int32(0)].sum()), table, idx_in)
t("gather idx=input+0*tab[0] -> sum (barrier)",
  jax.jit(lambda tb, i: tb[(i + (tb[0] & 1).astype(jnp.int32))].sum()),
  table, idx_in)
# like the vote path: 3 seed-major gathers ANDed then reduced
idx3 = idx_in.reshape(B, 3, N // B // 3)
t("3x seed-major gathers AND'd -> sum",
  jax.jit(lambda tb, i: (tb[i[:, 0]] & tb[i[:, 1]] & tb[i[:, 2]]).sum()),
  table, idx3)
