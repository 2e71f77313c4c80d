"""Targeted gather/scatter shape-dependence microbench on the device.

The consume redesign hinges on the true cost of random gathers/scatters
into the filter arrays.  Flat-1D vs [B, N] 2D forms of the SAME work, all
dtypes i32, table 570 MB.
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

SIZE = 142_368_384
N = 6_144_000
B = 64

rng = np.random.default_rng(0)
table = jnp.zeros(SIZE + 1, dtype=jnp.uint32)
idx1 = jnp.asarray(rng.integers(0, SIZE, N, dtype=np.int32))
idx2 = idx1.reshape(B, N // B)
idx1_sorted = jnp.asarray(np.sort(np.asarray(idx1)))
vals1 = jnp.ones(N, dtype=jnp.uint32)
vals2 = vals1.reshape(B, N // B)


@jax.jit
def _sc(x):
    return x.astype(jnp.float32).sum()


def t(name, fn, *args, n=6):
    out = fn(*args)
    float(_sc(jnp.ravel(out)[:1000]))
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    float(_sc(jnp.ravel(out)[:1000]))
    print(f"{name:42s} {(time.time()-t0)/n*1000:9.2f} ms")
    return out


g1 = jax.jit(lambda tab, i: tab[i].sum())
g2 = jax.jit(lambda tab, i: tab[i].sum())           # 2D index form
g1v = jax.jit(lambda tab, i: tab[i])                # returns gathered vector

t("gather 1D 6.1M -> sum", g1, table, idx1)
t("gather 2D [64,96k] -> sum", g2, table, idx2)
t("gather 1D sorted 6.1M -> sum", g1, table, idx1_sorted)
t("gather 1D 6.1M -> vector out", g1v, table, idx1)

sc_add = jax.jit(lambda tab, i, v: tab.at[i].add(v, mode="drop"),
                 donate_argnums=(0,))
sc_add2 = jax.jit(lambda tab, i, v: tab.at[i].add(v, mode="drop"),
                  donate_argnums=(0,))
sc_set = jax.jit(lambda tab, i, v: tab.at[i].set(v, mode="drop"),
                 donate_argnums=(0,))
sc_set_u = jax.jit(
    lambda tab, i, v: tab.at[i].set(v, mode="drop", unique_indices=True),
    donate_argnums=(0,))
sc_add_u = jax.jit(
    lambda tab, i, v: tab.at[i].add(v, mode="drop", unique_indices=True),
    donate_argnums=(0,))

table = t("scatter-add 1D", sc_add, table, idx1, vals1)
table = t("scatter-add 2D [64,96k]", sc_add2, table, idx2, vals2)
table = t("scatter-add 1D sorted", sc_add, table, idx1_sorted, vals1)
table = t("scatter-set 1D", sc_set, table, idx1, vals1)
table = t("scatter-set 1D unique", sc_set_u, table, idx1, vals1)
table = t("scatter-add 1D unique", sc_add_u, table, idx1, vals1)

# fused grid-shaped gather like the classify path: [B, H, TF] from table
idx3 = idx1.reshape(B, 3, N // B // 3)
g3 = jax.jit(lambda tab, i: sum(tab[i[:, s, :]].sum() for s in range(3)))
t("gather 3x[64,32k] seed-major -> sum", g3, table, idx3)
