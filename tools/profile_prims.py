"""Micro: the primitives behind the round-4 scan — scatter-add vs
scatter-max at insert sizes, gathers vs table size, single-row sorts."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import goldrush_jax  # noqa
import jax
import jax.numpy as jnp

SIZE = 142_368_768          # bench filter alloc
rng = np.random.default_rng(0)


@jax.jit
def _scal(x):
    return x[:1000].astype(jnp.float32).sum()


def t_donate(name, fn, w, *args, n=20):
    w = fn(w, *args)
    float(_scal(w))
    t0 = time.time()
    for _ in range(n):
        w = fn(w, *args)
    float(_scal(w))
    print(f"{name:44s} {(time.time()-t0)/n*1000:8.3f} ms", flush=True)
    return w


def t_pure(name, fn, *args, n=20):
    out = fn(*args)
    float(jnp.asarray(out).astype(jnp.float32).reshape(-1)[:1000].sum())
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    float(jnp.asarray(out).astype(jnp.float32).reshape(-1)[:1000].sum())
    print(f"{name:44s} {(time.time()-t0)/n*1000:8.3f} ms", flush=True)


words = jnp.zeros(SIZE, dtype=jnp.uint32)
for N in (20_000, 60_000):
    idx = jnp.asarray(rng.integers(0, SIZE, N, dtype=np.int64)
                      .astype(np.int32))
    vals = jnp.asarray(rng.integers(0, 1 << 29, N, dtype=np.int64)
                       .astype(np.uint32))
    add = jax.jit(lambda w, i, v: w.at[i].add(v, mode="drop"),
                  donate_argnums=(0,))
    mx = jax.jit(lambda w, i, v: w.at[i].max(v, mode="drop"),
                 donate_argnums=(0,))
    mxu = jax.jit(lambda w, i, v: w.at[i].max(v, mode="drop",
                                              unique_indices=True),
                  donate_argnums=(0,))
    words = t_donate(f"scatter-add {N//1000}k -> 570MB", add, words, idx,
                     vals)
    words = t_donate(f"scatter-max {N//1000}k -> 570MB", mx, words, idx,
                     vals)
    words = t_donate(f"scatter-max-unique {N//1000}k -> 570MB", mxu, words,
                     idx, vals)
    t_pure(f"gather {N//1000}k from 570MB",
           jax.jit(lambda w, i: w[i]), words, idx)

small = jnp.arange(1 << 22, dtype=jnp.uint32)          # 16 MB
idx60 = jnp.asarray(rng.integers(0, 1 << 22, 60_000, dtype=np.int64)
                    .astype(np.int32))
t_pure("gather 60k from 16MB", jax.jit(lambda w, i: w[i]), small, idx60)
packed = jnp.arange(1 << 19, dtype=jnp.uint32)         # 2 MB
t_pure("gather 60k from 2MB", jax.jit(lambda w, i: w[i]), packed,
       idx60 & jnp.int32((1 << 19) - 1))

for shape in ((24, 3000), (24, 1500), (1, 60_000), (1, 20_000)):
    a = jnp.asarray(rng.integers(0, 1 << 30, shape, dtype=np.int64)
                    .astype(np.uint32))
    t_pure(f"row-sort {shape}", jax.jit(lambda x: jnp.sort(x, axis=-1)), a)

a = jnp.asarray(rng.integers(0, 1 << 30, (64 * 20, 3000), dtype=np.int64)
                .astype(np.uint32))
t_pure("row-sort (1280, 3000) [batched]",
       jax.jit(lambda x: jnp.sort(x, axis=-1)), a)
idxB = jnp.asarray(rng.integers(0, SIZE, (64, 60_000), dtype=np.int64)
                   .astype(np.int32))
t_pure("gather 64x60k from 570MB [batched]",
       jax.jit(lambda w, i: w[i]), words, idxB)
