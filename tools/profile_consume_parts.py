"""Attribute the engine consume-scan cost: live re-classify vs insert-key
build vs insert scatters, using the REAL engine executable on bench-shaped
data with pieces force-toggled via monkeypatching the step closure inputs.

Strategy: build a GoldenPathEngine on a small synthetic dataset with bench
production settings, run fill, then time _consume_for executables compiled
with (a) stock, (b) live forced off, (c) insert forced off, (d) both off.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import goldrush_jax  # noqa
import jax
import jax.numpy as jnp

from goldrush_jax.config import PathConfig
from goldrush_jax.path.engine import GoldenPathEngine
from goldrush_jax.utils import synth

GENOME = 5_000_000
READ_LEN = 20_000
N_READS = 256
PRESET = "1011011110110111101101"

workdir = "/tmp/consume_prof"
os.makedirs(workdir, exist_ok=True)
reads_path = os.path.join(workdir, "reads.fq")
if not os.path.exists(reads_path):
    genome = synth.random_genome(GENOME, seed=11)
    rs = synth.simulate_reads(genome, N_READS, READ_LEN, seed=12,
                              err_rate=0.05)
    synth.write_fastq(reads_path, rs)

cfg = PathConfig(
    input=reads_path, genome_size=GENOME, kmer_size=22, weight=16,
    hash_num=3, seed_preset=PRESET, silver_path=True, max_paths=5,
    min_length=20_000, prefix_file=os.path.join(workdir, "p"),
    frame_stride=8, probe_seeds=1, recheck="optimistic")

eng = GoldenPathEngine(cfg)
eng.calc_phred_threshold(reads_path)
t0 = time.time()
eng.fill(reads_path)
print(f"fill: {time.time()-t0:.2f}s  size={eng.size}")

# build one batch of consume inputs
from goldrush_jax.io import ingest
TL = cfg.tile_length
B, T = 64, 32
codes = np.zeros((B, T * TL + TL), dtype=np.uint8)
lengths = np.zeros(B, dtype=np.int32)
fl = np.zeros(B, dtype=np.int64)
i = 0
with ingest.ReadStream(reads_path) as rsm:
    for rec in rsm.records():
        if rec.length < cfg.min_length:
            continue
        L = min(rec.length, T * TL + TL - 1)
        codes[i, :L] = rec.codes[:L]
        lengths[i] = L
        fl[i] = rec.length
        i += 1
        if i == B:
            break

codes_d = jnp.asarray(codes)
lengths_d = jnp.asarray(lengths)
fl_d = jnp.asarray(fl)
scal0 = jnp.asarray([0, 0, 1, 0], dtype=jnp.int64)

fn = eng._consume_for(B, T)
state = eng.state


def timeit(name, fn, state, n=3):
    # rows0 is a donated [B, 8] output buffer — fresh per call
    filt, out, scal = fn(state, codes_d, lengths_d, fl_d, scal0,
                         jnp.zeros((B, 8), dtype=jnp.int64))
    jax.block_until_ready(scal)
    t0 = time.time()
    for _ in range(n):
        filt, out, scal = fn(filt, codes_d, lengths_d, fl_d, scal0,
                             jnp.zeros((B, 8), dtype=jnp.int64))
    jax.block_until_ready(scal)
    dt = (time.time() - t0) / n
    dec = np.asarray(out)[:, 0]
    print(f"{name:34s} {dt*1000:9.2f} ms/batch ({dt/B*1000:6.2f} ms/read) "
          f"recruits={int((dec > 0).sum())}")
    return filt


state = timeit("stock (optimistic)", fn, state)

# variant: force live off (use batch classification always)
import goldrush_jax.path.engine as em
orig_cond = jax.lax.cond
eng2 = GoldenPathEngine(cfg)
eng2.state = state
real_cond = jax.lax.cond


def consume_variant(live_off=False, insert_off=False):
    e = GoldenPathEngine(cfg)
    e.phred_min = eng.phred_min
    # monkeypatch: wrap lax.cond to force predicates
    import goldrush_jax.mibf.mibf as dmm

    orig = jax.lax.cond

    def build(B, T):
        # copy of the engine's builder but with flags; easiest: patch
        # jnp.bool_ predicates by shadowing lax.cond selectively is fragile.
        raise SystemExit("unused")
    return e


# Simpler attribution: time sub-executables directly.
from goldrush_jax.mibf import mibf as dm
from goldrush_jax.path.classify import classify_batch

params, params_ins = eng.params, eng.params_ins
fam, x_eff = eng.fam, eng.x_eff

# (1) batched classify (the batch-start pass)
def batch_classify(filt, codes, lengths):
    n_tiles = (lengths // TL).astype(jnp.int32)
    slots, ok = dm.build_slot_grid(codes, lengths, fam, params, T)
    v = dm.probe_and_vote(filt, slots, ok, params, num_tiles=T)
    r = classify_batch(v.curr_id, v.top_count, v.cand_ids, v.cand_counts,
                       n_tiles, x_eff, cfg.unassigned_min, cfg.assigned_max)
    return r.decision


f1 = jax.jit(batch_classify)
r = f1(state.words, codes_d, lengths_d); jax.block_until_ready(r)
t0 = time.time()
for _ in range(5):
    r = f1(state.words, codes_d, lengths_d)
jax.block_until_ready(r)
print(f"batched classify B=64:             {(time.time()-t0)/5*1000:9.2f} "
      f"ms/batch ({(time.time()-t0)/5/B*1000:6.2f} ms/read)")

# (2) B=1 live classify (what use_live costs per conflicted read)
def one_classify(filt, codes, lengths):
    return batch_classify(filt, codes, lengths)


f2 = jax.jit(one_classify)
c1, l1 = codes_d[:1], lengths_d[:1]
r = f2(state.words, c1, l1); jax.block_until_ready(r)
t0 = time.time()
for _ in range(20):
    r = f2(state.words, c1, l1)
jax.block_until_ready(r)
print(f"B=1 live classify (top-level):     "
      f"{(time.time()-t0)/20*1000:9.2f} ms")

# (3) B=1 insert-key build (hash full-res + grid + sort)
def keybuild(codes, lengths):
    g = dm.build_slot_grid(codes, lengths, fam, params_ins, T)[0][0]
    return dm.build_insert_keys(g, T)


f3 = jax.jit(keybuild)
r = f3(c1, l1); jax.block_until_ready(r)
t0 = time.time()
for _ in range(20):
    r = f3(c1, l1)
jax.block_until_ready(r)
print(f"B=1 insert-key build (top-level):  "
      f"{(time.time()-t0)/20*1000:9.2f} ms")

# (4) batched insert-key build
def keybuild_b(codes, lengths):
    g = dm.build_slot_grid(codes, lengths, fam, params_ins, T)[0]
    return dm.build_insert_keys(g, T)


f4 = jax.jit(keybuild_b)
r = f4(codes_d, lengths_d); jax.block_until_ready(r)
t0 = time.time()
for _ in range(5):
    r = f4(codes_d, lengths_d)
jax.block_until_ready(r)
print(f"B=64 insert-key build (batched):   "
      f"{(time.time()-t0)/5*1000:9.2f} ms/batch "
      f"({(time.time()-t0)/5/B*1000:6.2f} ms/read)")

# (5) insert_read_sorted at top level
kz = f3(c1, l1)
f5 = jax.jit(lambda st, kz: dm.insert_read_sorted(
    st, kz, jnp.int32(0), jnp.int32(19), jnp.uint32(1), jnp.bool_(False),
    jnp.bool_(True), params_ins, num_tiles=T, assume_present=True))
st2 = f5(state, kz); jax.block_until_ready(st2.words)
t0 = time.time()
for _ in range(10):
    st2 = f5(st2, kz)
jax.block_until_ready(st2.words)
print(f"insert_read_sorted (top-level):    "
      f"{(time.time()-t0)/10*1000:9.2f} ms")
