"""Multi-device sharding of the golden-path engine.

The reference is single-node OpenMP (SURVEY P4: no distributed backend); the
scaling axes here are:

  data axis   — read batches shard across devices (DP): slots/frames/vote
                tables carry the batch dimension, classification is
                embarrassingly parallel per read.
  model axis  — the miBF arrays shard by slot range across devices
                (TP-analog "banked" filter) for capacity beyond one card's
                memory; probes into a sharded words array become
                XLA-inserted collectives between the devices.

Replicated mode keeps miBF replicas in sync without communication: inserts
are deterministic pure functions of (state, read), so every device computes
the identical update.  Sharded mode lets XLA route gathers/scatters.  Both
are expressed as shardings on the same kernels — no separate code path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..mibf import mibf as dm
from ..ops.nthash import SeedFamily
from ..path.classify import classify_batch


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int = 1) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"mesh of {n} devices requested, but JAX sees {len(devs)} "
            f"{devs[0].platform} device(s)")
    data = data or (n // model)
    if data * model != n:
        raise ValueError(f"data ({data}) x model ({model}) != devices ({n})")
    arr = np.array(devs[:n]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def shard_state(state: dm.MibfState, mesh: Mesh, sharded: bool
                ) -> dm.MibfState:
    """Place miBF arrays: slot-sharded over 'model' or fully replicated."""
    spec = P("model") if sharded else P()
    sh = NamedSharding(mesh, spec)
    return dm.MibfState(words=jax.device_put(state.words, sh),
                        counts=jax.device_put(state.counts, sh))


def classify_step(words, codes, lengths, fam: SeedFamily,
                  params: dm.MibfParams, num_tiles_max: int,
                  threshold: int, unassigned_min: int, assigned_max: int):
    """One fused classification step: hash -> slot grid -> probe/vote ->
    smoothing/decision.  The flagship compute path."""
    slots, frame_ok = dm.build_slot_grid(codes, lengths, fam, params,
                                         num_tiles_max)
    votes = dm.probe_and_vote(words, slots, frame_ok, params,
                              num_tiles=num_tiles_max)
    res = classify_batch(votes.curr_id, votes.top_count, votes.cand_ids,
                         votes.cand_counts,
                         (lengths // params.tile_length).astype(jnp.int32),
                         threshold, unassigned_min, assigned_max)
    return res, slots, votes


def train_step(state: dm.MibfState, codes, lengths, base_ids, fam: SeedFamily,
               params: dm.MibfParams, num_tiles_max: int, max_blocks: int,
               threshold: int = 10, unassigned_min: int = 5,
               assigned_max: int = 1):
    """One full engine step over a read batch: classify every read, then
    sequentially recruit the batch's whole-read candidates into the filter
    (scan over the batch axis — the state-mutating analog of a training
    step).  Returns (new_state, decisions)."""
    res, slots, _ = classify_step(
        state.words, codes, lengths, fam, params, num_tiles_max,
        threshold, unassigned_min, assigned_max)

    def recruit(carry, xs):
        st = carry
        slots_row, dec, ts, te, n_t, bid = xs
        lo = jnp.where(dec == 2, ts, 0)
        hi = jnp.where(dec == 2, te, n_t - 1)
        # route non-recruits to an empty insert (lo>hi => all blocks no-op)
        lo = jnp.where(dec == 0, jnp.int32(1), lo)
        hi = jnp.where(dec == 0, jnp.int32(0), hi)
        st = dm.insert_read(st, slots_row, lo, hi, bid.astype(jnp.uint32),
                            dec == 2, params, max_blocks=max_blocks,
                            num_tiles=num_tiles_max)
        return st, dec

    n_tiles = (lengths // params.tile_length).astype(jnp.int32)
    state, decs = jax.lax.scan(
        recruit, state,
        (slots, res.decision, res.trim_start, res.trim_end, n_tiles,
         base_ids))
    return state, decs


def sharded_train_step(mesh: Mesh, fam: SeedFamily, params: dm.MibfParams,
                       num_tiles_max: int, max_blocks: int,
                       shard_filter: bool):
    """jit-compiled multi-device step: batch sharded over 'data', miBF
    replicated or slot-sharded over 'model'."""
    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P("data"))
    state_sh = NamedSharding(mesh, P("model") if shard_filter else P())

    fn = partial(train_step, fam=fam, params=params,
                 num_tiles_max=num_tiles_max, max_blocks=max_blocks)
    return jax.jit(
        fn,
        in_shardings=(dm.MibfState(words=state_sh, counts=state_sh),
                      batch_sh, batch_sh, batch_sh),
        out_shardings=(dm.MibfState(words=state_sh, counts=state_sh), repl),
    )
