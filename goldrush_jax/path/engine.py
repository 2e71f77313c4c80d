"""Streaming golden/silver path engine.

Orchestrates the two-pass GoldRush-Path flow (goldrush_path.cpp:1096-1275)
around the batched device kernels:

  pass 1: host filter gates (length/phred/ACGT) -> whole-read hashing ->
          presence scatter (fill_bit_vector equivalent),
  pass 2: reads stream IN ORDER through optimistic micro-batches: a batched
          classify (hash -> probe/vote -> smoothing/decision) against the
          miBF state at batch start, then candidates (non-drop decisions) are
          re-checked sequentially against the live state before recruitment.

Batch staleness policy (cfg.recheck): "exact" (default) re-runs every read
against the live carried state from the first mid-batch insert onward, so
the engine is bit-exact sequential at ANY batch size (proven against the
compiled reference binary in tests/test_ref_parity.py); "optimistic" only
re-runs stale candidates — a read classified "drop" against the batch-start
state stays dropped, which can rarely diverge in recruit-dense phases (the
same nondeterminism class the reference accepts across thread interleavings,
MIBloomFilter.hpp:105-107) but skips the serialized re-checks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PathConfig, calc_optimal_size
from ..io import fastq, ingest
from ..mibf import mibf as dm
from ..ops.nthash import build_seed_family, hash_positions
from ..ops.phred import (MEDIAN_SAMPLES_NEEDED, MINIMUM_PHRED_THRESHOLD,
                         calc_median_phred, sum_phred)
from ..ops.seeds import make_seed_pattern
from .classify import classify_batch

# tile-bucket sizes: mid values between powers of two cut probe/insert
# padding waste (a 20-tile ONT read on a 32 bucket pays 60% extra scatter
# traffic); each bucket costs one extra jit executable, amortized by the
# persistent compile cache
BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 32, 48, 64, 96, 128, 192, 256,
           384, 512, 768, 1024, 1536, 2048)
# per-batch tile budget: a batch is cut so B_pad * T stays under this, so
# rare ultralong reads (large T buckets) run in small batches instead of
# padding a whole 64-read batch to their bucket
TILE_BUDGET = 4096
# the wavefront consume amortizes per-window fixed costs over bigger
# windows; its budget bounds the full-resolution grid memory
# (~budget * tile_length * h * 16 B ≈ 400 MB at 8192)
WAVE_TILE_BUDGET = 8192
# replay-record cache cap: the submit pass keeps eligible records in memory
# (seq/qual/codes views pinning their block buffers) so the replay pass
# skips the second stream over the input; beyond this many RETAINED
# allocation bytes (counted via PreppedRead.pinned_nbytes — views pin whole
# block buffers, so logical base counts undercount) it falls back to
# re-streaming (the reference's memory envelope must not be blown at scale)
REPLAY_CACHE_BYTES = 3_000_000_000
# process-level consume-executable cache (engine._consume_key -> jitted fn):
# engines with identical consume-relevant config share the compiled
# executable instead of re-paying trace + XLA-cache deserialize per engine
_CONSUME_CACHE: dict = {}


@dataclass
class EngineStats:
    valid_reads: int = 0
    total_tiles: int = 0
    assigned_tiles: int = 0
    unassigned_tiles: int = 0
    queries: int = 0
    hits: int = 0
    misses: int = 0
    reads_in_path: int = 0
    phred_sum_in_path: float = 0.0
    num_reads: int = 0
    num_passed_reads: int = 0
    skipped_phred: int = 0
    skipped_delta: int = 0
    skipped_length: int = 0
    skipped_invalid: int = 0
    vote_overflow: int = 0
    recruits: int = 0
    paths_completed: int = 0
    inserted_bases_in_path: int = 0
    wall_fill_s: float = 0.0
    wall_fill_stream_s: float = 0.0   # fill stream+scatter, pre-freeze
    wall_assign_s: float = 0.0
    wall_submit_s: float = 0.0       # assign: device submit pass
    wall_submit_first_s: float = 0.0  # first batch (compile) per bucket
    wall_replay_s: float = 0.0       # assign: host replay pass
    wall_fetch_s: float = 0.0        # assign: device->host row fetch
    num_batches: int = 0


def _device_memory_bytes() -> int:
    """Memory the filter may use on one device: the allocator's
    ``bytes_limit`` on an accelerator, the host's physical memory on the
    CPU backend.  A device that reports neither is an error."""
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise RuntimeError(
        f"{dev.platform} device {dev.device_kind!r} reports no bytes_limit")


from .engine_util import tile_min_count as _tile_min_count  # noqa: E402
from .engine_util import recheck_zone as _recheck_zone  # noqa: E402


def _bucket_for(num_tiles: int, cap: int) -> int:
    for b in BUCKETS:
        if num_tiles <= b:
            return min(b, cap)
    return cap


class GoldenPathEngine:
    """goldrush-path equivalent.  Construct, then call run()."""

    def __init__(self, cfg: PathConfig):
        cfg.validate()
        self.cfg = cfg
        self.seeds = make_seed_pattern(cfg.seed_preset, cfg.kmer_size,
                                       cfg.weight, cfg.hash_num)
        self.fam = build_seed_family(self.seeds)
        if cfg.ntcard and not cfg.hash_universe:
            # --ntcard: size the universe from a streaming F0 estimate
            # (goldrush_path.cpp:1110-1112); rbits=22 keeps the counter
            # banks at 33 MB (reference: 27 / 1 GB) with ample accuracy for
            # <= few-Gbp inputs
            from ..utils.ntcard import NtCardParams, estimate_genome_size
            self.universe = estimate_genome_size(
                cfg.input, self.seeds, NtCardParams(rbits=22, sbits=7))
        else:
            self.universe = cfg.derived_hash_universe()
        self.size = calc_optimal_size(self.universe, 1, cfg.occupancy)
        S = cfg.frame_stride
        if cfg.tile_length % S:
            raise ValueError("frame_stride must divide tile_length")
        self.x_eff = max(1, cfg.threshold // S)
        # probe_seeds > 0: the SAMPLED query tier hashes/probes only the
        # probed seed prefix (3x less hash+gather work at the reference
        # h=3).  Fill and insert cover cfg.insert_seeds (default: all h) —
        # ids at unprobed seeds' slots are invisible to the sampled tier's
        # direct hits, but they set the filter's background vote statistics
        # that the reference's trim flank heuristics depend on, and the
        # full-resolution trim recheck probes ALL insert seeds with the
        # exact reference gates (measured in tools/calib_gate.py:
        # 1-seed-everything scores Jaccard 0.787 vs exact, 3-seed-insert
        # 0.859, +recheck higher still).
        self.h_active = cfg.probe_seeds or cfg.hash_num
        seeds_q = self.seeds[: self.h_active]
        self.fam_q = (self.fam if self.h_active == cfg.hash_num
                      else build_seed_family(seeds_q))
        self.h_ins = cfg.insert_seeds or cfg.hash_num
        self.fam_ins = (self.fam if self.h_ins == cfg.hash_num
                        else build_seed_family(self.seeds[: self.h_ins]))
        self.params = dm.MibfParams(
            size=self.size, h=self.h_active, k=cfg.kmer_size,
            spans=tuple(len(s) for s in seeds_q),
            tile_length=cfg.tile_length, threshold=self.x_eff,
            block_size=cfg.block_size, vote_topk=cfg.vote_topk,
            # vote_min floors at 1 for S>1: 2//S would hit 0 at stride>=4,
            # letting every single spurious frame vote become a candidate
            # (reference gate: count > 2, goldrush_path.cpp:616); stride=1
            # keeps the exact reference gate
            frame_stride=S, vote_min=2 // S if S == 1 else max(1, 2 // S),
            probe_seeds=0, slot_map=cfg.slot_map)
        # insertion is full-resolution by default regardless of the query
        # stride; cfg.insert_stride > 1 samples the inserted frames too
        # (throughput mode, quality-gated).  params_full doubles as the
        # trim-recheck classifier: full resolution, all insert seeds, the
        # exact reference gates (x, vote_min=2)
        if cfg.tile_length % cfg.insert_stride:
            raise ValueError("insert_stride must divide tile_length")
        self.params_full = dataclasses.replace(
            self.params, h=self.h_ins,
            spans=tuple(len(s) for s in self.seeds[: self.h_ins]),
            frame_stride=1, vote_min=2, threshold=cfg.threshold,
            probe_seeds=0)
        self.params_ins = dataclasses.replace(
            self.params_full, frame_stride=cfg.insert_stride)
        self.compressed = cfg.mibf_mode == "compressed"
        self.cstate = None        # CompressedState after freeze
        self.state = dm.init_state(self.params)
        # multi-device execution (cfg.devices > 1): batch classification is
        # data-parallel over the 'data' mesh axis; the miBF either replicated
        # (model_shards == 1: every device computes the identical insert — no
        # sync traffic) or slot-BANKED over the 'model' axis
        # (model_shards > 1: words/counts shard by slot range, XLA routes
        # probe gathers/insert scatters with psum/local-masking collectives —
        # the capacity lever for filters beyond one chip's HBM, the TP analog
        # of SURVEY §5's distributed plan).  The reference's only analogous
        # knob is RAM (README.md:115-123).
        self.mesh = None
        self._shard_data = self._shard_repl = self._shard_filt = None
        self.data_shards = 1
        if cfg.devices > 1 or cfg.model_shards > 1:
            from ..parallel.mesh import make_mesh
            from jax.sharding import NamedSharding, PartitionSpec
            n = cfg.devices if cfg.devices > 1 else cfg.model_shards
            mm = cfg.model_shards
            if n % mm:
                raise ValueError(
                    f"devices ({n}) must be divisible by model_shards ({mm})")
            self.data_shards = n // mm
            self.mesh = make_mesh(n, data=self.data_shards, model=mm)
            self._shard_data = NamedSharding(self.mesh,
                                             PartitionSpec("data"))
            self._shard_repl = NamedSharding(self.mesh, PartitionSpec())
            self._shard_filt = (NamedSharding(self.mesh,
                                              PartitionSpec("model"))
                                if mm > 1 else self._shard_repl)
            if not self.compressed:
                self.state = dm.MibfState(
                    words=jax.device_put(self.state.words,
                                         self._shard_filt),
                    counts=jax.device_put(self.state.counts,
                                          self._shard_filt))
        # -f: read names to exclude from pass 2 (pass 1 still inserts their
        # presence bits — goldrush_path.cpp:1163-1170 loads the set, only
        # process_read consults it)
        self.filter_out: set[str] = set()
        if cfg.filter_file:
            import sys
            print(f"Using only reads not found in: {cfg.filter_file}",
                  file=sys.stderr)
            with open(cfg.filter_file) as f:
                self.filter_out.update(f.read().split())
        # --debug dumps per-pass tile states per read; force strict
        # sequential batches so every dump reflects the live filter
        # (the reference consumer is sequential, goldrush_path.cpp:1229).
        # Kept as engine state — cfg is the caller's object, never mutated.
        self.batch_reads = 1 if cfg.debug else cfg.batch_reads
        # wavefront consume (path/wavefront.py): the throughput-mode batched
        # round engine.  Active only with the optimistic+scatter-max policy
        # (its semantics class); GOLDRUSH_NO_WAVE forces the sequential
        # scan for A/B comparisons.  Windows are wave_window-read batches.
        import os as _os
        self._wave = (cfg.recheck == "optimistic" and cfg.wavefront
                      and not cfg.debug
                      and not _os.environ.get("GOLDRUSH_NO_FASTINS")
                      and not _os.environ.get("GOLDRUSH_NO_WAVE"))
        if self._wave:
            self.batch_reads = max(self.batch_reads, cfg.wave_window)
        self._tile_budget = WAVE_TILE_BUDGET if self._wave else TILE_BUDGET
        # -j: host-side pipelining depth — the producer thread may run this
        # many ingest blocks ahead of the device (the device analog of the
        # reference's OpenMP thread count, goldrush_path.cpp:1101-1103;
        # device parallelism itself scales via cfg.devices)
        self._prefetch = max(1, min(int(cfg.jobs), 16))
        self.phred_min = cfg.phred_min
        self.stats = EngineStats()
        self.writers: list[fastq.PathWriter] = []
        self._fill_fn = {}
        self._classify_fn = {}
        self._consume_fn = {}
        import threading
        self._consume_lock = threading.Lock()
        self._prewarm_thread: threading.Thread | None = None
        self._prewarm_key: tuple[int, int] | None = None
        self._prewarm_sim = (0, 1)      # pending (count, tile bucket)
        self._prewarm_done = False      # set when prewarm launched/declined

    # ------------------------------------------------------------------
    def _maybe_prewarm(self, lengths) -> None:
        """Feed read lengths into the first-batch grouping simulation and
        launch the consume-executable prewarm thread once a batch closes.
        Called from the earliest stream pass available (phred sampling
        before fill) so the compile/cache-load overlaps maximum host work."""
        if self._prewarm_thread is not None or self._prewarm_done:
            return
        if os.environ.get("GOLDRUSH_NO_PREWARM"):     # A/B: fill contention
            self._prewarm_done = True
            return
        TLp, capp = self.params.tile_length, self.cfg.max_tiles
        pn, pT = self._prewarm_sim
        for L in lengths:
            T_r = _bucket_for(L // TLp, capp)
            T_new = max(pT, T_r)
            if pn and (pn + 1) * T_new > self._tile_budget:
                self._launch_prewarm(pn, pT)
                break
            pn, pT = pn + 1, T_new
            if pn >= self.batch_reads:
                self._launch_prewarm(pn, pT)
                break
        self._prewarm_sim = (pn, pT)

    def calc_phred_threshold(self, path: str) -> None:
        """Auto threshold = max(10, median of first 50k passing reads)
        (goldrush_path.cpp:79-107)."""
        if self.phred_min != 0:
            return
        scores = np.zeros(MEDIAN_SAMPLES_NEEDED, dtype=np.uint32)
        count = 0
        with ingest.ReadStream(path, prefetch=self._prefetch) as rs:
            for block in rs:
                block = [r for r in block
                         if r.length >= self.cfg.min_length]
                if not block:
                    continue
                # the phred pass sees read lengths first — overlap the
                # consume compile/cache-load with this scan + fill (the
                # phred gate is not yet known; length-only grouping is the
                # correct key for uniform-length streams and merely wastes
                # the warm otherwise)
                self._maybe_prewarm(r.length for r in block)
                take = min(len(block), MEDIAN_SAMPLES_NEEDED - count)
                scores[count:count + take] = [r.phred_avg
                                              for r in block[:take]]
                count += take
                if count >= MEDIAN_SAMPLES_NEEDED:
                    break
        self.phred_min = max(MINIMUM_PHRED_THRESHOLD,
                             calc_median_phred(scores, count))

    # ------------------------------------------------------------------
    def fill(self, path: str) -> None:
        """Pass 1: presence fill over all gate-passing reads.

        Direct mode scatters the presence bit into the slot words; compressed
        mode fills a transient byte array which freeze() packs into the
        rank-compressed structure (the reference's setup() analog)."""
        t0 = time.time()
        st = self.stats
        # the phred pass may have fed lengths of pre-phred-gate reads into
        # the prewarm simulation without closing a batch; restart the
        # simulation so this pass's eligible stream is counted exactly once
        if self._prewarm_thread is None and not self._prewarm_done:
            self._prewarm_sim = (0, 1)
        if self.cfg.load_mibf:
            # resume from a saved filter: skip pass 1 entirely (the gate
            # bookkeeping of the skipped pass is not reconstructed; combine
            # with -f for explicit exclusions)
            state, meta = dm.load_state(self.cfg.load_mibf)
            # geometry check keys on the FILL-side params (params_full:
            # h_ins seeds, full spans): a filter's contents are determined
            # by what was inserted, not by the probed-seed prefix — a
            # filter saved by an exact engine must load into a
            # probe_seeds=1 engine with the same fill geometry (and two
            # engines differing in insert_seeds must NOT compare equal)
            pf = self.params_full
            want = dict(size=pf.size, h=pf.h, k=pf.k,
                        spans=tuple(pf.spans), tile_length=pf.tile_length)
            if meta != want:
                raise ValueError(
                    f"saved miBF geometry {meta} != engine {want}")
            if self._shard_filt is not None:
                state = dm.MibfState(
                    words=jax.device_put(state.words, self._shard_filt),
                    counts=jax.device_put(state.counts, self._shard_filt))
            self.state = state
            st.num_passed_reads = -1     # unknown; loaded
            st.wall_fill_s += time.time() - t0
            return
        # non-banked compressed fills reuse the DIRECT presence path (one
        # flat u32 scatter instead of the byte-row transient) and
        # pack/rank from the words' PRESENT bit; the
        # banked mode keeps the byte rows (1 B/slot per shard at genome
        # scale where the 4 B/slot transient would not fit)
        cz_via_words = (self.compressed and self._shard_filt is None
                        and self.params.alloc * 4 * 3
                        < _device_memory_bytes())
        if self.compressed and not cz_via_words:
            from ..mibf import compressed as cz
            R = cz.fill_rows(self.params.size)
            if self._shard_filt is not None:
                R = -(-R // self.cfg.model_shards) * self.cfg.model_shards
            words = jnp.zeros((R, cz.FILL_COLS), dtype=jnp.uint8)
            if self._shard_filt is not None:
                words = jax.device_put(words, self._shard_filt)
        elif cz_via_words:
            # the direct-layout state allocated at __init__ serves as the
            # presence transient; freed right after the freeze below
            words = self.state.words
        else:
            words = self.state.words
        # presence covers every seed the engine will ever probe: the
        # sampled tier's seeds are a prefix of the insert seeds, and the
        # full-res trim recheck probes all insert seeds with the h-way
        # AND gate
        fam_fill = self.fam_ins
        spans = self.params_ins.spans

        def fill_for(P):
            """Fused hash+scatter executable per padded length (hashing on
            device inside the same jit; data-parallel over the mesh when
            cfg.devices > 1 — every device scatters into its replica)."""
            if P in self._fill_fn:
                return self._fill_fn[P]
            size, mode, fam = self.params.size, self.cfg.slot_map, fam_fill
            idx_dtype = self.params.idx_dtype
            if self.compressed and not cz_via_words:
                from ..mibf import compressed as cz

                def step(words, codes, valid):
                    hashes = hash_positions(codes, fam, P)
                    return cz.fill_bytes(words, hashes, valid, size, mode)
            else:
                def step(words, codes, valid):
                    hashes = hash_positions(codes, fam, P)
                    return dm.fill_presence(words, hashes, valid, size,
                                            idx_dtype, mode)
            if self.mesh is None:
                fn = jax.jit(step, donate_argnums=(0,))
            else:
                # presence array banked over 'model' when model_shards > 1
                fn = jax.jit(step, donate_argnums=(0,),
                             in_shardings=(self._shard_filt,
                                           self._shard_data,
                                           self._shard_data),
                             out_shardings=self._shard_filt)
            self._fill_fn[P] = fn
            return fn
        # producer thread (native C++ reader when available) runs parse +
        # encode + phred ahead of the device scatter (read_hashing.cpp
        # producer-pool analog)
        with ingest.ReadStream(path, prefetch=self._prefetch) as rs:
            for block in rs:
                st.num_reads += len(block)
                keep = []
                for r in block:
                    if r.length < self.cfg.min_length:
                        st.skipped_length += 1
                    else:
                        keep.append(r)
                if not keep:
                    continue
                good = []
                for r in keep:
                    bad_p = r.phred_avg < self.phred_min
                    bad_d = r.phred_delta >= self.cfg.phred_delta
                    if bad_p or bad_d:
                        st.skipped_phred += int(bad_p)
                        st.skipped_delta += int(bad_d)
                        self.filter_out.add(r.id)
                        continue
                    if r.invalid:
                        st.skipped_invalid += 1
                        self.filter_out.add(r.id)
                        continue
                    good.append(r)
                if not good:
                    continue
                st.num_passed_reads += len(good)
                # replicate the assign pass's first batch grouping on the
                # eligible stream (same gates, same order) and prewarm its
                # consume executable in a side thread while fill streams on
                self._maybe_prewarm(r.length for r in good)
                # fixed batch/length buckets keep jit shapes stable
                FB = 64
                good.sort(key=lambda r: r.length)
                i = 0
                while i < len(good):
                    batch = good[i: i + FB]
                    i += FB
                    L = max(r.length for r in batch)
                    Lb = 1 << max(10, (L - 1).bit_length())
                    P = Lb - self.params.k + 1
                    codes = np.zeros((FB, Lb), dtype=np.uint8)
                    valid = np.zeros((FB, len(spans), P), dtype=bool)
                    for j, r in enumerate(batch):
                        codes[j, : r.length] = r.codes
                        for s, span in enumerate(spans):
                            valid[j, s, : max(r.length - span + 1, 0)] = True
                    words = fill_for(P)(words, codes, jnp.asarray(valid))
        if st.num_passed_reads == 0:
            raise RuntimeError(
                "no reads passed the Phred score and min length requirements")
        jax.block_until_ready(words)
        st.wall_fill_stream_s = time.time() - t0
        if self.compressed:
            from ..mibf import compressed as cz
            if cz_via_words:
                self.cstate = cz.freeze_device_words(words, self.params.size)
            else:
                self.cstate = cz.freeze_device(words, self.params.size)
            del words
            self.state = None       # free the direct-layout transient
            if self._shard_filt is not None:
                # bank the rank-indexed id/counter arrays over 'model' (the
                # rank structure itself is small and replicated) — the
                # memory-parity mode's capacity lever at genome scale
                # (compressed.py:18-21)
                self.cstate = cz.CompressedState(
                    bitrank=jax.device_put(self.cstate.bitrank,
                                           self._shard_repl),
                    supers=jax.device_put(self.cstate.supers,
                                          self._shard_repl),
                    ids=jax.device_put(self.cstate.ids, self._shard_filt),
                    counts=jax.device_put(self.cstate.counts,
                                          self._shard_filt))
        else:
            self.state = dm.MibfState(words=words, counts=self.state.counts)
        st.wall_fill_s += time.time() - t0

    def _filt_shardings(self):
        """Pytree of shardings for the filter state under the mesh."""
        if self.compressed:
            from ..mibf.compressed import CompressedState
            return CompressedState(
                bitrank=self._shard_repl, supers=self._shard_repl,
                ids=self._shard_filt, counts=self._shard_filt)
        return dm.MibfState(words=self._shard_filt,
                            counts=self._shard_filt)

    # ------------------------------------------------------------------
    def _open_writer(self, curr_path: int) -> None:
        cfg = self.cfg
        if cfg.silver_path:
            w = fastq.PathWriter(f"{cfg.prefix_file}_{curr_path}.fq", True)
        else:
            w = fastq.PathWriter(f"{cfg.prefix_file}.fa", False)
        self.writers.append(w)

    def _classify(self, codes, lengths, T):
        """hash -> grid -> vote -> classify for a padded [B] batch.

        One fused jit executable per (B, T) bucket — re-checks against the
        live state reuse the batch-shaped executable instead of compiling a
        [1]-batch variant per bucket."""
        key = (codes.shape[0], T)
        if key not in self._classify_fn:
            params, x_eff, cfg = self.params, self.x_eff, self.cfg

            def step(filt, codes, lengths):
                slots, frame_ok = dm.build_slot_grid(
                    codes, lengths, self.fam_q, params, T)
                if self.compressed:
                    from ..mibf import compressed as cz
                    votes = cz.probe_and_vote(filt, slots, frame_ok, params,
                                              num_tiles=T)
                else:
                    votes = dm.probe_and_vote(filt, slots, frame_ok, params,
                                              num_tiles=T)
                res = classify_batch(
                    votes.curr_id, votes.top_count, votes.cand_ids,
                    votes.cand_counts,
                    (lengths // params.tile_length).astype(jnp.int32),
                    x_eff, cfg.unassigned_min, cfg.assigned_max)
                return slots, votes, res

            self._classify_fn[key] = jax.jit(step)
        filt = self.cstate if self.compressed else self.state.words
        return self._classify_fn[key](
            filt, jnp.asarray(codes),
            jnp.asarray(lengths, dtype=jnp.int32))

    def _debug_dump(self, codes, lengths, batch, T):
        """--debug: per-pass tile-state dumps against the live filter
        (log_tile_states parity, goldrush_path.cpp:109-124, dump sites
        :637-880)."""
        key = (codes.shape[0], T, "dbg")
        if key not in self._classify_fn:
            params, x_eff, cfg = self.params, self.x_eff, self.cfg

            def step(filt, codes, lengths):
                slots, frame_ok = dm.build_slot_grid(
                    codes, lengths, self.fam_q, params, T)
                if self.compressed:
                    from ..mibf import compressed as cz
                    votes = cz.probe_and_vote(filt, slots, frame_ok, params,
                                              num_tiles=T)
                else:
                    votes = dm.probe_and_vote(filt, slots, frame_ok, params,
                                              num_tiles=T)
                return classify_batch(
                    votes.curr_id, votes.top_count, votes.cand_ids,
                    votes.cand_counts,
                    (lengths // params.tile_length).astype(jnp.int32),
                    x_eff, cfg.unassigned_min, cfg.assigned_max, debug=True)

            self._classify_fn[key] = jax.jit(step)
        filt = self.cstate if self.compressed else self.state.words
        _, ids_tr, bools_tr = self._classify_fn[key](
            filt, jnp.asarray(codes), jnp.asarray(lengths, dtype=jnp.int32))
        from ..utils.observability import log_tile_states
        ids_tr = np.asarray(ids_tr)
        bools_tr = np.asarray(bools_tr)
        TL = self.cfg.tile_length
        for i, _r in enumerate(batch):
            n = int(lengths[i]) // TL
            for p in range(ids_tr.shape[1]):
                log_tile_states(ids_tr[i, p, :n], bools_tr[i, p, :n])

    # ------------------------------------------------------------------
    def _consume_for(self, B, T):
        """Fused per-batch executable: batched classify + grid/sort prep,
        then an exact sequential consume scan over the batch.

        The executable is fetch-free: its outputs are chained device-to-
        device across batches (``scal``) and the per-read rows are fetched
        by the host only AFTER the whole pass, so the steady-state loop
        never waits on a device-to-host transfer.  Structure:

          * each step re-probes the LIVE state and classifies, via a cond
            whose outputs are only the small per-read decision tuple (the
            filter is a read-only operand); while the state is unchanged
            since batch start the step reuses the batched classification,
          * insertion runs ONLY for recruits, under a lax.cond whose false
            branch passes the filter through: a recruit pays the one-pass
            sorted-key scatter (grid + row sort + 4 table ops over its hash
            set), a drop pays ~nothing (running the masked insert for every
            read would charge every read a recruit's insert;
            tools/profile_scan.py B vs F variants),
          * a silver rotation resets the filter in-scan (rare-true cond)
            and processing continues within the batch; path accounting is
            reconstructed by the host replay from the per-read rows.

        Staleness policy (cfg.recheck): "exact" re-probes every read from
        the first in-batch state change onward — bit-exact sequential at ANY
        batch size (proven vs the compiled reference in test_ref_parity);
        "optimistic" re-probes only stale candidates (a stale "drop" stays
        dropped — rare drift in recruit-dense phases)."""
        key = (B, T)
        with self._consume_lock:
            return self._consume_for_locked(key)

    def _consume_key(self, B, T):
        """Process-level cache key: every config bit the consume closure
        bakes in.  MibfParams is a frozen dataclass (hashable); meshes are
        excluded (mesh engines keep per-engine executables)."""
        import os as _os
        cfg = self.cfg
        # the resolved fast-insert flag is baked into the closure (see
        # _consume_for_locked); keying on it keeps a mid-process
        # GOLDRUSH_NO_FASTINS toggle (A/B comparisons) from reusing a
        # cached executable with the wrong insert rule
        fast = (cfg.recheck != "exact"
                and not _os.environ.get("GOLDRUSH_NO_FASTINS"))
        ranksc = bool(_os.environ.get("GOLDRUSH_RANKSCAN"))
        return (B, T, self.params, self.params_ins, self.compressed, fast,
                self._wave, ranksc,
                cfg.recheck, cfg.trim_recheck, cfg.insert_stride,
                cfg.silver_path, int(cfg.target_bases()), cfg.max_paths,
                cfg.unassigned_min, cfg.assigned_max, cfg.threshold,
                self.h_active, self.h_ins, tuple(self.seeds))

    def _consume_for_locked(self, key):
        B, T = key
        if key in self._consume_fn:
            return self._consume_fn[key]
        if self.mesh is None:
            gkey = self._consume_key(B, T)
            fn = _CONSUME_CACHE.get(gkey)
            if fn is not None:
                self._consume_fn[key] = fn
                return fn
        params, params_ins = self.params, self.params_ins
        params_full = self.params_full
        fam, fam_ins = self.fam_q, self.fam_ins
        cfg, x_eff = self.cfg, self.x_eff
        mesh, repl = self.mesh, self._shard_repl
        TL, bs = params.tile_length, params.block_size
        silver = bool(cfg.silver_path)
        exact = cfg.recheck == "exact"
        # optimistic mode swaps the bit-parity reservoir insert (sorted
        # keys + counter traffic) for the one-scatter-max insert
        # (mibf.insert_read_max) — the reservoir's winner-selection is the
        # one semantic the reference itself treats as nondeterministic
        # (MIBloomFilter.hpp:105-107)
        import os as _os
        fast = not exact and not _os.environ.get("GOLDRUSH_NO_FASTINS")
        target = int(cfg.target_bases())
        max_paths = int(cfg.max_paths)
        u_min, a_max = cfg.unassigned_min, cfg.assigned_max
        compressed = self.compressed
        # full-resolution trim recheck (cfg.trim_recheck): boundary-zone
        # reads re-classify at full res, all insert seeds, exact gates — a
        # no-op when the primary classify already IS that classifier
        rech_on = (cfg.trim_recheck and cfg.insert_stride == 1
                   and (params.frame_stride > 1
                        or self.h_active < self.h_ins))
        # the query grid can double as the insert grid only at full common
        # resolution over the same seeds
        reuse_q = (params.frame_stride == 1 and params_ins.frame_stride == 1
                   and self.h_active == self.h_ins)
        if compressed:
            from ..mibf import compressed as cz

        def classify(votes, n_tiles):
            return classify_batch(votes.curr_id, votes.top_count,
                                  votes.cand_ids, votes.cand_counts,
                                  n_tiles, x_eff, u_min, a_max)

        def classify_rech(votes, n_tiles):
            return classify_batch(votes.curr_id, votes.top_count,
                                  votes.cand_ids, votes.cand_counts,
                                  n_tiles, cfg.threshold, u_min, a_max)

        def consume(filt, codes, lengths, full_lengths, scal0, rows0):
            # scal0: int64 [4] = ids_inserted, inserted_bases, path_idx,
            # done — device-chained across batches, never read by the host
            # until the whole pass is over.  lengths are bucket-capped for
            # the probe grid; full_lengths are the true read lengths, used
            # for inserted-base accounting (process_read adds the whole
            # read, goldrush_path.cpp:996-1000).  rows0: int64 [B, 8]
            # donated per-read output buffer — EVERY output of this
            # executable is donation-aliased (filt, scal, rows), so a call
            # allocates no new output buffers
            #
            # The scan carry's filter ("sf") is the MUTATED subset of the
            # state only: the full MibfState/CompressedState in exact mode,
            # just the words (direct) / ids (compressed) array in fast
            # mode — counts and the rank structure pass through untouched.
            # rank-space scan (cz.rank_grid precompute + pure id-table
            # probes) is OPT-IN: the batched rank mapping replaces the
            # per-probe rank lookups that XLA fuses into the gathers, and
            # which of the two is faster is decided by an A/B on the
            # device.  The wavefront consume still requires it (its merged
            # scatters are rank-indexed).
            rank_scan = (compressed and fast
                         and bool(_os.environ.get("GOLDRUSH_RANKSCAN")))
            if rank_scan:
                br, su, cn = filt.bitrank, filt.supers, filt.counts

                def probe(sf, r, ok):
                    return cz.probe_and_vote_ranks(sf, r, ok, params,
                                                   num_tiles=T)

                def probe_full(sf, r, ok):
                    return cz.probe_and_vote_ranks(sf, r, ok, params_full,
                                                   num_tiles=T)

                def insert_sf(sf, ri, crow, ln, rq, lo, hi, base, trimmed):
                    return cz.insert_ranks_max(sf, ri, lo, hi, base,
                                               trimmed, params_ins,
                                               num_tiles=T)

                def reset(sf):
                    return jnp.zeros_like(sf)

                def sf_of(filt):
                    return filt.ids

                def repack(sf):
                    return cz.CompressedState(br, su, sf, cn)
            elif compressed and fast:
                # DEFAULT fast path: the slot-space scan — per-probe rank
                # lookups inside the step (fuse into the gathers, see above)
                br, su, cn = filt.bitrank, filt.supers, filt.counts

                def probe(sf, s, ok):
                    st = cz.CompressedState(br, su, sf, cn)
                    return cz.probe_and_vote(st, s, ok, params, num_tiles=T)

                def probe_full(sf, s, ok):
                    st = cz.CompressedState(br, su, sf, cn)
                    return cz.probe_and_vote(st, s, ok, params_full,
                                             num_tiles=T)

                def insert_sf(sf, si, crow, ln, sq, lo, hi, base, trimmed):
                    st = cz.CompressedState(br, su, sf, cn)
                    return cz.insert_read_max(st, si, lo, hi, base, trimmed,
                                              params_ins, num_tiles=T)

                def reset(sf):
                    return jnp.zeros_like(sf)

                def sf_of(filt):
                    return filt.ids

                def repack(sf):
                    return cz.CompressedState(br, su, sf, cn)
            elif compressed:
                def probe(sf, s, ok):
                    return cz.probe_and_vote(sf, s, ok, params, num_tiles=T)

                def probe_full(sf, s, ok):
                    return cz.probe_and_vote(sf, s, ok, params_full,
                                             num_tiles=T)

                def insert_sf(sf, si, crow, ln, sq, lo, hi, base, trimmed):
                    if reuse_q:
                        g = sq
                    else:
                        g = dm.build_slot_grid(crow[None], ln[None],
                                               fam_ins, params_ins, T)[0][0]
                    kz = cz.build_insert_keys(sf, g, params_ins, T)
                    # every engine-inserted rank was presence-filled in
                    # pass 1 and saturation is never set -> skip the
                    # old-entry gather
                    return cz.insert_read_sorted(sf, kz, lo, hi, base,
                                                 trimmed, jnp.bool_(True),
                                                 params_ins, num_tiles=T,
                                                 assume_present=True)

                def reset(sf):
                    return cz.reset_ids(sf)

                def sf_of(filt):
                    return filt

                def repack(sf):
                    return sf
            elif fast:
                counts_in = filt.counts

                def probe(sf, s, ok):
                    return dm.probe_and_vote(sf, s, ok, params, num_tiles=T)

                def probe_full(sf, s, ok):
                    return dm.probe_and_vote(sf, s, ok, params_full,
                                             num_tiles=T)

                def insert_sf(sf, si, crow, ln, sq, lo, hi, base, trimmed):
                    return dm.insert_read_max(sf, si, lo, hi, base, trimmed,
                                              params_ins, num_tiles=T)

                def reset(sf):
                    return sf & dm.PRESENT_BIT

                def sf_of(filt):
                    return filt.words

                def repack(sf):
                    return dm.MibfState(words=sf, counts=counts_in)
            else:
                def probe(sf, s, ok):
                    return dm.probe_and_vote(sf.words, s, ok, params,
                                             num_tiles=T)

                def probe_full(sf, s, ok):
                    return dm.probe_and_vote(sf.words, s, ok, params_full,
                                             num_tiles=T)

                def insert_sf(sf, si, crow, ln, sq, lo, hi, base, trimmed):
                    if reuse_q:
                        g = sq
                    else:
                        g = dm.build_slot_grid(crow[None], ln[None],
                                               fam_ins, params_ins, T)[0][0]
                    kz = dm.build_insert_keys(g, T)
                    # every engine-inserted slot was presence-filled in
                    # pass 1 and saturation is never set -> skip the
                    # old-word gather
                    return dm.insert_read_sorted(sf, kz, lo, hi, base,
                                                 trimmed, jnp.bool_(True),
                                                 params_ins, num_tiles=T,
                                                 assume_present=True)

                def reset(sf):
                    return dm.reset_ids(sf)

                def sf_of(filt):
                    return filt

                def repack(sf):
                    return sf

            n_tiles = (lengths // TL).astype(jnp.int32)
            slots_q, frame_ok = dm.build_slot_grid(codes, lengths, fam,
                                                   params, T)
            if fast or rech_on:
                # fast inserts and the trim recheck consume a BATCHED
                # full-res insert-seed grid built up front (no per-recruit
                # hashing/sorting inside the scan)
                if reuse_q:
                    slots_ins, ok_full = slots_q, frame_ok
                else:
                    slots_ins, ok_full = dm.build_slot_grid(
                        codes, lengths, fam_ins, params_ins, T)
            else:
                slots_ins = jnp.zeros((codes.shape[0], 1, 1),
                                      dtype=params.idx_dtype)
                ok_full = jnp.zeros((codes.shape[0], 1), dtype=bool)
            if rank_scan:
                # batched slot -> rank mapping (the structure is frozen);
                # the scan then runs entirely in rank space
                shell = cz.CompressedState(br, su, filt.ids, cn)
                slots_q = cz.rank_grid(shell, slots_q, params.size)
                if fast or rech_on:
                    slots_ins = cz.rank_grid(shell, slots_ins, params.size)
            sf0 = sf_of(filt)
            votes0 = probe(sf0, slots_q, frame_ok)
            res0 = classify(votes0, n_tiles)

            def body(carry, xs):
                (sf, rows, ids_ins, ins_bases, path_idx, done, changed,
                 reset_seen) = carry
                (ri, sq, ok, si, okf, crow, ln, L, n_t, dec0, ts0,
                 te0, na0, q0, h0, m0, ov0, tm0) = xs
                live = changed & (done == 0)
                if not exact:
                    # optimistic: a read the stale batch classified "drop"
                    # stays dropped; only candidates re-probe live.  An
                    # in-batch silver reset ALWAYS invalidates the rest of
                    # the batch (reset_seen), drops included — against the
                    # freshly reset filter the sequential reference would
                    # recruit them as whole unassigned reads
                    live = ((changed & (dec0 != 0)) | reset_seen) \
                        & (done == 0)

                def use_live(_):
                    v = probe(sf, sq[None], ok[None])
                    r = classify(v, n_t[None])
                    tmin = _tile_min_count(v.top_count, n_t[None])[0]
                    return (r.decision[0], r.trim_start[0], r.trim_end[0],
                            r.num_assigned[0], v.queries[0], v.hits[0],
                            v.misses[0], v.overflow.sum(), tmin)

                def use_batch(_):
                    return (dec0, ts0, te0, na0, q0, h0, m0, ov0, tm0)

                # cond outputs are small scalars only; the filter state is a
                # read-only closure operand, never selected through the cond
                dec, ts, te, na, q, h, m, ov, tmin = jax.lax.cond(
                    live, use_live, use_batch, None)
                if rech_on:
                    # boundary zone: partially-assigned or trim decisions
                    # re-classify at FULL resolution with the exact
                    # reference gates (x, vote_min=2, all insert seeds)
                    # against the live filter — the sampled tier keeps its
                    # verdict only for clean drops (all tiles assigned
                    # with margin) and clean novel reads (none assigned).
                    # The margin term makes the recheck trigger
                    # stride-independent: a fully-assigned read whose
                    # weakest tile sits within 2x of the assignment gate
                    # (in full-vote units) re-classifies too, so finer
                    # strides cannot skip borderline reads that coarser
                    # strides would have caught via sampling noise
                    # predicate shared with the wavefront + pinned by
                    # tests/test_recheck_zone.py (engine_util.recheck_zone)
                    zone = _recheck_zone(
                        dec, na, n_t, ts, te, tmin, params.frame_stride,
                        cfg.threshold, a_max) & (done == 0)

                    def use_full(_):
                        v = probe_full(sf, si[None], okf[None])
                        r = classify_rech(v, n_t[None])
                        return (r.decision[0], r.trim_start[0],
                                r.trim_end[0], r.num_assigned[0],
                                v.queries[0], v.hits[0], v.misses[0],
                                v.overflow.sum())

                    dec, ts, te, na, q, h, m, ov = jax.lax.cond(
                        zone, use_full,
                        lambda _: (dec, ts, te, na, q, h, m, ov), None)
                dec = jnp.where(done != 0, 0, dec)
                ts64, te64 = ts.astype(jnp.int64), te.astype(jnp.int64)
                l_trim = jnp.where(te64 == n_t.astype(jnp.int64) - 1,
                                   L - ts64 * TL, (te64 - ts64 + 1) * TL)
                rec_len = jnp.where(dec == 1, L,
                                    jnp.where(dec == 2, l_trim, 0))
                lo = jnp.where(dec == 1, 0,
                               jnp.where(dec == 2, ts64, 1)).astype(
                                   jnp.int32)
                hi = jnp.where(dec == 1, n_t.astype(jnp.int64) - 1,
                               jnp.where(dec == 2, te64, 0)).astype(
                                   jnp.int32)
                base = (ids_ins + 1).astype(jnp.uint32)

                # the insert runs ONLY for recruits: the cond's false branch
                # passes the filter through untouched, so drops cost ~zero
                # (tools/profile_scan.py F-variants).  Exact mode pays the
                # one-pass sorted-key reservoir insert; fast mode one
                # scatter-max
                def do_insert(f):
                    return insert_sf(f, si, crow, ln, sq, lo, hi, base,
                                     dec == 2)

                sf = jax.lax.cond((dec > 0) & (done == 0), do_insert,
                                  lambda f: f, sf)
                blocks = jnp.where(
                    dec == 1, 1 + L // (TL * bs),
                    jnp.where(dec == 2, 1 + (te64 - ts64) // bs, 0))
                ids_ins = ids_ins + jnp.where(done != 0, 0, blocks)
                ins_bases = ins_bases + jnp.where(done != 0, 0, rec_len)
                # silver rotation (goldrush_path.cpp:156-187): reset IDs +
                # counters in-scan (rare-true cond) and keep consuming
                rotate = (jnp.bool_(silver) & (dec > 0)
                          & (target < ins_bases) & (done == 0))
                path_idx = jnp.where(rotate, path_idx + 1, path_idx)
                overflow = rotate & (max_paths < path_idx)
                done = jnp.where(overflow, jnp.int64(1), done)
                do_reset = rotate & ~overflow
                sf = jax.lax.cond(do_reset, reset, lambda f: f, sf)
                ids_ins = jnp.where(do_reset, 0, ids_ins)
                ins_bases = jnp.where(do_reset, 0, ins_bases)
                changed = changed | (dec > 0)
                reset_seen = reset_seen | do_reset
                out = jnp.stack([
                    dec.astype(jnp.int64), ts64, te64, na.astype(jnp.int64),
                    q.astype(jnp.int64), h.astype(jnp.int64),
                    m.astype(jnp.int64), ov.astype(jnp.int64)])
                rows = jax.lax.dynamic_update_slice(rows, out[None, :],
                                                    (ri, jnp.int32(0)))
                return (sf, rows, ids_ins, ins_bases, path_idx, done,
                        changed, reset_seen), jnp.int32(0)

            xs = (jnp.arange(codes.shape[0], dtype=jnp.int32),
                  slots_q, frame_ok, slots_ins, ok_full, codes, lengths,
                  full_lengths.astype(jnp.int64), n_tiles,
                  res0.decision, res0.trim_start, res0.trim_end,
                  res0.num_assigned,
                  votes0.queries.astype(jnp.int64),
                  votes0.hits.astype(jnp.int64),
                  votes0.misses.astype(jnp.int64),
                  votes0.overflow.sum(axis=1).astype(jnp.int64),
                  _tile_min_count(votes0.top_count, n_tiles))
            if mesh is not None:
                # the batched classify above ran data-parallel; replicate its
                # outputs before the sequential scan so each scan step reads
                # local rows instead of per-step collectives
                xs = jax.tree_util.tree_map(
                    lambda a: jax.lax.with_sharding_constraint(a, repl), xs)
            carry0 = (sf0, rows0, scal0[0], scal0[1], scal0[2], scal0[3],
                      jnp.bool_(False), jnp.bool_(False))
            (sf, rows, ids_ins, ins_bases, path_idx, done, _, _), _ = \
                jax.lax.scan(body, carry0, xs)
            scal = jnp.stack([ids_ins, ins_bases, path_idx, done])
            return repack(sf), rows, scal

        wave = fast and self._wave
        if wave:
            # throughput mode may ship the wavefront consume: batched
            # rounds with merged insert scatters replace the sequential
            # per-read scan (path/wavefront.py).  It threads one extra
            # donated buffer (the earliest-wins side table) through the
            # call.
            from .wavefront import build_wave_consume
            consume = build_wave_consume(self, B, T)
        donate = (0, 4, 5, 6) if wave else (0, 4, 5)
        if mesh is None:
            fn = jax.jit(consume, donate_argnums=donate)
            self._consume_fn[key] = fn
            # share the jitted executable across engines in this process:
            # repeated runs (bench warm/measure, sweeps) otherwise re-pay
            # the trace + persistent-cache deserialize per engine
            _CONSUME_CACHE[self._consume_key(B, T)] = fn
        else:
            data, repl_ = self._shard_data, self._shard_repl
            filt_sh = self._filt_shardings()
            side_sh = (self._shard_filt,) if wave else ()
            self._consume_fn[key] = jax.jit(
                consume, donate_argnums=donate,
                # prefix pytrees: the filter state replicated (or banked
                # over 'model' when model_shards > 1), batch arrays sharded
                # over the data axis
                in_shardings=(filt_sh, data, data, data, repl_, repl_)
                + side_sh,
                out_shardings=(filt_sh, repl_, repl_) + side_sh)
        return self._consume_fn[key]

    # ------------------------------------------------------------------
    def _pad_batch(self, B: int, T: int) -> int:
        """Padded batch size for a closed batch of B reads at tile bucket T
        (shared by the submit pass and the fill-time prewarm so their keys
        agree)."""
        Bpad = max(B, self.batch_reads)
        if Bpad * T > self._tile_budget:
            Bpad = 1 << max(0, (B - 1)).bit_length()
        if self.mesh is not None:           # data axis must divide the batch
            d = int(self.data_shards)
            Bpad = -(-Bpad // d) * d
        return Bpad

    def _launch_prewarm(self, B: int, T: int) -> None:
        """Compile (or load from the persistent cache) the first consume
        executable in a side thread while pass 1 is still streaming — the
        executable build (a compile or a cache load per (B, T) bucket) is
        the dominant first-batch cost in assign."""
        self._prewarm_done = True
        if self.mesh is not None or self.cfg.debug:
            return
        key = (self._pad_batch(B, T), T)
        if key in self._consume_fn or self._prewarm_thread is not None:
            return
        # the dummy-state execution transiently holds a SECOND filter-sized
        # state on device while fill is still scattering into the real one;
        # skip it (compile/trace warm only) when that could pressure HBM
        big_filter = 2 * self.params.alloc * 4 * 3 > \
            _device_memory_bytes()
        import threading

        def work():
            try:
                fn = self._consume_for(*key)
                TL = self.params.tile_length
                Bp, Tp = key
                if big_filter:
                    return
                if self.compressed:
                    # shapes are size-deterministic (compressed.rank_alloc)
                    # so the executable compiled here is the one assign
                    # uses; the zero dummy state is semantically inert
                    from ..mibf import compressed as cz
                    nw = -(-self.params.size // 32)
                    alloc = cz.rank_alloc(self.params.size)
                    n_super = max(-(-nw // (1 << (cz.SUPER_BITS - 5))), 1)
                    dummy = cz.CompressedState(
                        bitrank=jnp.zeros(nw + 1, jnp.uint64),
                        supers=jnp.zeros(n_super, jnp.uint64),
                        ids=jnp.zeros(alloc, jnp.uint32),
                        counts=jnp.zeros(alloc, jnp.uint32))
                else:
                    dummy = dm.init_state(self.params)
                args = [dummy, jnp.zeros((Bp, Tp * TL + TL), jnp.uint8),
                        jnp.zeros(Bp, jnp.int32), jnp.zeros(Bp, jnp.int64),
                        jnp.asarray([0, 0, 1, 0], dtype=jnp.int64),
                        jnp.zeros((Bp, 8), dtype=jnp.int64)]
                if self._wave:
                    ids_like = (dummy.ids if self.compressed
                                else dummy.words)
                    args.append(jnp.zeros_like(ids_like))
                out = fn(*args)
                jax.block_until_ready(out[2])
            except Exception:               # noqa: BLE001 - thread boundary
                # the prewarm only saves time: assign compiles the same
                # executable itself, so report and carry on
                import sys
                import traceback
                print("consume prewarm failed:", file=sys.stderr)
                traceback.print_exc(file=sys.stderr)

        self._prewarm_key = key
        self._prewarm_thread = threading.Thread(target=work, daemon=True)
        self._prewarm_thread.start()

    # ------------------------------------------------------------------
    def _eligible(self, path: str):
        """Stream the pass-2-eligible reads in order (deterministic gates,
        so the submit pass and the replay pass see identical sequences)."""
        cfg = self.cfg
        with ingest.ReadStream(path, prefetch=self._prefetch) as rs:
            for rec in rs.records():
                if rec.length < cfg.min_length or \
                        rec.id in self.filter_out:
                    continue
                yield rec

    def assign(self, path: str) -> None:
        """Pass 2, in two host passes over the stream:

        submit pass — reads stream in order through device micro-batches;
        the consume executable chains its scalar state (ids, bases, path,
        done) device-to-device and the per-read decision rows stay on
        device.  NOTHING is fetched, so the host never waits on the device
        inside the pass (see _consume_for docstring).

        replay pass — after the last batch, the rows are fetched in one go
        and the input is re-streamed with identical gates; path files,
        stats, and silver rotations are reconstructed host-side (the device
        already applied the matching resets in-scan)."""
        t0 = time.time()
        cfg, st = self.cfg, self.stats
        TL = cfg.tile_length
        cap = cfg.max_tiles
        plans: list[tuple[int, int, object]] = []   # (n_reads, T, out_d)
        read_T: list[int] = []                      # per-eligible-read bucket
        # submit-pass record cache: replay skips the second input stream
        # when the whole eligible stream fits the cap (records hold views
        # into the ingest block buffers; the budget counts the RETAINED
        # allocation bytes those views pin, not logical bases)
        cache: list | None = []
        cached_bytes = 0
        cache_bufs: set = set()
        self._wave_side = None       # wave mode: earliest-wins side table
        scal_d = jnp.asarray([0, 0, 1, 0], dtype=jnp.int64)

        def submit(batch):
            nonlocal scal_d
            B = len(batch)
            T = max(_bucket_for(r.length // TL, cap) for r in batch)
            read_T.extend([T] * B)
            # pad to a power-of-two batch (shape reuse across batches) but
            # never past the tile budget: ultralong-read batches stay small
            Bpad = self._pad_batch(B, T)
            Lmax = T * TL + TL
            codes = np.zeros((Bpad, Lmax), dtype=np.uint8)
            lengths = np.zeros(Bpad, dtype=np.int32)
            full_lengths = np.zeros(Bpad, dtype=np.int64)
            for i, r in enumerate(batch):
                L = min(r.length, Lmax)
                codes[i, :L] = r.codes[:L]
                # cap tiles at the bucket limit (reads longer than
                # max_tiles*TL tiles are classified on the first cap tiles)
                lengths[i] = min(r.length, T * TL + TL - 1)
                full_lengths[i] = r.length
            if cfg.debug:
                self._debug_dump(codes, lengths, batch, T)
            tb = time.time()
            first = (Bpad, T) not in self._consume_fn
            if first and self._prewarm_key == (Bpad, T) and \
                    self._prewarm_thread is not None:
                # the executable is being built by the fill-time prewarm
                # thread; wait for it instead of racing the compile
                self._prewarm_thread.join()
                first = (Bpad, T) not in self._consume_fn
            fn = self._consume_for(Bpad, T)
            filt = self.cstate if self.compressed else self.state
            rows0 = jnp.zeros((Bpad, 8), dtype=jnp.int64)
            if self._wave:
                if self._wave_side is None:
                    ids_like = (self.cstate.ids if self.compressed
                                else self.state.words)
                    side = jnp.zeros_like(ids_like)
                    if self._shard_filt is not None:
                        side = jax.device_put(side, self._shard_filt)
                    self._wave_side = side
                filt, out_d, scal_d, self._wave_side = fn(
                    filt, jnp.asarray(codes), jnp.asarray(lengths),
                    jnp.asarray(full_lengths), scal_d, rows0,
                    self._wave_side)
            else:
                filt, out_d, scal_d = fn(filt, jnp.asarray(codes),
                                         jnp.asarray(lengths),
                                         jnp.asarray(full_lengths), scal_d,
                                         rows0)
            if self.compressed:
                self.cstate = filt
            else:
                self.state = filt
            if first:
                jax.block_until_ready(scal_d)
                st.wall_submit_first_s += time.time() - tb
            st.num_batches += 1
            plans.append((B, T, out_d))

        # batching: reads group in ORDER (the golden path is an online
        # algorithm); a batch closes at batch_reads, or earlier when padding
        # every pending read to the batch's tile bucket would blow the tile
        # budget (ultralong reads then run in small batches instead of
        # inflating a whole batch to their bucket — no cap, no reordering)
        pending = []
        pend_T = 1
        for rec in self._eligible(path):
            if cache is not None:
                cache.append(rec)
                cached_bytes += rec.pinned_nbytes(cache_bufs)
                if cached_bytes > REPLAY_CACHE_BYTES:
                    cache = None        # too big: replay re-streams
                    cache_bufs.clear()
            T_r = _bucket_for(rec.length // TL, cap)
            T_new = max(pend_T, T_r)
            if pending and (len(pending) + 1) * T_new > self._tile_budget:
                submit(pending)
                pending = []
                T_new = T_r
            pending.append(rec)
            pend_T = T_new
            if len(pending) >= self.batch_reads:
                submit(pending)
                pending = []
                pend_T = 1
        if pending:
            submit(pending)
        if plans:
            jax.block_until_ready(scal_d)
        st.wall_submit_s += time.time() - t0

        # ---- fetch everything at once (consume never runs again) ---------
        # one device-side concat + ONE host transfer instead of one fetch
        # per batch
        t1 = time.time()
        if not cfg.keep_filter:
            # the filter is dead once the last batch ran: free it before
            # the fetch so the next engine in this process (the golden pass
            # after the silver one) has the device memory
            self.state = None
            self.cstate = None
            self._wave_side = None
        import os as _os
        if _os.environ.get("GOLDRUSH_DEBUG_LIVE"):
            big = sorted((a.nbytes for a in jax.live_arrays()), reverse=True)
            print("live device arrays >1MB:",
                  [f"{b/1e6:.0f}MB" for b in big if b > 1e6])
        if plans:
            out_all = jnp.concatenate([o[: b] for b, _, o in plans], axis=0)
            rows, scal = (np.asarray(a)
                          for a in jax.device_get((out_all, scal_d)))
            self.last_rows = rows       # per-read decision rows (analysis)
        else:
            rows = np.zeros((0, 8), dtype=np.int64)
            scal = np.asarray(scal_d)
        st.wall_fetch_s += time.time() - t1

        # ---- replay pass ---------------------------------------------------
        target_bases = cfg.target_bases()
        inserted_bases = 0
        curr_path = 1
        done = False
        self._open_writer(curr_path)
        records = cache if cache is not None else self._eligible(path)
        for ri, r in enumerate(records):
            if done or ri >= len(read_T):
                break
            T = read_T[ri]
            dec, ts, te, na, q, h, m, ov = (int(x) for x in rows[ri])
            # effective tile count is capped at the bucket limit (reads
            # longer than max_tiles*TL are classified on their first
            # max_tiles tiles; the reference has no cap)
            num_tiles = min(r.length, T * TL + TL - 1) // TL
            st.total_tiles += num_tiles
            st.queries += q
            st.hits += h
            st.misses += m
            st.vote_overflow += ov
            st.assigned_tiles += na
            st.unassigned_tiles += num_tiles - na
            if dec == 1:        # recruited whole read
                qual = r.qual_bytes()
                self.writers[-1].write(r.id, "_untrimmed",
                                       r.seq_bytes(), qual)
                inserted_bases += r.length
                st.inserted_bases_in_path += r.length
                st.reads_in_path += 1
                st.recruits += 1
                if qual is not None:
                    st.phred_sum_in_path += r.phred_sum
            elif dec == 2:      # recruited trimmed
                rseq, rqual = r.seq_bytes(), r.qual_bytes()
                if te == num_tiles - 1:
                    seq = rseq[ts * TL:]
                    qual = rqual[ts * TL:] if rqual else None
                else:
                    end = ts * TL + (te - ts + 1) * TL
                    seq = rseq[ts * TL:end]
                    qual = rqual[ts * TL:end] if rqual else None
                self.writers[-1].write(r.id, "_trimmed", seq, qual)
                inserted_bases += len(seq)
                st.inserted_bases_in_path += len(seq)
                st.reads_in_path += 1
                st.recruits += 1
                if qual is not None:
                    st.phred_sum_in_path += sum_phred(
                        np.frombuffer(qual, dtype=np.uint8))
            st.valid_reads += 1
            # silver rotation bookkeeping mirrors the in-scan reset
            # (goldrush_path.cpp:156-187)
            if dec in (1, 2) and cfg.silver_path and \
                    target_bases < inserted_bases:
                st.paths_completed += 1
                curr_path += 1
                if cfg.max_paths < curr_path:
                    done = True
                    # the reference exit(0)s here; we stop consuming
                    st.valid_reads -= 1   # exit happens before ++valid
                    break
                inserted_bases = 0
                st.reads_in_path = 0
                st.inserted_bases_in_path = 0
                st.phred_sum_in_path = 0.0
                self.writers[-1].close()
                self._open_writer(curr_path)
        if not done:
            assert inserted_bases == int(scal[1]), \
                (inserted_bases, int(scal[1]))
            assert curr_path == int(scal[2]), (curr_path, int(scal[2]))
        for w in self.writers:
            w.close()
        if cfg.silver_path and cfg.max_paths > curr_path:
            print(f"WARNING: Expected {cfg.max_paths} silver paths, "
                  f"but only {curr_path} generated.")
        st.wall_replay_s += time.time() - t1
        st.wall_assign_s += time.time() - t0

    # ------------------------------------------------------------------
    def run(self, input_path: str | None = None) -> EngineStats:
        from ..utils import observability as obs
        path = input_path or self.cfg.input
        fmt = fastq.detect_format(path)
        if fmt != "fastq":
            raise RuntimeError("Gold Path requires fastq format")
        self.calc_phred_threshold(path)
        if self.cfg.verbose:
            obs.log_engine_header(self.cfg, self.seeds, self.universe,
                                  self.phred_min)
        with obs.profiler_trace(self.cfg.trace_dir or None):
            with obs.phase_timer("inserting bit vector", self.cfg.verbose):
                self.fill(path)
            if self.cfg.save_mibf:
                # save the FILL-side geometry (see the load check in fill())
                dm.save_state(self.state, self.params_full,
                              self.cfg.save_mibf)
            if self.cfg.verbose:
                obs.log_filter_breakdown(self.stats)
            with obs.phase_timer("assigned", self.cfg.verbose):
                self.assign(path)
        if self.cfg.verbose:
            obs.log_path_stat(max(self.stats.paths_completed, 1), self.stats,
                              max(self.stats.inserted_bases_in_path, 1))
        return self.stats
