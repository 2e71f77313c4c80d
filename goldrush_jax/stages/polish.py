"""GoldPolish equivalent: alignment-free k-mer polishing of goldtigs.

The reference invokes the external bcgsc/goldpolish (ntEdit/Sealer-style
under the hood) via ``goldpolish --minimap2 -m /dev/shm`` (bin/goldrush:
266-268).  Batched reformulation:

 1. all read k-mers are hashed on device and scatter-counted into a flat
    table; "solid" k-mers (count >= solid_min) are the evidence set;
 2. every contig k-mer is presence-checked in one batched device query;
    absent runs localize candidate error bases (a lone error base b makes
    exactly the k-mers [b-k+1, b] absent);
 3. each error site generates 8 candidate edits (3 substitutions, 4
    insertions, 1 deletion); every candidate's edited window is re-hashed
    and scored in one big device batch — sites are processed in parallel,
    not by a sequential walk, because sites >= k apart are independent;
 4. winning edits are applied right-to-left; clustered sites resolve over
    multiple rounds.

This is the polishing analog of the survey's "batched, not sequential"
design rule (SURVEY.md section 7).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io import fastq
from ..mibf.mibf import fastrange
from ..ops.nthash import build_seed_family, hash_positions
from ..ops import nthash_np

BASES = b"ACGT"


@dataclass
class PolishParams:
    k: int = 24
    solid_min: int = 2
    rounds: int = 6
    occupancy_factor: int = 8   # table slots per expected distinct k-mer
    min_score: float = 0.3      # absolute floor; acceptance is relative to
                                # the unedited window's score
    min_gain: int = 3           # an edit must make >= this many additional
                                # window k-mers solid (a true single-base fix
                                # gains ~k; guards truncated end windows
                                # where 1 accidental k-mer beats an empty
                                # noop)
    batch: int = 64
    # multi-k schedule ((k, rounds), ...): smaller k first resolves dense
    # error clusters (absent runs merge when errors are < k apart and a
    # large-k window never beats its noop), larger k refines.  Empty ->
    # single (k, rounds) stage.
    schedule: tuple = ()
    # site density controls (ONT error spacing ~ 1/err_rate is COMPARABLE to
    # k, so merged absent regions hide most error sites from the one-edit-
    # per-region-per-round walk — measured on homopolymer-indel reads the
    # default-spacing polisher fixes only ~28% of errors, tools/
    # polish_probe.py).  site_spacing < k emits a candidate at EVERY absent
    # sub-run end at least this far from the previous site; edits still
    # apply right-to-left so coordinate shifts compose, and each round
    # re-scores against the edited sequence, so overlapping-window score
    # error self-corrects over rounds.
    site_spacing: int = 0           # 0 -> p.k (the conservative default)

    def spacing(self, k: int) -> int:
        return self.site_spacing if self.site_spacing > 0 else k

    def stages(self) -> tuple:
        return self.schedule or ((self.k, self.rounds),)


def _pow2(n: int, floor: int = 1 << 10) -> int:
    return 1 << max(floor.bit_length() - 1, (n - 1).bit_length())


def _capacity(n: int) -> int:
    """Counts-array length for a table of n slots: a power of two, at least
    2^22 (16 MB), so the per-contig tables of a run share one shape and one
    executable per (k, batch shape) instead of one per table size."""
    return max(1 << 22, 1 << (n - 1).bit_length())


@partial(jax.jit, static_argnames=("k", "P"))
def _count_kmers(counts, codes, lengths, size, k: int, P: int):
    fam = build_seed_family(["1" * k])
    h = hash_positions(codes, fam, P)[:, 0, :]
    valid = (jnp.arange(P, dtype=jnp.int64)[None, :]
             < (lengths - k + 1)[:, None])
    slots = jnp.where(valid, fastrange(h, size),
                      jnp.uint64(size)).astype(jnp.int64)
    return counts.at[slots.reshape(-1)].add(jnp.uint32(1), mode="drop")


@partial(jax.jit, static_argnames=("k", "P"))
def _query_kmers(counts, codes, lengths, size, k: int, P: int):
    """counts of the codes' k-mers: uint32 [B, P] (+ valid mask)."""
    fam = build_seed_family(["1" * k])
    h = hash_positions(codes, fam, P)[:, 0, :]
    valid = (jnp.arange(P, dtype=jnp.int64)[None, :]
             < (lengths - k + 1)[:, None])
    slots = fastrange(h, size).astype(jnp.int64)
    return counts[slots], valid


class KmerTable:
    """Flat count table of canonical k-mer hashes (device scatter-add).

    All device entry points pad to shape buckets: stage inputs have
    arbitrary lengths and a compile per distinct shape turns the polisher
    into a compile farm.  The slot map uses the exact ``size`` (a traced
    argument); the counts array is allocated at a bucketed capacity above
    it, and the slots past ``size`` stay unused.
    """

    def __init__(self, expected_kmers: int, factor: int):
        self.size = max(1 << 16, int(expected_kmers * factor)) | 1
        self.counts = jnp.zeros(_capacity(self.size + 1), dtype=jnp.uint32)
        self._size = jnp.uint64(self.size)

    def add_batch(self, codes: np.ndarray, lengths: np.ndarray, k: int):
        B, L = codes.shape
        Bp, Lp = _pow2(B, 8), _pow2(L)
        cp = np.zeros((Bp, Lp), dtype=np.uint8)
        cp[:B, :L] = codes
        lp = np.zeros(Bp, dtype=np.int64)
        lp[:B] = lengths
        self.counts = _count_kmers(self.counts, jnp.asarray(cp),
                                   jnp.asarray(lp), self._size, k,
                                   Lp - k + 1)

    def query_batch(self, codes: np.ndarray, lengths: np.ndarray, k: int):
        """(counts uint32 [B, P], valid bool [B, P]) for padded batch."""
        B, L = codes.shape
        Bp, Lp = _pow2(B, 8), _pow2(L)
        cp = np.zeros((Bp, Lp), dtype=np.uint8)
        cp[:B, :L] = codes
        lp = np.zeros(Bp, dtype=np.int64)
        lp[:B] = lengths
        cnt, valid = _query_kmers(self.counts, jnp.asarray(cp),
                                  jnp.asarray(lp), self._size, k,
                                  Lp - k + 1)
        P = L - k + 1
        return np.asarray(cnt)[:B, :P], np.asarray(valid)[:B, :P]


def build_read_table(reads: list[bytes], p: PolishParams) -> KmerTable:
    total = sum(len(r) for r in reads)
    table = KmerTable(total, p.occupancy_factor)
    order = sorted(range(len(reads)), key=lambda i: len(reads[i]))
    i = 0
    while i < len(order):
        grp = order[i: i + p.batch]
        i += p.batch
        L = max(max(len(reads[j]) for j in grp), p.k + 1)
        codes = np.zeros((len(grp), L), dtype=np.uint8)
        lens = np.zeros(len(grp), dtype=np.int64)
        for row, j in enumerate(grp):
            c = fastq.encode(reads[j])
            c = np.where(c > 3, 0, c)
            codes[row, : len(c)] = c
            lens[row] = len(c)
        table.add_batch(codes, lens, p.k)
    return table


def _contig_solidity(table: KmerTable, codes: np.ndarray, p: PolishParams
                     ) -> np.ndarray:
    """bool[P] solid flags of one contig's k-mers (single query batch)."""
    n = len(codes) - p.k + 1
    if n <= 0:
        return np.zeros(0, dtype=bool)
    cnt, _ = table.query_batch(codes[None, :],
                               np.array([len(codes)], dtype=np.int64), p.k)
    return cnt[0] >= p.solid_min


def _candidate_edits(seq: np.ndarray, b: int, k: int):
    """8 edited windows around error base b: list of (tag, window_codes).
    Window spans [b-k+1, b+k) of the edited sequence, so every k-mer touching
    base b is covered."""
    lo = max(b - k + 1, 0)
    hi = min(b + k, len(seq))
    left, mid, right = seq[lo:b], seq[b:b + 1], seq[b + 1:hi]
    out = []
    cur = int(mid[0]) if len(mid) else 0
    for alt in range(4):
        if alt != cur:
            out.append((("sub", alt),
                        np.concatenate([left, [alt], right])))
    out.append((("del", 0), np.concatenate([left, right])))
    for ins in range(4):
        # insert before b (contig missing a base ending the absent run) and
        # after b (run end localizes the junction one base earlier for
        # deletion-type errors)
        out.append((("ins", ins),
                    np.concatenate([left, [ins], mid, right])))
        out.append((("ins2", ins),
                    np.concatenate([left, mid, [ins], right])))
    # 2-bp homopolymer run adjustments: two same-run indels land in one
    # absent region on ONT homopolymer-biased reads, and no single edit's
    # window clears the noop gate (ntEdit's indel ladder plays the same
    # card — VERDICT r4 item 3)
    out.append((("del2", 0), np.concatenate([left, right[1:]])))
    out.append((("ins_hp2", cur),
                np.concatenate([left, [cur, cur], mid, right])))
    return out


def polish_contig(seq: bytes, table: KmerTable, p: PolishParams
                  ) -> tuple[bytes, int]:
    """Polish one contig; returns (new_seq, n_edits)."""
    arr = fastq.encode(seq)
    arr = np.where(arr > 3, 0, arr).astype(np.uint8)
    total_edits = 0
    for _ in range(p.rounds):
        solid = _contig_solidity(table, arr, p)
        n = len(solid)
        if n == 0 or solid.all():
            break
        absent = ~solid
        # error sites: last index of each absent run (b = run_end), spaced
        # >= k apart so their candidate windows don't interact
        d = np.diff(absent.astype(np.int8))
        # absent runs separated by < k chance-solid k-mers belong to one
        # error region; the region's end localizes the bad base (a bad base
        # b makes exactly k-mers [b-k+1, b] absent); a region reaching the
        # final k-mer only bounds the bad base below
        r_starts = list(np.nonzero(d == 1)[0] + 1)
        r_ends = list(np.nonzero(d == -1)[0])
        if absent[0]:
            r_starts = [0] + r_starts
        if absent[-1]:
            r_ends = r_ends + [n - 1]
        spacing = p.spacing(p.k)
        cand_b = []
        for s_, e_ in zip(r_starts, r_ends):
            if cand_b and s_ - cand_b[-1] < spacing:
                cand_b[-1] = e_        # merge into previous region
            else:
                cand_b.append(e_)
        if cand_b and cand_b[-1] == n - 1:
            cand_b[-1] = min(n - 1 + p.k - 1, len(arr) - 1)
        sites = []
        last = -10 ** 9
        for b in cand_b:
            b = min(int(b), len(arr) - 1)
            if b - last >= spacing:
                sites.append(b)
                last = b
        if not sites:
            break
        # batch-score all candidates of all sites; the UNEDITED window is
        # scored too ("noop") so acceptance is relative — with clustered
        # errors an edited window still contains absent k-mers from the
        # neighbor error, and an absolute gate would reject the true fix
        cands = []           # (site_idx, b, tag, window)
        for si, b in enumerate(sites):
            lo = max(b - p.k + 1, 0)
            hi = min(b + p.k, len(arr))
            cands.append((si, b, ("noop", 0), arr[lo:hi]))
            # run-end localization jitters by one for indel-type errors:
            # also try the neighbors
            for bb in (b - 1, b, b + 1):
                if 0 <= bb < len(arr):
                    for tag, win in _candidate_edits(arr, bb, p.k):
                        cands.append((si, bb, tag, win))
        W = max(len(c[3]) for c in cands)
        wins = np.zeros((len(cands), max(W, p.k + 1)), dtype=np.uint8)
        lens = np.zeros(len(cands), dtype=np.int64)
        for i, (_, _, _, win) in enumerate(cands):
            wins[i, : len(win)] = win
            lens[i] = len(win)
        cnt, valid = table.query_batch(wins, lens, p.k)
        solid_w = (cnt >= p.solid_min) & valid
        nsolid = solid_w.sum(1)
        scores = nsolid / np.maximum(valid.sum(1), 1)
        # pick best candidate per site; accept only if it beats the
        # unedited window by >= min_gain solid k-mers AND clears the floor
        best: dict[int, tuple[float, int, tuple, int]] = {}
        noop: dict[int, tuple[float, int]] = {}
        for i, (si, b, tag, _) in enumerate(cands):
            s = float(scores[i])
            if tag[0] == "noop":
                noop[si] = (s, int(nsolid[i]))
                continue
            if si not in best or s > best[si][0]:
                best[si] = (s, b, tag, int(nsolid[i]))
        # apply accepted edits right-to-left
        edits = sorted(
            ((s, b, tag) for si, (s, b, tag, ns) in best.items()
             if s > noop.get(si, (0.0, 0))[0] and s >= p.min_score
             and ns - noop.get(si, (0.0, 0))[1] >= p.min_gain),
            key=lambda v: -v[1])
        if not edits:
            break
        pieces = arr.copy()
        for score, b, (kind, alt) in edits:
            if kind == "sub":
                pieces[b] = alt
            elif kind == "del":
                pieces = np.concatenate([pieces[:b], pieces[b + 1:]])
            elif kind == "del2":
                pieces = np.concatenate([pieces[:b], pieces[b + 2:]])
            elif kind == "ins_hp2":
                pieces = np.concatenate([pieces[:b],
                                         np.array([alt, alt], np.uint8),
                                         pieces[b:]])
            elif kind == "ins":
                pieces = np.concatenate([pieces[:b],
                                         np.array([alt], np.uint8),
                                         pieces[b:]])
            else:  # ins2: insert after b
                pieces = np.concatenate([pieces[:b + 1],
                                         np.array([alt], np.uint8),
                                         pieces[b + 1:]])
            total_edits += 1
        arr = pieces
    return np.frombuffer(BASES, np.uint8)[arr].tobytes(), total_edits


def polish_seq(seq: bytes, reads: list[bytes], p: PolishParams,
               tables: dict | None = None) -> tuple[bytes, int]:
    """Polish one sequence through the (k, rounds) schedule; per-k read
    tables are built lazily and may be shared via ``tables``."""
    import dataclasses
    total = 0
    for k, rounds in p.stages():
        pp = dataclasses.replace(p, k=k, rounds=rounds, schedule=())
        if tables is not None:
            if k not in tables:
                tables[k] = build_read_table(reads, pp)
            table = tables[k]
        else:
            table = build_read_table(reads, pp)
        seq, ne = polish_contig(seq, table, pp)
        total += ne
    return seq, total


def run_polish_streaming(contigs: list[tuple[str, bytes]], reads_path: str,
                         p: PolishParams | None = None,
                         mapper_k: int = 15, mapper_w: int = 10,
                         chunk: int = 512, spill_dir: str | None = None
                         ) -> tuple[list[tuple[str, bytes]], int]:
    """Bounded-memory run_polish: reads STREAM from disk in fixed-size
    chunks through the batched mapper and spill to one temp file per
    goldtig; each goldtig then polishes against its own spilled reads.

    Peak memory is O(contigs + minimizer index + chunk + largest
    per-goldtig read set) instead of O(all reads) — the reference's
    memory envelope at scale (67x human ~ 200 GB of reads vs its 51.9 GB
    peak, /root/reference/README.md:121) cannot be met by whole-file
    lists.  Output is IDENTICAL to run_polish(mapper_k=...): read->contig
    assignment is per-read (chunking cannot change it) and per-contig
    polishing is independent.
    """
    import shutil as _shutil
    import tempfile as _tempfile
    from ..io import fastq as _fq
    from . import mapping
    p = p or PolishParams()
    index = mapping.build_index([s for _, s in contigs],
                                [n for n, _ in contigs], mapper_k, mapper_w)
    own = spill_dir is None
    if own:
        spill_dir = _tempfile.mkdtemp(prefix="polish_spill_")
    files = [open(os.path.join(spill_dir, f"c{i}.reads"), "wb")
             for i in range(len(contigs))]
    try:
        def spill(batch: list[bytes]):
            for read, hits in zip(batch, mapping.map_reads(index, batch)):
                if hits:
                    files[hits[0].tid].write(read + b"\n")

        batch: list[bytes] = []
        for rec in _fq.read_records(reads_path):
            batch.append(rec.seq)
            if len(batch) >= chunk:
                spill(batch)
                batch = []
        if batch:
            spill(batch)
        for f in files:
            f.close()
        out, edits = [], 0
        for i, (name, seq) in enumerate(contigs):
            with open(os.path.join(spill_dir, f"c{i}.reads"), "rb") as f:
                rds = [ln for ln in f.read().splitlines() if ln]
            if rds:
                ns, ne = polish_seq(seq, rds, p)
            else:
                ns, ne = seq, 0        # no evidence -> leave unpolished
            out.append((name, ns))
            edits += ne
        return out, edits
    finally:
        for f in files:
            if not f.closed:
                f.close()
        if own:
            _shutil.rmtree(spill_dir, ignore_errors=True)


def run_polish(contigs: list[tuple[str, bytes]], reads: list[bytes],
               p: PolishParams | None = None,
               mapper_k: int | None = None, mapper_w: int = 10
               ) -> tuple[list[tuple[str, bytes]], int]:
    """Polish contigs against read k-mer evidence.

    With mapper_k set, reads are first assigned to their best-mapping goldtig
    and each goldtig is polished against ITS reads' k-mers only — goldpolish's
    targeted architecture (reads mapped with --minimap2 or --ntlink,
    bin/goldrush:35-41), which keeps cross-contig k-mers from vetoing true
    edits.  Without it, one global table serves all contigs (alignment-free
    fallback)."""
    p = p or PolishParams()
    out = []
    edits = 0
    if mapper_k is None:
        tables: dict = {}
        for name, seq in contigs:
            ns, ne = polish_seq(seq, reads, p, tables)
            out.append((name, ns))
            edits += ne
        return out, edits
    from . import mapping
    index = mapping.build_index([s for _, s in contigs],
                                [n for n, _ in contigs], mapper_k, mapper_w)
    assigned: list[list[bytes]] = [[] for _ in contigs]
    for read, hits in zip(reads, mapping.map_reads(index, reads)):
        if hits:
            assigned[hits[0].tid].append(read)
    for (name, seq), rds in zip(contigs, assigned):
        if rds:
            ns, ne = polish_seq(seq, rds, p)
        else:
            ns, ne = seq, 0            # no evidence -> leave unpolished
        out.append((name, ns))
        edits += ne
    return out, edits
