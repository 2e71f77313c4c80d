"""Sequential reference-behavior engine: the full goldrush-path per-read loop
over the NumPy miBF oracle.

This is the executable specification for end-to-end parity tests: it
transcribes main()/process_read (goldrush_path.cpp:892-1275) — two-pass
construction, streaming classify/recruit with trimming, silver-path rotation
and the exact ID-accounting quirks — on top of MibfOracle and path.oracle.
Slow (pure Python) but authoritative; the JAX engine must produce identical
path files on identical input when run in sequential-parity mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import PathConfig, calc_optimal_size
from ..io import fastq
from ..mibf.mibf_np import MibfOracle
from ..ops import nthash_np as nth
from ..ops.phred import (MEDIAN_SAMPLES_NEEDED, MINIMUM_PHRED_THRESHOLD,
                         calc_median_phred, phred_stats, sum_phred)
from ..ops.seeds import make_seed_pattern
from . import oracle as clf


@dataclass
class PathStats:
    valid_reads: int = 0
    total_tiles: int = 0
    assigned_tiles: int = 0
    unassigned_tiles: int = 0
    queries: int = 0
    hits: int = 0
    misses: int = 0
    reads_in_path: int = 0
    phred_sum_in_path: float = 0.0
    recruited: list = field(default_factory=list)


class OracleEngine:
    def __init__(self, cfg: PathConfig):
        cfg.validate()
        self.cfg = cfg
        self.seeds = make_seed_pattern(cfg.seed_preset, cfg.kmer_size,
                                       cfg.weight, cfg.hash_num)
        self.universe = cfg.derived_hash_universe()
        self.size = calc_optimal_size(self.universe, 1, cfg.occupancy)
        self.mibf = MibfOracle(self.size)
        self.filter_out: set[str] = set()
        self.phred_min = cfg.phred_min

    # ---- phase 0: auto phred threshold (goldrush_path.cpp:79-107) -------
    def calc_phred_threshold(self, records) -> None:
        if self.phred_min != 0:
            return
        scores = np.zeros(MEDIAN_SAMPLES_NEEDED, dtype=np.uint32)
        count = 0
        for rec in records:
            if len(rec.seq) < self.cfg.min_length:
                continue
            if count >= MEDIAN_SAMPLES_NEEDED:
                break
            q = np.frombuffer(rec.qual, dtype=np.uint8)
            scores[count] = phred_stats(q)[0]
            count += 1
        self.phred_min = max(MINIMUM_PHRED_THRESHOLD,
                             calc_median_phred(scores, count))

    # ---- pass 1 (fill_bit_vector, goldrush_path.cpp:235-339) ------------
    def fill(self, records) -> int:
        passed = 0
        for rec in records:
            if len(rec.seq) < self.cfg.min_length:
                continue
            q = np.frombuffer(rec.qual, dtype=np.uint8)
            avg, delta = phred_stats(q)
            if avg < self.phred_min or delta >= self.cfg.phred_delta:
                self.filter_out.add(rec.id)
                continue
            codes = nth.encode_seq(rec.seq)
            if nth.has_invalid_bases(codes):
                self.filter_out.add(rec.id)
                continue
            passed += 1
            self.mibf.fill_presence(nth.multi_seed_canonical(codes, self.seeds))
        if passed == 0:
            raise RuntimeError(
                "no reads passed the Phred score and min length requirements")
        return passed

    # ---- pass 2: streaming consume loop ---------------------------------
    def run_paths(self, records) -> list[PathStats]:
        cfg = self.cfg
        target_bases = cfg.target_bases()
        inserted_bases = 0
        curr_path = 1
        ids_inserted = 0
        stats = PathStats()
        all_stats = [stats]
        done = False
        for rec in records:
            if done:
                break
            if len(rec.seq) < cfg.min_length:
                continue
            if rec.id in self.filter_out:
                continue
            num_tiles = len(rec.seq) // cfg.tile_length
            stats.total_tiles += num_tiles
            codes = nth.encode_seq(rec.seq)
            tiles = nth.tile_frame_hashes(codes, self.seeds, cfg.tile_length)
            # votes
            all_id, id_vec = [], []
            for flat in tiles:
                votes = self.mibf.tile_votes(flat, cfg.hash_num)
                q, h, m = self.mibf.counters_for_tile(flat, cfg.hash_num)
                stats.queries += q
                stats.hits += h
                stats.misses += m
                if votes:
                    best = max(votes.items(), key=lambda kv: (kv[1], -kv[0]))
                    id_vec.append(best[0])
                else:
                    id_vec.append(0)
                cand = sorted(((i, c) for i, c in votes.items() if c > 2),
                              key=lambda kv: (-kv[1], kv[0]))
                all_id.append(cand)
            bool_vec = [0] * num_tiles
            res = clf.classify_read(all_id, id_vec, bool_vec, cfg.threshold,
                                    cfg.unassigned_min, cfg.assigned_max)
            na = res["num_assigned"]
            stats.assigned_tiles += na
            stats.unassigned_tiles += num_tiles - na

            if res["decision"] == "whole":
                ids_inserted += 1
                bs = cfg.block_size
                block_start = 0
                while block_start < num_tiles:
                    block_end = min(block_start + bs, num_tiles)
                    cid = ids_inserted + block_start // bs
                    self.mibf.insert_block(
                        np.concatenate(tiles[block_start:block_end]), cid)
                    block_start += bs
                ids_inserted += len(rec.seq) // (cfg.tile_length * bs)
                stats.recruited.append((rec.id, "_untrimmed", rec.seq,
                                        rec.qual, curr_path))
                inserted_bases += len(rec.seq)
                stats.reads_in_path += 1
                stats.phred_sum_in_path += sum_phred(
                    np.frombuffer(rec.qual, dtype=np.uint8))
                if cfg.silver_path and target_bases < inserted_bases:
                    curr_path += 1
                    if cfg.max_paths < curr_path:
                        done = True
                        continue
                    inserted_bases = 0
                    self.mibf.reset_ids()
                    ids_inserted = 0
                    stats = PathStats()
                    all_stats.append(stats)
            elif res["decision"] == "trimmed":
                ts, te = res["trim"]
                ids_inserted += 1
                bs = cfg.block_size
                block_start = ts
                while block_start <= te:
                    block_end = min(block_start + bs - 1, te)
                    cid = ids_inserted + (block_start - ts + 1) // bs
                    self.mibf.insert_block(
                        np.concatenate(tiles[block_start:block_end + 1]), cid)
                    block_start += bs
                ids_inserted += (te - ts) // bs
                tl = cfg.tile_length
                if te == num_tiles - 1:
                    seq = rec.seq[ts * tl:]
                    qual = rec.qual[ts * tl:] if rec.qual else None
                else:
                    end = ts * tl + (te - ts + 1) * tl
                    seq = rec.seq[ts * tl:end]
                    qual = rec.qual[ts * tl:end] if rec.qual else None
                stats.recruited.append((rec.id, "_trimmed", seq, qual,
                                        curr_path))
                inserted_bases += len(seq)
                stats.reads_in_path += 1
                stats.phred_sum_in_path += sum_phred(
                    np.frombuffer(qual, dtype=np.uint8))
                if cfg.silver_path and target_bases < inserted_bases:
                    curr_path += 1
                    if cfg.max_paths < curr_path:
                        done = True
                        continue
                    inserted_bases = 0
                    self.mibf.reset_ids()
                    ids_inserted = 0
                    stats = PathStats()
                    all_stats.append(stats)
            stats.valid_reads += 1
        return all_stats

    def run(self, input_path: str | None = None) -> list[PathStats]:
        path = input_path or self.cfg.input
        self.calc_phred_threshold(fastq.read_records(path))
        self.fill(fastq.read_records(path))
        return self.run_paths(fastq.read_records(path))
