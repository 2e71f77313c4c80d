"""Batched JAX classifier vs the fixture-verified Python oracle, on all 1200
reference-generated cases padded into batches."""

import json

import numpy as np

import tests.conftest  # noqa: F401
from tests.conftest import FIXTURES
from goldrush_jax.path import oracle
from goldrush_jax.path.classify import classify_batch

THRESHOLD, U_MIN, A_MAX = 10, 5, 1
K = 8


def load_cases():
    return json.load(open(FIXTURES / "classify_fixtures.json"))


def batch_from_cases(cases, T):
    B = len(cases)
    curr_id = np.zeros((B, T), np.int32)
    top_count = np.zeros((B, T), np.int32)
    cand_ids = np.zeros((B, T, K), np.int32)
    cand_counts = np.zeros((B, T, K), np.int32)
    n = np.zeros(B, np.int32)
    for b, c in enumerate(cases):
        nt = len(c["id_vec"])
        n[b] = nt
        curr_id[b, :nt] = c["id_vec"]
        for t, lst in enumerate(c["all_id"]):
            assert len(lst) <= K
            for j, (i, cnt) in enumerate(lst):
                cand_ids[b, t, j] = i
                cand_counts[b, t, j] = cnt
        # top_count: the max over all ids; fixtures only carry the >2 list,
        # whose [0] equals the overall top when non-empty.  For tiles with an
        # empty list the initial id_vec entry may still be a low-count id;
        # top_count is not consumed by classify_batch (bool comes from the
        # candidate table), so 0 is fine.
        for t, lst in enumerate(c["all_id"]):
            if lst:
                top_count[b, t] = lst[0][1]
    return curr_id, top_count, cand_ids, cand_counts, n


def run_oracle(c):
    id_vec = list(c["id_vec"])
    bool_vec = [0] * len(id_vec)
    all_id = [[(i, cnt) for i, cnt in tile] for tile in c["all_id"]]
    return oracle.classify_read(all_id, id_vec, bool_vec, THRESHOLD,
                                U_MIN, A_MAX)


def test_classifier_matches_oracle_fixtures():
    cases = load_cases()
    DEC = {"drop": 0, "whole": 1, "trimmed": 2}
    # group into two padded shapes to exercise padding variety
    groups = [[c for c in cases if len(c["id_vec"]) <= 16],
              [c for c in cases if len(c["id_vec"]) > 16]]
    sizes = [16, 160]
    for cs, T in zip(groups, sizes):
        assert len(cs) > 100
        curr_id, top_count, cand_ids, cand_counts, n = batch_from_cases(cs, T)
        res = classify_batch(curr_id, top_count, cand_ids, cand_counts, n,
                             THRESHOLD, U_MIN, A_MAX)
        dec = np.asarray(res.decision)
        ts, te = np.asarray(res.trim_start), np.asarray(res.trim_end)
        na = np.asarray(res.num_assigned)
        ids_out = np.asarray(res.ids)
        bools_out = np.asarray(res.bools)
        for b, c in enumerate(cs):
            want = run_oracle(c)
            nt = len(c["id_vec"])
            assert list(ids_out[b, :nt]) == want["id_vec"], f"case {b} T={T}"
            assert list(bools_out[b, :nt]) == want["bool_vec"], f"case {b}"
            assert na[b] == want["num_assigned"], f"case {b} T={T}"
            assert dec[b] == DEC[want["decision"]], \
                (b, T, want["decision"], dec[b])
            if want["decision"] == "trimmed":
                assert (ts[b], te[b]) == want["trim"], (b, T, want["trim"],
                                                        (ts[b], te[b]))
