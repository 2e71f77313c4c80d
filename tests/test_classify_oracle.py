"""The classifier oracle must reproduce the compiled reference logic on all
1200 golden fixture cases (smoothing passes + longest stretch + flank eval)."""

import json

from tests.conftest import FIXTURES
from goldrush_jax.path import oracle


def test_oracle_matches_reference_fixtures():
    cases = json.load(open(FIXTURES / "classify_fixtures.json"))
    assert len(cases) >= 1000
    for n_case, c in enumerate(cases):
        id_vec = list(c["id_vec"])
        bool_vec = [0] * len(id_vec)
        all_id = [[(i, cnt) for i, cnt in tile] for tile in c["all_id"]]
        na = oracle.smooth_tiles(all_id, id_vec, bool_vec, threshold=10)
        assert id_vec == c["out_id"], f"case {n_case}: id_vec mismatch"
        assert bool_vec == c["out_bool"], f"case {n_case}: bool_vec mismatch"
        assert na == c["num_assigned"], f"case {n_case}"
        ls, le = oracle.find_longest_stretch(bool_vec)
        assert [ls, le] == c["longest"], f"case {n_case}"
        good, ts, te = oracle.eval_flanks(ls, le, id_vec)
        assert int(good) == c["good_flank"], f"case {n_case}"
        assert [ts, te] == c["trim"], f"case {n_case}"
