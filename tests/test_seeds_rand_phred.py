"""Parity tests for seed design, glibc rand, and phred math against golden
vectors generated from the compiled reference code (see tests/fixtures/)."""

import json

import numpy as np
import pytest

from tests.conftest import FIXTURES
from goldrush_jax.ops.cxx_rand import GlibcRand
from goldrush_jax.ops.seeds import make_seed_pattern, care_positions
from goldrush_jax.ops.phred import (phred_stats, phred_stats_block, sum_phred,
                                    calc_median_phred)


def test_glibc_rand_golden():
    golden = json.load(open(FIXTURES / "glibc_rand_123.json"))
    rng = GlibcRand(123)
    assert [rng.rand() for _ in range(len(golden))] == golden


def test_glibc_rand_long_stream():
    # exercise the internal buffer trimming
    rng = GlibcRand(123)
    vals = [rng.rand() for _ in range(10000)]
    rng2 = GlibcRand(123)
    assert vals[-1] == [rng2.rand() for _ in range(10000)][-1]


def test_seed_patterns_golden():
    for line in open(FIXTURES / "seed_fixtures.jsonl"):
        c = json.loads(line)
        got = make_seed_pattern(c["preset"], c["k"], c["w"], c["h"])
        assert got == c["seeds"], c


def test_seed_structure():
    seeds = make_seed_pattern("", 22, 16, 3)
    assert [len(s) for s in seeds] == [22, 23, 24]
    for s in seeds:
        assert s.count("1") == 16
        assert s == s[::-1]  # symmetric (palindromic) seeds
    assert care_positions("101") == [0, 2]


def test_phred_golden():
    cases = json.load(open(FIXTURES / "phred_fixtures.json"))
    quals = [np.frombuffer(c["qual"].encode(), dtype=np.uint8) for c in cases]
    for c, q in zip(cases, quals):
        avg, delta = phred_stats(q)
        assert avg == c["avg"], c
        assert delta == c["delta"], c
        assert sum_phred(q) == pytest.approx(c["sum"], rel=1e-14)
    # block-vectorized path must agree
    lengths = np.array([len(q) for q in quals])
    block = np.zeros((len(quals), lengths.max()), dtype=np.uint8)
    for i, q in enumerate(quals):
        block[i, : len(q)] = q
    avg, delta, total = phred_stats_block(block, lengths)
    for i, c in enumerate(cases):
        assert int(avg[i]) == c["avg"]
        assert int(delta[i]) == c["delta"]
        assert float(total[i]) == pytest.approx(c["sum"], rel=1e-14)


def test_median_descending():
    # reference sorts descending and takes vec[n/2] (goldrush_path.cpp:53-59)
    scores = np.array([1, 9, 5, 7, 3], dtype=np.uint32)
    assert calc_median_phred(scores, 5) == 5
    assert calc_median_phred(scores, 4) == 5  # n/2 = 2 into [9,7,5,3,1]
