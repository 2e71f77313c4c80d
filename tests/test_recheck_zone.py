"""Pins the trim-recheck boundary-zone heuristics (engine_util.recheck_zone).

VERDICT r4 weak item 7: the zone constants (`tile_min*S < 2*threshold`,
`stretch >= 3`, `na <= assigned_max + 2`) encode measured calibration
findings (tools/calib_gate.py) but nothing failed if a refactor flipped
one.  These vectors enumerate each rule's boundary on both sides, so any
semantic change to the predicate fails here rather than (only) costing
~0.05 recruit-set Jaccard in the 0.90 quality gate.
"""
import jax.numpy as jnp
import numpy as np

from goldrush_jax.path.engine_util import recheck_zone

S, X, A_MAX = 8, 10, 1          # shipped stride, x-gate, assigned_max


def zone(dec, na, n_tiles, ts, te, tmin, stride=S, thr=X, a_max=A_MAX):
    out = recheck_zone(jnp.int32(dec), jnp.int32(na), jnp.int32(n_tiles),
                       jnp.int32(ts), jnp.int32(te), jnp.int32(tmin),
                       stride, thr, a_max)
    return bool(np.asarray(out))


def test_trim_decisions_always_recheck():
    assert zone(dec=2, na=5, n_tiles=20, ts=3, te=4, tmin=1000)


def test_clean_drop_skips_recheck():
    # all tiles assigned with margin: the sampled verdict stands
    assert not zone(dec=0, na=20, n_tiles=20, ts=0, te=19, tmin=1000)


def test_weak_margin_full_assignment_rechecks():
    # tmin * S < 2 * threshold  <=>  tmin < 2*10/8 = 2.5
    assert zone(dec=0, na=20, n_tiles=20, ts=0, te=19, tmin=2)
    assert not zone(dec=0, na=20, n_tiles=20, ts=0, te=19, tmin=3)


def test_margin_is_stride_scaled():
    # full-vote units: at stride 1 the margin boundary is 2*threshold = 20
    assert zone(dec=0, na=20, n_tiles=20, ts=0, te=19, tmin=19, stride=1)
    assert not zone(dec=0, na=20, n_tiles=20, ts=0, te=19, tmin=20, stride=1)


def test_partial_needs_stretch_or_boundary_na():
    # stretch = te - ts - 1; na far above a_max+2, single-tile dropout:
    # sampling noise, no recheck
    assert not zone(dec=0, na=10, n_tiles=20, ts=5, te=7, tmin=1000)
    # stretch >= 3 tiles: meaningful unassigned run -> recheck
    assert zone(dec=0, na=10, n_tiles=20, ts=5, te=9, tmin=1000)
    # na <= a_max + 2 (= 3): whole-read recruit boundary -> recheck
    assert zone(dec=0, na=3, n_tiles=20, ts=5, te=7, tmin=1000)
    assert not zone(dec=0, na=4, n_tiles=20, ts=5, te=7, tmin=1000)


def test_fully_unassigned_skips_recheck():
    # na == 0 (clean novel read): whole-read recruit, verdict stands
    assert not zone(dec=1, na=0, n_tiles=20, ts=0, te=19, tmin=0)
