"""``deposition._merge_runs`` (the per-event (pad, tb) group-by) against a
plain NumPy group-by.

The merge sorts each event row of packed keys ``(space_key << rank_bits) |
track_rank``, sums the charges of every run of equal ``space_key`` and
keeps, per run, the key with the highest rank — the deposition-last
writer, whose label the reference's dict overwrite keeps
(transporter.py:169,249). Runs beyond ``cap`` per row are dropped but
counted in ``n_uniq``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest

import jax

from attpc_engine_tpu.detector.deposition import KEY_SENTINEL, _merge_runs

SENT = int(KEY_SENTINEL)


def merge_reference(packed: np.ndarray, qv: np.ndarray, cap: int, rank_bits: int):
    """NumPy group-by: per row, unique space keys ascending, each with its
    last writer's packed key and its charge sum (f64)."""
    e, w = packed.shape
    cap = min(cap, w)
    key2 = np.full((e, cap), SENT, np.int64)
    sums = np.zeros((e, cap), np.float64)
    n_uniq = np.zeros(e, np.int64)
    for i in range(e):
        live = packed[i] != SENT
        keys = packed[i][live].astype(np.int64)
        q = qv[i][live].astype(np.float64)
        space = keys >> rank_bits
        uniq = np.unique(space)
        n_uniq[i] = len(uniq)
        for j, u in enumerate(uniq[:cap]):
            sel = space == u
            key2[i, j] = keys[sel].max()
            sums[i, j] = q[sel].sum()
    return key2, sums, n_uniq


def make_rows(e, w, n_space, rank_bits, dead_frac, seed, dup_pool=None):
    """Random packed rows: ``n_space`` distinct space keys per row (or a
    pool of ``dup_pool`` keys shared by every lane), random ranks, a
    ``dead_frac`` share of sentinel lanes carrying zero charge."""
    rng = np.random.default_rng(seed)
    max_space = 10240 * 512
    packed = np.empty((e, w), np.int64)
    for i in range(e):
        pool = rng.choice(max_space, size=dup_pool or n_space, replace=False)
        space = rng.choice(pool, size=w)
        rank = rng.integers(0, 1 << rank_bits, size=w)
        packed[i] = (space << rank_bits) | rank
    dead = rng.random((e, w)) < dead_frac
    packed = np.where(dead, SENT, packed).astype(np.int32)
    qv = np.where(dead, 0.0, rng.exponential(50.0, (e, w))).astype(np.float32)
    return packed, qv


def check(packed, qv, cap, rank_bits):
    fn = jax.jit(partial(_merge_runs, cap=cap, rank_bits=rank_bits))
    key2, sums, valid2, n_uniq = (np.asarray(x) for x in fn(packed, qv))
    rk, rs, rn = merge_reference(packed, qv, cap, rank_bits)
    np.testing.assert_array_equal(n_uniq, rn)
    np.testing.assert_array_equal(valid2, rk != SENT)
    # exact keys: the kept rank of every run is its last writer's
    np.testing.assert_array_equal(key2.astype(np.int64), rk)
    # charge sums are differences of an f32 row prefix: the error scales
    # with the row's total charge, never with the run's own size
    for i in range(packed.shape[0]):
        total = float(qv[i].astype(np.float64).sum())
        np.testing.assert_allclose(
            sums[i], rs[i], rtol=1e-5, atol=4e-7 * total + 1e-6
        )
    return key2, sums, valid2, n_uniq


# (events, width, distinct keys, rank_bits, dead share, cap) — widths that
# are not powers of two, like the engine's point_budget * 100 rows
CASES = {
    "w7": (2, 7, 5, 1, 0.2, 16),
    "w100": (3, 100, 40, 1, 0.3, 128),
    "w1000": (2, 1000, 300, 2, 0.5, 512),
    "w5760_flagship_row": (2, 5760, 2000, 1, 0.6, 4096),
    "three_tracks": (2, 900, 200, 2, 0.1, 1024),
    "many_tracks": (2, 640, 100, 5, 0.1, 1024),
    "uniq_overflow": (2, 1000, 600, 1, 0.0, 256),
    "cap_above_width": (2, 50, 20, 1, 0.1, 4096),
    "no_dead_lanes": (3, 333, 111, 1, 0.0, 512),
    "mostly_dead": (3, 400, 50, 1, 0.95, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_matches_numpy_groupby(case):
    e, w, n_space, rank_bits, dead, cap = CASES[case]
    packed, qv = make_rows(e, w, n_space, rank_bits, dead, seed=len(case))
    check(packed, qv, cap, rank_bits)


def test_all_sentinel_rows():
    packed = np.full((3, 77), SENT, np.int32)
    qv = np.zeros((3, 77), np.float32)
    key2, sums, valid2, n_uniq = check(packed, qv, 32, 1)
    assert not valid2.any() and (n_uniq == 0).all() and (sums == 0).all()


def test_single_run_row():
    """Every lane in one (pad, tb): one run whose label is the highest
    rank and whose charge is the row total."""
    w = 301
    rank = np.arange(w) % 4
    packed = ((np.int64(12345) << 2) | rank).astype(np.int32)[None]
    qv = np.full((1, w), 2.5, np.float32)
    key2, sums, valid2, n_uniq = check(packed, qv, 64, 2)
    assert n_uniq[0] == 1 and valid2[0].sum() == 1
    assert key2[0, 0] == (12345 << 2) | 3
    assert sums[0, 0] == pytest.approx(2.5 * w, rel=1e-6)


@pytest.mark.parametrize("pool", [1, 3, 17])
def test_heavy_duplication(pool):
    """Thousands of lanes over a handful of (pad, tb) keys."""
    packed, qv = make_rows(2, 4000, pool, 1, 0.1, seed=pool, dup_pool=pool)
    key2, sums, valid2, n_uniq = check(packed, qv, 128, 1)
    assert (n_uniq == pool).all()


def test_overflow_keeps_lowest_keys_and_counts_all():
    """uniq_budget overflow: the ``cap`` lowest keys survive, ``n_uniq``
    still counts every run (the driver doubles the budget from it)."""
    packed, qv = make_rows(2, 2000, 1500, 1, 0.0, seed=7)
    key2, sums, valid2, n_uniq = check(packed, qv, 100, 1)
    assert valid2.all() and (n_uniq > 100).all()
    space = key2.astype(np.int64) >> 1
    assert (np.diff(space, axis=1) > 0).all()
