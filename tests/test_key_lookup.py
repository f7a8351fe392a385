"""``deposition._key_lookup`` (the pad lookup of every diffusion pixel)
against direct NumPy indexing of the 0.1-mm ``pad_grid`` and the
``beam_mask``.

The reference floors each pixel to whole mm before it indexes its 0.1-mm
pad grid (transporter.py:101-120), so the engine's 1-mm key grid must give,
for every point, exactly ``pad * 512`` or the sentinel: off the plane, on
a hole of the grid (pad < 0) or on a beam pad.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest

import jax

from attpc_engine_tpu.constants import NUM_TB
from attpc_engine_tpu.detector.deposition import KEY_SENTINEL, _key_lookup
from __graft_entry__ import _tiny_setup

SENT = int(KEY_SENTINEL)


@pytest.fixture(scope="module")
def config():
    _, sim = _tiny_setup(events_per_batch=4)
    return sim.config


def lookup_reference(config, x_m, y_m):
    """Whole-mm floor, then the 0.1-mm grid cell of that mm, then the
    beam veto — straight from pad_grid and beam_mask."""
    lo, hi, step = (float(v) for v in config.pad_grid_edges)
    n_mm = int(round(hi - lo))
    ix = np.floor(x_m * 1000.0 - lo).astype(np.int64)
    iy = np.floor(y_m * 1000.0 - lo).astype(np.int64)
    on_plane = (ix >= 0) & (ix < n_mm) & (iy >= 0) & (iy < n_mm)
    g_max = config.pad_grid.shape[0] - 1
    gx = np.clip(np.round(np.clip(ix, 0, n_mm - 1) / step).astype(np.int64), 0, g_max)
    gy = np.clip(np.round(np.clip(iy, 0, n_mm - 1) / step).astype(np.int64), 0, g_max)
    pad = config.pad_grid[gx, gy].astype(np.int64)
    vetoed = (pad < 0) | config.beam_mask[np.clip(pad, 0, None)]
    return np.where(on_plane & ~vetoed, pad * NUM_TB, SENT)


def engine_lookup(config, x_m, y_m):
    dev = config.device_arrays()
    fn = jax.jit(
        partial(_key_lookup, lo_mm=dev["grid_lo_mm"], n_mm=dev["grid_n_mm"])
    )
    return np.asarray(
        fn(dev["key_grid_mm"].reshape(-1), x_m=np.float32(x_m),
           y_m=np.float32(y_m))
    ).astype(np.int64)


def _points(kind, config, rng):
    lo, hi, _ = (float(v) for v in config.pad_grid_edges)
    if kind == "random_on_plane":
        xy = rng.uniform(lo, hi, (2, 5000)) / 1000.0
    elif kind == "off_plane":
        xy = rng.uniform(hi + 1, hi + 200, (2, 500)) / 1000.0
        xy *= rng.choice([-1.0, 1.0], xy.shape)
    elif kind == "grid_edges":
        # the first and last mm of each axis, and one mm beyond them
        edges = np.array([lo - 0.5, lo + 0.25, lo + 1.5, hi - 1.5, hi - 0.75,
                          hi + 0.5]) / 1000.0
        gx, gy = np.meshgrid(edges, edges)
        xy = np.stack([gx.ravel(), gy.ravel()])
    elif kind in ("beam_pads", "holes"):
        # centres of whole-mm cells that the grid maps to beam pads / holes
        key = config.device_arrays()["key_grid_mm"]
        n = key.shape[0]
        mm = np.arange(n)
        src = np.round(mm / float(config.pad_grid_edges[2])).astype(np.int64)
        src = np.clip(src, 0, config.pad_grid.shape[0] - 1)
        grid = config.pad_grid[np.ix_(src, src)].astype(np.int64)
        if kind == "beam_pads":
            mask = (grid >= 0) & config.beam_mask[np.clip(grid, 0, None)]
        else:
            mask = grid < 0
        ix, iy = np.nonzero(mask)
        pick = rng.choice(len(ix), size=min(500, len(ix)), replace=False)
        xy = (np.stack([ix[pick], iy[pick]]) + lo + 0.5) / 1000.0
    elif kind == "near_origin":
        # negative coordinates floor away from zero
        xy = rng.uniform(-3.0, 3.0, (2, 2000)) / 1000.0
    else:
        raise ValueError(kind)
    return xy[0], xy[1]


@pytest.mark.parametrize(
    "kind",
    ["random_on_plane", "off_plane", "grid_edges", "beam_pads", "holes",
     "near_origin"],
)
def test_key_lookup_matches_pad_grid(config, kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    x, y = _points(kind, config, rng)
    # both sides see the same f32 coordinates
    x, y = x.astype(np.float32), y.astype(np.float32)
    got = engine_lookup(config, x, y)
    want = lookup_reference(config, x.astype(np.float64), y.astype(np.float64))
    np.testing.assert_array_equal(got, want)
    if kind in ("off_plane", "beam_pads", "holes"):
        assert (got == SENT).all()
    if kind == "random_on_plane":
        assert (got != SENT).mean() > 0.3  # mostly real pads


def test_key_grid_folds_every_beam_pad(config):
    """No cell of the key grid names a beam pad."""
    key = config.device_arrays()["key_grid_mm"].astype(np.int64)
    pads = key[key != SENT] // NUM_TB
    assert not config.beam_mask[pads].any()
    assert (key[key != SENT] % NUM_TB == 0).all()
