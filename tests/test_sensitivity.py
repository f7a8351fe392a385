"""Bragg-region stopping sensitivity: the harness measures real physics.

The sub-1 MeV/u stopping model has no external anchor in-repo;
tools/sensitivity_stopping.py bounds what a model error there does
to observables. This test pins the harness's physics on a small stopped-
track batch: energy conservation makes the total collected charge nearly
invariant under a dE/dx scaling, while the track RANGE (tb span) moves
opposite to the scaling — lower stopping power, longer track.
"""

from tools.sensitivity_stopping import run


def test_stopped_track_sensitivity_signs():
    e, steps, cut, seed = 4, 2500, 1.0, 7
    base = run(1.0, e, steps, cut, seed, "stopped")
    low = run(0.9, e, steps, cut, seed, "stopped")  # 10% weaker stopping

    # stopped tracks deposit their full KE either way: total charge is
    # conserved to well under 1% (only threshold-edge redistribution)
    rel_q = abs(low["total_charge"] - base["total_charge"]) / base["total_charge"]
    assert rel_q < 0.01, rel_q

    # 10% weaker stopping -> measurably longer range (tb span up) and
    # the charge spread over more cells (kept rows up)
    assert low["tb_span_mean"] > base["tb_span_mean"]
    assert low["rows_per_event"] > base["rows_per_event"]


def test_flagship_insensitive_to_bragg_region():
    """The flagship 12C(d,p)@120 MeV products leave the active volume
    above ~4.5 MeV — never entering the unanchored sub-1 MeV/u region —
    so its outputs must be bit-identical under a Bragg-region scaling."""
    e, steps, cut, seed = 4, 1000, 1.0, 7
    base = run(1.0, e, steps, cut, seed, "flagship")
    pert = run(1.2, e, steps, cut, seed, "flagship")
    assert base == pert
