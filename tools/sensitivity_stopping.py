"""Bragg-region stopping-power sensitivity harness.

The in-house stopping model is anchored to external references above
~1 MeV/u (protons <=3.5% of PSTAR, alphas +3.8% of ASTAR CSDA, carbon
1-2% of an independent Bethe evaluation — tests/test_nuclear.py), but
NO external anchor exists in-repo for z>=2 ions BELOW ~1 MeV/u — the
Bragg-peak endgame of every stopped track (reference analog: pycatima
at each ODE step, /root/reference/src/attpc_engine/detector/solver.py:65).
This harness quantifies what a worst-case model error there would do to
the observable outputs: it scales dE/dx by a factor ONLY where the
table's KE < cut (default 1 MeV/u, per species), reruns the identical
event batch (same seed, same kinematics), and reports the shift in:

- kept rows per event (ADC-thresholded point count),
- total gained charge,
- per-event tb span (track z-extent proxy: drift time window covered),
- charge-weighted mean tb (profile centroid).

Env: SENS_EVENTS (64), SENS_STEPS (4000), SENS_FACTORS
("0.9,0.95,1.05,1.1"), SENS_CUT_MEV_PER_U (1.0), SENS_SEED (7).
Prints one JSON line per factor with relative shifts vs factor 1.0.
CPU-runnable (tiny shapes); run it alone when it runs on a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _tiny_setup  # noqa: E402
from attpc_engine_tpu.detector.simulator import split_packed  # noqa: E402

AMU_MEV = 931.494


def perturb_species(species, factor: float, cut_mev_per_u: float):
    """Scale each species' dE/dx table by ``factor`` below cut MeV/u."""
    n_tab = species.dedx.shape[1]
    log_ke = species.log_ke_lo + species.dlog_ke * np.arange(n_tab)
    ke = np.exp(log_ke)  # total KE (MeV) grid
    a_nucleons = np.round(np.asarray(species.mass) / AMU_MEV)
    below = ke[None, :] < (a_nucleons[:, None] * cut_mev_per_u)
    dedx = np.asarray(species.dedx) * np.where(below, factor, 1.0)
    return dataclasses.replace(
        species, dedx=jnp.asarray(dedx, dtype=jnp.float32)
    )


def observables(out, e: int) -> dict:
    counts = np.asarray(out["spyral_counts"])
    total = int(counts.sum())
    q, tb, _pad, _lab = split_packed(np.asarray(out["packed"])[:total])
    offs = np.concatenate([[0], np.cumsum(counts)])
    spans, cents = [], []
    for i in range(e):
        lo, hi = offs[i], offs[i + 1]
        if hi > lo:
            spans.append(float(tb[lo:hi].max() - tb[lo:hi].min()))
            cents.append(float(np.average(tb[lo:hi], weights=q[lo:hi])))
    return {
        "rows_per_event": total / e,
        "total_charge": float(q[: total].sum()),
        "tb_span_mean": float(np.mean(spans)),
        "tb_centroid_mean": float(np.mean(cents)),
    }


def _stopped_inputs(e: int, seed: int, k_tracks: int):
    """Hand-built events whose tracks STOP IN THE GAS (the flagship's
    products exit the chamber above ~4.5 MeV — measured below — so the
    Bragg region must be probed with slow tracks): a ~3 MeV proton near
    90 deg (Larmor spiral at 2.85 T, ~1.3 m path, stops in ~1200 steps;
    ~2/3 of its energy deposits BELOW the 1 MeV/u cut) and a 13C at
    ~20 MeV (1.5 MeV/u, range of a few mm — almost
    all of it inside the Bragg region). Returns (vertices, momenta) in
    the [E, 4, 4] kinematics layout [d, 12C, p, 13C]."""
    rng = np.random.default_rng(seed)
    m_p, m_c13 = 938.272, 12109.481
    ke_p = rng.uniform(1.2, 2.0, e)
    ke_c = rng.uniform(15.0, 25.0, e)
    th_p = rng.uniform(np.radians(80), np.radians(100), e)
    th_c = rng.uniform(np.radians(60), np.radians(120), e)
    ph = rng.uniform(0, 2 * np.pi, (2, e))

    def four_mom(ke, m, th, phi):
        p = np.sqrt(ke * (ke + 2 * m))
        return np.stack(
            [p * np.sin(th) * np.cos(phi), p * np.sin(th) * np.sin(phi),
             p * np.cos(th), ke + m], axis=-1,
        )

    momenta = np.zeros((e, 4, 4))
    momenta[:, 2] = four_mom(ke_p, m_p, th_p, ph[0])
    momenta[:, 3] = four_mom(ke_c, m_c13, th_c, ph[1])
    vertices = np.tile(np.array([0.0, 0.0, 0.5]), (e, 1))
    return vertices, momenta


def run(
    factor: float, e: int, steps: int, cut: float, seed: int, scenario: str
) -> dict:
    # a FRESH simulator per factor: the jitted step captures self.species
    # at trace time, so mutating a used simulator would hit a stale cache
    pipeline, sim = _tiny_setup(events_per_batch=e, n_time_steps=steps)
    # stopped spiraling tracks stay alive for ~1200 deposit points — far
    # past the tiny default point_budget; overflow would silently truncate
    # deposits and fake a sensitivity (measured: -20% "shift" was pure
    # pool_overflow). Size the pools up and ASSERT no overflow below.
    sim.engine.point_budget = max(sim.engine.point_budget, 4096)
    sim.engine.uniq_budget = max(sim.engine.uniq_budget, 16384)
    if factor != 1.0:
        sim.species = perturb_species(sim.species, factor, cut)
    if scenario == "flagship":
        vertices, momenta = pipeline.run_batch(
            e, key=jax.random.PRNGKey(seed)
        )
        vertices, momenta = np.asarray(vertices), np.asarray(momenta)
    else:
        vertices, momenta = _stopped_inputs(e, seed, sim.k_tracks)
    out = sim.simulate_batch(
        jax.random.PRNGKey(seed + 1), vertices, momenta, assemble=False,
        point_budget=sim.engine.point_budget,
        uniq_budget=sim.engine.uniq_budget,
    )
    for ovf in ("pool_overflow", "uniq_overflow", "spyral_overflow"):
        n = int(np.asarray(out[ovf]))
        assert n == 0, f"{ovf}={n}: raise budgets, the shift would be fake"
    return observables(out, e)


def main():
    e = int(os.environ.get("SENS_EVENTS", 64))
    steps = int(os.environ.get("SENS_STEPS", 4000))
    cut = float(os.environ.get("SENS_CUT_MEV_PER_U", 1.0))
    seed = int(os.environ.get("SENS_SEED", 7))
    scenario = os.environ.get("SENS_SCENARIO", "stopped")
    factors = [
        float(x)
        for x in os.environ.get("SENS_FACTORS", "0.9,0.95,1.05,1.1").split(",")
    ]
    base = run(1.0, e, steps, cut, seed, scenario)
    print(json.dumps({"scenario": scenario, "factor": 1.0, **base}),
          flush=True)
    for f in factors:
        obs = run(f, e, steps, cut, seed, scenario)
        rel = {
            k: (obs[k] - base[k]) / base[k] if base[k] else 0.0 for k in obs
        }
        print(
            json.dumps(
                {"scenario": scenario, "factor": f, **obs,
                 "rel_shift": {k: round(v, 5) for k, v in rel.items()}}
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
