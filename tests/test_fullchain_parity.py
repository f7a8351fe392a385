"""Full-chain statistical parity: engine vs a reference-faithful path.

Builds a slow numpy/scipy mirror of the ENTIRE reference detector chain —
Radau trajectory integration with terminal events
(/root/reference/src/attpc_engine/detector/solver.py:243-305), Fano-smeared
electron generation (solver.py:308-347), mesh diffusion transport with the
per-pixel int() truncation and dict-overwrite labels
(transporter.py:124-318), TB wiggle + bounds (simulator.py:104-113) and the
GET response/ADC threshold (writer.py:61-112, response.py:35-56) — and
compares the engine's batched chain against it
DISTRIBUTIONALLY on a handful of 12C(d,p) events, with diffusion on and
off.

The two paths share the physics inputs (same stopping tables via
``GasTarget.get_dedx``, same geometry, same kinematics sample) but draw
independent random numbers, so the comparison is on per-event observables
with stated tolerances, not bitwise:

- kept-point count per event: within 15%
- total integral (charge) per event: within 5%
- pad set (diffusion on): Jaccard overlap >= 0.75 and charge-weighted
  overlap >= 0.9. With diffusion OFF every deposit lands on exactly one
  pad, so the cloud is a one-pad-wide line and a sub-mm difference
  between the f32 RK4 and f64 Radau trajectories flips the whole-mm
  floor to a NEIGHBORING pad: exact set membership is razor-thin there
  (measured Jaccard ~0.57 between two otherwise identical chains).
  For the point-transport case the spatial metric below is the correct
  comparison and the set Jaccard bound is relaxed to >= 0.4.
- charge-weighted (x, y) profile: 1-cm-binned charge histogram over the
  pad plane, total-variation distance <= 0.15 (catches any real spatial
  divergence while tolerating one-pad jitter)
- tb profile: total-variation distance of the 32-bin histogram <= 0.15
- per-label charge split: within 5% of total

Tolerances are loose enough for the stochastic parts (Fano smear, TB
wiggle, threshold-edge points) and tight enough to catch any structural
divergence in trajectory, deposition, merge or response semantics.
"""

import numpy as np
import pytest
from scipy.integrate import solve_ivp

import jax

from attpc_engine_tpu import nuclear_map
from attpc_engine_tpu.constants import C, E_CHARGE, MEV_2_JOULE, MEV_2_KG
from attpc_engine_tpu.detector import (
    Config,
    DetectorParams,
    ElectronicsParams,
    EngineParams,
    PadParams,
)
from attpc_engine_tpu.detector.deposition import MESH_STEPS
from attpc_engine_tpu.detector.response import get_response
from attpc_engine_tpu.detector.simulator import DetectorSimulator
from attpc_engine_tpu.kinematics import (
    ExcitationGaussian,
    KinematicsPipeline,
    PolarUniform,
    Reaction,
)
from attpc_engine_tpu.nuclear import GasTarget

N_EVENTS = 4
N_STEPS = 2500  # integration window (both paths truncate identically)
DT = 1e-10


def _make_config(diffusion: float) -> Config:
    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    return Config(
        DetectorParams(1.0, 45000.0, 2.85, 175000, gas, diffusion, 0.2, 34.0),
        ElectronicsParams(6.25, 900, 1000, 10, 560, 40),
        PadParams(),
    )


@pytest.fixture(scope="module")
def kinematics_sample():
    pipeline = KinematicsPipeline(
        [
            Reaction(
                target=nuclear_map.get_data(1, 2),
                projectile=nuclear_map.get_data(6, 12),
                ejectile=nuclear_map.get_data(1, 1),
            )
        ],
        [ExcitationGaussian(0.0, 0.0)],
        [PolarUniform(0.0, np.pi)],
        120.0,
    )
    vertices, momenta = pipeline.run_batch(
        N_EVENTS, key=jax.random.PRNGKey(7)
    )
    return pipeline, np.asarray(vertices), np.asarray(momenta)


# --------------------------------------------------------------------- #
# reference-faithful numpy/scipy chain
# --------------------------------------------------------------------- #


def _ref_trajectory(vertex, momentum, nucleus, gas, det: DetectorParams):
    """scipy Radau with the reference's four terminal events
    (solver.py:243-305), fields negated, t_eval on the engine's window."""
    mass = nucleus.mass
    z = nucleus.Z
    state0 = np.zeros(6)
    state0[:3] = vertex
    state0[3:] = momentum[:3] / mass

    bfield = -det.bfield
    efield = -det.efield
    q_m = z * E_CHARGE / (mass * MEV_2_KG)

    def rhs(t, state):
        gv = np.linalg.norm(state[3:])
        beta = np.sqrt(gv**2 / (1.0 + gv**2))
        gamma = gv / beta
        u = state[3:] / gv
        velo = u * beta * C
        ke = mass * (gamma - 1.0)
        decel = (
            gas.get_dedx(nucleus, ke) * MEV_2_JOULE * gas.density * 100.0
        ) / (mass * MEV_2_KG)
        out = np.empty(6)
        out[:3] = velo
        out[3] = (q_m * velo[1] * bfield - decel * u[0]) / C
        out[4] = (-q_m * velo[0] * bfield - decel * u[1]) / C
        out[5] = (q_m * efield - decel * u[2]) / C
        return out

    def ev_ke(t, s):
        gv = np.linalg.norm(s[3:])
        gamma = np.sqrt(1.0 + gv**2)
        return mass * (gamma - 1.0) - 1e-6

    def ev_zf(t, s):
        return s[2] - 1.0

    def ev_zb(t, s):
        return s[2]

    def ev_rho(t, s):
        return np.hypot(s[0], s[1]) - 0.292

    ev_ke.terminal, ev_ke.direction = True, -1.0
    ev_zf.terminal, ev_zf.direction = True, 1.0
    ev_zb.terminal, ev_zb.direction = True, -1.0
    ev_rho.terminal, ev_rho.direction = True, 1.0

    sol = solve_ivp(
        rhs,
        (0.0, 1.0),
        state0,
        method="Radau",
        events=[ev_ke, ev_zf, ev_zb, ev_rho],
        t_eval=np.arange(N_STEPS + 1) * DT,
    )
    return sol.y.T  # [n, 6]


def _ref_event_cloud(vertex, momenta_rows, nuclei, labels, config, rng):
    """One event through the full reference-faithful chain; returns the
    merged dict {pad*512+tb: [charge, label]} and final spyral-like rows."""
    det = config.det_params
    gas = det.gas_target
    grid = config.pad_grid
    low, high, binsize = config.pad_grid_edges
    beam_mask = config.beam_mask
    dv = config.drift_velocity
    points: dict = {}

    for momentum, nucleus, label in zip(momenta_rows, nuclei, labels):
        if nucleus.Z == 0:
            continue
        track = _ref_trajectory(vertex, momentum, nucleus, gas, det)
        # electrons (solver.py:308-347)
        gv = np.linalg.norm(track[:, 3:], axis=1)
        gamma = np.sqrt(1.0 + gv**2)
        energy = nucleus.mass * (gamma - 1.0)
        electrons = np.zeros_like(energy)
        electrons[1:] = np.abs(np.diff(energy)) * (1.0e6 / det.w_value)
        electrons = np.array(
            [
                rng.normal(p, np.sqrt(det.fano_factor * p)) if p > 0 else 0.0
                for p in electrons
            ],
            dtype=np.int64,
        )
        mask = electrons >= 1
        track = track[mask]
        ne = electrons[mask] * det.mpgd_gain
        # z -> float tb (solver.py:394-398)
        tbs = (det.length - track[:, 2]) / dv + config.elec_params.micromegas_edge
        # transport_track (transporter.py:252-318)
        for (x, y), tb_f, n_e in zip(track[:, :2], tbs, ne):
            sigma = np.sqrt(2.0 * det.diffusion * dv * tb_f / det.efield)
            tb = int(tb_f)
            if sigma == 0.0:
                _ref_deposit(
                    points, grid, low, high, binsize, beam_mask,
                    x, y, tb, int(n_e), label,
                )
            else:
                mesh = np.linspace(-3 * sigma, 3 * sigma, MESH_STEPS)
                step = 6.0 * sigma / (MESH_STEPS - 1)
                c_norm = 1.0 / (2.0 * np.pi * sigma**2)
                for ox in mesh:
                    for oy in mesh:
                        pdf = c_norm * np.exp(
                            -0.5 * (ox**2 + oy**2) / sigma**2
                        )
                        q = int(pdf * step * step * n_e)  # per-pixel int()
                        _ref_deposit(
                            points, grid, low, high, binsize, beam_mask,
                            x + ox, y + oy, tb, q, label,
                        )

    # TB wiggle + bounds (simulator.py:104-113), response + ADC threshold
    # (writer.py:222-238)
    response = np.asarray(get_response(config), dtype=np.float64)
    adc = float(config.elec_params.adc_threshold)
    rows = []
    for key, (q, label) in points.items():
        pad, tb = divmod(key, 512)
        tb_f = tb + rng.uniform(0.0, 1.0)
        if not (0.0 <= tb_f < 512.0):
            continue
        trace = np.minimum(response * q, 4095.0)
        amp = trace.max()
        integral = trace.sum()
        if amp > adc:
            rows.append((pad, tb_f, amp, integral, label))
    return points, rows


def _ref_deposit(points, grid, low, high, binsize, beam_mask, x, y, tb, q, label):
    """position_to_index + accumulate (transporter.py:79-169)."""
    x_mm, y_mm = np.floor(x * 1000.0), np.floor(y * 1000.0)
    if not (low <= x_mm < high and low <= y_mm < high):
        return
    ix = int((x_mm - low) / binsize)
    iy = int((y_mm - low) / binsize)
    pad = int(grid[ix, iy])
    if pad < 0 or beam_mask[pad]:
        return
    key = pad * 512 + tb
    if key in points:
        points[key][0] += q
        points[key][1] = label
    else:
        points[key] = [q, label]


# --------------------------------------------------------------------- #
# engine chain
# --------------------------------------------------------------------- #


def _engine_clouds(config, pipeline, vertices, momenta):
    sim = DetectorSimulator(
        config,
        pipeline.get_proton_numbers(),
        pipeline.get_mass_numbers(),
        engine=EngineParams(
            n_time_steps=N_STEPS,
            chunk_steps=250,
            point_budget=4096,
            uniq_budget=24576,
            out_budget=16384,
            events_per_batch=N_EVENTS,
        ),
    )
    out = sim.simulate_batch(
        jax.random.PRNGKey(99), vertices, momenta, assemble=True
    )
    assert int(np.asarray(out["pool_overflow"])) == 0
    assert int(np.asarray(out["uniq_overflow"])) == 0
    assert int(np.asarray(out["spyral_overflow"])) == 0
    counts = np.asarray(out["spyral_counts"])
    spyral = out["spyral"]  # [total, 8] pad_x, pad_y, z, amp, integral, pad, tb, size
    labels = out["spyral_labels"]
    bounds = np.concatenate([[0], np.cumsum(counts)])
    per_event = []
    for i in range(len(counts)):
        s = slice(bounds[i], bounds[i + 1])
        per_event.append((spyral[s], labels[s]))
    return sim.sim_indices, per_event


# --------------------------------------------------------------------- #
# comparison
# --------------------------------------------------------------------- #


def _compare(ref_rows, eng_spyral, eng_labels, pad_centers, diffusion_on):
    ref = np.array(
        [(p, t, a, i, l) for (p, t, a, i, l) in ref_rows], dtype=np.float64
    ).reshape(-1, 5)
    n_ref, n_eng = len(ref), len(eng_spyral)
    assert n_ref > 0 and n_eng > 0
    # point counts
    assert abs(n_eng - n_ref) <= max(0.15 * n_ref, 8), (n_eng, n_ref)
    # total integral
    tot_ref = ref[:, 3].sum()
    tot_eng = eng_spyral[:, 4].sum()
    assert abs(tot_eng - tot_ref) <= 0.05 * tot_ref, (tot_eng, tot_ref)
    # pad sets: plain Jaccard + charge-weighted overlap (see module
    # docstring for why the point-transport bound is looser)
    pads_ref = set(ref[:, 0].astype(int))
    pads_eng = set(eng_spyral[:, 5].astype(int))
    jac = len(pads_ref & pads_eng) / len(pads_ref | pads_eng)
    assert jac >= (0.75 if diffusion_on else 0.4), jac
    if diffusion_on:
        qr = {}
        for p, q in zip(ref[:, 0].astype(int), ref[:, 3]):
            qr[p] = qr.get(p, 0.0) + q
        shared = sum(q for p, q in qr.items() if p in pads_eng)
        assert shared >= 0.9 * ref[:, 3].sum()
    # charge-weighted spatial profile: 1-cm bins over the pad plane
    def xy_hist(pads, charge):
        xy = pad_centers[pads.astype(int)]
        h, _, _ = np.histogram2d(
            xy[:, 0], xy[:, 1], bins=56, range=[[-280, 280], [-280, 280]],
            weights=charge,
        )
        return h / max(charge.sum(), 1e-12)

    tv_xy = 0.5 * np.abs(
        xy_hist(ref[:, 0], ref[:, 3])
        - xy_hist(eng_spyral[:, 5], eng_spyral[:, 4])
    ).sum()
    assert tv_xy <= 0.15, tv_xy
    # tb profile: 32-bin TV distance
    h_ref, _ = np.histogram(ref[:, 1], bins=32, range=(0, 512))
    h_eng, _ = np.histogram(eng_spyral[:, 6], bins=32, range=(0, 512))
    tv = 0.5 * np.abs(
        h_ref / max(n_ref, 1) - h_eng / max(n_eng, 1)
    ).sum()
    assert tv <= 0.15, tv
    # per-label charge split within 5% of the total
    for lab in np.unique(ref[:, 4]).astype(int):
        q_ref = ref[ref[:, 4] == lab, 3].sum()
        q_eng = eng_spyral[np.asarray(eng_labels) == lab, 4].sum()
        assert abs(q_eng - q_ref) <= 0.05 * tot_ref, (lab, q_eng, q_ref)


@pytest.mark.parametrize("diffusion", [0.277, 0.0], ids=["diffusion", "point"])
def test_fullchain_statistical_parity(kinematics_sample, diffusion):
    pipeline, vertices, momenta = kinematics_sample
    config = _make_config(diffusion)
    indices, eng_events = _engine_clouds(config, pipeline, vertices, momenta)

    zs = pipeline.get_proton_numbers()
    azs = pipeline.get_mass_numbers()
    nuclei = [nuclear_map.get_data(int(zs[i]), int(azs[i])) for i in indices]
    rng = np.random.default_rng(2024)
    for ev in range(N_EVENTS):
        _, ref_rows = _ref_event_cloud(
            vertices[ev],
            momenta[ev, indices],
            nuclei,
            list(indices),
            config,
            rng,
        )
        eng_spyral, eng_labels = eng_events[ev]
        _compare(
            ref_rows, eng_spyral, eng_labels,
            np.asarray(config.pad_centers), diffusion > 0.0,
        )
