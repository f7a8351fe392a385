"""Detector-stage tests.

Ports the reference smoke tests (/root/reference/tests/test_detector.py) and
adds physics checks the reference lacks: trajectory cross-validation against
an independent scipy Radau integration of the same EoM, and transport
conservation sanity.
"""

import numpy as np
import pytest

import jax

from attpc_engine_tpu import nuclear_map
from attpc_engine_tpu.nuclear import GasTarget
from attpc_engine_tpu.detector import (
    Config,
    DetectorParams,
    ElectronicsParams,
    PadParams,
    EngineParams,
)
from attpc_engine_tpu.detector.simulator import simulate, DetectorSimulator

gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)

detector = DetectorParams(
    length=1.0,
    efield=45000.0,
    bfield=2.85,
    mpgd_gain=175000,
    gas_target=gas,
    diffusion=0.277,
    fano_factor=0.2,
    w_value=34.0,
)

electronics = ElectronicsParams(
    clock_freq=6.25,
    amp_gain=900,
    shaping_time=1000,
    micromegas_edge=10,
    windows_edge=560,
    adc_threshold=40,
)

pads = PadParams()

# small engine for fast CPU tests
fast_engine = EngineParams(
    n_time_steps=2000,
    chunk_steps=250,
    point_budget=2048,
    cloud_cap=4096,
    events_per_batch=2,
)


def test_config():
    config = Config(detector, electronics, pads)
    assert config.pad_grid.shape == (5600, 5600)
    assert config.pad_centers.shape == (10240, 2)
    assert config.pad_sizes.shape == (10240,)
    assert config.beam_mask.sum() == len(config.beam_pads)
    assert config.drift_velocity == pytest.approx(1.0 / 550.0)


def test_simulation_event():
    """Reference smoke test: 4 'protons' at pz=10 MeV/c from (1,1,1)...
    vertex outside the chamber -> empty but well-formed result; then a real
    in-chamber proton produces a non-empty labeled cloud."""
    fake_data = np.array(
        [
            [0.0, 0.0, 10.0, 938.0],
            [0.0, 0.0, 10.0, 938.0],
            [0.0, 0.0, 10.0, 938.0],
            [0.0, 0.0, 10.0, 938.0],
        ]
    )
    proton_numbers = np.array([1, 1, 1, 1])
    mass_numbers = np.array([1, 1, 1, 1])
    vertex = np.array([1.0, 1.0, 1.0])
    config = Config(detector, electronics, pads)
    rng = np.random.default_rng()

    event = simulate(
        fake_data, vertex, proton_numbers, mass_numbers, config, rng, [0],
        engine=fast_engine,
    )
    assert len(event) == 2


def test_simulation_proton_track():
    """A 5 MeV proton fired transversely from the chamber center must light
    up pads with correct labels and tb bounds."""
    p = np.sqrt(5.0 * (5.0 + 2.0 * 938.272))  # MeV/c
    momenta = np.array(
        [
            [0.0, 0.0, 0.0, 938.272],
            [0.0, 0.0, 0.0, 938.272],
            [p / np.sqrt(2), 0.0, p / np.sqrt(2), 938.272 + 5.0],
            [0.0, 0.0, 0.0, 938.272],
        ]
    )
    vertex = np.array([0.0, 0.0, 0.5])
    config = Config(detector, electronics, pads)
    rng = np.random.default_rng(42)
    cloud, labels = simulate(
        momenta,
        vertex,
        np.array([1, 1, 1, 1]),
        np.array([1, 1, 1, 1]),
        config,
        rng,
        [2],
        engine=fast_engine,
    )
    assert len(cloud) > 10
    assert np.all(labels == 2)
    assert np.all((cloud[:, 0] >= 0) & (cloud[:, 0] < 10240))
    assert np.all((cloud[:, 1] >= 0) & (cloud[:, 1] < 512))
    # charges are nonnegative; entries far below one electron may merge to
    # exactly 0 (f32 prefix granularity — the reference's per-pixel int()
    # truncation produces charge-0 dict entries the same way)
    assert np.all(cloud[:, 2] >= 0)
    assert cloud[:, 2].max() > 0
    # unique (pad, tb_int) keys — merged
    keys = cloud[:, 0] * 512 + np.floor(cloud[:, 1])
    assert len(np.unique(keys)) == len(keys)


def test_trajectory_vs_scipy_radau():
    """RK4 lax.scan trajectory matches an independent scipy Radau solve of
    the same EoM (same stopping tables) to sub-mm over the track."""
    from scipy.integrate import solve_ivp
    from attpc_engine_tpu.detector.transport import integrate_tracks, TrackSpecies
    from attpc_engine_tpu.constants import C, E_CHARGE, MEV_2_JOULE, MEV_2_KG
    import jax.numpy as jnp

    proton = nuclear_map.get_data(1, 1)
    log_ke, dedx_tab = gas.dedx_interp_arrays(proton)

    ke0 = 5.0  # MeV
    gv_mag = np.sqrt(ke0 * (ke0 + 2 * proton.mass)) / proton.mass
    direction = np.array([1.0, 0.0, 1.0]) / np.sqrt(2)
    gv0 = gv_mag * direction
    pos0 = np.array([0.0, 0.0, 0.3])

    bfield, efield = detector.bfield, detector.efield
    density = gas.density

    def rhs(t, state):
        gv = state[3:]
        gvm = np.linalg.norm(gv)
        gamma = np.sqrt(1 + gvm**2)
        beta = gvm / gamma
        ke = proton.mass * gvm**2 / (1 + gamma)
        u = gv / gvm
        velo = u * beta * C
        q_m = 1 * E_CHARGE / (proton.mass * MEV_2_KG)
        dedx = np.interp(np.log(max(ke, 1e-12)), log_ke, dedx_tab)
        decel = dedx * MEV_2_JOULE * density * 100.0 / (proton.mass * MEV_2_KG)
        b, e = -bfield, -efield
        return [
            velo[0],
            velo[1],
            velo[2],
            (q_m * velo[1] * b - decel * u[0]) / C,
            (-q_m * velo[0] * b - decel * u[1]) / C,
            (q_m * e - decel * u[2]) / C,
        ]

    t_end = 2000 * 1e-10
    sol = solve_ivp(
        rhs,
        (0, t_end),
        np.concatenate([pos0, gv0]),
        method="Radau",
        t_eval=np.linspace(1e-10, t_end, 2000),
        rtol=1e-8,
        atol=1e-10,
    )

    species = TrackSpecies(
        mass=jnp.array([proton.mass], dtype=jnp.float32),
        charge=jnp.array([1.0], dtype=jnp.float32),
        log_ke_lo=float(log_ke[0]),
        dlog_ke=float(log_ke[1] - log_ke[0]),
        dedx=jnp.asarray(dedx_tab[None, :], dtype=jnp.float32),
    )
    positions, dke, alive = integrate_tracks(
        jnp.asarray(pos0[None], dtype=jnp.float32),
        jnp.asarray(gv0[None], dtype=jnp.float32),
        jnp.zeros(1, dtype=jnp.int32),
        species,
        density=density,
        bfield=bfield,
        efield=efield,
        n_steps=2000,
        chunk_steps=250,
    )
    ours = np.asarray(positions[:, 0, :])
    alive_mask = np.asarray(alive[:, 0])
    n = min(len(sol.t), alive_mask.sum())
    err = np.linalg.norm(ours[:n] - sol.y[:3, :n].T, axis=1)
    assert err.max() < 5e-4  # < 0.5 mm over the whole track


def test_energy_deposit_totals():
    """Total deposited dKE over a stopped track ~ initial KE."""
    from attpc_engine_tpu.detector.transport import integrate_tracks, TrackSpecies
    import jax.numpy as jnp

    # heavy slow nucleus stops quickly: 13C at 2 MeV
    c13 = nuclear_map.get_data(6, 13)
    log_ke, dedx_tab = gas.dedx_interp_arrays(c13)
    ke0 = 2.0
    gv_mag = np.sqrt(ke0 * (ke0 + 2 * c13.mass)) / c13.mass
    species = TrackSpecies(
        mass=jnp.array([c13.mass], dtype=jnp.float32),
        charge=jnp.array([6.0], dtype=jnp.float32),
        log_ke_lo=float(log_ke[0]),
        dlog_ke=float(log_ke[1] - log_ke[0]),
        dedx=jnp.asarray(dedx_tab[None, :], dtype=jnp.float32),
    )
    positions, dke, alive = integrate_tracks(
        jnp.asarray([[0.0, 0.0, 0.5]], dtype=jnp.float32),
        jnp.asarray([[0.0, gv_mag / np.sqrt(2), gv_mag / np.sqrt(2)]], jnp.float32),
        jnp.zeros(1, dtype=jnp.int32),
        species,
        density=gas.density,
        bfield=detector.bfield,
        efield=detector.efield,
        n_steps=10000,
        chunk_steps=500,
    )
    total = float(np.asarray(dke[:, 0]).sum())
    alive_frac = float(np.asarray(alive[:, 0]).mean())
    if alive_frac < 1.0:  # track ended inside the window
        # deposits should account for most of the initial KE (modulo the
        # E-field work and the sub-limit tail)
        assert total == pytest.approx(ke0, rel=0.2)


def test_batched_events_deterministic():
    """Same key -> identical batch output; different keys differ."""
    config = Config(detector, electronics, pads)
    sim = DetectorSimulator(
        config,
        np.array([1, 1, 1, 1]),
        np.array([1, 1, 1, 1]),
        indices=[2],
        engine=fast_engine,
    )
    p = np.sqrt(5.0 * (5.0 + 2.0 * 938.272))
    momenta = np.zeros((2, 4, 4))
    momenta[:, :, 3] = 938.272
    momenta[:, 2, 0] = p / np.sqrt(2)
    momenta[:, 2, 2] = p / np.sqrt(2)
    momenta[:, 2, 3] = 938.272 + 5.0
    vertices = np.tile(np.array([0.0, 0.0, 0.5]), (2, 1))

    out1 = sim.simulate_batch(jax.random.PRNGKey(0), vertices, momenta)
    out2 = sim.simulate_batch(jax.random.PRNGKey(0), vertices, momenta)
    out3 = sim.simulate_batch(jax.random.PRNGKey(1), vertices, momenta)
    np.testing.assert_array_equal(
        np.asarray(out1["charges"]), np.asarray(out2["charges"])
    )
    assert not np.array_equal(np.asarray(out1["charges"]), np.asarray(out3["charges"]))
    # two identical events in the batch should give identical merged keys
    # (stochastic electron counts differ, but pads hit should overlap a lot)
    c = np.asarray(out1["spyral_counts"])
    assert c[0] > 0 and c[1] > 0


def test_simulate_cache_key_is_content_based():
    """Regression: the simulate() memo must key on
    config CONTENT, not id() — a new Config allocated at a recycled address
    with different physics must not hit a stale cached simulator."""
    from attpc_engine_tpu.detector.simulator import (
        _config_fingerprint,
        _engine_fingerprint,
    )

    cfg_a = Config(detector, electronics, pads)
    gas_b = GasTarget([(1, 2, 2)], 600.0, nuclear_map)  # different pressure
    det_b = DetectorParams(
        length=1.0,
        efield=45000.0,
        bfield=2.85,
        mpgd_gain=175000,
        gas_target=gas_b,
        diffusion=0.277,
        fano_factor=0.2,
        w_value=34.0,
    )
    cfg_b = Config(det_b, electronics, pads)
    assert _config_fingerprint(cfg_a) != _config_fingerprint(cfg_b)

    # identical values in distinct objects fingerprint equal (cache reuse
    # survives reconstruction)
    cfg_a2 = Config(
        DetectorParams(
            length=1.0,
            efield=45000.0,
            bfield=2.85,
            mpgd_gain=175000,
            gas_target=GasTarget([(1, 2, 2)], 300.0, nuclear_map),
            diffusion=0.277,
            fano_factor=0.2,
            w_value=34.0,
        ),
        ElectronicsParams(
            clock_freq=6.25,
            amp_gain=900,
            shaping_time=1000,
            micromegas_edge=10,
            windows_edge=560,
            adc_threshold=40,
        ),
        PadParams(),
    )
    assert _config_fingerprint(cfg_a) == _config_fingerprint(cfg_a2)

    # in-place mutation is picked up
    cfg_a2.det_params.diffusion = 0.5
    assert _config_fingerprint(cfg_a) != _config_fingerprint(cfg_a2)

    assert _engine_fingerprint(None) is None
    assert _engine_fingerprint(fast_engine) == _engine_fingerprint(
        EngineParams(**fast_engine.__dict__)
    )


def test_get_response_independent_formula():
    """get_response vs an independently-written evaluation of the published
    GET response (reference response.py:8-31): r = c1 e^{-3c2} c2^3 sin(c2)
    with c1 = 4095 e / (amp_gain fC), c2 = tb/(shaping_ns * clock_MHz * 1e-3),
    sampled on the reference's linspace(0, 512, 512) grid (NOT 0..511),
    negatives clipped. Values are checked point-by-point, plus landmark
    properties: r[0] == 0, the peak sits where d/dc2 [e^{-3c2} c2^3 sin(c2)]
    crosses zero, and the first zero of sin(c2) bounds the positive lobe."""
    import math

    from attpc_engine_tpu.detector.response import apply_response, get_response

    config = Config(detector, electronics, pads)
    ep = config.elec_params
    got = np.asarray(get_response(config), dtype=np.float64)
    assert got.shape == (512,)

    e_charge = 1.602176634e-19
    c1 = 4095.0 * e_charge / ep.amp_gain / 1e-15
    expected = np.empty(512)
    for i in range(512):
        tb = 512.0 * i / 511.0  # linspace(0, 512, 512) endpoint included
        c2 = tb / (ep.shaping_time * ep.clock_freq * 0.001)
        r = c1 * math.exp(-3.0 * c2) * c2**3 * math.sin(c2)
        expected[i] = max(r, 0.0)
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=0.0)

    assert got[0] == 0.0
    # 3 c2^2 sin + c2^3 cos = 3 c2^3 sin  =>  tan(c2) = c2 / (3 c2 - 3)
    # (peak of the positive lobe); just assert the argmax's neighbors are
    # lower and the lobe ends before sin's first zero c2 = pi
    k = int(np.argmax(got))
    assert got[k - 1] < got[k] and got[k] > got[k + 1]
    # sin(c2) < 0 on (pi, 2pi) is clipped to exactly 0; later positive
    # lobes survive but e^{-3 c2} suppresses them to <1e-4 of the peak
    # (second lobe tops out ~5e-6 of it at these electronics params)
    scale = ep.shaping_time * ep.clock_freq * 0.001
    grid = np.linspace(0.0, 512.0, 512)
    c2g = grid / scale
    neg_lobe = (c2g > math.pi + 1e-9) & (c2g < 2.0 * math.pi - 1e-9)
    assert neg_lobe.any() and np.all(got[neg_lobe] == 0.0)
    assert np.all(got[c2g > math.pi + 1e-9] < 1e-4 * got.max())

    # apply_response: amplitude = max of the ADC-clipped trace, integral = sum
    q = 3.0 / got.max() * 4095.0  # scale so the peak clips
    amp, integral = apply_response(got, q)
    assert amp == 4095.0
    assert integral == pytest.approx(np.minimum(got * q, 4095.0).sum())


def test_fused_default_gates_off_cpu(monkeypatch):
    """The default EngineParams (pallas_transport="auto") must keep the
    scan integrator off a GPU backend: the engine never drags CPU runs
    through the Pallas interpreter. Proven by making both kernel entry
    points raise, then matching an explicit pallas_transport=False run."""
    import dataclasses

    from attpc_engine_tpu.detector import transport_pallas

    def _boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("Pallas transport kernel invoked on CPU backend")

    for name in ("integrate_tracks_pallas", "integrate_tracks_pallas_chunked"):
        monkeypatch.setattr(transport_pallas, name, _boom)

    config = Config(detector, electronics, pads)
    zp, ap = np.array([1, 1, 1, 1]), np.array([1, 1, 1, 1])
    p = np.sqrt(5.0 * (5.0 + 2.0 * 938.272))
    momenta = np.zeros((2, 4, 4))
    momenta[:, :, 3] = 938.272
    momenta[:, 2, 0] = p / np.sqrt(2)
    momenta[:, 2, 2] = p / np.sqrt(2)
    momenta[:, 2, 3] = 938.272 + 5.0
    vertices = np.tile(np.array([0.0, 0.0, 0.5]), (2, 1))

    scan = DetectorSimulator(
        config, zp, ap, indices=[2],
        engine=dataclasses.replace(fast_engine, pallas_transport=False),
    )
    out_scan = scan.simulate_batch(jax.random.PRNGKey(3), vertices, momenta)

    auto = DetectorSimulator(config, zp, ap, indices=[2], engine=fast_engine)
    assert fast_engine.pallas_transport == "auto"
    assert auto._use_transport_kernel() is False
    out_auto = auto.simulate_batch(jax.random.PRNGKey(3), vertices, momenta)
    for name in ("charges", "pads", "tbs_i", "labels"):
        np.testing.assert_array_equal(
            np.asarray(out_scan[name]), np.asarray(out_auto[name]),
            err_msg=name,
        )


def test_engine_params_rejects_unknown_flag_strings():
    """A typo'd kernel-flag string must raise, not silently fall back to
    one of the two transport paths; the removed kernel knobs are gone."""
    import pytest

    from attpc_engine_tpu.detector import EngineParams

    for v in (True, False, "auto"):
        EngineParams(pallas_transport=v)
    for bad in ("on", "Auto", "fused"):
        with pytest.raises(ValueError, match="pallas_transport"):
            EngineParams(pallas_transport=bad)
    for removed in ("pallas_lookup", "pallas_sort", "lookup_two_stage"):
        with pytest.raises(TypeError):
            EngineParams(**{removed: True})
