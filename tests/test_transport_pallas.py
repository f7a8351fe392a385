"""Pallas RK4 transport kernel (Triton route) vs the lax.scan integrator.

Runs the kernel through the Pallas interpreter on the CPU: the same
kernel code the GPU compiles, gridded over blocks of tracks with the batch
padded to a whole block. Tolerances: alive identical, positions within
1e-6 m, energy deposits within 1e-4 MeV (f32 operation order). On an H100
the compiled kernel met the same tolerances at 768 tracks x 500 and
10,000 steps (``chip_smoke.py`` phase 3 re-checks them on every run);
the ``gpu``-marked test below repeats that check where a card is present.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from __graft_entry__ import _tiny_setup
from attpc_engine_tpu.detector.transport import integrate_tracks
from attpc_engine_tpu.detector.transport_pallas import (
    _prepare,
    integrate_tracks_pallas,
    integrate_tracks_pallas_chunked,
)


def _tracks(n_events, n_steps, seed=0, pipeline=None):
    base, sim = _tiny_setup(events_per_batch=n_events, n_time_steps=n_steps)
    if pipeline is not None:
        from attpc_engine_tpu.detector.simulator import DetectorSimulator

        sim = DetectorSimulator(
            sim.config, pipeline.get_proton_numbers(),
            pipeline.get_mass_numbers(), engine=sim.engine,
        )
    else:
        pipeline = base
    vertices, momenta = pipeline.run_batch(n_events, key=jax.random.PRNGKey(seed))
    p3 = momenta[:, sim.sim_indices, :3]
    gvs = jnp.asarray(
        (p3 / sim.track_masses[None, :, None]).astype(np.float32)
    ).reshape(-1, 3)
    pos0 = jnp.repeat(
        jnp.asarray(vertices, dtype=jnp.float32), sim.k_tracks, axis=0
    )
    s_idx = jnp.tile(jnp.arange(sim.k_tracks, dtype=jnp.int32), n_events)
    cfg = sim.config
    kw = dict(
        density=cfg.det_params.gas_target.density,
        bfield=cfg.det_params.bfield,
        efield=cfg.det_params.efield,
        n_steps=n_steps,
    )
    return pos0, gvs, s_idx, sim.species, kw


def _assert_close(ref, got):
    p1, d1, a1 = (np.asarray(x) for x in ref)
    p2, d2, a2 = (np.asarray(x) for x in got)
    assert p1.shape == p2.shape and d1.shape == d2.shape
    np.testing.assert_array_equal(a1, a2)
    # compare only live deposit points: dead lanes freeze at their
    # stopping position and their outputs are never consumed
    live = a1
    if live.any():
        assert np.abs(p1 - p2)[live].max() < 1e-6  # meters
        assert np.abs(d1 - d2)[live].max() < 1e-4  # MeV


def test_pallas_matches_scan_interpret():
    pos0, gvs, s_idx, species, kw = _tracks(8, 200)
    ref = integrate_tracks(pos0, gvs, s_idx, species, chunk_steps=200, **kw)
    got = integrate_tracks_pallas(pos0, gvs, s_idx, species, interpret=True, **kw)
    _assert_close(ref, got)


def test_run_simulation_with_pallas_transport(tmp_path, interpret_kernels):
    """The pallas_transport engine flag produces working output through the
    full driver (the kernel runs interpreted on the CPU)."""
    from attpc_engine_tpu.detector import EngineParams, SpyralWriter, run_simulation
    from attpc_engine_tpu.kinematics import run_kinematics_pipeline

    pipeline, sim = _tiny_setup(events_per_batch=4)
    kine = tmp_path / "k.h5"
    run_kinematics_pipeline(pipeline, 4, kine, batch_size=4, seed=8,
                            show_progress=False)
    engine = EngineParams(
        n_time_steps=250, chunk_steps=250, point_budget=2048,
        out_budget=8192, events_per_batch=4, pallas_transport=True,
    )
    d = tmp_path / "clouds"
    d.mkdir()
    run_simulation(sim.config, kine, SpyralWriter(d, sim.config),
                   engine=engine, seed=2, show_progress=False)
    import h5py

    with h5py.File(d / "run_0000.h5") as f:
        names = [k for k in f["cloud"].keys() if k.startswith("cloud_")]
        assert len(names) >= 3


def test_pallas_chunked_matches_scan_interpret():
    """The chunked wrapper (multi-chunk window + early exit) matches the
    scan integrator over a window several chunks long."""
    pos0, gvs, s_idx, species, kw = _tracks(4, 300, seed=3)
    ref = integrate_tracks(pos0, gvs, s_idx, species, chunk_steps=100, **kw)
    got = integrate_tracks_pallas_chunked(
        pos0, gvs, s_idx, species, chunk_steps=100, interpret=True, **kw
    )
    _assert_close(ref, got)


# (events, block_tracks, n_steps, chunk_steps): track counts (2 per event)
# that are not a multiple of the block, one block, several blocks
@pytest.mark.parametrize(
    "events,block,n_steps,chunk",
    [
        (3, 4, 64, 64),  # 6 tracks -> 2 blocks of 4, 2 padding lanes
        (5, 32, 96, 96),  # 10 tracks in one block of 32
        (9, 8, 96, 32),  # 18 tracks -> 3 blocks of 8, chunked
        (16, 32, 64, 16),  # exactly one full block, chunked
    ],
)
def test_kernel_blocks_and_padding_match_scan(events, block, n_steps, chunk):
    pos0, gvs, s_idx, species, kw = _tracks(events, n_steps, seed=events)
    ref = integrate_tracks(pos0, gvs, s_idx, species, chunk_steps=chunk, **kw)
    if chunk == n_steps:
        got = integrate_tracks_pallas(
            pos0, gvs, s_idx, species, block_tracks=block, interpret=True, **kw
        )
    else:
        got = integrate_tracks_pallas_chunked(
            pos0, gvs, s_idx, species, chunk_steps=chunk, block_tracks=block,
            interpret=True, **kw,
        )
    _assert_close(ref, got)


@pytest.mark.parametrize("chunked", [False, True], ids=["single", "chunked"])
def test_kernel_three_species_chain_matches_scan(chunked):
    """A decay chain: three species per event, each with its own table
    block in the flattened dE/dx table."""
    from tests.test_cuda_lowering import _decay_chain_pipeline

    pos0, gvs, s_idx, species, kw = _tracks(
        4, 128, seed=5, pipeline=_decay_chain_pipeline()
    )
    assert species.dedx.shape[0] == 3
    chunk = 32 if chunked else 128
    ref = integrate_tracks(pos0, gvs, s_idx, species, chunk_steps=chunk, **kw)
    if chunked:
        got = integrate_tracks_pallas_chunked(
            pos0, gvs, s_idx, species, chunk_steps=chunk, interpret=True, **kw
        )
    else:
        got = integrate_tracks_pallas(
            pos0, gvs, s_idx, species, interpret=True, **kw
        )
    _assert_close(ref, got)


def test_padding_lanes_start_dead():
    pos0, gvs, s_idx, species, _ = _tracks(3, 16)
    _, _, alive0, base, _, _, b_pad = _prepare(pos0, gvs, s_idx, species, 4)
    assert b_pad == 8
    alive0 = np.asarray(alive0)
    assert (alive0[6:] == 0).all() and (alive0[:6] == 1).all()
    n_tab = species.dedx.shape[1]
    np.testing.assert_array_equal(
        np.asarray(base)[:6], np.asarray(s_idx) * n_tab
    )


@pytest.mark.gpu
def test_compiled_kernel_matches_scan_on_gpu(gpu_device):
    """The kernel compiled for the card against the scan on the card."""
    with jax.default_device(gpu_device):
        pos0, gvs, s_idx, species, kw = _tracks(64, 500)
        ref = integrate_tracks(pos0, gvs, s_idx, species, chunk_steps=500, **kw)
        got = integrate_tracks_pallas(pos0, gvs, s_idx, species, **kw)
    _assert_close(ref, got)
