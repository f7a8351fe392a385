"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np

import jax

from attpc_engine_tpu.parallel import event_mesh, shard_events


def test_virtual_mesh_present():
    assert len(jax.devices()) == 8


def test_shard_events_layout():
    mesh = event_mesh()
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    xs = shard_events(mesh, x)
    assert xs.sharding.num_devices == 8
    np.testing.assert_array_equal(np.asarray(xs), x)


def test_dryrun_multichip():
    """The driver's multi-chip validation path: full kinematics+detector
    step jitted over an 8-device mesh."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


def test_run_simulation_multidevice_end_to_end(tmp_path):
    """The PRODUCTION driver sharded over 8 virtual devices writes the same
    HDF5 event content as the single-device run (same seed)."""
    import sys
    from pathlib import Path

    import h5py

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup
    from attpc_engine_tpu.detector import EngineParams, SpyralWriter
    from attpc_engine_tpu.detector.simulator import run_simulation
    from attpc_engine_tpu.kinematics import run_kinematics_pipeline

    pipeline, sim = _tiny_setup(events_per_batch=16)
    kine = tmp_path / "kine.h5"
    run_kinematics_pipeline(pipeline, 16, kine, seed=21, show_progress=False)

    def run(outdir, use_mesh):
        outdir.mkdir()
        engine = EngineParams(
            n_time_steps=500, chunk_steps=250, point_budget=512,
            out_budget=8192, events_per_batch=16,
        )
        run_simulation(
            sim.config, kine, SpyralWriter(outdir, sim.config),
            engine=engine, seed=21, show_progress=False, auto_tune=False,
            use_mesh=use_mesh,
        )
        out = {}
        with h5py.File(outdir / "run_0000.h5") as f:
            for k in f["cloud"]:
                out[k] = np.asarray(f["cloud"][k])
        return out

    single = run(tmp_path / "single", use_mesh=False)
    sharded = run(tmp_path / "sharded", use_mesh=True)
    assert len(jax.devices()) == 8  # conftest mesh really was available
    assert single.keys() == sharded.keys()
    for k in single:
        np.testing.assert_allclose(
            sharded[k], single[k], rtol=2e-5, atol=2e-3,
            err_msg=f"dataset {k}",
        )
        assert single[k].shape == sharded[k].shape


def test_sharded_matches_single_device():
    """Event-sharded execution produces identical physics to single-device
    (same keys, same events)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup

    pipeline, sim = _tiny_setup(events_per_batch=8, n_time_steps=500)
    vertices, momenta = pipeline.run_batch(8, key=jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(3)

    out_single = sim.simulate_batch(key, vertices, momenta)

    mesh = event_mesh()
    p3 = momenta[:, sim.sim_indices, :3]
    gvs = (p3 / sim.track_masses[None, :, None]).astype(np.float32)
    vg = np.concatenate(
        [vertices.astype(np.float32), gvs.reshape(8, -1)], axis=1
    )
    vg_sh = shard_events(mesh, vg)
    out_sharded = jax.jit(
        sim._simulate_impl,
        static_argnames=("n_events",),
        out_shardings=None,
    )(key, vg_sh, 8)

    # XLA does not guarantee bit-identical f32 across different compilations
    # (fusion/reduction order changes under sharding), so compare at physics
    # level: identical point counts, pad sets, and close charge totals.
    c_single = np.asarray(out_single["spyral_counts"])
    c_sharded = np.asarray(out_sharded["spyral_counts"])
    # a charge within f32 reduction noise of the ADC threshold can flip
    # in or out between the two compilations — allow a row or two per
    # event, never more
    assert (np.abs(c_single - c_sharded) <= 2).all(), (c_single, c_sharded)
    meta_s = np.asarray(out_single["packed"][:, 1])
    meta_h = np.asarray(out_sharded["packed"][:, 1])
    pads_s = (meta_s >> 8) & 0x3FFF
    pads_h = (meta_h >> 8) & 0x3FFF
    int_s = np.ascontiguousarray(out_single["packed"][:, 0]).view(np.float32)
    int_h = np.ascontiguousarray(out_sharded["packed"][:, 0]).view(np.float32)
    off_s = np.concatenate([[0], np.cumsum(c_single)])
    off_h = np.concatenate([[0], np.cumsum(c_sharded)])
    from collections import Counter

    for e in range(8):
        ps = Counter(pads_s[off_s[e]:off_s[e + 1]].tolist())
        ph = Counter(pads_h[off_h[e]:off_h[e + 1]].tolist())
        sym_diff = sum((ps - ph).values()) + sum((ph - ps).values())
        # pad multisets agree except for the threshold-edge rows (one
        # flipping out while another flips in leaves the count equal but
        # the symmetric difference at 2)
        assert sym_diff <= 2 * abs(int(c_single[e]) - int(c_sharded[e])) + 2, e
        np.testing.assert_allclose(
            int_s[off_s[e]:off_s[e + 1]].sum(),
            int_h[off_h[e]:off_h[e + 1]].sum(),
            rtol=1e-3,
        )  # same total integral


def test_pallas_kernels_inside_shard_map(interpret_kernels):
    """The shard_map path runs the transport kernel per shard (each shard
    is a single device; pallas_call itself cannot partition). Forced on
    here (interpreted on the CPU), the sharded program must match the
    same-flags unsharded program bit-for-bit."""
    import dataclasses
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup
    from attpc_engine_tpu.detector.simulator import DetectorSimulator

    e = 4
    pipeline, sim0 = _tiny_setup(events_per_batch=e, n_time_steps=250)
    vertices, momenta = pipeline.run_batch(e, key=jax.random.PRNGKey(5))

    engine = dataclasses.replace(
        sim0.engine,
        point_budget=128,
        uniq_budget=4096,
        out_budget=4096,
        n_time_steps=250,
        pallas_transport=True,
    )
    zp = pipeline.get_proton_numbers()
    ap = pipeline.get_mass_numbers()

    flat = DetectorSimulator(sim0.config, zp, ap, engine=engine)
    out_flat = flat.simulate_batch(
        jax.random.PRNGKey(7), vertices, momenta, assemble=False
    )

    mesh = event_mesh(jax.devices()[:2])
    sharded = DetectorSimulator(sim0.config, zp, ap, engine=engine,
                                mesh=mesh)
    # on CPU the "auto" gate stays off, but explicit True must reach the
    # kernel inside the shard
    assert sharded._use_transport_kernel() is True
    out_shard = sharded.simulate_batch(
        jax.random.PRNGKey(7), vertices, momenta, assemble=False
    )

    for name in ("pads", "tbs_i", "labels", "events", "cloud_valid",
                 "counts", "n_points", "spyral_counts", "packed"):
        np.testing.assert_array_equal(
            np.asarray(out_flat[name]), np.asarray(out_shard[name]),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(out_flat["charges"]), np.asarray(out_shard["charges"])
    )
    np.testing.assert_array_equal(
        np.asarray(out_flat["meta_i32"]), np.asarray(out_shard["meta_i32"])
    )
