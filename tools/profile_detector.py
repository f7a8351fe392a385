"""Phase-level timing of the detector stage on the local device.

Times integrate_tracks, generate_electrons+deposit_and_merge, and the
Spyral conversion separately to locate the bottleneck. Env knobs:
PROF_EVENTS (default 64), PROF_STEPS (default 10000), PROF_POINT_BUDGET,
PROF_UNIQ_BUDGET, PROF_OUT_BUDGET.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from attpc_engine_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
import jax.numpy as jnp

from __graft_entry__ import _tiny_setup
from attpc_engine_tpu.detector.transport import integrate_tracks
from attpc_engine_tpu.detector.deposition import (
    deposit_and_merge,
    event_keys,
    generate_electrons,
)


def _force(x):
    """Force full execution: pull one element of every output leaf to the
    host."""
    import jax
    for leaf in jax.tree.leaves(x):
        np.asarray(leaf.ravel()[0])
    return x


def timeit(label, fn, n=3):
    _force(fn())  # compile
    t0 = time.perf_counter()
    for _ in range(n):
        _force(fn())
    dt = (time.perf_counter() - t0) / n
    print(f"{label}: {dt * 1000:.1f} ms", flush=True)
    return dt


def main():
    e = int(os.environ.get("PROF_EVENTS", 64))
    steps = int(os.environ.get("PROF_STEPS", 10000))
    point_budget = int(os.environ.get("PROF_POINT_BUDGET", 1024))
    uniq_budget = int(os.environ.get("PROF_UNIQ_BUDGET", 12288))
    out_budget = int(os.environ.get("PROF_OUT_BUDGET", 8192))

    pipeline, sim = _tiny_setup(events_per_batch=e, n_time_steps=steps)
    sim.engine.point_budget = point_budget
    sim.engine.uniq_budget = uniq_budget
    sim.engine.out_budget = out_budget
    sim.engine.n_time_steps = steps
    cfg = sim.config
    dev = cfg.device_arrays()

    vertices, momenta = pipeline.run_batch(e, key=jax.random.PRNGKey(0))
    p3 = momenta[:, sim.sim_indices, :3]
    gvs = jnp.asarray(
        (p3 / sim.track_masses[None, :, None]).astype(np.float32)
    ).reshape(-1, 3)
    pos0 = jnp.repeat(jnp.asarray(vertices, dtype=jnp.float32), sim.k_tracks, axis=0)
    s_idx = jnp.tile(jnp.arange(sim.k_tracks, dtype=jnp.int32), e)
    key = jax.random.PRNGKey(1)

    b = pos0.shape[0]
    print(f"events={e} tracks={b} steps={steps} point_budget={point_budget}")

    integ = lambda: (
        integrate_tracks(
            pos0, gvs, s_idx, sim.species,
            density=cfg.det_params.gas_target.density,
            bfield=cfg.det_params.bfield,
            efield=cfg.det_params.efield,
            n_steps=steps, chunk_steps=500,
        )
    )
    t_int = timeit("integrate", integ)

    positions, dke, alive = integrate_tracks(
        pos0, gvs, s_idx, sim.species,
        density=cfg.det_params.gas_target.density,
        bfield=cfg.det_params.bfield,
        efield=cfg.det_params.efield,
        n_steps=steps, chunk_steps=500,
    )
    alive_count = int(np.asarray(alive.sum()))
    print(f"  alive deposit points: {alive_count} "
          f"({alive_count / b:.0f}/track avg)")

    ev_keys = event_keys(key, e)
    electrons = generate_electrons(
        ev_keys, dke, cfg.det_params.w_value, cfg.det_params.fano_factor,
        chunk_steps=500,
    )
    labels = jnp.tile(jnp.asarray(sim.sim_indices, dtype=jnp.int32), e)

    dep = lambda: (
        deposit_and_merge(
            ev_keys, positions, electrons, alive, labels,
            dev["key_grid_mm"], grid_lo_mm=dev["grid_lo_mm"], grid_n_mm=dev["grid_n_mm"],
            diffusion=cfg.det_params.diffusion,
            efield=cfg.det_params.efield,
            drift_velocity=cfg.drift_velocity,
            micromegas_edge=float(cfg.elec_params.micromegas_edge),
            length=cfg.det_params.length,
            mpgd_gain=float(cfg.det_params.mpgd_gain),
            n_events=e, tracks_per_event=sim.k_tracks,
            point_budget=point_budget, uniq_budget=uniq_budget,
        )
    )
    t_dep = timeit("deposit+merge", dep)

    cloud = deposit_and_merge(
        ev_keys, positions, electrons, alive, labels,
        dev["key_grid_mm"], grid_lo_mm=dev["grid_lo_mm"], grid_n_mm=dev["grid_n_mm"],
        diffusion=cfg.det_params.diffusion,
        efield=cfg.det_params.efield,
        drift_velocity=cfg.drift_velocity,
        micromegas_edge=float(cfg.elec_params.micromegas_edge),
        length=cfg.det_params.length,
        mpgd_gain=float(cfg.det_params.mpgd_gain),
        n_events=e, tracks_per_event=sim.k_tracks,
        point_budget=point_budget, uniq_budget=uniq_budget,
    )
    print(f"  n_points avg: {np.asarray(cloud['n_points']).mean():.0f}, "
          f"pool_overflow: {np.asarray(cloud['pool_overflow'])}, "
          f"cloud pts avg: {np.asarray(cloud['counts']).mean():.0f}, "
          f"uniq overflow: {np.asarray(cloud['uniq_overflow'])}, "
          f"uniq max: {np.asarray(cloud['uniq_max'])}")

    window = cloud["pads"].shape[0] // e
    conv_jit = jax.jit(
        sim._convert_to_spyral, static_argnames=("out_budget", "e", "window")
    )
    conv = lambda: conv_jit(cloud, out_budget, e, window)
    t_conv = timeit("convert", conv)

    vg = jnp.concatenate(
        [jnp.asarray(vertices, dtype=jnp.float32), gvs.reshape(e, -1)],
        axis=1,
    )
    full = lambda: (
        sim._sim_jit(
            key, vg, e,
            point_budget=point_budget, uniq_budget=uniq_budget,
            out_budget=out_budget, n_steps=steps,
        )["packed"]
    )
    t_full = timeit("full fused step", full)

    per_ev = t_full / e
    print(f"per-event: {per_ev * 1000:.2f} ms -> {1 / per_ev:.0f} events/s")


if __name__ == "__main__":
    main()
