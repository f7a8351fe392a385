"""Stage-ablation timing of the fused detector step on the real device.

Runs the full fused program and variants with one stage neutered, and
reports the timing deltas — intra-program attribution without a profiler
(tools/trace_step.py attributes from a device trace instead). Env: ABL_EVENTS, ABL_STEPS, ABL_POINT, ABL_UNIQ, ABL_OUT.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from attpc_engine_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from __graft_entry__ import _tiny_setup
from attpc_engine_tpu.detector.transport import integrate_tracks
from attpc_engine_tpu.detector.deposition import (
    KEY_SENTINEL,
    MESH_STEPS,
    NUM_TB,
    _key_lookup,
    _run_last,
)


def main():
    e = int(os.environ.get("ABL_EVENTS", 384))
    steps = int(os.environ.get("ABL_STEPS", 500))
    pb = int(os.environ.get("ABL_POINT", 576))
    u_cap = int(os.environ.get("ABL_UNIQ", 12288))

    pipeline, sim = _tiny_setup(events_per_batch=e, n_time_steps=steps)
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
    k = sim.k_tracks
    p = e * pb
    f32 = jnp.float32
    grid_flat = jnp.asarray(dev["key_grid_mm"]).reshape(-1)
    glo, gn = dev["grid_lo_mm"], dev["grid_n_mm"]
    dp = cfg.det_params

    def staged(mode):
        """mode: full | nointeg | nogather | nosort1 | nosort2 | nocumsum"""

        def fn(key, pos0, gvs):
            if mode == "nointeg":
                t = steps
                positions = jnp.broadcast_to(pos0[None], (t, e * k, 3))
                dke = jnp.full((t, e * k), 1e-3, f32)
                alive = jnp.ones((t, e * k), bool)
            else:
                positions, dke, alive = integrate_tracks(
                    pos0, gvs, s_idx, sim.species,
                    density=dp.gas_target.density, bfield=dp.bfield,
                    efield=dp.efield, n_steps=steps, chunk_steps=500,
                )
            electrons = (dke * (1e6 / dp.w_value)).astype(jnp.int32)
            valid = alive & (electrons >= 1)
            tb_f = (dp.length - positions[:, :, 2]) / cfg.drift_velocity + 10.0
            tb_i = tb_f.astype(jnp.int32)
            valid = valid & (tb_f > -1.0) & (tb_i < NUM_TB)
            kt = k * steps

            def ev_flat(a):
                return a.transpose(1, 0).reshape(e * kt)

            valid_r = ev_flat(valid).reshape(e, kt)
            slot = jnp.cumsum(valid_r.astype(jnp.int32), axis=1) - 1
            row = jnp.arange(e, dtype=jnp.int32)[:, None]
            dest = jnp.where(valid_r & (slot < pb), row * pb + slot, p)
            src = (
                jnp.full(p, -1, jnp.int32)
                .at[dest.reshape(-1)]
                .set(jnp.arange(e * kt, dtype=jnp.int32), mode="drop")
            )
            taken = src >= 0
            gsrc = jnp.maximum(src, 0)
            px = ev_flat(positions[:, :, 0])[gsrc]
            py = ev_flat(positions[:, :, 1])[gsrc]
            ptbf = ev_flat(tb_f)[gsrc]
            ptbi = ev_flat(tb_i)[gsrc]
            pne = ev_flat(electrons)[gsrc].astype(f32)
            prank = (gsrc // steps) % k

            sigma = jnp.sqrt(
                2.0 * dp.diffusion * cfg.drift_velocity * ptbf / dp.efield
            ).astype(f32)
            sigma = jnp.where(sigma > 0, sigma, 1.0)
            mesh_1d = jnp.linspace(-3.0, 3.0, MESH_STEPS, dtype=f32)
            pix_x = px[:, None, None] + sigma[:, None, None] * mesh_1d[:, None]
            pix_y = py[:, None, None] + sigma[:, None, None] * mesh_1d[None, :]
            stepw = 6.0 / (MESH_STEPS - 1)
            pdf = (stepw * stepw / (2 * jnp.pi)) * jnp.exp(
                -0.5 * (mesh_1d[:, None] ** 2 + mesh_1d[None, :] ** 2)
            )
            q_pix = pne[:, None, None] * pdf
            if mode == "nogather":
                ix = jnp.floor(pix_x * 1000.0 - glo).astype(jnp.int32)
                iy = jnp.floor(pix_y * 1000.0 - glo).astype(jnp.int32)
                pkey = jnp.where(
                    (ix >= 0) & (ix < gn) & (iy >= 0) & (iy < gn),
                    (ix * 17 + iy) % (10240 * NUM_TB),
                    KEY_SENTINEL,
                )
            else:
                pkey = _key_lookup(grid_flat, glo, gn, pix_x, pix_y)
            pv = (pkey != KEY_SENTINEL) & taken[:, None, None]
            packed = jnp.where(
                pv, ((pkey + ptbi[:, None, None]) << 1) | prank[:, None, None],
                KEY_SENTINEL,
            )
            w = pb * 100
            packed = packed.reshape(e, w)
            lq = jnp.where(pv, q_pix, 0.0).reshape(e, w)

            if mode != "nosort1":
                packed, lq = jax.lax.sort((packed, lq), dimension=1, num_keys=1)
            last = _run_last(packed >> 1)
            rl = last & (packed != KEY_SENTINEL)
            if mode == "nocumsum":
                c = lq
            else:
                c = jnp.cumsum(lq, axis=1, dtype=f32)
            key2 = jnp.where(rl, packed, KEY_SENTINEL)
            c2op = jnp.where(rl, c, 0.0)
            if mode != "nosort2":
                key2, c2 = jax.lax.sort((key2, c2op), dimension=1, num_keys=1)
            else:
                c2 = c2op
            key2 = key2[:, :u_cap]
            c2 = c2[:, :u_cap]
            v2 = key2 != KEY_SENTINEL
            prev = jnp.concatenate([jnp.zeros((e, 1), f32), c2[:, :-1]], axis=1)
            sums = jnp.where(v2, jnp.maximum(c2 - prev, 0), 0)
            return key2.sum(), sums.sum(), rl.sum()

        return jax.jit(fn)

    def timeit(label, fn, n=4):
        r = fn(key, pos0, gvs)
        np.asarray(r[0])
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn(key, pos0, gvs)
            np.asarray(r[0])
        dt = (time.perf_counter() - t0) / n
        print(f"{label}: {dt * 1000:.1f} ms", flush=True)
        return dt

    base = timeit("full", staged("full"))
    for mode in ("nointeg", "nogather", "nosort1", "nosort2", "nocumsum"):
        t = timeit(mode, staged(mode))
        print(f"  -> {mode} saves {1000 * (base - t):.1f} ms", flush=True)


if __name__ == "__main__":
    main()
