"""BASELINE.json measurement ladder, configs 1-4.

Config 5 (the 1M production run) has its own runner, tools/run_1m_soak.sh.
Each config prints one line: events, wall seconds, events/s. Event counts
scale with LADDER_SCALE (default 1.0; use a small value for CPU smoke
tests). Writes everything under LADDER_OUTDIR (default /dev/shm).

LADDER_CONFIGS (default "1,2,4") selects which rungs run, so each rung
can be its own timeout-wrapped process.

Configs (BASELINE.json):
1. Single-step two-body kinematics only: 16O(d,p)17O at 10 MeV/u,
   10k events, fixed excitation, HDF5 output.
2. Multi-step kinematics chain: (d,p) populating an excited state +
   sequential decay, Gaussian Ex + angular-distribution sampling,
   100k events.
3. Kinematics + detector geometry: gas transport with dE/dx energy loss,
   electron drift/diffusion, pad-plane hit mapping, 100k events.
4. Full detector response (B-field spiral trajectories + GET response)
   with point-cloud output, 100k events — the flagship 12C(d,p) config.

The reference engine publishes no numbers for these; the recorded rates
in BASELINE.md are this engine's own ladder trail.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    scale = float(os.environ.get("LADDER_SCALE", "1.0"))
    configs = {
        c.strip()
        for c in os.environ.get("LADDER_CONFIGS", "1,2,4").split(",")
        if c.strip()
    }
    base = Path(os.environ.get("LADDER_OUTDIR", "/dev/shm")) / "ladder"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)

    from attpc_engine_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from attpc_engine_tpu import nuclear_map
    from attpc_engine_tpu.nuclear import GasTarget
    from attpc_engine_tpu.detector import (
        Config,
        DetectorParams,
        ElectronicsParams,
        EngineParams,
        PadParams,
        SpyralWriterProc,
        run_simulation,
    )
    from attpc_engine_tpu.kinematics import (
        Decay,
        ExcitationGaussian,
        KinematicsPipeline,
        PolarArbitrary,
        PolarUniform,
        Reaction,
        run_kinematics_pipeline,
    )

    results = {}

    def timed(tag, n_events, fn):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        rate = n_events / dt
        results[tag] = {"events": n_events, "wall_s": round(dt, 2),
                        "events_per_sec": round(rate, 1)}
        print(f"[ladder] {tag}: {n_events} events in {dt:.2f}s = "
              f"{rate:.0f} ev/s", file=sys.stderr)

    # ---- config 1: single-step two-body kinematics, fixed Ex ---------- #
    if "1" in configs:
        n1 = max(int(10_000 * scale), 64)
        pipe1 = KinematicsPipeline(
            [
                Reaction(
                    target=nuclear_map.get_data(1, 2),
                    projectile=nuclear_map.get_data(8, 16),
                    ejectile=nuclear_map.get_data(1, 1),
                )
            ],
            [ExcitationGaussian(0.0, 0.0)],
            [PolarUniform(0.0, np.pi)],
            160.0,  # 16O at 10 MeV/u, inverse kinematics on d
        )
        # warm the sampler program outside the timed region
        run_kinematics_pipeline(pipe1, min(n1, 4096), base / "warm1.h5",
                                batch_size=min(n1, 65536), seed=2,
                                show_progress=False)
        timed("config1_kinematics_2body", n1,
              lambda: run_kinematics_pipeline(
                  pipe1, n1, base / "c1.h5", batch_size=min(n1, 65536),
                  seed=1, show_progress=False))

    # ---- config 2: chain with excited state + sequential decay -------- #
    if "2" in configs:
        n2 = max(int(100_000 * scale), 64)
        # 12C(d,p)13C* (Ex ~ 3.09 MeV state) followed by 13C* -> 12C + n,
        # with a non-uniform (forward-peaked) angular distribution
        angles = np.linspace(0.0, np.pi, 181)[:-1]  # bin lower edges
        bin_w = float(np.pi / 180.0)
        probs = np.cos(angles / 2.0) ** 2
        probs /= probs.sum()
        pipe2 = KinematicsPipeline(
            [
                Reaction(
                    target=nuclear_map.get_data(1, 2),
                    projectile=nuclear_map.get_data(6, 12),
                    ejectile=nuclear_map.get_data(1, 1),
                ),
                Decay(
                    parent=nuclear_map.get_data(6, 13),
                    residual_1=nuclear_map.get_data(0, 1),
                ),
            ],
            [ExcitationGaussian(6.0, 0.5), ExcitationGaussian(0.0, 0.0)],
            [PolarArbitrary(angles, probs, bin_w), PolarUniform(0.0, np.pi)],
            120.0,
        )
        run_kinematics_pipeline(pipe2, min(n2, 4096), base / "warm2.h5",
                                batch_size=min(n2, 65536), seed=2,
                                show_progress=False)
        timed("config2_kinematics_chain", n2,
              lambda: run_kinematics_pipeline(
                  pipe2, n2, base / "c2.h5", batch_size=min(n2, 65536),
                  seed=1, show_progress=False))

    # ---- configs 3+4: kinematics + full detector + point clouds ------- #
    if "4" in configs or "3" in configs:
        gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
        config = Config(
            DetectorParams(1.0, 45000.0, 2.85, 175000, gas, 0.277, 0.2,
                           34.0),
            ElectronicsParams(6.25, 900, 1000, 10, 560, 40),
            PadParams(),
        )
        pipe4 = KinematicsPipeline(
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
        n4 = max(int(100_000 * scale), 64)
        eb = int(os.environ.get("LADDER_BATCH", "384"))
        eb = min(eb, max(n4 // 2, 16))
        engine = EngineParams(events_per_batch=eb)
        kine4 = base / "c4_kine.h5"
        clouds = base / "c4_clouds"
        clouds.mkdir()
        # recycled in-memory run files: seed the pool + return flow
        # (separate pruner process, bounded) so the mem path actually sees
        # warm spares
        from attpc_engine_tpu.io.recycle import seed_spares, spawn_pruner

        seed_spares(clouds, n=2)
        pruner = spawn_pruner(clouds, keep=2, max_spares=3)
        try:
            run_kinematics_pipeline(pipe4, n4, kine4,
                                    batch_size=min(n4, 65536),
                                    seed=1, show_progress=False)
            # warm the detector programs (budget probe + tuned shapes)
            warmw = SpyralWriterProc(base / "c4_warm", config)
            run_simulation(config, kine4, warmw, engine=engine, seed=1,
                           show_progress=False, stop_event=eb * 2)
            # config 3 is detector-geometry mapping; in this engine
            # transport, drift/diffusion, pad mapping and GET response are
            # ONE fused program, so configs 3 and 4 share the measurement
            # (there is no cheaper "no-response" mode to sell as config 3
            # — record it honestly)
            timed("config4_full_detector", n4, lambda: run_simulation(
                config, kine4, SpyralWriterProc(clouds, config),
                engine=engine, seed=1, show_progress=False))
            results["config3_detector_geometry"] = dict(
                results["config4_full_detector"],
                note="same fused program as config 4 (response "
                     "inseparable)",
            )
        finally:
            # the r4 all-in-one ladder leaked this on the config-4 hang
            pruner.terminate()

    print(json.dumps(results))


if __name__ == "__main__":
    main()
