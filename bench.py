"""End-to-end benchmark: full pipeline events/sec.

Runs the complete two-stage simulation — batched kinematics sampling ->
kinematics HDF5 -> detector transport/deposition -> Spyral cloud HDF5 — for
the flagship configuration (12C(d,p) inverse kinematics at 120 MeV, default
AT-TPC detector), and prints ONE JSON line:

    {"metric": "full_pipeline_events_per_sec", "value": N,
     "unit": "events/s", "device": {"platform": ..., "kind": ..., "count": ...}}

The benchmark measures the GPU: it exits non-zero when JAX finds none.
``BENCH_PLATFORM=cpu`` runs the same code path on the CPU backend, for the
CPU smoke test only; its number is a CPU number and says so in ``device``.

Env knobs: BENCH_EVENTS (default 20000), BENCH_BATCH (detector events per
XLA execution, default 384), BENCH_OUTDIR (default: a temp dir under
/dev/shm when available, else the system temp dir, so that the disk does
not bound the engine measurement; the full HDF5 output is produced either
way). BENCH_PALLAS_TRANSPORT=0 runs the transport as the ``lax.scan``
integrator instead of the Pallas kernel, for A/B attribution.

BENCH_RECYCLE=1 (default 0): rotate run files through a recycle pool
(<clouds>/.recycle) so the writer child overwrites pages it already owns
instead of faulting in fresh ones; only the newest 2 run files are
retained.

The compilation cache follows ``utils.compile_cache``:
``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main() -> int:
    n_events = int(os.environ.get("BENCH_EVENTS", 20_000))
    det_batch = int(os.environ.get("BENCH_BATCH", 384))
    outdir = os.environ.get("BENCH_OUTDIR")

    import jax

    platform = os.environ.get("BENCH_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    if jax.default_backend() != "gpu" and platform != "cpu":
        print(
            f"[bench] no GPU found (JAX backend {jax.default_backend()!r}); "
            "set BENCH_PLATFORM=cpu to run the CPU smoke path",
            file=sys.stderr,
        )
        return 1

    from attpc_engine_tpu.utils.compile_cache import configure_compile_cache

    cache_dir = configure_compile_cache()

    from attpc_engine_tpu import nuclear_map
    from attpc_engine_tpu.nuclear import GasTarget
    from attpc_engine_tpu.detector import (
        Config,
        DetectorParams,
        ElectronicsParams,
        PadParams,
        EngineParams,
        SpyralWriterProc,
        run_simulation,
    )
    from attpc_engine_tpu.kinematics import (
        KinematicsPipeline,
        ExcitationGaussian,
        PolarUniform,
        Reaction,
        run_kinematics_pipeline,
    )

    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    config = Config(
        DetectorParams(
            length=1.0,
            efield=45000.0,
            bfield=2.85,
            mpgd_gain=175000,
            gas_target=gas,
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
    # default engine params; run_simulation auto-tunes the pool budgets to
    # the observed multiplicities after the first batch
    engine = EngineParams(events_per_batch=det_batch)
    if os.environ.get("BENCH_PALLAS_TRANSPORT") == "0":
        engine.pallas_transport = False

    tmp_ctx = None
    if outdir is None:
        shm = Path("/dev/shm")
        base = str(shm) if shm.is_dir() and os.access(shm, os.W_OK) else None
        tmp_ctx = tempfile.TemporaryDirectory(dir=base)
        outdir = tmp_ctx.name
        print(f"[bench] output dir: {outdir}", file=sys.stderr)
    outdir = Path(outdir)
    kine_path = outdir / "bench_kinematics.h5"
    cloud_dir = outdir / "clouds"
    cloud_dir.mkdir(parents=True, exist_ok=True)

    # recycled in-memory run files: seed a spare pool during the untimed
    # warmup and keep returning completed run files to it (a separate
    # pruner PROCESS with a bounded pool, so a plain-path fallback that
    # never consumes spares cannot fill the disk)
    pruner = None
    if os.environ.get("BENCH_RECYCLE", "0") != "0":
        from attpc_engine_tpu.io.recycle import seed_spares, spawn_pruner

        seed_spares(cloud_dir, n=2)
        pruner = spawn_pruner(cloud_dir, keep=2, max_spares=3)

    # ---- warmup / compile (excluded from the timed run) ---------------- #
    # Exactly the timed run's program shapes, each compiled ONCE: the
    # kinematics warm file is sampled at the timed batch shape (a smaller
    # warm batch would compile a second, never-again-used sampler), and
    # the detector warms over its first two batches only (batch 1 probes
    # and compiles the default-budget program, batch 2 compiles the tuned
    # shapes). Warmup shares the timed run's seed so the auto-tuned pool
    # shapes are identical and every compilation happens here, not in the
    # timed region.
    t0 = time.perf_counter()
    cache_before = (
        {p.name for p in cache_dir.iterdir()} if cache_dir.is_dir() else set()
    )
    kine_batch = min(65536, n_events)
    warm_path = outdir / "warm.h5"
    run_kinematics_pipeline(
        pipeline, kine_batch, warm_path, batch_size=kine_batch, seed=1,
        show_progress=False,
    )
    writer = SpyralWriterProc(cloud_dir, config)
    run_simulation(config, warm_path, writer, engine=engine, seed=1,
                   show_progress=False, stop_event=det_batch * 2)
    compile_s = time.perf_counter() - t0
    # persistent-cache hit log: every program slow enough to persist that
    # had to be XLA-compiled this run leaves a new cache file; 0 new
    # entries = the whole warmup was served from the cache.
    new_entries = (
        sorted({p.name for p in cache_dir.iterdir()} - cache_before)
        if cache_dir.is_dir()
        else []
    )
    print(
        f"[bench] warmup/compile: {compile_s:.1f}s "
        f"(persistent-cache misses: {len(new_entries)} new entries)",
        file=sys.stderr,
    )

    # ---- timed end-to-end run ------------------------------------------ #
    t1 = time.perf_counter()
    # spawn the writer child first: its interpreter/numpy boot overlaps
    # the kinematics stage's device work instead of serializing before
    # the first detector batch
    writer = SpyralWriterProc(cloud_dir, config, first_run_number=100)
    run_kinematics_pipeline(
        pipeline, n_events, kine_path, batch_size=kine_batch, seed=1,
        show_progress=False,
    )
    t2 = time.perf_counter()
    run_simulation(config, kine_path, writer, engine=engine, seed=1,
                   show_progress=False)
    t3 = time.perf_counter()

    kine_s = t2 - t1
    det_s = t3 - t2
    total_s = t3 - t1
    eps = n_events / total_s
    print(
        f"[bench] {n_events} events: kinematics {kine_s:.2f}s "
        f"({n_events / kine_s:.0f} ev/s), detector+write {det_s:.2f}s "
        f"({n_events / det_s:.0f} ev/s), total {total_s:.2f}s",
        file=sys.stderr,
    )
    if pruner is not None:
        pruner.terminate()
    devices = jax.devices()
    print(
        json.dumps(
            {
                "metric": "full_pipeline_events_per_sec",
                "value": eps,
                "unit": "events/s",
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        )
    )
    if tmp_ctx is not None:
        tmp_ctx.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
