"""On-card smoke test: the flagship two-stage simulation on one GPU.

    python chip_smoke.py          # one card, every phase below
    python chip_smoke.py --four   # the event-sharded path on four cards only

Phases of the default run (one process, one pinned card):

0. device report: platform, device kind and count; the card's name and
   power limit from ``nvidia-smi`` (run in a child that imports no JAX);
   the JAX version, ``XLA_FLAGS`` and the compile-cache directory.
1. GPU check: exits non-zero, printing no result, unless JAX's backend is
   the GPU. It never continues on the CPU.
2. the flagship (12C(d,p) at 120 MeV in 300 Torr D2, default AT-TPC
   detector, GET electronics) through ``KinematicsPipeline.run_batch`` ->
   ``run_simulation`` (auto-tune and overflow retry on, the default
   10,000-step physics window, 384 events per batch, 4 batches) ->
   in-process Spyral assembly, cold then warm, with every event's cloud
   validated against the Spyral contract. The kinematics and cloud HDF5
   files are not written (h5py is optional; the CPU tests cover them).
3. the Pallas transport kernel against ``integrate_tracks`` at 768 tracks
   for a 500-step and a 10,000-step window, and the whole detector step
   with each transport, timed as medians after warmup.
4. GPU against CPU for a few events: the kinematics sampler on the same
   key, and one 16-event detector batch.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
any failed phase raises and exits non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# per-phase tolerances, each with its reason (printed beside the results)
# kernel vs scan on one device: the CPU interpret-mode tolerances of
# tests/test_transport_pallas.py (f32 contraction and operation order)
KERNEL_POS_TOL_M = 1e-6
KERNEL_DKE_TOL_MEV = 1e-4
# kinematics is f64 on both backends; only transcendental rounding differs
KINEMATICS_RTOL = 1e-9
# GPU detector step (kernel) vs CPU detector step (scan): trajectories
# agree to ~1e-7 m, but a deposit that sits on a 1-mm pixel edge or a
# time-bucket edge, or an electron count at an integer truncation edge,
# can land one bin over, and an ADC-threshold-edge row can flip in or
# out. Such edge cases are a small fraction of each event's ~3k rows.
STEP_COUNT_RTOL = 0.02
STEP_CHARGE_RTOL = 0.02
STEP_MIN_OVERLAP = 0.95


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_report() -> str:
    """The card's name and power limit as nvidia-smi reports them, from a
    child process that never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.stdout.strip() or out.stderr.strip()


def _median_ms(fn, reps: int = 7) -> float:
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


# --------------------------------------------------------------------- #
# phase 2: the main path


class PoolWriter:
    """In-memory Spyral writer: takes the pooled batches ``run_simulation``
    hands to ``write_spyral_pool`` and keeps each event's cloud; the run's
    manifest (final budgets, phase times) goes to ``directory``."""

    def __init__(self, directory):
        self.directory = Path(directory)
        self.clouds: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def get_directory_name(self) -> Path:
        return self.directory

    def manifest(self) -> dict:
        paths = sorted(self.directory.glob("run_manifest_*.json"))
        return json.loads(paths[-1].read_text())

    def write_spyral_pool(
        self, spyral_pool, labels_pool, counts, event_numbers, raw_counts=None
    ) -> None:
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        for i, ev in enumerate(event_numbers):
            lo, hi = offsets[i], offsets[i + 1]
            if hi > lo:
                self.clouds[int(ev)] = (
                    np.array(spyral_pool[lo:hi]), np.array(labels_pool[lo:hi])
                )

    def close(self) -> None:
        pass


def validate_clouds(clouds: dict, adc_threshold: float) -> int:
    """Check every cloud against the Spyral contract; returns the row
    total. Raises AssertionError on the first violation."""
    assert clouds, "no event produced a cloud"
    rows = 0
    for ev, (cloud, labels) in clouds.items():
        assert cloud.ndim == 2 and cloud.shape[1] == 8, (ev, cloud.shape)
        assert cloud.dtype == np.float64, (ev, cloud.dtype)
        assert np.all(np.diff(cloud[:, 2]) >= 0), f"event {ev}: z not ascending"
        amp = cloud[:, 3]
        assert np.all((amp > adc_threshold) & (amp <= 4095.0)), ev
        assert np.all((cloud[:, 5] >= 0) & (cloud[:, 5] < 10240)), ev
        assert np.all((cloud[:, 6] >= 0) & (cloud[:, 6] < 512)), ev
        assert len(labels) == len(cloud), ev
        assert np.all(np.isfinite(cloud)), ev
        rows += len(cloud)
    return rows


def flagship(events_per_batch: int):
    """(pipeline, config) of the flagship configuration."""
    from __graft_entry__ import _tiny_setup

    pipeline, sim = _tiny_setup(events_per_batch=events_per_batch)
    return pipeline, sim.config


def phase_main_path(
    n_events: int = 1536, events_per_batch: int = 384, devices=None,
    seed: int = 11,
) -> dict:
    """The flagship through run_batch -> run_simulation -> in-process
    Spyral assembly, cold and warm, validated. Returns the run's facts."""
    import jax

    from attpc_engine_tpu.detector import EngineParams, run_simulation
    from attpc_engine_tpu.io import KinematicsArrays

    pipeline, config = flagship(events_per_batch)
    engine = EngineParams(events_per_batch=events_per_batch)
    devices = devices if devices is not None else jax.devices()[:1]
    facts = {}
    tmp = tempfile.TemporaryDirectory()
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        vertices, momenta = pipeline.run_batch(
            n_events, key=jax.random.PRNGKey(seed)
        )
        t1 = time.perf_counter()
        source = KinematicsArrays(
            vertices, momenta, pipeline.get_proton_numbers(),
            pipeline.get_mass_numbers(),
        )
        writer = PoolWriter(Path(tmp.name) / label)
        writer.directory.mkdir()
        run_simulation(
            config, source, writer, engine=engine, seed=seed,
            show_progress=False, devices=devices,
        )
        t2 = time.perf_counter()
        facts[f"{label}_kinematics_s"] = t1 - t0
        facts[f"{label}_detector_s"] = t2 - t1
    facts["events"] = n_events
    facts["events_with_clouds"] = len(writer.clouds)
    facts["rows"] = validate_clouds(
        writer.clouds, float(config.elec_params.adc_threshold)
    )
    facts["warm_events_per_s"] = n_events / (
        facts["warm_kinematics_s"] + facts["warm_detector_s"]
    )
    facts["compile_s_estimate"] = (
        facts["cold_kinematics_s"] + facts["cold_detector_s"]
        - facts["warm_kinematics_s"] - facts["warm_detector_s"]
    )
    budgets = writer.manifest()["budgets"]
    tmp.cleanup()
    facts["tuned_budgets"] = budgets
    stats = devices[0].memory_stats() or {}
    facts["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return facts


def step_budgets(tuned: dict) -> dict:
    """simulate_batch keyword budgets from a run manifest's budgets."""
    return dict(
        point_budget=tuned["point"], uniq_budget=tuned["uniq"],
        out_budget=tuned["out"], n_steps=tuned["steps"],
    )


def check_no_overflow(
    config, pipeline, n_events: int, budgets: dict, seed: int = 11,
) -> list:
    """One batch at the given budgets: every overflow counter must be 0.
    Returns [out, uniq, pool] overflow counts (all zero)."""
    import jax

    from attpc_engine_tpu.detector import EngineParams
    from attpc_engine_tpu.detector.simulator import DetectorSimulator

    vertices, momenta = pipeline.run_batch(n_events, key=jax.random.PRNGKey(seed))
    sim = DetectorSimulator(
        config, pipeline.get_proton_numbers(), pipeline.get_mass_numbers(),
        engine=EngineParams(events_per_batch=n_events),
    )
    out = sim.simulate_batch(
        jax.random.PRNGKey(seed), vertices, momenta, assemble=False, **budgets
    )
    meta = np.asarray(out["meta_i32"])
    overflows = [int(x) for x in meta[-5:-2]]
    assert overflows == [0, 0, 0], f"overflow counters {overflows}"
    return overflows


# --------------------------------------------------------------------- #
# phase 3: the transport kernel against its plain reference


def phase_transport_kernel(
    n_events: int = 384,
    windows=((500, 500), (10000, 500), (10000, 10000)),
    interpret: bool = False, time_it: bool = True,
) -> list[dict]:
    """Kernel vs ``integrate_tracks`` on the flagship's tracks for each
    (n_steps, chunk_steps) window — the engine's own chunking exits early
    once every track is dead; a single 10,000-step chunk times every step:
    alive identical, positions and energy deposits within the stated
    tolerances, both timed."""
    import jax
    import jax.numpy as jnp

    from attpc_engine_tpu.detector.transport import integrate_tracks
    from attpc_engine_tpu.detector.transport_pallas import (
        integrate_tracks_pallas,
        integrate_tracks_pallas_chunked,
    )
    from __graft_entry__ import _tiny_setup

    pipeline, sim = _tiny_setup(events_per_batch=n_events)
    cfg = sim.config
    vertices, momenta = pipeline.run_batch(n_events, key=jax.random.PRNGKey(0))
    p3 = momenta[:, sim.sim_indices, :3]
    gv0 = jnp.asarray(
        (p3 / sim.track_masses[None, :, None]).astype(np.float32)
    ).reshape(-1, 3)
    pos0 = jnp.repeat(
        jnp.asarray(vertices, dtype=jnp.float32), sim.k_tracks, axis=0
    )
    s_idx = jnp.tile(jnp.arange(sim.k_tracks, dtype=jnp.int32), n_events)
    kw = dict(
        density=float(cfg.det_params.gas_target.density),
        bfield=float(cfg.det_params.bfield),
        efield=float(cfg.det_params.efield),
    )
    results = []
    for n_steps, cs in windows:

        def scan():
            return integrate_tracks(
                pos0, gv0, s_idx, sim.species, n_steps=n_steps,
                chunk_steps=cs, **kw,
            )

        if n_steps == cs:
            def kernel():
                return integrate_tracks_pallas(
                    pos0, gv0, s_idx, sim.species, n_steps=n_steps,
                    interpret=interpret, **kw,
                )
        else:
            def kernel():
                return integrate_tracks_pallas_chunked(
                    pos0, gv0, s_idx, sim.species, n_steps=n_steps,
                    chunk_steps=cs, interpret=interpret, **kw,
                )

        p1, d1, a1 = (np.asarray(x) for x in scan())
        p2, d2, a2 = (np.asarray(x) for x in kernel())
        assert np.array_equal(a1, a2), f"alive differs at {n_steps} steps"
        live = a1
        dpos = float(np.abs(p1 - p2)[live].max()) if live.any() else 0.0
        ddke = float(np.abs(d1 - d2)[live].max()) if live.any() else 0.0
        assert dpos < KERNEL_POS_TOL_M, (n_steps, dpos)
        assert ddke < KERNEL_DKE_TOL_MEV, (n_steps, ddke)
        res = {
            "tracks": int(pos0.shape[0]),
            "n_steps": n_steps,
            "chunk_steps": cs,
            "steps_alive": int(live.any(axis=1).sum()),
            "max_dpos_m": dpos,
            "max_ddke_mev": ddke,
        }
        if time_it:
            res["scan_ms"] = _median_ms(scan)
            res["kernel_ms"] = _median_ms(kernel)
        results.append(res)
    return results


def phase_step_timing(config, pipeline, budgets: dict, n_events: int = 384):
    """The whole detector step (transport -> deposit/merge -> convert) with
    the scan and with the kernel, at the tuned flagship budgets."""
    import dataclasses

    import jax

    from attpc_engine_tpu.detector import EngineParams
    from attpc_engine_tpu.detector.simulator import DetectorSimulator

    vertices, momenta = pipeline.run_batch(n_events, key=jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    base = EngineParams(events_per_batch=n_events)
    out = {}
    counts = {}
    for flag in (False, True):
        sim = DetectorSimulator(
            config, pipeline.get_proton_numbers(), pipeline.get_mass_numbers(),
            engine=dataclasses.replace(base, pallas_transport=flag),
        )

        def step():
            return sim.simulate_batch(
                key, vertices, momenta, assemble=False, **budgets
            )

        name = "kernel" if flag else "scan"
        out[f"step_{name}_ms"] = _median_ms(step)
        counts[name] = np.asarray(step()["spyral_counts"])
    # same physics either way (threshold-edge rows may flip)
    dc = np.abs(counts["scan"].astype(np.int64) - counts["kernel"])
    assert (dc <= np.maximum(2, STEP_COUNT_RTOL * counts["scan"])).all(), dc.max()
    return out


# --------------------------------------------------------------------- #
# phase 4: GPU against the CPU reference


def _event_rows(out, e: int):
    """Per-event (count, total charge, set of (pad, tb)) from a batch."""
    from attpc_engine_tpu.detector.simulator import split_packed

    counts = np.asarray(out["spyral_counts"])
    packed = np.asarray(out["packed"])[: int(counts.sum())]
    q, tb, pad, _ = split_packed(packed)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    rows = []
    for i in range(e):
        lo, hi = offsets[i], offsets[i + 1]
        rows.append(
            (int(counts[i]), float(q[lo:hi].astype(np.float64).sum()),
             set(zip(pad[lo:hi].tolist(), tb[lo:hi].tolist())))
        )
    return rows


def phase_cpu_reference(n_kine: int = 64, n_det: int = 16, n_steps: int = 500):
    """Kinematics on the accelerator vs the CPU for the same key, then one
    detector batch: accelerator (the engine's default transport) vs the
    CPU with the scan."""
    import jax

    from attpc_engine_tpu.detector import EngineParams
    from attpc_engine_tpu.detector.simulator import DetectorSimulator

    pipeline, config = flagship(n_det)
    cpu = jax.devices("cpu")[0]
    key = np.asarray(jax.random.PRNGKey(5))
    v_acc, m_acc = pipeline.run_batch(n_kine, key=jax.numpy.asarray(key))
    with jax.default_device(cpu):
        v_cpu, m_cpu = pipeline.run_batch(n_kine, key=jax.numpy.asarray(key))
    for a, b in ((v_acc, v_cpu), (m_acc, m_cpu)):
        scale = np.maximum(np.abs(b), 1.0)
        rel = float((np.abs(a - b) / scale).max())
        assert rel < KINEMATICS_RTOL, rel
    kine_rel = float(
        max(
            (np.abs(v_acc - v_cpu) / np.maximum(np.abs(v_cpu), 1.0)).max(),
            (np.abs(m_acc - m_cpu) / np.maximum(np.abs(m_cpu), 1.0)).max(),
        )
    )

    budgets = dict(point_budget=1024, uniq_budget=12288, out_budget=8192,
                   n_steps=n_steps)
    engine = EngineParams(
        n_time_steps=n_steps, chunk_steps=n_steps, events_per_batch=n_det
    )
    vertices, momenta = v_acc[:n_det], m_acc[:n_det]
    zp, ap = pipeline.get_proton_numbers(), pipeline.get_mass_numbers()
    acc = DetectorSimulator(config, zp, ap, engine=engine)
    out_acc = acc.simulate_batch(
        jax.random.PRNGKey(6), vertices, momenta, assemble=False, **budgets
    )
    rows_acc = _event_rows(out_acc, n_det)
    engine_cpu = EngineParams(
        n_time_steps=n_steps, chunk_steps=n_steps, events_per_batch=n_det,
        pallas_transport=False,
    )
    with jax.default_device(cpu):
        ref = DetectorSimulator(config, zp, ap, engine=engine_cpu)
        out_cpu = ref.simulate_batch(
            jax.random.PRNGKey(6), vertices, momenta, assemble=False,
            **budgets,
        )
        rows_cpu = _event_rows(out_cpu, n_det)
    worst = {"count_rel": 0.0, "charge_rel": 0.0, "min_overlap": 1.0}
    for (ca, qa, sa), (cc, qc, sc) in zip(rows_acc, rows_cpu):
        if cc == 0 and ca == 0:
            continue
        worst["count_rel"] = max(worst["count_rel"], abs(ca - cc) / max(cc, 1))
        worst["charge_rel"] = max(
            worst["charge_rel"], abs(qa - qc) / max(abs(qc), 1e-30)
        )
        worst["min_overlap"] = min(
            worst["min_overlap"], len(sa & sc) / max(len(sa | sc), 1)
        )
    assert worst["count_rel"] <= STEP_COUNT_RTOL, worst
    assert worst["charge_rel"] <= STEP_CHARGE_RTOL, worst
    assert worst["min_overlap"] >= STEP_MIN_OVERLAP, worst
    return {"kinematics_max_rel": kine_rel, "events": n_det, **worst}


# --------------------------------------------------------------------- #
# --four: the event-sharded path against one card


def phase_sharded(
    devices, n_events: int = 3072, events_per_batch: int = 1536,
    seed: int = 13,
) -> dict:
    """run_simulation over ``devices`` (one shard_map program per batch)
    against the same run on the first device alone: per-event row counts
    within 2, the same pads, the same total integral (rtol 1e-3) — the
    tolerances of tests/test_parallel.py::test_sharded_matches_single_device
    (the XLA-partitioned Spyral conversion reassociates f32 sums, so a
    threshold-edge row can flip)."""
    from collections import Counter

    import jax

    from attpc_engine_tpu.detector import EngineParams, run_simulation
    from attpc_engine_tpu.io import KinematicsArrays

    pipeline, config = flagship(events_per_batch)
    vertices, momenta = pipeline.run_batch(n_events, key=jax.random.PRNGKey(seed))
    engine = EngineParams(
        events_per_batch=events_per_batch, point_budget=768,
        uniq_budget=12288, out_budget=4096,
    )
    runs = {}
    times = {}
    tmp = tempfile.TemporaryDirectory()
    for label, devs in (("sharded", devices), ("single", devices[:1])):
        source = KinematicsArrays(
            vertices, momenta, pipeline.get_proton_numbers(),
            pipeline.get_mass_numbers(),
        )
        writer = PoolWriter(tmp.name)
        t0 = time.perf_counter()
        run_simulation(
            config, source, writer, engine=engine, seed=seed,
            show_progress=False, auto_tune=False, devices=list(devs),
        )
        times[label] = time.perf_counter() - t0
        validate_clouds(writer.clouds, float(config.elec_params.adc_threshold))
        runs[label] = writer.clouds
    tmp.cleanup()
    single, sharded = runs["single"], runs["sharded"]
    assert single.keys() == sharded.keys(), "different events have clouds"
    worst_dc = 0
    for ev in single:
        cs, ls = single[ev]
        ch, lh = sharded[ev]
        dc = abs(len(cs) - len(ch))
        assert dc <= 2, (ev, len(cs), len(ch))
        ps, ph = Counter(cs[:, 5].tolist()), Counter(ch[:, 5].tolist())
        sym = sum((ps - ph).values()) + sum((ph - ps).values())
        assert sym <= 2 * dc + 2, (ev, sym)
        np.testing.assert_allclose(ch[:, 4].sum(), cs[:, 4].sum(), rtol=1e-3)
        worst_dc = max(worst_dc, dc)
    return {
        "events": n_events,
        "events_per_batch": events_per_batch,
        "devices": len(devices),
        "events_with_clouds": len(single),
        "max_row_count_diff": worst_dc,
        "sharded_s": times["sharded"],
        "single_s": times["single"],
    }


# --------------------------------------------------------------------- #


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the event-sharded path on four cards",
    )
    args = parser.parse_args(argv)

    import jax

    from attpc_engine_tpu.utils.compile_cache import configure_compile_cache

    cache_dir = configure_compile_cache()

    # phase 0: device report
    devices = jax.devices()
    _log(
        f"[phase 0] backend={jax.default_backend()} "
        f"platform={devices[0].platform} kind={devices[0].device_kind!r} "
        f"count={len(devices)}"
    )
    _log("[phase 0] card name, power limit (nvidia-smi):")
    _log(_card_report())
    _log(
        f"[phase 0] jax {jax.__version__}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
        f"compile cache {cache_dir}"
    )

    # phase 1: a GPU, or nothing
    if jax.default_backend() != "gpu":
        print(
            f"[phase 1] FAIL: JAX found no GPU (backend "
            f"{jax.default_backend()!r}); this smoke test never runs on the "
            "CPU",
            file=sys.stderr,
        )
        return 2
    _log("[phase 1] GPU backend: ok")

    if args.four:
        if len(devices) < 4:
            print(f"[four] FAIL: {len(devices)} device(s), need 4",
                  file=sys.stderr)
            return 2
        devices = devices[:4]
        res = phase_sharded(devices)
        _log(f"[four] sharded vs one card: {json.dumps(res)}")
    else:
        devices = devices[:1]
        try:
            import h5py  # noqa: F401

            why = "h5py is installed; the HDF5 layer is covered by the CPU tests"
        except ImportError:
            why = "h5py is not installed on this host"
        _log(
            "[phase 2] HDF5 layer not run "
            f"({why}): kinematics go through KinematicsArrays and clouds "
            "through an in-memory writer"
        )
        facts = phase_main_path(devices=devices)
        _log(f"[phase 2] flagship main path: {json.dumps(facts)}")
        pipeline, config = flagship(384)
        budgets = step_budgets(facts["tuned_budgets"])
        overflows = check_no_overflow(config, pipeline, 384, budgets)
        _log(f"[phase 2] overflow counters at {budgets}: {overflows}")

        for res in phase_transport_kernel():
            _log(f"[phase 3] transport kernel vs scan: {json.dumps(res)}")
        _log(
            "[phase 3] detector step at the tuned flagship budgets: "
            f"{json.dumps(phase_step_timing(config, pipeline, budgets))}"
        )

        res = phase_cpu_reference()
        _log(
            "[phase 4] GPU vs CPU reference (tolerances: kinematics rel "
            f"{KINEMATICS_RTOL}; per event rows rel {STEP_COUNT_RTOL}, charge "
            f"rel {STEP_CHARGE_RTOL}, (pad, tb) overlap >= "
            f"{STEP_MIN_OVERLAP}): {json.dumps(res)}"
        )

    _log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
