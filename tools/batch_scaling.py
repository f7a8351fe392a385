"""Fused-detector-step throughput vs events_per_batch on current defaults.

The RK4 transport is latency-bound (a step costs nearly the same at any
batch width) and each batch pays fixed dispatch and pull round trips, so
a wider batch should amortize both — but every per-lane stage (sorts,
lookup, output) scales linearly. This tool times the DEFAULT fused step
at a ladder of batch sizes with the per-event budgets held fixed,
printing one JSON line per size.

Reference context: the reference simulates one event at a time
(/root/reference/src/attpc_engine/detector/simulator.py run loop); batch
width is a degree of freedom of this engine with no upstream analogue.

Run it alone on the device. Env: BS_SIZES
(comma list, default "384,768,1536"), BS_REPS (4), BS_POINT (576),
BS_UNIQ (12288), BS_STEPS (500), BS_OUT (4096).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _tiny_setup  # noqa: E402


def main():
    sizes = [
        int(s) for s in os.environ.get("BS_SIZES", "384,768,1536").split(",")
    ]
    reps = int(os.environ.get("BS_REPS", 4))
    point = int(os.environ.get("BS_POINT", 576))
    uniq = int(os.environ.get("BS_UNIQ", 12288))
    steps = int(os.environ.get("BS_STEPS", 500))
    out_b = int(os.environ.get("BS_OUT", 4096))

    results = {}
    for e in sizes:
        try:
            pipeline, sim = _tiny_setup(events_per_batch=e, n_time_steps=steps)
            vertices, momenta = pipeline.run_batch(e, key=jax.random.PRNGKey(0))
            p3 = momenta[:, sim.sim_indices, :3]
            gvs = (p3 / sim.track_masses[None, :, None]).astype(np.float32)
            vg = np.concatenate(
                [np.asarray(vertices, dtype=np.float32), gvs.reshape(e, -1)],
                axis=1,
            )
            key = np.asarray(jax.random.PRNGKey(1))
            vg_d = jnp.asarray(vg)
            t0 = time.perf_counter()
            out = sim._sim_jit(
                key, vg_d, e, point_budget=point, uniq_budget=uniq,
                out_budget=out_b, n_steps=steps,
            )
            float(np.asarray(out["meta_i32"][0]))
            compile_s = time.perf_counter() - t0
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = sim._sim_jit(
                    key, vg_d, e, point_budget=point, uniq_budget=uniq,
                    out_budget=out_b, n_steps=steps,
                )
                float(np.asarray(out["meta_i32"][0]))
                ts.append(time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — record and move on
            print(json.dumps({
                "batch": e, "failed": f"{type(exc).__name__}: {exc}"[:400],
            }), flush=True)
            continue
        med = float(np.median(ts)) * 1000
        results[e] = med
        print(json.dumps({
            "batch": e, "median_ms": round(med, 1),
            "ev_per_s": round(e / (med / 1000), 1),
            "ms_per_event": round(med / e, 3),
            "compile_first_s": round(compile_s, 1), "reps": reps,
        }), flush=True)

    if results:
        best = max(results, key=lambda e: e / results[e])
        print(json.dumps({
            "best_batch": best,
            "all_ev_per_s": {
                str(e): round(e / (m / 1000), 1) for e, m in results.items()
            },
        }), flush=True)


if __name__ == "__main__":
    main()
