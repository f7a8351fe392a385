"""The trace reduction of ``tools/trace_step.py`` on a small hand-made
trace and on the step's real compiled HLO (CPU)."""

import importlib.util
from pathlib import Path

import numpy as np

import jax

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "trace_step", REPO / "tools" / "trace_step.py"
)
trace_step = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_step)


def test_reduce_trace_busy_idle_and_stages():
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        # two overlapping device kernels, a gap, a third one
        {"ph": "X", "pid": 1, "ts": 0, "dur": 10, "name": "rk4_transport"},
        {"ph": "X", "pid": 1, "ts": 5, "dur": 10, "name": "cub_sort",
         "args": {"name": "jit(_simulate_impl)/jit(deposit_and_merge)/merge/sort"}},
        {"ph": "X", "pid": 1, "ts": 30, "dur": 10, "name": "loop_fusion_3"},
        # host events never count as device time
        {"ph": "X", "pid": 2, "ts": 0, "dur": 100, "name": "python"},
    ]
    scopes = {"loop_fusion": ("jit(_simulate_impl)/spyral_convert/sort", "")}
    res = trace_step.reduce_trace(events, scopes)
    assert res["busy_ms"] == 0.025  # [0, 15] and [30, 40] us
    assert res["window_ms"] == 0.04
    assert abs(res["idle_share"] - 0.375) < 1e-12
    assert res["stage_ms"] == {
        "transport": 0.01, "merge": 0.01, "spyral_convert": 0.01,
    }


def test_hlo_scopes_map_the_compiled_step():
    """Every stage of the real step is found in its compiled HLO."""
    from __graft_entry__ import _tiny_setup

    _, sim = _tiny_setup(events_per_batch=2, n_time_steps=250)
    vg = np.zeros((2, 3 + 3 * sim.k_tracks), np.float32)
    hlo = sim._sim_jit.lower(
        jax.random.PRNGKey(0), vg, 2, point_budget=64, uniq_budget=512,
        out_budget=512, n_steps=250, event_start=np.int32(0),
    ).compile().as_text()
    table = trace_step.hlo_scopes(hlo)
    stages = {
        trace_step._match_stage(own) or trace_step._match_stage(inner)
        for own, inner in table.values()
    }
    assert {"transport", "pad_lookup", "merge", "spyral_convert"} <= stages
