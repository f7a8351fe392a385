"""Profile the flagship detector step on the local accelerator and
attribute its device time to the stages of the step.

Usage: python tools/trace_step.py [events] [outdir]

Warms the fused detector step (transport -> electrons -> pad lookup ->
merge -> Spyral convert) at the tuned flagship budgets, captures a
``jax.profiler`` trace of PROF_REPS steps under ``outdir`` (default
``chiprun_out/trace_step``), and prints one JSON line: device time per
stage (from the ``jax.named_scope`` spans ``pad_lookup``, ``merge`` and
``spyral_convert``, the ``rk4_transport`` kernel or the
``integrate_tracks`` scan), each stage's share of the device busy time,
and the device idle share of the traced window. Env: PROF_STEPS (500),
PROF_POINT_BUDGET (576), PROF_UNIQ_BUDGET (12288), PROF_OUT_BUDGET (4096),
PROF_REPS (3), PROF_PALLAS_TRANSPORT (1; 0 traces the scan).
"""

import gzip
import json
import os
import re
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

# first match wins: kernel and scope names -> stage
STAGES = (
    ("rk4_transport", "transport"),
    ("integrate_tracks", "transport"),
    ("/pad_lookup", "pad_lookup"),
    ("/merge", "merge"),
    ("/spyral_convert", "spyral_convert"),
    ("generate_electrons", "electrons"),
    ("deposit_and_merge", "deposit_other"),
    ("Memcpy", "memcpy"),
)


def _match_stage(text: str) -> str | None:
    for needle, stage in STAGES:
        if needle in text:
            return stage
    return None


def hlo_scopes(hlo_text: str) -> dict:
    """Compiled HLO text -> {kernel-style instruction name: (the
    instruction's own op_name scope — a fusion's is its root's —, the
    joined scopes of every computation it calls)}. Device kernels are
    named after their HLO instruction ('.' -> '_'), and kernels inside CUDA
    graphs carry no scope of their own, so this is how a trace event finds
    its stage."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head:
            cur = comps.setdefault(head.group(1), [])
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            cur.append(line)

    def scopes_in(comp, seen):
        out = []
        for line in comps.get(comp, []):
            out += re.findall(r'op_name="([^"]+)"', line)
            for callee in re.findall(r"(?:calls|to_apply)=%([\w.\-]+)", line):
                if callee not in seen:
                    seen.add(callee)
                    out += scopes_in(callee, seen)
        return out

    table = {}
    for lines in comps.values():
        for line in lines:
            m = re.match(r"^\s*(?:ROOT )?%([\w.\-]+) = ", line)
            if not m:
                continue
            own = re.findall(r'op_name="([^"]+)"', line)
            inner = []
            for callee in re.findall(r"(?:calls|to_apply)=%([\w.\-]+)", line):
                inner += scopes_in(callee, {callee})
            table[m.group(1).replace(".", "_")] = (" ".join(own), " ".join(inner))
    return table


def stage_of(event: dict, scopes: dict | None = None) -> str:
    args = event.get("args", {})
    text = " ".join(
        str(x) for x in (event.get("name", ""), args.get("name", ""),
                         args.get("long_name", ""), args.get("hlo_op", ""))
    )
    stage = _match_stage(text)
    if stage is None and scopes:
        for key in (event.get("name", ""), str(args.get("hlo_op", ""))):
            key = key.replace(".", "_")
            while key:
                if key in scopes:
                    own, inner = scopes[key]
                    stage = _match_stage(own) or _match_stage(inner)
                    break
                trimmed = re.sub(r"_+\d+$", "", key)
                key = "" if trimmed == key else trimmed
            if stage is not None:
                break
    return stage or "other"


def reduce_trace(trace_events: list, scopes: dict | None = None) -> dict:
    """Device events of a perfetto trace -> per-stage device ms, busy ms
    (union of device intervals), window ms and idle share."""
    device_pids = {
        e["pid"]
        for e in trace_events
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and "/device:" in str(e.get("args", {}).get("name", ""))
    }
    spans = []
    per_stage = defaultdict(float)
    per_op = defaultdict(float)
    for e in trace_events:
        if e.get("ph") == "X" and e.get("pid") in device_pids and "dur" in e:
            ts, dur = float(e["ts"]), float(e["dur"])
            spans.append((ts, ts + dur))
            stage = stage_of(e, scopes)
            per_stage[stage] += dur
            per_op[(stage, e.get("name", "?")[:60])] += dur
    if not spans:
        raise RuntimeError("no device events in the trace")
    spans.sort()
    busy = 0.0
    cur_lo, cur_hi = spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = spans[-1][1] - spans[0][0]
    return {
        "stage_ms": {k: v / 1e3 for k, v in sorted(per_stage.items())},
        "stage_share_of_busy": {
            k: v / busy for k, v in sorted(per_stage.items())
        },
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "idle_share": 1.0 - busy / window,
        "top_ops_ms": [
            [stage, name, dur / 1e3]
            for (stage, name), dur in sorted(
                per_op.items(), key=lambda kv: -kv[1]
            )[:15]
        ],
    }


def main():
    import dataclasses

    from attpc_engine_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    e = int(sys.argv[1]) if len(sys.argv) > 1 else 384
    outdir = Path(sys.argv[2] if len(sys.argv) > 2 else "chiprun_out/trace_step")
    reps = int(os.environ.get("PROF_REPS", 3))

    from __graft_entry__ import _tiny_setup

    steps = int(os.environ.get("PROF_STEPS", 500))
    pipeline, sim = _tiny_setup(events_per_batch=e, n_time_steps=steps)
    # the engine's default chunking (one launch per 500-step chunk)
    sim.engine = dataclasses.replace(sim.engine, chunk_steps=500)
    if os.environ.get("PROF_PALLAS_TRANSPORT", "1") == "0":
        sim.engine = dataclasses.replace(sim.engine, pallas_transport=False)
    vertices, momenta = pipeline.run_batch(e, key=jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    kw = dict(
        assemble=False,
        point_budget=int(os.environ.get("PROF_POINT_BUDGET", 576)),
        uniq_budget=int(os.environ.get("PROF_UNIQ_BUDGET", 12288)),
        out_budget=int(os.environ.get("PROF_OUT_BUDGET", 4096)),
        n_steps=steps,
    )
    jax.block_until_ready(sim.simulate_batch(key, vertices, momenta, **kw))
    # the same program simulate_batch runs, for kernel -> scope names
    import numpy as np

    p3 = momenta[:, sim.sim_indices, :3]
    gvs = (p3 / sim.track_masses[None, :, None]).astype(np.float32)
    vg = np.concatenate(
        [np.asarray(vertices, dtype=np.float32), gvs.reshape(e, -1)], axis=1
    )
    budgets = {k: v for k, v in kw.items() if k != "assemble"}
    hlo = sim._sim_jit.lower(
        key, vg, e, event_start=np.int32(0), **budgets
    ).compile().as_text()
    scopes = hlo_scopes(hlo)
    with jax.profiler.trace(str(outdir), create_perfetto_trace=True):
        for _ in range(reps):
            jax.block_until_ready(
                sim.simulate_batch(key, vertices, momenta, **kw)
            )
    path = sorted(outdir.rglob("perfetto_trace.json.gz"))[-1]
    with gzip.open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    res = reduce_trace(events, scopes)
    res.update(
        events=e, steps_traced=reps, budgets=kw, trace=str(path),
        device=jax.devices()[0].device_kind,
        transport="kernel" if sim._use_transport_kernel() else "scan",
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
