"""Multi-process (multi-"host") execution over jax.distributed.

The reference is single-process (SURVEY.md section 2.3); this engine's
distributed slot is ``jax.distributed.initialize`` + the same event-axis
sharding over the GLOBAL mesh. Several hosts are not
available here, so this test exercises the real multi-controller code path
the way JAX upstream does: two OS processes, each owning 2 virtual CPU
devices, form one 4-device global mesh over a localhost coordinator. The
detector step runs jit-sharded over the global mesh and every process
checks its local shard against a single-process reference run.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

_WORKER = r"""
import os, sys
import numpy as np

proc = int(sys.argv[1])
nprocs = int(sys.argv[2])
coord = sys.argv[3]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=coord, num_processes=nprocs, process_id=proc
)
assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.devices()) == nprocs * 2  # global devices
assert len(jax.local_devices()) == 2

sys.path.insert(0, os.getcwd())
from jax.experimental import multihost_utils
from attpc_engine_tpu.parallel import event_mesh, event_sharding
from __graft_entry__ import _tiny_setup

E = 8  # global events, 2 per device
pipeline, sim = _tiny_setup(events_per_batch=E, n_time_steps=250)

# identical host-side sample on every process (same seed)
vertices, momenta = pipeline.run_batch(E, key=jax.random.PRNGKey(7))
p3 = momenta[:, sim.sim_indices, :3]
gvs = np.asarray(p3 / sim.track_masses[None, :, None], dtype=np.float32)
verts = np.asarray(vertices, dtype=np.float32)
vg = np.concatenate([verts, gvs.reshape(E, -1)], axis=1)

mesh = event_mesh()  # global 4-device mesh
sh2 = event_sharding(mesh, 2)
# build the global array from per-process local shards (the multi-host way)
vg_glob = jax.make_array_from_process_local_data(sh2, vg[proc * 4:(proc + 1) * 4])
key = jax.random.PRNGKey(3)

out = sim._sim_jit(key, vg_glob, E)
counts = np.asarray(
    multihost_utils.process_allgather(out["spyral_counts"], tiled=True)
)
# single-process reference on this process's own devices
ref = sim._sim_jit(key, jax.numpy.asarray(vg), E)
ref_counts = np.asarray(ref["spyral_counts"])
assert counts.shape == (E,)
np.testing.assert_array_equal(counts, ref_counts)
assert ref_counts.min() > 0
print(f"proc {proc}: OK counts={ref_counts.tolist()}", flush=True)
"""


def test_two_process_distributed_detector(tmp_path):
    """Two jax.distributed processes × 2 virtual CPU devices run the
    sharded detector step over one global 4-device mesh and match the
    single-process result."""
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = ""
    repo = Path(__file__).resolve().parent.parent
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", coord],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=repo,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=600)
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
        assert f"proc {i}: OK" in out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_PROD_WORKER = r"""
import os, sys

proc = int(sys.argv[1])
nprocs = int(sys.argv[2])
coord = sys.argv[3]
kine = sys.argv[4]
outdir = sys.argv[5]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=coord, num_processes=nprocs, process_id=proc
)
sys.path.insert(0, os.getcwd())
from __graft_entry__ import _tiny_setup
from attpc_engine_tpu.detector import EngineParams
from attpc_engine_tpu.parallel import run_simulation_multihost

pipeline, sim = _tiny_setup(events_per_batch=4, n_time_steps=500)
engine = EngineParams(
    n_time_steps=500, chunk_steps=250, point_budget=512,
    out_budget=8192, events_per_batch=4,
)
lo, hi = run_simulation_multihost(
    sim.config, kine, outdir, seed=23, engine=engine,
    max_events_per_file=3, run_number_stride=100,
)
print(f"proc {proc}: OK slice={lo}:{hi}", flush=True)
"""


def _collect_clouds(directory):
    """{dataset name: array} union over every run file in the directory."""
    import glob

    import h5py
    import numpy as np

    out = {}
    for path in sorted(glob.glob(str(directory / "run_*.h5"))):
        with h5py.File(path) as f:
            for k in f["cloud"]:
                assert k not in out, f"event {k} written twice"
                out[k] = np.asarray(f["cloud"][k])
    return out


def test_multihost_production_driver(tmp_path):
    """Two jax.distributed processes × 2 virtual CPU devices run
    ``run_simulation_multihost`` — each owning half the kinematics file's
    events on its own LOCAL device mesh with its own writer fleet and run-
    number block — and the union of their run files matches a single-
    process ``run_simulation`` with the same seed, event for event."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup
    from attpc_engine_tpu.detector import EngineParams, SpyralWriter
    from attpc_engine_tpu.detector.simulator import run_simulation
    from attpc_engine_tpu.kinematics import run_kinematics_pipeline

    pipeline, sim = _tiny_setup(events_per_batch=4, n_time_steps=500)
    kine = tmp_path / "kine.h5"
    run_kinematics_pipeline(pipeline, 12, kine, seed=23, show_progress=False)

    outdir = tmp_path / "pod"
    outdir.mkdir()
    port = _free_port()
    script = tmp_path / "prod_worker.py"
    script.write_text(_PROD_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = ""
    repo = Path(__file__).resolve().parent.parent
    procs = [
        subprocess.Popen(
            [
                sys.executable, str(script), str(i), "2",
                f"127.0.0.1:{port}", str(kine), str(outdir),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=repo,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=900)
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
    assert "proc 0: OK slice=0:6" in outs[0]
    assert "proc 1: OK slice=6:12" in outs[1]

    # disjoint run-number blocks: 6 events / 3 per file = runs {0,1} and
    # {100,101}
    runs = sorted(
        int(p.name[4:8]) for p in outdir.glob("run_*.h5")
    )
    assert runs == [0, 1, 100, 101], runs

    # single-process reference, same seed (grid-independent RNG makes the
    # split value-identical; float tolerance because each worker shards
    # over a 2-device local mesh while the reference runs flat)
    refdir = tmp_path / "ref"
    refdir.mkdir()
    engine = EngineParams(
        n_time_steps=500, chunk_steps=250, point_budget=512,
        out_budget=8192, events_per_batch=4,
    )
    run_simulation(
        sim.config, kine, SpyralWriter(refdir, sim.config),
        engine=engine, seed=23, show_progress=False, use_mesh=False,
    )
    pod = _collect_clouds(outdir)
    ref = _collect_clouds(refdir)
    assert pod.keys() == ref.keys()
    assert any(k.startswith("cloud_") for k in ref)
    for k in sorted(ref):
        assert pod[k].shape == ref[k].shape, k
        np.testing.assert_allclose(
            pod[k], ref[k], rtol=2e-5, atol=2e-3, err_msg=f"dataset {k}"
        )


def test_multihost_explicit_ids_without_coordinator(tmp_path):
    """``run_simulation_multihost`` with explicit process_id/num_processes
    shards across independent processes with no jax.distributed coordinator
    (e.g. separate single-host machines over a shared filesystem). Running
    all three slices sequentially in this one process reproduces the
    single-process run bit-exactly (same device layout, grid-independent
    RNG)."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup
    from attpc_engine_tpu.detector import EngineParams, SpyralWriter
    from attpc_engine_tpu.detector.simulator import run_simulation
    from attpc_engine_tpu.kinematics import run_kinematics_pipeline
    from attpc_engine_tpu.parallel import run_simulation_multihost

    pipeline, sim = _tiny_setup(events_per_batch=4, n_time_steps=500)
    kine = tmp_path / "kine.h5"
    run_kinematics_pipeline(pipeline, 8, kine, seed=31, show_progress=False)
    engine = EngineParams(
        n_time_steps=500, chunk_steps=250, point_budget=512,
        out_budget=8192, events_per_batch=4,
    )

    outdir = tmp_path / "fleet"
    outdir.mkdir()
    slices = [
        run_simulation_multihost(
            sim.config, kine, outdir, seed=31, engine=engine,
            process_id=pid, num_processes=3,
            max_events_per_file=3, run_number_stride=10,
        )
        for pid in range(3)
    ]
    assert slices == [(0, 3), (3, 6), (6, 8)]

    refdir = tmp_path / "ref"
    refdir.mkdir()
    run_simulation(
        sim.config, kine, SpyralWriter(refdir, sim.config),
        engine=engine, seed=31, show_progress=False, use_mesh=False,
    )
    fleet = _collect_clouds(outdir)
    ref = _collect_clouds(refdir)
    assert fleet.keys() == ref.keys()
    for k in sorted(ref):
        # same flat device layout on both sides -> bit-exact
        np.testing.assert_array_equal(fleet[k], ref[k], err_msg=f"dataset {k}")


def test_multihost_resume_after_interruption(tmp_path):
    """``resume=True`` restarts an interrupted slice at the last durable
    run file's ``max_event + 1``, deletes the crash partial, and the
    resulting directory matches an uninterrupted single run bit-exactly."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup
    from attpc_engine_tpu.detector import EngineParams, SpyralWriter, SpyralWriterProc
    from attpc_engine_tpu.detector.simulator import run_simulation
    from attpc_engine_tpu.kinematics import run_kinematics_pipeline
    from attpc_engine_tpu.parallel import run_simulation_multihost

    pipeline, sim = _tiny_setup(events_per_batch=4, n_time_steps=500)
    kine = tmp_path / "kine.h5"
    run_kinematics_pipeline(pipeline, 8, kine, seed=31, show_progress=False)
    engine = EngineParams(
        n_time_steps=500, chunk_steps=250, point_budget=512,
        out_budget=8192, events_per_batch=4,
    )

    # fabricate the interruption: events [0, 5) through the block's writer
    # params leave run_0000 (0-2, full) + run_0001 (3-4, closed under-full
    # — run_simulation closes the writer even when unwinding), plus a
    # never-closed crash partial at the next run number
    outdir = tmp_path / "interrupted"
    outdir.mkdir()
    w = SpyralWriterProc(
        outdir, sim.config, max_events_per_file=3, first_run_number=0
    )
    run_simulation(
        sim.config, kine, w, engine=engine, seed=31, show_progress=False,
        stop_event=5, use_mesh=False,
    )
    partial = outdir / "run_0002.h5"
    partial.write_bytes(b"definitely not hdf5")

    got = run_simulation_multihost(
        sim.config, kine, outdir, seed=31, engine=engine,
        process_id=0, num_processes=1,
        max_events_per_file=3, run_number_stride=10, resume=True,
    )
    assert got == (5, 8)

    refdir = tmp_path / "ref"
    refdir.mkdir()
    run_simulation(
        sim.config, kine, SpyralWriter(refdir, sim.config),
        engine=engine, seed=31, show_progress=False, use_mesh=False,
    )
    resumed = _collect_clouds(outdir)
    ref = _collect_clouds(refdir)
    assert resumed.keys() == ref.keys()
    for k in sorted(ref):
        np.testing.assert_array_equal(resumed[k], ref[k], err_msg=k)

    # idempotent: a second resume sees the slice complete and is a no-op
    before = sorted(p.name for p in outdir.iterdir())
    assert run_simulation_multihost(
        sim.config, kine, outdir, seed=31, engine=engine,
        process_id=0, num_processes=1,
        max_events_per_file=3, run_number_stride=10, resume=True,
    ) == (8, 8)
    assert sorted(p.name for p in outdir.iterdir()) == before


def test_multihost_guards(tmp_path):
    """Run-number-block guard and empty-slice handling."""
    import pytest

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup
    from attpc_engine_tpu.kinematics import run_kinematics_pipeline
    from attpc_engine_tpu.parallel import run_simulation_multihost

    pipeline, sim = _tiny_setup(events_per_batch=4, n_time_steps=500)
    kine = tmp_path / "kine.h5"
    run_kinematics_pipeline(pipeline, 8, kine, seed=31, show_progress=False)

    # 8 events / 1 file each needs 8 run numbers but the block holds 2
    with pytest.raises(ValueError, match="run-number block"):
        run_simulation_multihost(
            sim.config, kine, tmp_path, seed=1, process_id=0,
            num_processes=1, max_events_per_file=1, run_number_stride=2,
        )
    # 5 processes over 8 events: ceil -> 2/proc, process 4 owns nothing
    # and must not touch the filesystem
    empty = tmp_path / "empty"
    empty.mkdir()
    assert run_simulation_multihost(
        sim.config, kine, empty, seed=1, process_id=4, num_processes=5,
    ) == (8, 8)
    assert list(empty.iterdir()) == []
    with pytest.raises(ValueError, match="outside"):
        run_simulation_multihost(
            sim.config, kine, empty, seed=1, process_id=2, num_processes=2,
        )
