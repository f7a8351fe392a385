"""Multi-device soak: 512 events through the FULL
production path — run_simulation over the 8-virtual-device mesh, the
striped out-of-process writer fleet (n_shards=2), file rotation across
shard boundaries, and a forced overflow-retry under sharding — asserting
value-identity with the unsharded single-device run.

This is the scale guard for the multi-GPU path: budgets
retune after the first batch, files rotate mid-run, and the doubling
retry fires while batches are event-sharded.
"""

import glob

import h5py
import numpy as np
import pytest

from attpc_engine_tpu.detector import EngineParams, SpyralWriterProc
from attpc_engine_tpu.detector.simulator import run_simulation
from attpc_engine_tpu.kinematics import run_kinematics_pipeline


def _collect(dirs):
    out = {}
    for d in dirs:
        for fn in glob.glob(str(d / "run_*.h5")):
            with h5py.File(fn) as f:
                g = f["cloud"]
                for k in g.keys():
                    if k.startswith("cloud_"):
                        ev = int(k.split("_")[1])
                        assert ev not in out, f"event {ev} written twice"
                        out[ev] = np.asarray(g[k])
    return out


@pytest.mark.slow
def test_512_events_sharded_striped_rotating_with_retry(tmp_path):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _tiny_setup

    n_events = 512
    pipeline, sim = _tiny_setup(events_per_batch=64)
    kine = tmp_path / "kine.h5"
    run_kinematics_pipeline(pipeline, n_events, kine, batch_size=n_events,
                            seed=33, show_progress=False)

    def run(outdir, use_mesh):
        outdir.mkdir()
        # point_budget 64 is far below the observed multiplicity: the
        # FIRST batch must overflow and the driver's doubling retry must
        # fire (under sharding in the mesh run). 100 events/file forces
        # rotation inside and across shard boundaries (512 events, 2
        # shards, 6 files).
        engine = EngineParams(
            n_time_steps=500, chunk_steps=250, point_budget=64,
            out_budget=8192, events_per_batch=64,
        )
        writer = SpyralWriterProc(outdir, sim.config, 100, n_shards=2)
        run_simulation(
            sim.config, kine, writer, engine=engine, seed=33,
            show_progress=False, use_mesh=use_mesh,
        )
        files = sorted(glob.glob(str(outdir / "run_*.h5")))
        return _collect([outdir]), files

    single, files_s = run(tmp_path / "single", use_mesh=False)
    sharded, files_m = run(tmp_path / "sharded", use_mesh=True)

    assert len(files_m) >= 6, files_m  # rotation across shard boundaries
    assert set(single) == set(sharded)
    assert len(single) >= 500  # essentially every event lands pads
    for ev in single:
        np.testing.assert_allclose(
            sharded[ev], single[ev], rtol=2e-5, atol=2e-3,
            err_msg=f"event {ev}",
        )
        assert single[ev].shape == sharded[ev].shape
