"""Microbench the native per-event HDF5 write path.

Once pages are warm, the writer child's per-event CPU goes to
`write_batch_native` (2 dataset creates + 6 attrs + 2 writes per event,
old-format storage). This tool times
`sio_h5_write_events` directly (no child process, no device) for the
A/B that matters:

  default  — old-format file (byte-compatible with earlier rounds)
  latest   — ATTPC_H5_LATEST=1: 1.8-format (dense attrs, new object
             headers, fractal-heap links), content h5py-identical

Interleave arms and verify the latest-format file reads back identically
through h5py. Run it alone on the host (never next to a device job). Env: MB_EVENTS (default 4000),
MB_ROWS (mean rows/event, default 3100), MB_REPS (default 3),
MB_OUTDIR (default /dev/shm).
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

_DPTR = ctypes.POINTER(ctypes.c_double)
_I64PTR = ctypes.POINTER(ctypes.c_int64)


def _load(latest: bool):
    from attpc_engine_tpu.native import get_spyral_io_lib, hdf5_bundle

    lib = get_spyral_io_lib(with_h5=True)
    assert lib is not None, "native lib unavailable"
    h5path, _ = hdf5_bundle()
    assert h5path
    lib.sio_h5_set_latest.argtypes = [ctypes.c_int]
    lib.sio_h5_set_latest.restype = None
    lib.sio_h5_set_latest(1 if latest else 0)
    return lib


def main() -> None:
    n_events = int(os.environ.get("MB_EVENTS", 4000))
    rows_mean = int(os.environ.get("MB_ROWS", 3100))
    reps = int(os.environ.get("MB_REPS", 3))
    outdir = Path(os.environ.get("MB_OUTDIR", "/dev/shm")) / "mb_h5"
    outdir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(0)
    counts = np.maximum(
        rng.poisson(rows_mean, n_events), 1
    ).astype(np.int64)
    total = int(counts.sum())
    spyral = rng.normal(100.0, 30.0, (total, 8)).astype(np.float64)
    labels = rng.integers(0, 4, total).astype(np.int64)
    c_ptr = counts.ctypes.data_as(_I64PTR)
    s_ptr = spyral.ctypes.data_as(_DPTR)
    l_ptr = labels.ctypes.data_as(_I64PTR)

    lib = _load(False)
    results: dict[str, list[float]] = {"default": [], "latest": []}
    paths = {}
    for rep in range(reps):
        for arm, latest in (("default", False), ("latest", True)):
            lib.sio_h5_set_latest(1 if latest else 0)
            # one path per ARM, overwritten each rep: keeps /dev/shm usage
            # at 2 files (~1 GB each at defaults) and mirrors the warm
            # steady state (rewriting owned pages) after rep 0
            path = outdir / f"{arm}.h5"
            t0 = time.perf_counter()
            h = lib.sio_h5_open(str(path).encode())
            assert h
            w = lib.sio_h5_write_events(
                h, 0, 0, c_ptr, None, n_events, s_ptr, l_ptr
            )
            assert w == n_events, w
            lib.sio_h5_close(h, 0, n_events - 1)
            dt = time.perf_counter() - t0
            results[arm].append(dt)
            paths[arm] = path
            print(
                json.dumps({"arm": arm, "rep": rep, "s": round(dt, 2),
                            "us_per_event": round(dt / n_events * 1e6)}),
                flush=True,
            )

    # content identity through h5py (the actual Spyral contract level)
    import h5py

    fa = h5py.File(paths["default"], "r")
    fb = h5py.File(paths["latest"], "r")
    for k in ("cloud_0", f"cloud_{n_events - 1}", "labels_0"):
        np.testing.assert_array_equal(fa["cloud"][k][()], fb["cloud"][k][()])
    for a in ("min_event", "max_event"):
        assert fa["cloud"].attrs[a] == fb["cloud"].attrs[a]
    d0 = fa["cloud"]["cloud_0"]
    db = fb["cloud"]["cloud_0"]
    assert dict(d0.attrs) == dict(db.attrs)
    med = {k: float(np.median(v)) for k, v in results.items()}
    print(json.dumps({
        "verdict": "latest" if med["latest"] < med["default"] else "default",
        "median_s": {k: round(v, 2) for k, v in med.items()},
        "speedup": round(med["default"] / med["latest"], 3),
        "events": n_events, "mean_rows": rows_mean,
        "content_identical": True,
    }), flush=True)


if __name__ == "__main__":
    main()
