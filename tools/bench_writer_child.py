"""Host-only throughput bench of the SpyralWriterProc child pipeline.

Pumps synthetic packed batches (the exact wire format run_simulation ships)
through a real writer child process and reports events/s of the writer
path alone — no device, so A/B runs of child variants are
reproducible. Knobs: WB_EVENTS (default 10000), WB_BATCH (384), WB_ROWS
(mean rows/event, 3000 — the measured 12C(d,p) bench multiplicity), WB_OUTDIR (default /dev/shm).

Usage: python tools/bench_writer_child.py
       ATTPC_TPU_NO_NATIVE=1 python tools/bench_writer_child.py  # fallback
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    n_events = int(os.environ.get("WB_EVENTS", 10_000))
    batch = int(os.environ.get("WB_BATCH", 384))
    mean_rows = int(os.environ.get("WB_ROWS", 3000))
    outdir = Path(os.environ.get("WB_OUTDIR", "/dev/shm")) / "wb_clouds"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    pruner = None
    if os.environ.get("WB_RECYCLE"):
        # opt into the in-memory image path with recycled destinations:
        # pre-seed warm spares OUTSIDE the timed region, then keep
        # recycling completed run files back into the pool (separate
        # pruner process, bounded pool) — without the return flow every
        # rotation past the seeds hits a FRESH destination path and pays
        # the full first-touch cost in one pwrite, which is the soak's
        # worst case, not its steady state
        from attpc_engine_tpu.io.recycle import seed_spares, spawn_pruner

        seed_spares(outdir, n=2,
                    spare_bytes=int(mean_rows * 5000 * 80 * 1.15))
        pruner = spawn_pruner(outdir, keep=2, max_spares=3)

    from attpc_engine_tpu import nuclear_map
    from attpc_engine_tpu.nuclear import GasTarget
    from attpc_engine_tpu.detector import (
        Config,
        DetectorParams,
        ElectronicsParams,
        PadParams,
        SpyralWriterProc,
    )

    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    config = Config(
        DetectorParams(1.0, 45000.0, 2.85, 175000, gas, 0.277, 0.2, 34.0),
        ElectronicsParams(6.25, 900, 1000, 10, 560, 40),
        PadParams(),
    )
    writer = SpyralWriterProc(outdir, config)

    rng = np.random.default_rng(0)
    # one synthetic batch, reused: counts ~ N(mean_rows, 10%) clipped
    counts = np.clip(
        rng.normal(mean_rows, mean_rows * 0.1, batch).astype(np.int64), 1, None
    )
    rows = int(counts.sum())
    q = (rng.random(rows, dtype=np.float32) * 50 + 1).astype(np.float32)
    tb = rng.integers(0, 512, rows).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)])
    for i in range(batch):
        lo, hi = off[i], off[i + 1]
        tb[lo:hi] = np.sort(tb[lo:hi])[::-1]
    pad = rng.integers(0, 10240, rows).astype(np.int32)
    lab = rng.integers(0, 3, rows).astype(np.int32)
    packed = np.ascontiguousarray(
        np.stack([q.view(np.int32), (tb << 22) | (pad << 8) | lab], axis=1)
    )

    n_batches = (n_events + batch - 1) // batch
    # warm the child (interpreter + numpy boot is seconds on this VM's
    # cold-cache disk) and the shm pool before timing
    warm_start = n_batches * batch  # disjoint event ids (dataset names)
    writer.write_packed(
        packed, counts, np.arange(warm_start, warm_start + batch),
        wiggle_seed=7,
    )
    while writer._outstanding:
        writer._reap_one()
    t0 = time.perf_counter()
    for b in range(n_batches):
        start = b * batch
        writer.write_packed(
            packed, counts, np.arange(start, start + batch), wiggle_seed=7
        )
    t_sub = time.perf_counter() - t0
    writer.close()
    dt = time.perf_counter() - t0
    if pruner is not None:
        pruner.terminate()
    ev = n_batches * batch
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    print(
        f"parent: submit {t_sub:.2f}s close {dt - t_sub:.2f}s "
        f"cpu {ru.ru_utime + ru.ru_stime:.2f}s",
        file=sys.stderr,
    )
    print(
        f"writer-path: {ev} events, {rows * n_batches} rows, {dt:.2f}s "
        f"= {ev / dt:.0f} ev/s ({rows * n_batches * 8 / dt / 1e6:.0f} MB/s wire)"
    )
    shutil.rmtree(outdir, ignore_errors=True)


if __name__ == "__main__":
    main()
