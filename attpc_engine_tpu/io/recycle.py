"""Recycle-pool helpers for the in-memory run-file writer path.

The writer child's recycled in-memory mode (see spyral_child.ChildWriter)
consumes spare files from
``<outdir>/.recycle``; something must keep returning completed run files
to the pool. These helpers implement that return flow for the benchmarks
and runners (tools/run_1m_soak.sh carries its own shell variant):

- ``seed_spares``: pre-create N zero-filled spares (pays the first-touch
  cost once, outside any timed region).
- ``spawn_pruner``: a SEPARATE OS PROCESS that every 0.5 s moves all but
  the newest ``keep`` run files into the pool, deleting beyond
  ``max_spares`` so the pool stays bounded even when the child falls back
  to the plain write path and never consumes spares (compression on,
  native lib unavailable) — an unbounded pool would fill the disk on a
  long run. A process, not a thread: host-side file shuffling must not
  take the GIL from the benchmarked interpreter, which drives the
  device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

__all__ = ["seed_spares", "spawn_pruner"]

_PRUNER_CODE = r"""
import sys, time
from pathlib import Path

outdir, keep, max_spares = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
rdir = outdir / ".recycle"
while True:
    try:
        files = sorted(outdir.glob("run_*.h5"))
        for f in files[: max(len(files) - keep, 0)]:
            spares = list(rdir.glob("*.h5"))
            try:
                if len(spares) < max_spares:
                    f.rename(rdir / f.name)
                else:
                    f.unlink()
            except OSError:
                pass
    except OSError:
        pass
    time.sleep(0.5)
"""


def seed_spares(outdir: Path | str, n: int = 2,
                spare_bytes: int = 5_000 * 3_000 * 80 * 115 // 100) -> Path:
    """Create ``<outdir>/.recycle`` with ``n`` zero-filled spares sized for
    a default-rotation run file. Idempotent; returns the pool path."""
    rdir = Path(outdir) / ".recycle"
    rdir.mkdir(parents=True, exist_ok=True)
    blk = b"\0" * (64 << 20)
    for i in range(n):
        spare = rdir / f"spare_{i}.h5"
        if spare.exists() and spare.stat().st_size >= spare_bytes:
            continue
        with open(spare, "wb") as f:
            left = spare_bytes
            while left > 0:
                f.write(blk[: min(left, len(blk))])
                left -= len(blk)
    return rdir


def spawn_pruner(outdir: Path | str, keep: int = 2,
                 max_spares: int = 3) -> subprocess.Popen:
    """Start the recycle pruner as a separate process; ``.terminate()`` it
    when the run is done."""
    return subprocess.Popen(
        [sys.executable, "-c", _PRUNER_CODE, str(outdir), str(keep),
         str(max_spares)],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
