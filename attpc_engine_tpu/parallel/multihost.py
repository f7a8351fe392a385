"""Multi-host production driver: one detector run spread over several hosts.

The reference engine is single-process and serial (no analog:
/root/reference/src has no multiprocessing/MPI — SURVEY.md section 2.3).
This workload is embarrassingly parallel over events and every random
stream is keyed by the GLOBAL event id (``run_simulation`` resume
semantics), so the multi-host decomposition needs no collectives at all:

- each process owns one contiguous slice of the kinematics file's events,
- simulates it over its OWN local chips (``run_simulation`` with
  ``devices=jax.local_devices()`` — a per-process program, not a global
  SPMD program, so a straggling host never stalls the others),
- and writes its own run files through its own writer fleet, with
  disjoint run numbers (``first_run_number = process_id * stride``).

The union of all processes' run files is value-identical, event for
event, to a single-process run with the same seed (grid-independent RNG;
tests/test_multihost.py::test_multihost_production_driver), which is also
what makes the split restartable per process. "Value-identical" is
bit-exact when both sides run the same device layout; across DIFFERENT
layouts (a >1-chip local mesh vs a flat single-device run) the
XLA-partitioned conversion tail reassociates f32 reductions, so rows
match to float tolerance and an ADC-threshold-straddling row can flip —
the test's rtol=2e-5/atol=2e-3 comparison is the honest contract.

This driver has run only on virtual CPU devices (tests/test_multihost.py),
not yet on GPUs.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax

__all__ = ["run_simulation_multihost"]


def _scan_resume_block(
    output_dir: Path, first_run: int, stride: int
) -> tuple[int | None, int, list[Path]]:
    """Walk this process's run-number block for a crash-resume point.

    Returns ``(resume_event, n_closed, stale)``: the global event id to
    restart from (``None`` when no durable file exists), how many
    consecutive properly-closed run files lead up to it, and the paths of
    any files after them (unreadable / never-closed partials from the
    crash, or files orphaned beyond a partial) that must be deleted before
    rewriting.

    A file is durable iff it carries the ``max_event`` attr — the writers
    only write attrs in ``close()``, and ``run_simulation`` closes its
    writer even when unwinding on an exception; a file from a hard-killed
    process has no attrs (usually it is not even readable HDF5). The
    recycled in-memory path preserves this invariant by materializing the
    image into an invisible ``.run_XXXX.h5.part`` sidecar and publishing
    it with one atomic rename (spyral_child._finalize_inner) — the run
    path never holds a recycled predecessor's complete-but-wrong-range
    file.
    Under-full closed files are still durable (an interrupted run's final
    file, like the reference's own last file, legitimately holds fewer
    than ``max_events_per_file`` events), so the walk continues past them.
    """
    import h5py

    n = 0
    resume_event: int | None = None
    while n < stride:
        path = output_dir / f"run_{first_run + n:04d}.h5"
        if not path.exists():
            break
        try:
            with h5py.File(path, "r") as f:
                last = int(f["cloud"].attrs["max_event"])
        except (OSError, KeyError):
            break  # crash partial: not closed (or not even HDF5)
        resume_event = last + 1
        n += 1
    stale = [
        p
        for i in range(n, stride)
        if (p := output_dir / f"run_{first_run + i:04d}.h5").exists()
    ]
    return resume_event, n, stale


def run_simulation_multihost(
    config,
    input_path: Path | str,
    output_dir: Path | str,
    *,
    seed: int,
    indices: list[int] | None = None,
    engine=None,
    writer_shards: int = 1,
    max_events_per_file: int = 5_000,
    run_number_stride: int = 10_000,
    compression: str | None = None,
    show_progress: bool = False,
    process_id: int | None = None,
    num_processes: int | None = None,
    resume: bool = False,
) -> tuple[int, int]:
    """Run this process's slice of a detector simulation.

    Call from every process of a ``jax.distributed``-initialized job (or
    pass ``process_id``/``num_processes`` explicitly to shard across
    independent processes without a coordinator — e.g. separate
    single-host machines over a shared filesystem). Every process must
    pass the SAME ``seed``: all random streams key off
    ``fold_in(seed, global_event_id)``, so the union of the processes'
    outputs is bit-identical to a single-process run.

    Parameters mirror ``run_simulation`` plus:

    writer_shards: per-process striped writer children
        (``SpyralWriterProc(n_shards=...)``) — a multi-chip host needs
        several to keep up with device output (BASELINE.md).
    run_number_stride: run-number block per process. Process ``p`` writes
        run files ``p * stride, p * stride + 1, ...``; a guard raises if
        its event slice could need more files than the block holds.
    process_id / num_processes: default to ``jax.process_index()`` /
        ``jax.process_count()``.
    resume: continue an interrupted run of the SAME configuration (seed,
        slicing, file/stride parameters). The process's run-number block
        is scanned for durable (properly closed) run files; simulation
        restarts at the last durable file's ``max_event + 1`` with the
        next run number, after deleting any crash partials beyond it.
        Grid-independent RNG makes the result bit-identical to an
        uninterrupted run. Trailing skipped events (an interruption
        after the last event that produced clouds) re-simulate into an
        empty final file — harmless, but callers that care can compare
        the returned range.

    Returns ``(resume_start, stop_event)`` — the events this call
    actually simulated (empty: ``(stop, stop)``, filesystem untouched).
    """
    from ..detector.simulator import run_simulation
    from ..detector.writer import SpyralWriterProc
    from ..io.kinematics_file import KinematicsReader

    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id {pid} outside [0, {nproc})")

    reader = KinematicsReader(input_path)
    try:
        n_events = reader.n_events
    finally:
        reader.close()

    per_proc = math.ceil(n_events / nproc)
    start = pid * per_proc
    stop = min(n_events, start + per_proc)
    if start >= stop:
        return (start, start)

    first_run = pid * run_number_stride
    if resume:
        resume_event, n_closed, stale = _scan_resume_block(
            Path(output_dir), first_run, run_number_stride
        )
        if resume_event is not None:
            start = max(start, resume_event)
        if start >= stop:
            return (stop, stop)  # slice already complete
        for p in stale:
            p.unlink()
        first_run += n_closed

    # files hold up to max_events_per_file events each, regardless of
    # striping (striped children share one global run counter: child i
    # owns runs first+i, first+i+n_shards, ...)
    max_files = math.ceil((stop - start) / max_events_per_file)
    runs_left = run_number_stride - (first_run - pid * run_number_stride)
    if max_files > runs_left:
        raise ValueError(
            f"process {pid} may write {max_files} run files but its "
            f"run-number block has {runs_left} left; raise "
            "run_number_stride or max_events_per_file"
        )

    writer = SpyralWriterProc(
        output_dir,
        config,
        max_events_per_file=max_events_per_file,
        first_run_number=first_run,
        compression=compression,
        n_shards=writer_shards,
    )
    run_simulation(
        config,
        input_path,
        writer,
        indices=indices,
        engine=engine,
        seed=seed,
        show_progress=show_progress,
        start_event=start,
        stop_event=stop,
        devices=jax.local_devices(),
    )
    return (start, stop)
