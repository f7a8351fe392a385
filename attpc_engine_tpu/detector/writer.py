"""Point-cloud output writers.

Covers the reference's ``detector/writer.py``
(/root/reference/src/attpc_engine/detector/writer.py:12-281): the
``SimulationWriter`` protocol and a ``SpyralWriter`` producing
Spyral-analysis-compatible HDF5 files. Output format parity (the downstream
contract):

- files ``run_XXXX.h5`` with at most ``max_events_per_file`` events each,
- per event: ``/cloud/cloud_{n}`` float64 [N, 8] = [pad_x_mm, pad_y_mm,
  z_mm, amplitude, integral, pad_id, tb_float, pad_size], z-ascending,
  ADC-thresholded; attrs orig_run, orig_event, ic_* = -1.0,
- ``/cloud/labels_{n}`` int64 [N]; group attrs min_event/max_event,
- empty events are skipped (event numbers may gap).

The batched path (``write_spyral_batch``) receives device-converted batches
from the simulator; the scalar ``write`` keeps the reference protocol for
custom flows.
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol

import numpy as np

from .parameters import Config
from .response import get_response

__all__ = ["SimulationWriter", "SpyralWriter", "SpyralWriterProc", "convert_to_spyral"]

# reference-parity payloads for events whose points all failed the ADC
# threshold (the reference writes 0-row datasets for them, writer.py:240-251)
_EMPTY_SPYRAL = np.empty((0, 8), dtype=np.float64)
_EMPTY_LABELS = np.empty((0,), dtype=np.int64)


class SimulationWriter(Protocol):
    """Protocol for simulation writers (reference writer.py:12-58)."""

    def write(
        self, data: np.ndarray, labels: np.ndarray, config: Config, event_number: int
    ) -> None: ...

    def get_directory_name(self) -> Path: ...

    def close(self) -> None: ...


def convert_to_spyral(
    points: np.ndarray,
    window_edge: int,
    mm_edge: int,
    length: float,
    response: np.ndarray,
    pad_centers: np.ndarray,
    pad_sizes: np.ndarray,
) -> np.ndarray:
    """Host-side Spyral conversion of a raw [N, 3] = [pad, tb, electrons]
    cloud (reference writer.py:61-112), vectorized with numpy.
    """
    pads = points[:, 0].astype(np.int64)
    tbs = points[:, 1]
    electrons = points[:, 2]
    storage = np.empty((len(points), 8))
    sig = np.minimum(response[None, :] * electrons[:, None], 4095.0)
    storage[:, 0] = pad_centers[pads, 0]
    storage[:, 1] = pad_centers[pads, 1]
    storage[:, 2] = (window_edge - tbs) / (window_edge - mm_edge) * length * 1000.0
    storage[:, 3] = sig.max(axis=1)
    storage[:, 4] = sig.sum(axis=1)
    storage[:, 5] = pads
    storage[:, 6] = tbs
    storage[:, 7] = pad_sizes[pads]
    return storage


class SpyralWriter:
    """Writer for default Spyral analysis (multi-file HDF5 point clouds).

    Parameters mirror the reference (writer.py:164-181): output directory,
    config, ``max_events_per_file`` (default 5000) and ``first_run_number``.
    """

    def __init__(
        self,
        directory_path: Path | str,
        config: Config,
        max_events_per_file: int = 5_000,
        first_run_number: int = 0,
        compression: str | None = None,
    ):
        """``compression``: optional HDF5 dataset filter ("lzf" or "gzip").
        Default None matches the reference's uncompressed layout exactly;
        "lzf" roughly halves the bytes on real cloud data and pays host CPU
        for it — a net win when sustained disk throughput is the
        bottleneck. Readers are
        unaffected (HDF5 filters are transparent to h5py/Spyral)."""
        self.directory_path = Path(directory_path)
        self.config = config
        self.response: np.ndarray = get_response(config).copy()
        self.max_events_per_file = max_events_per_file
        self._dset_kwargs = {}
        if compression == "gzip":
            self._dset_kwargs = {"compression": "gzip", "compression_opts": 1}
        elif compression is not None:
            self._dset_kwargs = {"compression": compression}
        self.run_number = first_run_number
        self.starting_event = 0
        self.last_event = 0
        self.events_written = 0
        self._open_file()

    def _open_file(self) -> None:
        import h5py

        path = self.directory_path / f"run_{self.run_number:04d}.h5"
        self.file = h5py.File(path, "w")
        self.cloud_group = self.file.create_group("cloud")

    def create_next_file(self) -> None:
        self.run_number += 1
        self._open_file()

    def _maybe_rotate(self, event_number: int) -> None:
        if self.events_written == self.max_events_per_file:
            self.close()
            self.create_next_file()
            self.starting_event = event_number
            self.events_written = 0

    def _write_event(
        self, spyral: np.ndarray, labels: np.ndarray, event_number: int
    ) -> None:
        self._maybe_rotate(event_number)
        dset = self.cloud_group.create_dataset(
            f"cloud_{event_number}", data=spyral, **self._dset_kwargs
        )
        dset.attrs["orig_run"] = self.run_number
        dset.attrs["orig_event"] = event_number
        dset.attrs["ic_amplitude"] = -1.0
        dset.attrs["ic_multiplicity"] = -1.0
        dset.attrs["ic_integral"] = -1.0
        dset.attrs["ic_centroid"] = -1.0
        self.cloud_group.create_dataset(
            f"labels_{event_number}", data=labels, **self._dset_kwargs
        )
        self.last_event = event_number
        self.events_written += 1

    def write_spyral_batch(
        self,
        spyral: np.ndarray,
        labels: np.ndarray,
        counts: np.ndarray,
        event_numbers: np.ndarray,
        raw_counts: np.ndarray | None = None,
    ) -> None:
        """Write a device-converted batch: spyral [E, C, 8] (valid rows
        first), labels [E, C], counts [E].

        Empty-event semantics match the reference
        (simulator.py:204-205 + writer.py:194-255): an event whose RAW cloud
        was empty is skipped entirely, but an event whose points all failed
        the ADC threshold still gets empty cloud_N/labels_N datasets and
        counts toward file rotation. ``raw_counts`` (pre-threshold merged
        entries per event) drives that distinction; None treats kept == 0 as
        raw-empty (the old skip behavior)."""
        for i, event_number in enumerate(event_numbers):
            n = int(counts[i])
            if n == 0:
                if raw_counts is None or int(raw_counts[i]) == 0:
                    continue
                self._write_event(_EMPTY_SPYRAL, _EMPTY_LABELS, int(event_number))
                continue
            self._write_event(spyral[i, :n], labels[i, :n], int(event_number))

    def write_spyral_pool(
        self,
        spyral_pool: np.ndarray,
        labels_pool: np.ndarray,
        counts: np.ndarray,
        event_numbers: np.ndarray,
        raw_counts: np.ndarray | None = None,
    ) -> None:
        """Write a pooled device-converted batch: spyral_pool [sum(counts), 8]
        with the events' rows concatenated in order. Empty-event semantics as
        in :meth:`write_spyral_batch`."""
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for i, event_number in enumerate(event_numbers):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            if hi == lo:
                if raw_counts is None or int(raw_counts[i]) == 0:
                    continue
                self._write_event(_EMPTY_SPYRAL, _EMPTY_LABELS, int(event_number))
                continue
            self._write_event(
                spyral_pool[lo:hi], labels_pool[lo:hi], int(event_number)
            )

    def write(
        self, data: np.ndarray, labels: np.ndarray, config: Config, event_number: int
    ) -> None:
        """Reference-protocol scalar write of a raw [N, 3] cloud
        (writer.py:194-255): convert, threshold, z-sort, store."""
        spyral = convert_to_spyral(
            data,
            config.elec_params.windows_edge,
            config.elec_params.micromegas_edge,
            config.det_params.length,
            self.response,
            config.pad_centers,
            config.pad_sizes,
        )
        mask = spyral[:, 3] > config.elec_params.adc_threshold
        spyral = spyral[mask]
        labels = labels[mask]
        order = np.argsort(spyral[:, 2], kind="stable")
        self._write_event(spyral[order], labels[order], event_number)

    def set_number_of_events(self) -> None:
        self.cloud_group.attrs["min_event"] = self.starting_event
        self.cloud_group.attrs["max_event"] = self.last_event

    def get_directory_name(self) -> Path:
        return self.directory_path

    def close(self) -> None:
        self.set_number_of_events()
        self.file.close()


class SpyralWriterProc:
    """Out-of-process SpyralWriter: Spyral assembly + HDF5 writing run in a
    separate OS process fed over POSIX shared memory.

    Why a process and not a thread: numpy/h5py hold the GIL in bursts, and
    a GIL-holding sibling thread stalls the parent's device dispatch and
    pulls, so host I/O overlaps device work only from a second process.
    The child imports no JAX, so it never opens the card. Output files are
    byte-identical to ``SpyralWriter`` (tests/test_writer_proc.py).

    Drop-in for ``run_simulation``: it exposes ``write_packed`` so the
    driver ships the 8-byte packed device rows straight to the child and
    skips in-process assembly entirely.
    """

    def __init__(
        self,
        directory_path: Path | str,
        config: Config,
        max_events_per_file: int = 5_000,
        first_run_number: int = 0,
        compression: str | None = None,
        max_outstanding: int = 4,
        n_shards: int = 1,
        run_stride: int = 1,
        owns_first_file: bool = True,
    ):
        import subprocess
        import sys
        import tempfile

        self.directory_path = Path(directory_path)
        self.config = config
        self.max_events_per_file = max_events_per_file
        # Striped mode (n_shards > 1): N writer children, each owning
        # every N-th run file, fed round-robin BY FILE so every run file
        # still holds a contiguous written-event range (the Spyral
        # min_event/max_event contract). A host whose devices produce
        # events faster than one child writes them needs several; on a
        # host with few cores striping only adds contention — default 1.
        self._shards: list[SpyralWriterProc] | None = None
        if n_shards > 1:
            if run_stride != 1:
                raise ValueError("n_shards and run_stride are exclusive")
            self._shards = [
                SpyralWriterProc(
                    directory_path, config, max_events_per_file,
                    first_run_number + i, compression, max_outstanding,
                    run_stride=n_shards, owns_first_file=(i == 0),
                )
                for i in range(n_shards)
            ]
            self._written_total = 0
            self._closed = False
            return
        resp = np.asarray(get_response(config), dtype=np.float64)
        asc = np.sort(resp)
        self._tables_file = tempfile.NamedTemporaryFile(
            suffix=".npz", delete=False
        )
        np.savez(
            self._tables_file,
            pad_centers=np.asarray(config.pad_centers, dtype=np.float64),
            pad_sizes=np.asarray(config.pad_sizes, dtype=np.float64),
            resp_asc=asc,
            resp_prefix=np.concatenate([[0.0], np.cumsum(asc)]),
            resp_max=resp.max(),
            windows_edge=float(config.elec_params.windows_edge),
            micromegas_edge=float(config.elec_params.micromegas_edge),
            length=float(config.det_params.length),
        )
        self._tables_file.close()
        child = Path(__file__).resolve().parent.parent / "io" / "spyral_child.py"
        # build (once) + advertise the native assembly/HDF5 library to the
        # child; it falls back to numpy+h5py when the env vars are absent
        import os

        env = os.environ.copy()
        from ..native import get_spyral_io_lib, hdf5_bundle

        if get_spyral_io_lib(with_h5=True) is not None:
            so = Path(__file__).resolve().parent.parent / "native" / "libspyral_io.so"
            h5path, _ = hdf5_bundle()
            if so.exists() and h5path:
                env["ATTPC_SIO_LIB"] = str(so)
                env["ATTPC_SIO_HDF5"] = h5path
        self._proc = subprocess.Popen(
            [
                sys.executable,
                str(child),
                self._tables_file.name,
                str(self.directory_path),
                str(max_events_per_file),
                str(first_run_number),
                compression or "-",
                str(run_stride),
                "1" if owns_first_file else "0",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            text=True,
            env=env,
        )
        self._outstanding: list = []
        self._free: list = []
        self._max_outstanding = max_outstanding
        self._closed = False
        # a parent crash must not leak owned /dev/shm segments: unlink any
        # still-outstanding ones at interpreter exit
        import atexit

        outstanding = self._outstanding
        free = self._free

        def _cleanup(pools=(outstanding, free)):
            for segs in pools:
                for shm in segs:
                    try:
                        shm.close()
                        shm.unlink()
                    except Exception:
                        pass
                segs.clear()

        self._atexit_cleanup = _cleanup
        atexit.register(_cleanup)

    def _reap_one(self) -> None:
        line = self._proc.stdout.readline()
        if not line.startswith("ok "):
            raise RuntimeError(
                f"spyral writer child failed (rc={self._proc.poll()}): {line!r}"
            )
        name = line.split()[1]
        for i, shm in enumerate(self._outstanding):
            if shm.name == name:
                # acked segments return to the reuse pool: a fresh
                # SharedMemory per batch pays first-touch page faults on
                # both sides every batch
                self._free.append(shm)
                del self._outstanding[i]
                return
        raise RuntimeError(f"child acked unknown shm {name!r}")

    def write_packed(
        self,
        packed: np.ndarray,
        counts: np.ndarray,
        event_numbers: np.ndarray,
        raw_counts: np.ndarray | None = None,
        wiggle_seed: int = 0,
    ) -> None:
        """Ship one batch of packed [rows, 2] i32 device rows (see
        DetectorSimulator._convert_to_spyral) to the writer process; the
        child draws the per-event TB wiggle from ``wiggle_seed`` and
        finalizes the z ordering.

        ``raw_counts`` (pre-threshold merged entries per event) lets the
        child write reference-parity EMPTY datasets for events whose points
        all failed the ADC threshold (see SpyralWriter.write_spyral_batch).
        """
        import json
        from multiprocessing import shared_memory

        import time

        if self._shards is not None:
            self._route_packed(
                packed, counts, event_numbers, raw_counts, wiggle_seed
            )
            return
        if self._proc.poll() is not None:
            # surface a child crash at the next write instead of a broken
            # pipe at close
            raise RuntimeError(
                f"spyral writer child exited early (rc={self._proc.returncode})"
            )
        t0 = time.perf_counter()
        while len(self._outstanding) >= self._max_outstanding:
            self._reap_one()
        t1 = time.perf_counter()
        self._t_reap = getattr(self, "_t_reap", 0.0) + (t1 - t0)
        rows = len(packed)
        start = int(event_numbers[0])
        raw_list = (
            None
            if raw_counts is None
            else np.asarray(raw_counts, dtype=np.int64).tolist()
        )
        if rows == 0 and (raw_counts is None or int(np.sum(raw_counts)) == 0):
            # nothing to assemble and no empty events to record
            return
        need = max(rows * 8, 1)
        shm = None
        for i, seg in enumerate(self._free):
            if seg.size >= need:
                shm = seg
                del self._free[i]
                break
        if shm is None:
            # size rounded up so later (slightly larger) batches still fit
            # the pooled segment
            alloc = (need + (1 << 21) - 1) >> 21 << 21
            shm = shared_memory.SharedMemory(create=True, size=alloc)
        if rows:
            np.ndarray((rows, 2), dtype=np.int32, buffer=shm.buf)[:] = packed
        self._t_shm = getattr(self, "_t_shm", 0.0) + (time.perf_counter() - t1)
        self._outstanding.append(shm)
        msg = {
            "shm": shm.name,
            "rows": rows,
            "counts": np.asarray(counts, dtype=np.int64).tolist(),
            "raw_counts": raw_list,
            "start": start,
            "wseed": int(wiggle_seed),
        }
        self._proc.stdin.write(json.dumps(msg) + "\n")
        self._proc.stdin.flush()

    def _route_packed(
        self, packed, counts, event_numbers, raw_counts, wiggle_seed
    ) -> None:
        """Striped mode: split the batch at written-event file boundaries
        and ship each contiguous segment to the shard owning that run
        file. Mirrors ChildWriter's rotation arithmetic (events with rows
        OR a non-empty raw batch count toward rotation; raw-empty events
        are skipped), and the per-event Philox TB wiggle makes the output
        bytes invariant to how batches are split."""
        counts = np.asarray(counts, dtype=np.int64)
        raws = (
            None
            if raw_counts is None
            else np.asarray(raw_counts, dtype=np.int64)
        )
        written = counts > 0
        if raws is not None:
            written |= raws > 0
        row_off = np.concatenate([[0], np.cumsum(counts)])
        n = len(counts)
        mepf = self.max_events_per_file
        i = 0
        while i < n:
            w_rest = written[i:]
            if not w_rest.any():
                break
            file_idx = self._written_total // mepf
            cap = mepf - (self._written_total % mepf)
            wcum = np.cumsum(w_rest)
            j = i + int(np.searchsorted(wcum, cap, side="right"))
            lo, hi = int(row_off[i]), int(row_off[j])
            shard = self._shards[file_idx % len(self._shards)]
            shard.write_packed(
                packed[lo:hi],
                counts[i:j],
                event_numbers[i:j],
                raw_counts=None if raws is None else raws[i:j],
                wiggle_seed=wiggle_seed,
            )
            self._written_total += int(wcum[j - i - 1])
            i = j

    def write_spyral_pool(
        self, spyral_pool, labels_pool, counts, event_numbers
    ) -> None:  # pragma: no cover - driver prefers write_packed
        raise NotImplementedError(
            "SpyralWriterProc consumes packed rows via write_packed"
        )

    def get_directory_name(self) -> Path:
        return self.directory_path

    def close(self) -> None:
        import atexit
        import json
        import os

        if self._closed:
            return
        self._closed = True
        if self._shards is not None:
            errs = []
            for s in self._shards:
                try:
                    s.close()
                except Exception as exc:  # close every shard regardless
                    errs.append(exc)
            if errs:
                raise errs[0]
            return
        if os.environ.get("ATTPC_CHILD_TIMING"):
            import sys

            print(
                f"[writer-parent] reap={getattr(self, '_t_reap', 0.0):.2f}s "
                f"shm={getattr(self, '_t_shm', 0.0):.2f}s",
                file=sys.stderr,
            )
        try:
            while self._outstanding:
                self._reap_one()
            self._proc.stdin.write(json.dumps({"close": True}) + "\n")
            self._proc.stdin.flush()
            line = self._proc.stdout.readline()
            self._proc.stdin.close()
            self._proc.wait(timeout=120)
        finally:
            self._atexit_cleanup()
            try:
                atexit.unregister(self._atexit_cleanup)
            except Exception:
                pass
            try:
                os.unlink(self._tables_file.name)
            except OSError:
                pass
        if line.strip() != "done":
            raise RuntimeError(f"spyral writer child exited abnormally: {line!r}")
