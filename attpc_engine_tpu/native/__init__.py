"""Native (C++) acceleration components.

``libstopping.so`` is the stopping-power/range table generator (the slot
pycatima occupies in the reference's stack). ``libspyral_io.so`` is the
Spyral writer hot path — bit-exact Philox TB wiggle + per-event z-sort +
[n, 8] f64 assembly, and per-event HDF5 dataset writes through libhdf5's
C API (dlopen'd from h5py's bundled shared object) — used by both the
out-of-process writer child (io/spyral_child.py) and the in-process
assembly (detector/simulator.py), where every microsecond of writer CPU
is end-to-end throughput.

Both are loaded lazily via ctypes; if a shared object is missing it is
built from ``native/*.cpp`` with g++ when available, and the pure-Python
implementations are the fallback either way. Set ``ATTPC_TPU_NO_NATIVE=1``
to force the Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False
_SIO = None
_SIO_TRIED = False


def _build_if_possible(so_path: Path, source: str = "stopping.cpp") -> bool:
    src = Path(__file__).resolve().parents[2] / "native" / source
    if not src.exists():
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", str(so_path), str(src), "-ldl"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return so_path.exists()
    except (OSError, subprocess.SubprocessError):
        return False


def hdf5_bundle() -> tuple[str | None, list[str]]:
    """(libhdf5 path, dependency .so paths) from h5py's wheel.

    h5py's auditwheel-repaired libhdf5 carries no RPATH for its private
    compression deps (libaec/libsz), so they must be dlopen'd RTLD_GLOBAL
    before libhdf5 itself.
    """
    import glob

    try:
        import h5py

        base = Path(h5py.__file__).resolve().parent.parent / "h5py.libs"
    except Exception:
        return None, []
    libs = sorted(glob.glob(str(base / "*.so*")))
    main = [p for p in libs if Path(p).name.startswith("libhdf5-")]
    deps = [p for p in libs if "hdf5" not in Path(p).name]
    return (main[0] if main else None), deps


def configure_spyral_io(lib: "ctypes.CDLL") -> None:
    """Set ctypes signatures on a loaded libspyral_io handle (shared with
    the standalone loader in io/spyral_child.py)."""
    d = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sio_wiggle.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64, d
    ]
    lib.sio_wiggle.restype = None
    lib.sio_assemble_batch.argtypes = [
        i32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, d, d, d, d, d, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, d, i64p,
    ]
    lib.sio_assemble_batch.restype = None
    lib.sio_h5_init.argtypes = [ctypes.c_char_p]
    lib.sio_h5_init.restype = ctypes.c_int
    lib.sio_h5_open.argtypes = [ctypes.c_char_p]
    lib.sio_h5_open.restype = ctypes.c_void_p
    lib.sio_h5_write_event.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, d, ctypes.c_int64,
        i64p,
    ]
    lib.sio_h5_write_event.restype = ctypes.c_int
    lib.sio_h5_write_events.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ctypes.c_int64, d, i64p,
    ]
    lib.sio_h5_write_events.restype = ctypes.c_int64
    lib.sio_h5_close.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64
    ]
    lib.sio_h5_close.restype = ctypes.c_int
    lib.sio_h5_mem_available.argtypes = []
    lib.sio_h5_mem_available.restype = ctypes.c_int
    lib.sio_h5_open_mem.argtypes = []
    lib.sio_h5_open_mem.restype = ctypes.c_void_p
    lib.sio_h5_close_mem.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p
    ]
    lib.sio_h5_close_mem.restype = ctypes.c_int
    lib.sio_h5_mem_prewarm.argtypes = []
    lib.sio_h5_mem_prewarm.restype = None


def get_spyral_io_lib(with_h5: bool = False):
    """The configured ctypes handle to libspyral_io, or None.

    ``with_h5=True`` additionally requires the dlopen'd-libhdf5 writer to
    have initialized (pure assembly/wiggle use works without it).
    """
    global _SIO, _SIO_TRIED
    if not _SIO_TRIED:
        _SIO_TRIED = True
        if os.environ.get("ATTPC_TPU_NO_NATIVE"):
            return None
        so_path = Path(__file__).parent / "libspyral_io.so"
        if so_path.exists() or _build_if_possible(so_path, "spyral_io.cpp"):
            try:
                lib = ctypes.CDLL(str(so_path))
                configure_spyral_io(lib)
                h5path, deps = hdf5_bundle()
                if h5path is not None:
                    for p in deps:
                        ctypes.CDLL(p, mode=ctypes.RTLD_GLOBAL)
                    lib._h5_ready = lib.sio_h5_init(h5path.encode()) == 0
                else:
                    lib._h5_ready = False
                _SIO = lib
            except OSError:
                _SIO = None
    if _SIO is not None and with_h5 and not _SIO._h5_ready:
        return None
    return _SIO


def native_assemble_batch(
    packed: np.ndarray,
    counts: np.ndarray,
    start_event: int,
    wiggle_seed: int,
    tables: dict,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Packed device rows -> (spyral [n, 8] f64, labels i64), per-event
    z-sorted — the C twin of the wiggle+sort+assemble pipeline in
    DetectorSimulator.assemble_spyral_ordered (bit-exact, see
    tests/test_native.py). Returns None if the native lib is unavailable.

    ``tables`` needs: pad_cx, pad_cy, pad_sizes, resp_asc, resp_prefix
    (all f64 contiguous), resp_max, windows_edge, micromegas_edge, length.
    """
    lib = get_spyral_io_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    rows = int(counts.sum())
    out_spyral = np.empty((rows, 8), dtype=np.float64)
    out_labels = np.empty(rows, dtype=np.int64)
    d = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sio_assemble_batch(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows,
        counts.ctypes.data_as(i64p),
        len(counts),
        int(start_event),
        int(wiggle_seed) & 0xFFFFFFFFFFFFFFFF,
        tables["pad_cx"].ctypes.data_as(d),
        tables["pad_cy"].ctypes.data_as(d),
        tables["pad_sizes"].ctypes.data_as(d),
        tables["resp_asc"].ctypes.data_as(d),
        tables["resp_prefix"].ctypes.data_as(d),
        len(tables["resp_asc"]),
        float(tables["resp_max"]),
        float(tables["windows_edge"]),
        float(tables["micromegas_edge"]),
        float(tables["length"]),
        out_spyral.ctypes.data_as(d),
        out_labels.ctypes.data_as(i64p),
    )
    return out_spyral, out_labels


def get_stopping_lib():
    """The ctypes handle to libstopping, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("ATTPC_TPU_NO_NATIVE"):
        return None
    so_path = Path(__file__).parent / "libstopping.so"
    if not so_path.exists() and not _build_if_possible(so_path):
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    d = ctypes.POINTER(ctypes.c_double)
    lib.mass_stopping_power.argtypes = [
        ctypes.c_int, ctypes.c_double, d, ctypes.c_int,
        d, d, d, ctypes.c_int, ctypes.c_double, d,
    ]
    lib.mass_stopping_power.restype = None
    lib.csda_range.argtypes = [d, d, ctypes.c_int, d]
    lib.csda_range.restype = None
    _LIB = lib
    return _LIB


def native_mass_stopping_power(
    z_proj: int,
    mass_mev: float,
    ke_mev: np.ndarray,
    constituents: list[tuple[int, int, float]],
    i_override_ev: float | None = None,
) -> np.ndarray | None:
    """C++ stopping power; returns None if the native lib is unavailable."""
    lib = get_stopping_lib()
    if lib is None:
        return None
    ke = np.ascontiguousarray(np.atleast_1d(ke_mev), dtype=np.float64)
    z_t = np.ascontiguousarray([c[0] for c in constituents], dtype=np.float64)
    a_t = np.ascontiguousarray([c[1] for c in constituents], dtype=np.float64)
    w_t = np.ascontiguousarray([c[2] for c in constituents], dtype=np.float64)
    out = np.empty_like(ke)
    d = ctypes.POINTER(ctypes.c_double)
    lib.mass_stopping_power(
        int(z_proj), float(mass_mev),
        ke.ctypes.data_as(d), len(ke),
        z_t.ctypes.data_as(d), a_t.ctypes.data_as(d), w_t.ctypes.data_as(d),
        len(constituents),
        float(i_override_ev or 0.0),
        out.ctypes.data_as(d),
    )
    return out.reshape(np.shape(ke_mev))
