"""Event sharding across a device mesh (the GPUs of a host).

The reference engine is single-process/serial (verified: no multiprocessing,
threading, or MPI anywhere in /root/reference/src — SURVEY.md section 2.3);
its workload is embarrassingly parallel over events. The engine's
parallelism is therefore data parallelism over the event batch:

- a 1-D mesh over all devices with axis name "events",
- every event-major array ([E, ...]) is sharded on its leading axis,
- there is no cross-event state, so the jitted programs need no collectives
  beyond what XLA inserts for the (sharded) outputs; host gathers feed the
  HDF5 writers,
- per-event RNG comes from fold_in(key, event_index), so results are
  independent of the device layout.

The cards of one host are joined all to all (NVLink on an H100 host), so
the mesh follows the algorithm alone. Multi-host runs use
``parallel/multihost.py``: one process per host, each over its own local
devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["event_mesh", "shard_events", "distributed_init", "event_sharding"]


def distributed_init(**kwargs) -> None:
    """Initialize multi-host JAX (no-op if already initialized)."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized


def event_mesh(devices: list | None = None) -> Mesh:
    """A 1-D mesh over the given (default: all) devices, axis "events"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), axis_names=("events",))


def event_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for an event-major array of rank ``ndim``: leading axis over
    the mesh, everything else replicated."""
    spec = PartitionSpec("events", *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def shard_events(mesh: Mesh, *arrays):
    """Place event-major arrays onto the mesh, sharded on the leading axis.

    Array leading dims must be divisible by the mesh size.
    """
    out = tuple(
        jax.device_put(a, event_sharding(mesh, np.ndim(a))) for a in arrays
    )
    return out if len(out) > 1 else out[0]
