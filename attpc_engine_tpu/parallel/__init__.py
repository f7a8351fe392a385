"""Device-mesh parallelism (event sharding over a mesh of GPUs)."""

from .mesh import distributed_init, event_mesh, event_sharding, shard_events
from .multihost import run_simulation_multihost

__all__ = [
    "event_mesh",
    "event_sharding",
    "shard_events",
    "distributed_init",
    "run_simulation_multihost",
]
