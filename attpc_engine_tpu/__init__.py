"""attpc_engine_tpu: a batched JAX Monte-Carlo simulation engine for the AT-TPC.

A ground-up JAX/XLA/Pallas re-design of the capability set of
``attpc_engine`` (reference engine studied at /root/reference): a two-stage
pipeline of (1) batched relativistic reaction/decay kinematics sampling and
(2) charged-particle transport + detector response, producing
Spyral-compatible point-cloud HDF5 files.

Everything event-scoped is batched: events live in event-major device arrays
and the full physics runs as a handful of jitted XLA programs, optionally
sharded over a mesh of GPUs.

Note: this package enables JAX 64-bit mode at import. Relativistic
kinematics at MeV precision against ~GeV masses requires f64 (verified:
catastrophic cancellation in f32 produces keV-scale errors). The detector
hot path explicitly pins float32.
"""

import jax

jax.config.update("jax_enable_x64", True)

from .nuclear.masses import NuclearDataMap, NucleusData  # noqa: E402

# Global nuclide lookup singleton, mirroring the reference's package-level
# `nuclear_map` (/root/reference/src/attpc_engine/__init__.py:1-3).
nuclear_map = NuclearDataMap()

__version__ = "0.1.0"

__all__ = ["nuclear_map", "NuclearDataMap", "NucleusData", "__version__"]
