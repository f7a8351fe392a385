"""Profiling and phase timing.

The reference engine's only instrumentation is tqdm progress bars
(/root/reference/src/attpc_engine/kinematics/pipeline.py:477-478). Here we
add what a production engine needs: ``jax.profiler`` trace capture
(viewable in TensorBoard/Perfetto) and lightweight per-phase wall timing
that the drivers aggregate and report.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class PhaseTimes:
    """Accumulated wall-clock seconds per named phase."""

    seconds: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] += dt
        self.counts[name] += 1

    def summary(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"total {total:.2f}s"]
        for name, s in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {s:.2f}s ({self.counts[name]}x)")
        return "\n".join(lines)


@contextmanager
def phase_timer(times: PhaseTimes, name: str):
    """Accumulate the wall time of a block into ``times``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times.add(name, time.perf_counter() - t0)


@contextmanager
def trace_to(log_dir: str | None):
    """Capture a jax.profiler trace of the block into ``log_dir`` (no-op if
    None). View with TensorBoard or Perfetto."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
