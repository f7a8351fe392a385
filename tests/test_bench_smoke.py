"""Smoke-test the benchmark entry point on the CPU.

bench.py measures the GPU and refuses to run without one;
BENCH_PLATFORM=cpu is the explicit opt-in that runs the identical code path
(warmup with cache-miss accounting, SpyralWriterProc, timed two-stage run,
JSON line) on the CPU backend in a subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _bench_env(tmp_path, **extra):
    env = dict(os.environ)
    env.pop("BENCH_PLATFORM", None)
    env.update(
        BENCH_EVENTS="32",
        BENCH_BATCH="16",
        BENCH_OUTDIR=str(tmp_path / "out"),
        JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
        JAX_PLATFORMS="cpu",
        **extra,
    )
    (tmp_path / "out").mkdir(exist_ok=True)
    return env


def test_bench_cpu_smoke(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        env=_bench_env(tmp_path, BENCH_PLATFORM="cpu"),
        capture_output=True,
        text=True,
        timeout=900,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    # last stdout line is the one JSON metric line
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    assert result["metric"] == "full_pipeline_events_per_sec"
    assert result["value"] > 0
    assert result["unit"] == "events/s"
    # the number says which device produced it
    assert result["device"]["platform"] == "cpu"
    assert result["device"]["count"] >= 1
    assert "vs_baseline" not in result
    assert "persistent-cache misses" in proc.stderr
    # the run produced real output files through the full writer path
    clouds = tmp_path / "out" / "clouds"
    assert any(clouds.glob("run_*.h5"))


def test_bench_without_gpu_exits_nonzero(tmp_path):
    """No GPU and no explicit BENCH_PLATFORM=cpu: no number at all."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        env=_bench_env(tmp_path),
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REPO,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no GPU" in proc.stderr
