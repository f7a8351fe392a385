"""Entry points, compile cache and process rules, on the CPU.

- ``chip_smoke.py`` never reports a result without a GPU, and its phases
  run here at tiny sizes (the transport kernel interpreted);
- the compile cache follows ``JAX_COMPILATION_CACHE_DIR`` or one fixed
  path inside the checkout;
- the writer child and the recycle pruner never import JAX, so they never
  open the card;
- the engine never picks interpret mode by itself.
"""

from __future__ import annotations

import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _cpu_env(**extra):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_chip_smoke_without_gpu_exits_nonzero(tmp_path):
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)),
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr
    # the device report came first
    assert "[phase 0]" in proc.stdout


def test_chip_smoke_alone_in_a_directory_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=env, capture_output=True,
        text=True, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_CACHE_PROBE = (
    "import jax; from attpc_engine_tpu.utils.compile_cache import "
    "configure_compile_cache as c; d = c(); "
    "print(d); print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_honours_env(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE],
        env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c")),
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    returned, configured = proc.stdout.split()
    assert returned == configured == str(tmp_path / "c")


def test_compile_cache_default_is_fixed_path_in_checkout():
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env,
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    returned, configured = proc.stdout.split()
    assert returned == configured == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text()


def _imported_modules(source: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if node.level == 0
                      else ".")
    return names


def test_writer_child_imports_no_jax():
    """The writer child is a second process beside the one that owns the
    card: anything importing JAX there could reserve device memory."""
    path = REPO / "attpc_engine_tpu" / "io" / "spyral_child.py"
    mods = _imported_modules(path.read_text())
    assert not mods & {"jax", "jaxlib", "attpc_engine_tpu", "."}, mods
    # and loading it as the child does pulls in no JAX either
    probe = (
        "import runpy, sys; runpy.run_path(sys.argv[1], run_name='probe'); "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'attpc_engine_tpu')))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe, str(path)], capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_recycle_pruner_imports_no_jax():
    from attpc_engine_tpu.io import recycle

    assert _imported_modules(recycle._PRUNER_CODE) <= {"sys", "time", "pathlib"}
    assert not _imported_modules(inspect.getsource(recycle)) & {"jax", "jaxlib"}


def test_engine_never_selects_interpret_mode(monkeypatch):
    """Only a caller passing interpret=True gets the interpreter: the
    kernels default to compiling, and the simulator calls them without
    the argument (here the kernel entry points are replaced by recorders
    that run the scan instead)."""
    import dataclasses

    from attpc_engine_tpu.detector import transport_pallas as tp
    from attpc_engine_tpu.detector.simulator import DetectorSimulator
    from attpc_engine_tpu.detector.transport import integrate_tracks
    from __graft_entry__ import _tiny_setup

    for fn in (tp.integrate_tracks_pallas, tp.integrate_tracks_pallas_chunked):
        sig = inspect.signature(getattr(fn, "__wrapped__", fn))
        assert sig.parameters["interpret"].default is False
    for path in (REPO / "attpc_engine_tpu").rglob("*.py"):
        text = path.read_text()
        assert "default_backend() !=" not in text, path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.keyword) and node.arg == "interpret":
                # only the kernel wrappers forward the caller's choice
                assert isinstance(node.value, ast.Name), (path, node.lineno)

    calls = []

    def recorder(*args, **kwargs):
        calls.append(kwargs)
        kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("interpret", "block_tracks")}
        kwargs.setdefault("chunk_steps", kwargs["n_steps"])
        return integrate_tracks(*args, **kwargs)

    monkeypatch.setattr(tp, "integrate_tracks_pallas", recorder)
    monkeypatch.setattr(tp, "integrate_tracks_pallas_chunked", recorder)
    pipeline, sim = _tiny_setup(events_per_batch=2, n_time_steps=500)
    sim = DetectorSimulator(
        sim.config, pipeline.get_proton_numbers(), pipeline.get_mass_numbers(),
        engine=dataclasses.replace(sim.engine, pallas_transport=True),
    )
    vertices, momenta = pipeline.run_batch(2, key=jax.random.PRNGKey(0))
    sim.simulate_batch(jax.random.PRNGKey(1), vertices, momenta,
                       assemble=False, n_steps=250)
    sim.simulate_batch(jax.random.PRNGKey(1), vertices, momenta,
                       assemble=False, n_steps=500)
    assert len(calls) == 2
    assert all("interpret" not in kw for kw in calls)


# ---- chip_smoke's phases at tiny sizes (the card runs them full size) --


def test_smoke_main_path_validates_clouds():
    facts = chip_smoke.phase_main_path(n_events=16, events_per_batch=16)
    assert facts["events"] == 16
    assert facts["events_with_clouds"] > 0 and facts["rows"] > 0
    assert set(facts["tuned_budgets"]) >= {"point", "uniq", "out", "steps"}


def test_smoke_validate_clouds_rejects_bad_rows():
    good = np.zeros((3, 8))
    good[:, 2] = [1.0, 2.0, 3.0]
    good[:, 3] = 100.0
    chip_smoke.validate_clouds({0: (good, np.zeros(3))}, 40.0)
    bad_z = good.copy()
    bad_z[:, 2] = [3.0, 2.0, 1.0]
    bad_amp = good.copy()
    bad_amp[0, 3] = 5000.0
    for bad, labels in ((bad_z, np.zeros(3)), (bad_amp, np.zeros(3)),
                        (good, np.zeros(2))):
        with pytest.raises(AssertionError):
            chip_smoke.validate_clouds({0: (bad, labels)}, 40.0)


def test_smoke_transport_kernel_phase_interpreted():
    res = chip_smoke.phase_transport_kernel(
        n_events=4, windows=((64, 64), (96, 32)), interpret=True,
        time_it=False,
    )
    assert [r["n_steps"] for r in res] == [64, 96]
    assert all(r["max_dpos_m"] < chip_smoke.KERNEL_POS_TOL_M for r in res)


def test_smoke_cpu_reference_phase():
    res = chip_smoke.phase_cpu_reference(n_kine=8, n_det=4, n_steps=250)
    assert res["kinematics_max_rel"] <= chip_smoke.KINEMATICS_RTOL
    assert res["min_overlap"] >= chip_smoke.STEP_MIN_OVERLAP


def test_smoke_sharded_phase_on_virtual_devices():
    res = chip_smoke.phase_sharded(
        jax.devices()[:4], n_events=16, events_per_batch=8
    )
    assert res["devices"] == 4
    assert res["max_row_count_diff"] <= 2
