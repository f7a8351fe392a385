"""The shipped examples must actually run: stage 1 -> stage 2 end to end.

Runs examples/generate_kinematics.py then examples/apply_detector.py as
real subprocesses in a temp cwd with EXAMPLE_EVENTS shrunk for CI, and
checks the stage-2 output is a valid Spyral file (mirrors the
reference's getting-started workflow, /root/reference/docs).
"""

import glob
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.slow
def test_examples_end_to_end(tmp_path):
    env = dict(
        os.environ,
        EXAMPLE_EVENTS="64",
        PYTHONPATH=str(ROOT),
        JAX_PLATFORMS="",  # conftest's CPU pin doesn't reach subprocesses
    )
    # force CPU inside the subprocess through the config API, via a
    # sitecustomize shim
    shim = tmp_path / "sitecustomize.py"
    shim.write_text(
        "import jax\njax.config.update('jax_platforms', 'cpu')\n"
    )
    env["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{ROOT}"

    for script in ("generate_kinematics.py", "apply_detector.py"):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script)],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=900,
        )
        assert proc.returncode == 0, (script, proc.stdout[-2000:],
                                      proc.stderr[-2000:])

    kine = list(tmp_path.glob("output/kinematics/*.h5"))
    assert len(kine) == 1
    runs = sorted(glob.glob(str(tmp_path / "output/clouds/run_*.h5")))
    assert runs, "no Spyral output written"
    with h5py.File(runs[0]) as f:
        g = f["cloud"]
        clouds = [k for k in g if k.startswith("cloud_")]
        assert clouds
        a = np.asarray(g[clouds[0]])
        assert a.ndim == 2 and a.shape[1] == 8
