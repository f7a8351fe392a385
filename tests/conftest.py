"""Test configuration: run on a virtual 8-device CPU mesh.

Tests never need an accelerator; multi-device sharding is exercised via
XLA's host-platform device-count flag. The platform is pinned to the CPU
through the config API before any test imports jax-heavy modules.

Tests that need a GPU carry the ``gpu`` marker and skip here through the
``gpu_device`` fixture; ``python chip_smoke.py`` runs the same checks on
the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import time."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    return devices[0]


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Route the engine's Pallas transport kernel through the Pallas
    interpreter, so the kernel path of the engine runs on the CPU. The
    engine itself never chooses interpret mode."""
    from functools import partial

    from attpc_engine_tpu.detector import transport_pallas as tp

    for name in ("integrate_tracks_pallas", "integrate_tracks_pallas_chunked"):
        monkeypatch.setattr(tp, name, partial(getattr(tp, name), interpret=True))
