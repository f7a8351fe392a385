"""Lowering of the GPU programs for CUDA, on the CPU host.

``jax.export.export(..., platforms=["cuda"])`` runs JAX's whole lowering
to StableHLO for the CUDA platform host-side, with no device: the detector
step (with the Pallas transport kernel, as the engine runs it on a GPU),
the kinematics sampler and the Triton transport kernel alone. A Pallas
Triton kernel lowers to a ``__gpu$xla.gpu.triton`` custom call, which
export refuses by default because its serialized form is not stable
across JAX versions; these tests disable that one check.

What this cannot show is what only the card shows: the GPU compiler's
verdict (registers, shared memory), device memory, numerics and speed.
``python chip_smoke.py`` checks those on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from attpc_engine_tpu import nuclear_map
from attpc_engine_tpu.detector.simulator import DetectorSimulator
from attpc_engine_tpu.detector.transport import TrackSpecies
from attpc_engine_tpu.detector.transport_pallas import (
    integrate_tracks_pallas,
    integrate_tracks_pallas_chunked,
)
from attpc_engine_tpu.kinematics import (
    Decay,
    ExcitationGaussian,
    KinematicsPipeline,
    PolarUniform,
    Reaction,
)
from __graft_entry__ import _tiny_setup

TRITON = jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")


def _export_cuda(fn, *args):
    exp = jax.export.export(
        jax.jit(fn), platforms=["cuda"], disabled_checks=[TRITON]
    )(*args)
    assert exp.platforms == ("cuda",)
    assert len(exp.mlir_module_serialized) > 0
    return exp.mlir_module()


def _decay_chain_pipeline():
    """10B(3He,4He)9B*, 9B* -> 4He + 5Li: three charged exit tracks."""
    return KinematicsPipeline(
        [
            Reaction(
                target=nuclear_map.get_data(5, 10),
                projectile=nuclear_map.get_data(2, 3),
                ejectile=nuclear_map.get_data(2, 4),
            ),
            Decay(
                parent=nuclear_map.get_data(5, 9),
                residual_1=nuclear_map.get_data(2, 4),
            ),
        ],
        [ExcitationGaussian(16.8, 0.2), ExcitationGaussian(0.0, 0.0)],
        [PolarUniform(0.0, np.pi)] * 2,
        24.0,
    )


def _vg(sim, e):
    """A [E, 3 + K*3] f32 input of the step's shape (values irrelevant
    to lowering)."""
    return np.zeros((e, 3 + 3 * sim.k_tracks), np.float32)


# (events, point_budget, uniq_budget, out_budget, n_steps, chunk_steps)
SHAPES = [
    (4, 128, 1024, 1024, 250, 250),  # one kernel launch per window
    (8, 256, 2048, 2048, 500, 250),  # chunked window, early exit
    (384, 576, 12288, 4096, 500, 500),  # the tuned flagship batch
]


@pytest.mark.parametrize("chain", ["flagship", "decay_chain"])
@pytest.mark.parametrize("shape", SHAPES, ids=["single", "chunked", "flagship"])
def test_detector_step_lowers_for_cuda(chain, shape):
    e, pb, ub, ob, steps, chunk = shape
    pipeline, sim = _tiny_setup(events_per_batch=e)
    if chain == "decay_chain":
        pipeline = _decay_chain_pipeline()
    engine = dataclasses.replace(
        sim.engine, n_time_steps=steps, chunk_steps=chunk,
        events_per_batch=e, pallas_transport=True,
    )
    sim = DetectorSimulator(
        sim.config, pipeline.get_proton_numbers(), pipeline.get_mass_numbers(),
        engine=engine,
    )
    assert sim.k_tracks == (2 if chain == "flagship" else 3)

    def step(key, vg):
        out = sim._simulate_impl(
            key, vg, e, point_budget=pb, uniq_budget=ub, out_budget=ob,
            n_steps=steps,
        )
        return out["packed"], out["meta_i32"]

    text = _export_cuda(step, jax.random.PRNGKey(0), _vg(sim, e))
    assert "xla.gpu.triton" in text  # the transport kernel is in the step


@pytest.mark.parametrize("chain", ["flagship", "decay_chain"])
def test_kinematics_sampler_lowers_for_cuda(chain):
    pipeline, _ = _tiny_setup(events_per_batch=4)
    if chain == "decay_chain":
        pipeline = _decay_chain_pipeline()

    def sample(key):
        return pipeline._run_batch_jit(key, 64)

    text = _export_cuda(sample, jax.random.PRNGKey(0))
    assert "f64" in text  # kinematics stay double precision on the GPU


def _species():
    return TrackSpecies(
        mass=jnp.array([938.0, 11175.0], dtype=jnp.float32),
        charge=jnp.array([1.0, 6.0], dtype=jnp.float32),
        log_ke_lo=-3.0,
        dlog_ke=0.05,
        dedx=jnp.ones((2, 64), dtype=jnp.float32),
    )


@pytest.mark.parametrize("chunked", [False, True], ids=["single", "chunked"])
def test_transport_kernel_lowers_for_cuda(chunked):
    b = 100  # not a multiple of the block: the wrapper pads
    kw = dict(density=1e-4, bfield=2.85, efield=45000.0)

    def run(pos, gv, sidx):
        if chunked:
            return integrate_tracks_pallas_chunked(
                pos, gv, sidx, _species(), n_steps=64, chunk_steps=16, **kw
            )
        return integrate_tracks_pallas(
            pos, gv, sidx, _species(), n_steps=32, **kw
        )

    text = _export_cuda(
        run,
        jnp.zeros((b, 3), jnp.float32),
        jnp.full((b, 3), 0.1, jnp.float32),
        jnp.zeros((b,), jnp.int32),
    )
    assert text.count("xla.gpu.triton") >= 1
