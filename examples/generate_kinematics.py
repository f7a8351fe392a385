"""Example stage-1 script: sample reaction kinematics to HDF5.

Simulates 16C(d,d')16C* inverse-kinematics elastic/inelastic scattering at
184.131 MeV in a D2 gas target, the workflow of the upstream engine's
getting-started guide, at batched-engine scale.
"""

import os
from pathlib import Path

import numpy as np

from attpc_engine_tpu import nuclear_map
from attpc_engine_tpu.nuclear import GasTarget
from attpc_engine_tpu.kinematics import (
    KinematicsPipeline,
    KinematicsTargetMaterial,
    ExcitationGaussian,
    PolarUniform,
    Reaction,
    run_kinematics_pipeline,
)

output_path = Path("./output/kinematics/c16dd_d2_300Torr_184MeV.h5")
output_path.parent.mkdir(parents=True, exist_ok=True)

target = GasTarget([(1, 2, 2)], 300.0, nuclear_map)  # D2 at 300 Torr

nevents = int(os.environ.get("EXAMPLE_EVENTS", 100_000))
beam_energy = 184.131  # MeV

pipeline = KinematicsPipeline(
    [
        Reaction(
            target=nuclear_map.get_data(1, 2),  # deuteron
            projectile=nuclear_map.get_data(6, 16),  # 16C
            ejectile=nuclear_map.get_data(1, 2),  # deuteron
        )
    ],
    [ExcitationGaussian(0.0, 0.001)],
    [PolarUniform(0.0, np.pi)],
    beam_energy=beam_energy,
    target_material=KinematicsTargetMaterial(
        material=target, z_range=(0.0, 1.0), rho_sigma=0.007
    ),
)

if __name__ == "__main__":
    # schema="reference" writes the upstream per-event dataset layout, so a
    # reference attpc_engine install (and its convert-kinematics tooling)
    # can read this file directly. For large runs that only this engine
    # consumes, schema="columnar" (the faster batched layout) is better.
    run_kinematics_pipeline(
        pipeline, nevents, output_path, seed=1234, schema="reference"
    )
