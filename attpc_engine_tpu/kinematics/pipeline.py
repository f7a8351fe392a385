"""The batched kinematics sampling pipeline.

Covers the reference's ``kinematics/pipeline.py``
(/root/reference/src/attpc_engine/kinematics/pipeline.py:79-495) with a
batched architecture. The reference samples one event at a time in a
Python ``while`` loop with rejection-resampling; here the *entire batch* of
events is sampled inside one jitted XLA program:

- every lane draws a full set of phase-space parameters,
- the whole reaction + decay chain is evaluated with batched 4-vector math,
- invalid lanes (energetically disallowed excitations) are redrawn by a
  bounded ``lax.while_loop`` — only not-yet-accepted lanes update, which
  preserves the reference's conditional distributions and its
  "exactly N valid events" guarantee (pipeline.py:285-319),
- the per-event ``event_sample_limit`` (default 1000, pipeline.py:132) maps
  to the loop's iteration bound; lanes still invalid at the bound raise
  ``PipelineError`` on the host, matching the reference's error semantics.

RNG is a JAX key; every batch is reproducible from (seed, batch_index).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Protocol

import jax
import jax.numpy as jnp
import numpy as np

from .reaction import Reaction, Decay, reaction_batch, decay_batch
from .excitation import ExcitationDistribution
from .angle import PolarDistribution

__all__ = [
    "KinematicsPipeline",
    "KinematicsTargetMaterial",
    "PipelineError",
    "run_kinematics_pipeline",
    "Sample",
    "CHUNK_SIZE",
]

# Reference kinematics-file chunking (pipeline.py:13)
CHUNK_SIZE: int = 1_000_000

# Number of z grid points for the beam energy-loss table
_ELOSS_TABLE_SIZE = 2048


class _EnergyLossMaterial(Protocol):
    """What the pipeline needs from a target material: the reference
    GasTarget's ``get_energy_loss`` signature (used at pipeline.py:256-263)."""

    def get_energy_loss(
        self, nucleus: Any, energy: float, distances: np.ndarray
    ) -> np.ndarray: ...


@dataclass
class KinematicsTargetMaterial:
    """Target material + vertex sampling parameters.

    Mirrors the reference dataclass (pipeline.py:16-37).

    Attributes
    ----------
    material: GasTarget
        The target material (anything with ``get_energy_loss``).
    z_range: tuple[float, float]
        Range of reaction vertices in meters; also the beam energy-loss span.
    rho_sigma: float
        Std-dev of the |N(0, sigma)| cylindrical-rho vertex distribution (m).
    """

    material: _EnergyLossMaterial
    z_range: tuple[float, float]
    rho_sigma: float


@dataclass
class Sample:
    """A batch of sampled pipeline parameters (batched analog of the
    reference's per-event ``Sample``, pipeline.py:40-70). Arrays are [n]."""

    beam_energy: jax.Array
    reaction_excitation: jax.Array
    reaction_theta: jax.Array
    reaction_phi: jax.Array
    vertex: jax.Array  # [n, 3]
    decay_excitations: list[jax.Array]
    decay_thetas: list[jax.Array]
    decay_phis: list[jax.Array]


class PipelineError(Exception):
    """Pipeline error class."""


class KinematicsPipeline:
    """The pipeline for generating kinematics data.

    Chain-validation semantics are identical to the reference
    (pipeline.py:125-183): at least one step, the first step a Reaction,
    all later steps Decays, matching list lengths, and each step's parent
    must equal the previous step's residual.

    Parameters
    ----------
    steps: list[Reaction | Decay]
        The reaction chain.
    excitations: list[ExcitationDistribution]
        Excitation distribution per step.
    polar_dists: list[PolarDistribution]
        CM polar-angle distribution per step.
    beam_energy: float
        Accelerator beam energy in MeV.
    target_material: KinematicsTargetMaterial | None
        Optional target; if present, vertices are sampled in the gas volume
        and the beam loses energy to the vertex.
    event_sample_limit: int
        Max resamples per event before raising PipelineError.
    """

    def __init__(
        self,
        steps: list[Reaction | Decay],
        excitations: list[ExcitationDistribution],
        polar_dists: list[PolarDistribution],
        beam_energy: float,
        target_material: KinematicsTargetMaterial | None = None,
        event_sample_limit: int = 1000,
    ):
        if len(steps) == 0:
            raise PipelineError("Pipeline must have at least one step (a Reaction)!")
        elif len(steps) != len(excitations):
            raise PipelineError(
                f"Pipeline must have the same number of steps (given {len(steps)})"
                f" and excitations (given {len(excitations)}!"
            )
        elif len(steps) != len(polar_dists):
            raise PipelineError(
                f"Pipeline must have the same number of steps (given {len(steps)})"
                f" and polar angle distributions (given {len(polar_dists)})!"
            )
        elif not isinstance(steps[0], Reaction):
            raise PipelineError("The first element in the pipeline must be a Reaction!")

        self.reaction: Reaction = steps[0]
        self.decays: list[Decay] = []
        self.excitations = excitations
        self.polar_dists = polar_dists
        self.event_sample_limit = event_sample_limit

        for idx in range(1, len(steps)):
            cur_step = steps[idx]
            if not isinstance(cur_step, Decay):
                raise PipelineError(
                    "All elements in the pipeline after the first element must be Decay!"
                )
            prev_step = steps[idx - 1]
            if isinstance(prev_step, Reaction):
                if (
                    prev_step.residual.isotopic_symbol
                    != cur_step.parent.isotopic_symbol
                ):
                    raise PipelineError(
                        "Broken step in pipeline! Step 0 residual does not match to Step 1 parent!"
                    )
            else:
                if (
                    prev_step.residual_2.isotopic_symbol
                    != cur_step.parent.isotopic_symbol
                ):
                    raise PipelineError(
                        f"Broken step in pipeline! Step {idx - 1} residual_2 does not"
                        f" match Step {idx} parent!"
                    )
            self.decays.append(cur_step)

        self.n_nuclei = 4 + len(self.decays) * 2
        self.beam_energy = beam_energy
        self.target_material = target_material

        # Device-resident mass constants for the chain
        self._rxn_masses = jnp.asarray(self.reaction.masses)
        self._decay_masses = [jnp.asarray(d.masses) for d in self.decays]

        # Beam energy-loss table over the vertex z span (host-precomputed,
        # device-interpolated). Replaces the per-event pycatima call of the
        # reference (pipeline.py:256-263).
        if target_material is not None:
            z_hi = max(target_material.z_range)
            z_grid = np.linspace(0.0, max(z_hi, 1e-6), _ELOSS_TABLE_SIZE)
            eloss = target_material.material.get_energy_loss(
                self.reaction.projectile, beam_energy, z_grid
            )
            self._z_grid = jnp.asarray(np.asarray(z_grid, dtype=np.float64))
            self._eloss_grid = jnp.asarray(np.asarray(eloss, dtype=np.float64))
        else:
            self._z_grid = None
            self._eloss_grid = None

        self._run_batch_jit = jax.jit(self._run_batch_impl, static_argnames=("n",))
        self._sharded_jits: dict = {}  # mesh -> sharded jit (see run_batch)
        # host-side default key for the compatibility run() API
        self._host_key = jax.random.PRNGKey(np.random.SeedSequence().entropy % (2**63))

    def __str__(self) -> str:
        chain = f"{self.reaction}"
        for decay in self.decays:
            chain += f", {str(decay)}"
        return chain

    # ------------------------------------------------------------------ #
    # sampling internals (traced)                                         #
    # ------------------------------------------------------------------ #

    def _sample(self, key: jax.Array, n: int) -> Sample:
        """Draw one full set of batched phase-space parameters."""
        n_decays = len(self.decays)
        keys = jax.random.split(key, 6 + 3 * n_decays)

        if self.target_material is not None:
            rho = jnp.abs(
                jax.random.normal(keys[0], (n,), dtype=jnp.float64)
                * self.target_material.rho_sigma
            )
            theta = jax.random.uniform(
                keys[1], (n,), dtype=jnp.float64, maxval=2.0 * jnp.pi
            )
            z = jax.random.uniform(
                keys[2],
                (n,),
                dtype=jnp.float64,
                minval=self.target_material.z_range[0],
                maxval=self.target_material.z_range[1],
            )
            vertex = jnp.stack([rho * jnp.cos(theta), rho * jnp.sin(theta), z], axis=-1)
            eloss = jnp.interp(z, self._z_grid, self._eloss_grid)
            beam_energy = self.beam_energy - eloss
        else:
            vertex = jnp.zeros((n, 3), dtype=jnp.float64)
            beam_energy = jnp.full((n,), self.beam_energy, dtype=jnp.float64)

        pi2 = 2.0 * jnp.pi
        return Sample(
            beam_energy=beam_energy,
            reaction_excitation=self.excitations[0].sample_jax(keys[3], (n,)),
            reaction_theta=self.polar_dists[0].sample_jax(keys[4], (n,)),
            reaction_phi=jax.random.uniform(
                keys[5], (n,), dtype=jnp.float64, maxval=pi2
            ),
            vertex=vertex,
            decay_excitations=[
                self.excitations[i + 1].sample_jax(keys[6 + 3 * i], (n,))
                for i in range(n_decays)
            ],
            decay_thetas=[
                self.polar_dists[i + 1].sample_jax(keys[7 + 3 * i], (n,))
                for i in range(n_decays)
            ],
            decay_phis=[
                jax.random.uniform(keys[8 + 3 * i], (n,), dtype=jnp.float64, maxval=pi2)
                for i in range(n_decays)
            ],
        )

    def _compute_chain(
        self, sample: Sample, n: int
    ) -> tuple[jax.Array, jax.Array]:
        """Evaluate the full reaction chain for a batch of samples.

        Returns (momenta [n, n_nuclei, 4], allowed [n])."""
        vectors, allowed = reaction_batch(
            self._rxn_masses,
            sample.beam_energy,
            sample.reaction_theta,
            sample.reaction_phi,
            sample.reaction_excitation,
        )
        rows = [vectors[:, 0], vectors[:, 1], vectors[:, 2], vectors[:, 3]]
        prev_resid = vectors[:, 3]
        for i, _decay in enumerate(self.decays):
            dvec, ok = decay_batch(
                self._decay_masses[i],
                prev_resid,
                sample.decay_thetas[i],
                sample.decay_phis[i],
                sample.decay_excitations[i],
            )
            allowed = allowed & ok
            rows.append(dvec[:, 0])
            rows.append(dvec[:, 1])
            prev_resid = dvec[:, 1]
        momenta = jnp.stack(rows, axis=1)
        return momenta, allowed

    def _run_batch_impl(
        self, key: jax.Array, n: int
    ) -> tuple[jax.Array, jax.Array, jax.Array]:
        """Masked rejection-resampling loop. Returns
        (vertices [n,3], momenta [n,N,4], accepted [n])."""

        def draw(key_draw):
            sample = self._sample(key_draw, n)
            momenta, allowed = self._compute_chain(sample, n)
            return sample.vertex, momenta, allowed

        k0, k1 = jax.random.split(key)
        vertices0, momenta0, accepted0 = draw(k1)
        init = (k0, accepted0, vertices0, momenta0, jnp.asarray(1, dtype=jnp.int32))

        def cond(state):
            _, accepted, _, _, iters = state
            return (~jnp.all(accepted)) & (iters < self.event_sample_limit)

        def body(state):
            key, accepted, vertices, momenta, iters = state
            key, sub = jax.random.split(key)
            v_new, m_new, ok = draw(sub)
            newly = ok & (~accepted)
            vertices = jnp.where(newly[:, None], v_new, vertices)
            momenta = jnp.where(newly[:, None, None], m_new, momenta)
            return (key, accepted | ok, vertices, momenta, iters + 1)

        _, accepted, vertices, momenta, _ = jax.lax.while_loop(cond, body, init)
        return vertices, momenta, accepted

    # ------------------------------------------------------------------ #
    # public API                                                           #
    # ------------------------------------------------------------------ #

    def _sharded_run_batch(self, mesh):
        """Jitted batch sampler with event-sharded outputs over ``mesh``.

        The sampler has no array inputs to propagate shardings from, so the
        device placement is forced through out_shardings; XLA back-propagates
        the event partitioning through the whole rejection-resampling loop
        (per-event lanes are independent by construction)."""
        cached = self._sharded_jits.get(mesh)
        if cached is None:
            from ..parallel.mesh import event_sharding

            cached = jax.jit(
                self._run_batch_impl,
                static_argnames=("n",),
                out_shardings=(
                    event_sharding(mesh, 2),
                    event_sharding(mesh, 3),
                    event_sharding(mesh, 1),
                ),
            )
            self._sharded_jits[mesh] = cached
        return cached

    def run_batch(
        self, n: int, key: jax.Array | None = None, mesh=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Sample ``n`` valid events as one jitted program.

        Parameters
        ----------
        n: int
            Number of events (static; one compilation per distinct n).
        key: jax.Array | None
            JAX PRNG key; if None, an internal host key is split off
            (non-reproducible convenience, like the reference's default_rng).
        mesh: jax.sharding.Mesh | None
            Optional device mesh: the batch is event-sharded across it
            (n must be divisible by the mesh size). Physics is independent
            of the layout (counter-based partitionable RNG).

        Returns
        -------
        (vertices, momenta)
            ``vertices``: [n, 3] float64 meters. ``momenta``: [n, N, 4]
            float64 MeV with rows ordered (target, projectile, ejectile,
            residual, d1_res1, d1_res2, ...) exactly as the reference file
            schema (pipeline.py:335-382).

        Raises
        ------
        PipelineError
            If any lane failed to produce a valid event within
            ``event_sample_limit`` samples.
        """
        if key is None:
            self._host_key, key = jax.random.split(self._host_key)
        if mesh is not None and n % mesh.size == 0:
            vertices, momenta, accepted = self._sharded_run_batch(mesh)(key, n)
        else:
            vertices, momenta, accepted = self._run_batch_jit(key, n)
        accepted = np.asarray(accepted)
        if not accepted.all():
            n_bad = int((~accepted).sum())
            raise PipelineError(
                f"Reached Sampling Limit ({self.event_sample_limit} samples) for"
                f" {n_bad} events! You may have defined an illegal reaction!"
            )
        return np.asarray(vertices), np.asarray(momenta)

    def run(self, key: jax.Array | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Single-event compatibility API (reference pipeline.py:285-388).

        Returns (vertex [3], result [N, 4]).
        """
        vertices, momenta = self.run_batch(1, key=key)
        return vertices[0], momenta[0]

    def check_excitations_allowed(
        self, projectile_energy: float, excitations: list[float]
    ) -> bool:
        """Total chain Q-value check (reference pipeline.py:200-230)."""
        q_value = (
            (self.reaction.projectile.mass + projectile_energy)
            + self.reaction.target.mass
            - (
                self.reaction.ejectile.mass
                + self.reaction.residual.mass
                + excitations[0]
            )
        )
        for idx, decay in enumerate(self.decays):
            q_value += -1.0 * (
                decay.residual_1.mass + decay.residual_2.mass + excitations[idx + 1]
            )
        return q_value >= 0.0

    def get_proton_numbers(self) -> np.ndarray:
        """Proton number per nucleus row (reference pipeline.py:390-407)."""
        z = np.empty(self.n_nuclei, dtype=int)
        z[0] = self.reaction.target.Z
        z[1] = self.reaction.projectile.Z
        z[2] = self.reaction.ejectile.Z
        z[3] = self.reaction.residual.Z
        for idx, decay in enumerate(self.decays):
            offset = idx * 2 + 4
            z[offset] = decay.residual_1.Z
            z[offset + 1] = decay.residual_2.Z
        return z

    def get_mass_numbers(self) -> np.ndarray:
        """Mass number per nucleus row (reference pipeline.py:409-426)."""
        a = np.empty(self.n_nuclei, dtype=int)
        a[0] = self.reaction.target.A
        a[1] = self.reaction.projectile.A
        a[2] = self.reaction.ejectile.A
        a[3] = self.reaction.residual.A
        for idx, decay in enumerate(self.decays):
            offset = idx * 2 + 4
            a[offset] = decay.residual_1.A
            a[offset + 1] = decay.residual_2.A
        return a


def run_kinematics_pipeline(
    pipeline: KinematicsPipeline,
    n_events: int,
    output_path: Path | str,
    batch_size: int = 65536,
    seed: int | None = None,
    schema: str = "columnar",
    show_progress: bool = True,
    use_mesh: bool = True,
) -> None:
    """Run a pipeline for ``n_events`` and write the result to HDF5.

    Batched analog of the reference driver (pipeline.py:429-495):
    events are sampled in jitted device batches and written per batch.
    When more than one device is visible (and the batch divides evenly),
    each batch is event-sharded across the device mesh; physics is
    independent of the layout (counter-based partitionable RNG).

    Parameters
    ----------
    pipeline: KinematicsPipeline
        The pipeline to run.
    n_events: int
        Number of events to sample.
    output_path: Path | str
        Output HDF5 path.
    batch_size: int
        Device batch size (one XLA program execution per batch).
    seed: int | None
        RNG seed; batches derive keys as fold_in(seed_key, batch_index), so
        any event range is reproducible.
    schema: str
        "columnar" (default): fast batched layout — datasets
        ``/data/vertices [n,3]`` and ``/data/momenta [n,N,4]`` with the same
        root attrs as the reference. "reference": bit-compatible with the
        reference's per-event dataset layout
        (/data/chunk_k/event_i, pipeline.py:449-493).
        NOTE: this engine's detector stage and converter read both schemas,
        but the REFERENCE engine's tools only read "reference" — pass
        schema="reference" for files a reference install must consume.
    use_mesh: bool
        Event-shard each batch across all visible devices (default True;
        only takes effect when > 1 device is visible and batch_size divides
        evenly).
    """
    from ..io.kinematics_file import KinematicsWriter  # local import: avoid cycle

    output_path = Path(output_path)
    batch_size = min(batch_size, n_events)
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    base_key = jax.random.PRNGKey(seed)

    writer = KinematicsWriter(
        output_path,
        n_events=n_events,
        proton_numbers=pipeline.get_proton_numbers(),
        mass_numbers=pipeline.get_mass_numbers(),
        schema=schema,
    )

    progress = None
    if show_progress:
        try:
            from tqdm import tqdm

            progress = tqdm(total=n_events, miniters=max(1, int(0.01 * n_events)))
        except ImportError:
            pass

    mesh = None
    if use_mesh and len(jax.devices()) > 1 and batch_size % len(jax.devices()) == 0:
        from ..parallel.mesh import event_mesh

        mesh = event_mesh()
    sampler = (
        pipeline._sharded_run_batch(mesh) if mesh is not None
        else pipeline._run_batch_jit
    )

    import time

    written = 0
    batch_index = 0
    pending = None  # double buffering: write batch k while k+1 computes
    wall_t0 = time.perf_counter()
    try:
        while written < n_events:
            n = min(batch_size, n_events - written)
            key = jax.random.fold_in(base_key, batch_index)
            # always sample the full batch shape (a tail-sized batch would
            # compile a fresh program); surplus lanes are dropped on write
            vertices, momenta, accepted = sampler(key, batch_size)
            if pending is not None:
                _drain_kinematics_batch(pipeline, writer, progress, pending)
            pending = (vertices, momenta, accepted, n)
            written += n
            batch_index += 1
        if pending is not None:
            _drain_kinematics_batch(pipeline, writer, progress, pending)
    finally:
        writer.close()
        if progress is not None:
            progress.close()
        from ..utils.manifest import write_run_manifest

        write_run_manifest(
            output_path,
            stage="kinematics",
            seed=seed,
            event_range=(0, n_events),
            config={
                "reaction": str(pipeline.reaction),
                "n_nuclei": pipeline.n_nuclei,
                "beam_energy": pipeline.beam_energy,
                "schema": schema,
            },
            budgets={"batch_size": batch_size},
            wall_seconds=time.perf_counter() - wall_t0,
            extra={
                "sharded_devices": mesh.size if mesh is not None else 1,
            },
        )


def _drain_kinematics_batch(pipeline, writer, progress, pending) -> None:
    vertices, momenta, accepted, n = pending
    accepted = np.asarray(accepted)[:n]
    if not accepted.all():
        n_bad = int((~accepted).sum())
        raise PipelineError(
            f"Reached Sampling Limit ({pipeline.event_sample_limit} samples)"
            f" for {n_bad} events! You may have defined an illegal reaction!"
        )
    writer.write_batch(np.asarray(vertices)[:n], np.asarray(momenta)[:n])
    if progress is not None:
        progress.update(n)
