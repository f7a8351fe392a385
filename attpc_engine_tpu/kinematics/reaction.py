"""Two-body reaction and decay kinematics.

Covers the capability of the reference's ``kinematics/reaction.py``
(/root/reference/src/attpc_engine/kinematics/reaction.py:8-303) with a
batched architecture: the physics lives in *batched, jittable* pure
functions over ``[n]``-shaped phase-space parameter arrays; the ``Reaction``
and ``Decay`` classes are thin host-side metadata holders (species,
validation, symbols) that also offer the reference's scalar ``calculate``
convenience API.

All kinematics runs in float64: MeV-scale precision against ~GeV masses is
unattainable in f32 (catastrophic cancellation). The CM energy is computed
via the cancellation-free invariant form  e_cm^2 = mt^2 + mp^2 + 2 mt (mp+T).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import nuclear_map
from ..nuclear.masses import NucleusData

__all__ = ["Reaction", "Decay", "FourVector", "reaction_batch", "decay_batch"]


class FourVector:
    """A minimal momentum 4-vector for the scalar convenience API.

    Mirrors the pieces of the ``vector`` package API the reference exposes to
    users (``.px .py .pz .E .M``; reference usage at
    /root/reference/tests/test_kinematics.py:31).
    """

    __slots__ = ("px", "py", "pz", "E")

    def __init__(self, px: float, py: float, pz: float, E: float):
        self.px = float(px)
        self.py = float(py)
        self.pz = float(pz)
        self.E = float(E)

    @property
    def M(self) -> float:
        """Invariant mass."""
        p2 = self.px**2 + self.py**2 + self.pz**2
        return float(np.sqrt(max(self.E**2 - p2, 0.0)))

    @property
    def momentum(self) -> float:
        return float(np.sqrt(self.px**2 + self.py**2 + self.pz**2))

    def as_array(self) -> np.ndarray:
        return np.array([self.px, self.py, self.pz, self.E])

    def __repr__(self) -> str:
        return f"FourVector(px={self.px}, py={self.py}, pz={self.pz}, E={self.E})"


def _boost_from_cm(p_cm: jnp.ndarray, parent: jnp.ndarray) -> jnp.ndarray:
    """Boost 4-vectors from the CM frame of ``parent`` to the lab frame.

    Parameters
    ----------
    p_cm: jnp.ndarray
        ``[..., 4]`` four-vectors (px, py, pz, E) in the parent CM frame.
    parent: jnp.ndarray
        ``[..., 4]`` parent four-vector in the lab frame.

    Returns
    -------
    jnp.ndarray
        ``[..., 4]`` boosted four-vectors in the lab frame.
    """
    pe = parent[..., 3:4]
    pvec = parent[..., :3]
    m = jnp.sqrt(jnp.maximum(pe**2 - jnp.sum(pvec**2, axis=-1, keepdims=True), 0.0))
    # beta and gamma of the parent in the lab
    beta = pvec / pe  # [..., 3]
    gamma = pe / m
    b2 = jnp.sum(beta**2, axis=-1, keepdims=True)
    e_cm = p_cm[..., 3:4]
    v_cm = p_cm[..., :3]
    bp = jnp.sum(v_cm * beta, axis=-1, keepdims=True)
    # Safe divide for beta ~ 0 (parent at rest): (gamma-1)/b2 -> gamma^2/(gamma+1)
    coef = jnp.where(b2 > 0.0, (gamma - 1.0) / jnp.where(b2 > 0.0, b2, 1.0), 0.0)
    v_lab = v_cm + beta * (coef * bp + gamma * e_cm)
    e_lab = gamma * (e_cm + bp)
    return jnp.concatenate([v_lab, e_lab], axis=-1)


def reaction_batch(
    masses: jnp.ndarray,
    projectile_energy: jnp.ndarray,
    ejectile_polar: jnp.ndarray,
    ejectile_azimuthal: jnp.ndarray,
    residual_excitation: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched two-body reaction a(b,c)d kinematics (pure, jittable, f64).

    Semantics match the reference scalar implementation
    (/root/reference/src/attpc_engine/kinematics/reaction.py:103-178): the
    ejectile is emitted at the sampled CM angles, the residual carries the
    excitation energy, and both are boosted back to the lab.

    Parameters
    ----------
    masses: jnp.ndarray
        ``[4]`` rest masses (target, projectile, ejectile, residual) in MeV.
    projectile_energy, ejectile_polar, ejectile_azimuthal, residual_excitation:
        ``[n]`` phase-space parameter arrays.

    Returns
    -------
    (vectors, allowed)
        ``vectors``: ``[n, 4, 4]`` lab four-vectors, rows (target, projectile,
        ejectile, residual), columns (px, py, pz, E).
        ``allowed``: ``[n]`` bool — energetically allowed
        (reference `is_excitation_allowed`, reaction.py:70-101). Disallowed
        lanes contain garbage (not NaN) vectors and must be masked by the
        caller.
    """
    mt, mp, me, mr = masses[0], masses[1], masses[2], masses[3]
    t = projectile_energy
    n = t.shape[0]

    pz_proj = jnp.sqrt(t * (t + 2.0 * mp))
    # Invariant CM energy, cancellation-free form
    e_cm = jnp.sqrt(mt * mt + mp * mp + 2.0 * mt * (mp + t))
    mr_ex = mr + residual_excitation
    allowed = (me + mr_ex) < e_cm

    # CM-frame ejectile energy/momentum (guard sqrt for disallowed lanes)
    e_eject_cm = (me * me - mr_ex * mr_ex + e_cm * e_cm) / (2.0 * e_cm)
    p_eject = jnp.sqrt(jnp.maximum(e_eject_cm * e_eject_cm - me * me, 0.0))

    sin_th = jnp.sin(ejectile_polar)
    eject_cm = jnp.stack(
        [
            p_eject * sin_th * jnp.cos(ejectile_azimuthal),
            p_eject * sin_th * jnp.sin(ejectile_azimuthal),
            p_eject * jnp.cos(ejectile_polar),
            e_eject_cm,
        ],
        axis=-1,
    )

    zeros = jnp.zeros_like(t)
    target_vec = jnp.stack([zeros, zeros, zeros, jnp.full((n,), mt, t.dtype)], axis=-1)
    proj_vec = jnp.stack([zeros, zeros, pz_proj, t + mp], axis=-1)
    parent = target_vec + proj_vec

    eject_vec = _boost_from_cm(eject_cm, parent)
    resid_vec = parent - eject_vec

    vectors = jnp.stack([target_vec, proj_vec, eject_vec, resid_vec], axis=1)
    return vectors, allowed


def decay_batch(
    masses: jnp.ndarray,
    parent_vector: jnp.ndarray,
    residual_1_polar: jnp.ndarray,
    residual_1_azimuthal: jnp.ndarray,
    residual_2_excitation: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched two-body decay a -> b + c kinematics (pure, jittable, f64).

    Matches reference ``Decay.calculate`` / ``is_excitation_allowed``
    (/root/reference/src/attpc_engine/kinematics/reaction.py:230-303).

    Parameters
    ----------
    masses: jnp.ndarray
        ``[2]`` rest masses (residual_1, residual_2) in MeV.
    parent_vector: jnp.ndarray
        ``[n, 4]`` parent lab four-vectors.
    residual_1_polar, residual_1_azimuthal, residual_2_excitation:
        ``[n]`` phase-space parameters (angles in the parent CM frame).

    Returns
    -------
    (vectors, allowed)
        ``vectors``: ``[n, 2, 4]`` lab four-vectors (residual_1, residual_2).
        ``allowed``: ``[n]`` bool (q_value > 0).
    """
    m1, m2 = masses[0], masses[1]
    pe = parent_vector[..., 3]
    p2 = jnp.sum(parent_vector[..., :3] ** 2, axis=-1)
    parent_mass = jnp.sqrt(jnp.maximum(pe * pe - p2, 0.0))

    m2_ex = m2 + residual_2_excitation
    allowed = (parent_mass - (m1 + m2_ex)) > 0.0

    e1_cm = (m1 * m1 - m2_ex * m2_ex + parent_mass * parent_mass) / (2.0 * parent_mass)
    p1_cm = jnp.sqrt(jnp.maximum(e1_cm * e1_cm - m1 * m1, 0.0))

    sin_th = jnp.sin(residual_1_polar)
    r1_cm = jnp.stack(
        [
            p1_cm * sin_th * jnp.cos(residual_1_azimuthal),
            p1_cm * sin_th * jnp.sin(residual_1_azimuthal),
            p1_cm * jnp.cos(residual_1_polar),
            e1_cm,
        ],
        axis=-1,
    )
    r1_vec = _boost_from_cm(r1_cm, parent_vector)
    r2_vec = parent_vector - r1_vec
    vectors = jnp.stack([r1_vec, r2_vec], axis=1)
    return vectors, allowed


class Reaction:
    """A two-body reaction a(b,c)d.

    Host-side metadata (species + residual inference by Z/A conservation,
    matching reference semantics at reaction.py:35-58) plus scalar and
    batched calculation entry points.

    Parameters
    ----------
    target, projectile, ejectile: NucleusData
        The participating nuclei. The residual is inferred.
    """

    def __init__(
        self,
        target: NucleusData,
        projectile: NucleusData,
        ejectile: NucleusData,
    ):
        self.target = target
        self.projectile = projectile
        self.ejectile = ejectile
        resid_z = projectile.Z + target.Z - ejectile.Z
        resid_a = projectile.A + target.A - ejectile.A
        if resid_z < 0:
            raise ValueError(
                "Reaction calculated a residual Z (proton number) < 0, illegal reaction!"
            )
        if resid_a < 0:
            raise ValueError(
                "Reaction calculated a residual A (mass number) < 0, illegal reaction!"
            )
        self.residual = nuclear_map.get_data(resid_z, resid_a)
        self.reaction_symbol = (
            f"{self.target}({self.projectile},{self.ejectile}){self.residual}"
        )

    def __str__(self) -> str:
        return self.reaction_symbol

    @property
    def masses(self) -> np.ndarray:
        """``[4]`` f64 rest masses (target, projectile, ejectile, residual)."""
        return np.array(
            [
                self.target.mass,
                self.projectile.mass,
                self.ejectile.mass,
                self.residual.mass,
            ],
            dtype=np.float64,
        )

    def is_excitation_allowed(
        self, projectile_energy: float, residual_excitation: float
    ) -> bool:
        """Scalar energetics check (reference reaction.py:70-101)."""
        mt, mp = self.target.mass, self.projectile.mass
        e_cm = np.sqrt(mt * mt + mp * mp + 2.0 * mt * (mp + projectile_energy))
        return bool(
            (self.ejectile.mass + self.residual.mass + residual_excitation) < e_cm
        )

    def calculate(
        self,
        projectile_energy: float,
        ejectile_polar: float,
        ejectile_azimuthal: float,
        residual_excitation: float,
    ) -> list[FourVector]:
        """Scalar convenience API: compute lab four-vectors for one event.

        Raises ``ValueError`` below the kinematic threshold, matching the
        reference (reaction.py:136-143).
        """
        q_value = (
            self.target.mass
            + self.projectile.mass
            - (self.ejectile.mass + self.residual.mass + residual_excitation)
        )
        e_threshold = (
            -q_value
            * (self.ejectile.mass + self.residual.mass)
            / (self.ejectile.mass + self.residual.mass - self.projectile.mass)
        )
        if projectile_energy < e_threshold:
            raise ValueError("Beam energy below kinematic threshold!")

        vectors, _ = reaction_batch(
            jnp.asarray(self.masses),
            jnp.array([projectile_energy], dtype=jnp.float64),
            jnp.array([ejectile_polar], dtype=jnp.float64),
            jnp.array([ejectile_azimuthal], dtype=jnp.float64),
            jnp.array([residual_excitation], dtype=jnp.float64),
        )
        arr = np.asarray(vectors[0])
        return [FourVector(*row) for row in arr]


class Decay:
    """A two-body decay a -> b + c.

    Host-side metadata with residual_2 inference by Z/A conservation,
    matching reference semantics (reaction.py:203-218).
    """

    def __init__(self, parent: NucleusData, residual_1: NucleusData):
        self.parent = parent
        self.residual_1 = residual_1
        resid_2_z = parent.Z - residual_1.Z
        resid_2_a = parent.A - residual_1.A
        if resid_2_z < 0:
            raise ValueError(
                "Decay calculated a residual2 Z (proton number) < 0, illegal decay!"
            )
        if resid_2_a < 0:
            raise ValueError(
                "Decay calculated a residual2 A (mass number) < 0, illegal decay!"
            )
        self.residual_2 = nuclear_map.get_data(resid_2_z, resid_2_a)
        self.decay_symbol = f"{self.parent}->{self.residual_1}+{self.residual_2}"

    def __str__(self) -> str:
        return self.decay_symbol

    @property
    def masses(self) -> np.ndarray:
        """``[2]`` f64 rest masses (residual_1, residual_2)."""
        return np.array(
            [self.residual_1.mass, self.residual_2.mass], dtype=np.float64
        )

    def is_excitation_allowed(
        self, parent_vector: FourVector, residual_2_excitation: float
    ) -> bool:
        """Scalar energetics check (reference reaction.py:230-250)."""
        q = parent_vector.M - (
            self.residual_1.mass + self.residual_2.mass + residual_2_excitation
        )
        return bool(q > 0.0)

    def calculate(
        self,
        parent_vector: FourVector,
        residual_1_polar: float,
        residual_1_azimuthal: float,
        residual_2_excitation: float,
    ) -> list[FourVector]:
        """Scalar convenience API (reference reaction.py:252-303)."""
        q = parent_vector.M - (
            self.residual_1.mass + self.residual_2.mass + residual_2_excitation
        )
        if q < 0.0:
            raise ValueError("Parent doesn't have enough energy to decay!")
        vectors, _ = decay_batch(
            jnp.asarray(self.masses),
            jnp.asarray(parent_vector.as_array())[None, :],
            jnp.array([residual_1_polar], dtype=jnp.float64),
            jnp.array([residual_1_azimuthal], dtype=jnp.float64),
            jnp.array([residual_2_excitation], dtype=jnp.float64),
        )
        arr = np.asarray(vectors[0])
        return [parent_vector, FourVector(*arr[0]), FourVector(*arr[1])]
