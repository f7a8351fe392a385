"""Charged-particle transport through the gas volume.

Batched replacement for the reference's trajectory solver
(/root/reference/src/attpc_engine/detector/solver.py:19-305): the reference
integrates one nucleus at a time with scipy's implicit Radau solver, calling
the pycatima C++ stopping library in a Python RHS on every evaluation — the
single hottest path of the reference engine. Here a whole batch of tracks is
integrated simultaneously by a fixed-step RK4 inside ``lax.scan``:

- state is ``[B, 6]`` float32 (position m, gamma*beta),
- stopping power is a uniform-log-grid table gather (2 loads + lerp) per
  RHS evaluation, per track,
- the reference's four terminal root-finding events (KE < 1e-6 MeV, z > 1 m,
  z < 0, rho > 0.292 m; solver.py:80-240) become per-lane "alive" masks:
  dead lanes freeze and stop emitting deposits,
- the energy deposited per output step (the reference's ``abs(diff(KE))``
  over t_eval points, solver.py:331-340) is emitted directly from the scan,
  so the trajectory itself is never materialized,
- an outer while-over-chunks loop exits early once every lane in the batch
  is dead — tracks that leave the chamber in ~200 steps don't pay for the
  full 10,000-step window.

Reference quirks kept for parity (SURVEY.md hard-part 5c): the forward z
bound is hardcoded at 1.0 m and the rho bound at 0.292 m regardless of
``DetectorParams.length``; fields enter the EoM negated
(solver.py:160,240,298-299).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..constants import C, E_CHARGE, MEV_2_JOULE, MEV_2_KG

__all__ = ["TrackSpecies", "integrate_tracks", "KE_LIMIT", "N_TIME_STEPS", "DT"]

KE_LIMIT = 1e-6  # MeV, reference solver.py:14
N_TIME_STEPS = 10000  # deposit points; reference t_eval has 10001 incl. t=0
DT = 1e-10  # s, reference solver.py:16
_Z_FORWARD_BOUND = 1.0  # m, reference quirk solver.py:160
_RHO_BOUND = 0.292  # m, reference quirk solver.py:240


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("mass", "charge", "dedx"),
    meta_fields=("log_ke_lo", "dlog_ke"),
)
@dataclass(frozen=True)
class TrackSpecies:
    """Per-track species constants, stacked over a species axis.

    Attributes
    ----------
    mass: [S] rest masses (MeV).
    charge: [S] proton numbers.
    log_ke_lo, dlog_ke: scalars — the uniform log-KE grid of the tables.
    dedx: [S, n_tab] mass stopping power tables (MeV cm^2/g).
    """

    mass: jax.Array
    charge: jax.Array
    log_ke_lo: float
    dlog_ke: float
    dedx: jax.Array


def _interp_dedx(
    species: TrackSpecies, s_idx: jax.Array, ke: jax.Array
) -> jax.Array:
    """Uniform-log-grid stopping table lookup: [B] KE -> [B] dE/dx."""
    n_tab = species.dedx.shape[1]
    ke = jnp.maximum(ke, 1e-12)
    pos = (jnp.log(ke) - species.log_ke_lo) / species.dlog_ke
    pos = jnp.clip(pos, 0.0, n_tab - 1.000001)
    i0 = pos.astype(jnp.int32)
    w = pos - i0.astype(pos.dtype)
    v0 = species.dedx[s_idx, i0]
    v1 = species.dedx[s_idx, i0 + 1]
    return v0 * (1.0 - w) + v1 * w


def _kinetic_energy(mass: jax.Array, gv: jax.Array) -> jax.Array:
    """KE = m (gamma - 1) via the cancellation-free form m gv^2/(1+gamma)."""
    gv2 = jnp.sum(gv * gv, axis=-1)
    gamma = jnp.sqrt(1.0 + gv2)
    return mass * gv2 / (1.0 + gamma)


def _rhs(
    pos: jax.Array,
    gv: jax.Array,
    mass: jax.Array,
    q_m: jax.Array,
    s_idx: jax.Array,
    species: TrackSpecies,
    density: float,
    bfield: float,
    efield: float,
) -> tuple[jax.Array, jax.Array]:
    """Equations of motion (reference solver.py:19-76, fields pre-negated).

    pos, gv: [B, 3]; returns (dpos/dt, dgv/dt)."""
    gv2 = jnp.sum(gv * gv, axis=-1)
    gv_mag = jnp.sqrt(jnp.maximum(gv2, 1e-30))
    gamma = jnp.sqrt(1.0 + gv2)
    beta = gv_mag / gamma
    ke = mass * gv2 / (1.0 + gamma)

    u = gv / gv_mag[:, None]
    velo = u * (beta * C)[:, None]  # m/s

    dedx = _interp_dedx(species, s_idx, ke)  # MeV cm^2/g
    mass_kg = mass * MEV_2_KG
    decel = dedx * MEV_2_JOULE * density * 100.0 / mass_kg  # m/s^2

    # Reference passes bfield and efield negated (solver.py:298-299)
    b = -bfield
    e = -efield
    dgv = jnp.stack(
        [
            (q_m * velo[:, 1] * b - decel * u[:, 0]) / C,
            (-q_m * velo[:, 0] * b - decel * u[:, 1]) / C,
            (q_m * e - decel * u[:, 2]) / C,
        ],
        axis=-1,
    )
    return velo, dgv


@partial(
    jax.jit,
    static_argnames=("n_steps", "chunk_steps"),
)
def integrate_tracks(
    init_pos: jax.Array,
    init_gv: jax.Array,
    s_idx: jax.Array,
    species: TrackSpecies,
    density: float,
    bfield: float,
    efield: float,
    dt: float = DT,
    n_steps: int = N_TIME_STEPS,
    chunk_steps: int = 500,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Integrate a batch of tracks, emitting per-step energy deposits.

    Parameters
    ----------
    init_pos: [B, 3] float32
        Vertex positions (m).
    init_gv: [B, 3] float32
        Initial gamma*beta (momentum / mass), reference solver.py:273.
    s_idx: [B] int32
        Species index per track into ``species`` arrays.
    species: TrackSpecies
        Stacked species constants + stopping tables.
    density, bfield, efield: float
        Gas density (g/cm^3) and field magnitudes (T, V/m).
    n_steps, dt, chunk_steps
        Fixed-step integration window (defaults match the reference's
        10,000 x 1e-10 s t_eval grid); the chunked outer loop exits once
        all lanes are dead.

    Returns
    -------
    (positions, dke, alive)
        ``positions``: [n_steps, B, 3] float32 — position at each deposit
        point (t_1 .. t_n).
        ``dke``: [n_steps, B] float32 — energy lost since the previous
        point (MeV), the reference's abs(diff(KE)).
        ``alive``: [n_steps, B] bool — whether the point is a real deposit
        (track inside all bounds and above the KE limit at that time).
    """
    if n_steps % chunk_steps != 0:
        raise ValueError("n_steps must be divisible by chunk_steps")
    n_chunks = n_steps // chunk_steps
    b = init_pos.shape[0]
    f32 = jnp.float32

    mass = species.mass[s_idx].astype(f32)
    q_m = (species.charge[s_idx] * E_CHARGE / (mass * MEV_2_KG)).astype(f32)

    pos0 = init_pos.astype(f32)
    gv0 = init_gv.astype(f32)
    ke0 = _kinetic_energy(mass, gv0)
    rho0 = jnp.sqrt(pos0[:, 0] ** 2 + pos0[:, 1] ** 2)
    # Bounds are inclusive at t0: scipy terminal events only fire on sign
    # changes after the start, so a vertex exactly on z = 0 (the no-target
    # default) must start alive.
    alive0 = (
        (ke0 > KE_LIMIT)
        & (pos0[:, 2] >= 0.0)
        & (pos0[:, 2] <= _Z_FORWARD_BOUND)
        & (rho0 < _RHO_BOUND)
    )

    def rk4_step(pos, gv):
        k1p, k1g = _rhs(pos, gv, mass, q_m, s_idx, species, density, bfield, efield)
        k2p, k2g = _rhs(
            pos + 0.5 * dt * k1p, gv + 0.5 * dt * k1g,
            mass, q_m, s_idx, species, density, bfield, efield,
        )
        k3p, k3g = _rhs(
            pos + 0.5 * dt * k2p, gv + 0.5 * dt * k2g,
            mass, q_m, s_idx, species, density, bfield, efield,
        )
        k4p, k4g = _rhs(
            pos + dt * k3p, gv + dt * k3g,
            mass, q_m, s_idx, species, density, bfield, efield,
        )
        pos_n = pos + (dt / 6.0) * (k1p + 2.0 * k2p + 2.0 * k3p + k4p)
        gv_n = gv + (dt / 6.0) * (k1g + 2.0 * k2g + 2.0 * k3g + k4g)
        return pos_n, gv_n

    def scan_step(carry, _):
        pos, gv, ke_prev, alive = carry
        pos_n, gv_n = rk4_step(pos, gv)
        # freeze dead lanes
        pos_n = jnp.where(alive[:, None], pos_n, pos)
        gv_n = jnp.where(alive[:, None], gv_n, gv)
        ke_n = _kinetic_energy(mass, gv_n)
        rho2 = pos_n[:, 0] ** 2 + pos_n[:, 1] ** 2
        alive_n = (
            alive
            & (ke_n > KE_LIMIT)
            & (pos_n[:, 2] > 0.0)
            & (pos_n[:, 2] < _Z_FORWARD_BOUND)
            & (rho2 < _RHO_BOUND * _RHO_BOUND)
        )
        dke = jnp.where(alive_n, jnp.abs(ke_prev - ke_n), 0.0)
        return (pos_n, gv_n, ke_n, alive_n), (pos_n, dke, alive_n)

    positions = jnp.zeros((n_steps, b, 3), dtype=f32)
    dkes = jnp.zeros((n_steps, b), dtype=f32)
    alives = jnp.zeros((n_steps, b), dtype=bool)

    def chunk_body(state):
        chunk_i, carry, positions, dkes, alives = state
        carry, (p_c, d_c, a_c) = jax.lax.scan(
            scan_step, carry, None, length=chunk_steps
        )
        offset = chunk_i * chunk_steps
        zero = jnp.asarray(0, dtype=offset.dtype)
        positions = jax.lax.dynamic_update_slice(positions, p_c, (offset, zero, zero))
        dkes = jax.lax.dynamic_update_slice(dkes, d_c, (offset, zero))
        alives = jax.lax.dynamic_update_slice(alives, a_c, (offset, zero))
        return chunk_i + 1, carry, positions, dkes, alives

    def chunk_cond(state):
        chunk_i, carry, *_ = state
        return (chunk_i < n_chunks) & jnp.any(carry[3])

    init_state = (
        jnp.asarray(0, dtype=jnp.int32),
        (pos0, gv0, ke0, alive0),
        positions,
        dkes,
        alives,
    )
    _, _, positions, dkes, alives = jax.lax.while_loop(
        chunk_cond, chunk_body, init_state
    )
    return positions, dkes, alives
