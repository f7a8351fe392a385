"""Pallas kernel (Triton route, for NVIDIA GPUs) for the RK4 track transport.

``integrate_tracks`` (transport.py) runs the RK4 loop as a ``lax.scan``
inside a ``while_loop``: XLA launches at least one fused kernel per step and
cannot fuse across steps, so a 500-step window costs 500+ dependent kernel
launches. This kernel runs a whole window inside one launch: each program
owns a block of ``block_tracks`` tracks, keeps their state in registers,
and loops over the steps itself, so there is no per-step dispatch at all.
Physics is identical to transport.integrate_tracks (same RK4, same EoM as
reference solver.py:19-76 with negated fields, same stop masks).

Layout notes:
- x64 is enabled globally, so every scalar constant is pinned to f32 and
  every loop index to int32,
- the grid runs over blocks of tracks; the batch is padded up to a
  multiple of ``block_tracks`` with dead lanes (alive = 0), which freeze
  at once and are sliced off on return,
- everything is AXIS-FIRST ([3, B] state, [T, 3, B] outputs): consecutive
  tracks are consecutive threads, so every per-step store is coalesced,
  and each load/store moves one power-of-two row as the Triton route
  requires,
- the stopping-power lookup is a direct indexed load of
  ``table[base + i0]`` and ``table[base + i0 + 1]`` from the small
  flattened [S * N] dE/dx table (a few KB, cache-resident).

``integrate_tracks_pallas`` runs one single-chunk window;
``integrate_tracks_pallas_chunked`` wraps the same kernel in an outer
while-over-chunks loop with the scan implementation's early exit, so it is
a full drop-in for any (n_steps, chunk_steps) window. Both compile the
kernel for the GPU unless ``interpret=True`` is passed (the CPU tests run
the same kernel code through the Pallas interpreter).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..constants import C, E_CHARGE, MEV_2_JOULE, MEV_2_KG
from .transport import _Z_FORWARD_BOUND, _RHO_BOUND, DT, KE_LIMIT, TrackSpecies

__all__ = [
    "BLOCK_TRACKS",
    "integrate_tracks_pallas",
    "integrate_tracks_pallas_chunked",
]

# tracks per program, one per thread (num_warps = BLOCK_TRACKS // 32). At
# the flagship's 768 tracks, blocks of 32, 64 and 128 timed within 10% of
# each other on an H100 (the kernel is latency-bound: 768 threads cannot
# fill the card); 64 was never slowest.
BLOCK_TRACKS = 64


def _kernel(
    pos_ref,  # [3, TB]
    gv_ref,  # [3, TB]
    alive_ref,  # [TB] int32 — lanes alive at window start
    base_ref,  # [TB] int32 — start of each lane's table block
    mass_ref,  # [TB]
    qm_ref,  # [TB]
    table_ref,  # [S*N] flattened dE/dx tables
    out_pos_ref,  # [T, 3, TB]
    out_dke_ref,  # [T, TB]
    out_alive_ref,  # [T, TB] int32
    fin_pos_ref,  # [3, TB] — state at window end (chunk carry)
    fin_gv_ref,  # [3, TB]
    fin_alive_ref,  # [TB] int32
    *,
    n_steps: int,
    dt: float,
    log_ke_lo: float,
    dlog_ke: float,
    n_tab: int,
    density: float,
    bfield: float,
    efield: float,
):
    f32 = jnp.float32
    log_lo_c = f32(log_ke_lo)
    dlog_c = f32(dlog_ke)
    dt_c = f32(dt)
    dt6_c = f32(dt / 6.0)
    half_dt_c = f32(0.5 * dt)
    dens_c = f32(MEV_2_JOULE * density * 100.0)
    c_c = f32(C)
    clip_hi_c = f32(n_tab - 1.000001)
    ke_lim_c = f32(KE_LIMIT)
    zb_c = f32(_Z_FORWARD_BOUND)
    rho2_c = f32(_RHO_BOUND * _RHO_BOUND)
    tiny_c = f32(1e-30)
    ke_floor_c = f32(1e-12)
    zero = f32(0.0)
    one = f32(1.0)
    two = f32(2.0)

    mass = mass_ref[...]
    q_m = qm_ref[...]
    base = base_ref[...]
    mass_kg = mass * f32(MEV_2_KG)
    b_neg = f32(-bfield)
    e_neg = f32(-efield)

    def interp_dedx(ke):
        posf = (jnp.log(jnp.maximum(ke, ke_floor_c)) - log_lo_c) / dlog_c
        posf = jnp.minimum(jnp.maximum(posf, zero), clip_hi_c)
        # posf >= 0, so truncation is floor; the clamp keeps i0 + 1 inside
        # the lane's own table block where f32 rounds clip_hi up to n - 1
        i0 = jnp.minimum(posf.astype(jnp.int32), jnp.int32(n_tab - 2))
        frac = posf - i0.astype(f32)
        idx0 = base + i0
        v0 = table_ref[idx0]
        v1 = table_ref[idx0 + 1]
        return v0 * (one - frac) + v1 * frac

    def rhs(x, y, z, gx, gy, gz):
        gv2 = gx * gx + gy * gy + gz * gz
        gv_mag = jnp.sqrt(jnp.maximum(gv2, tiny_c))
        gamma = jnp.sqrt(one + gv2)
        beta = gv_mag / gamma
        ke = mass * gv2 / (one + gamma)
        ux, uy, uz = gx / gv_mag, gy / gv_mag, gz / gv_mag
        speed = beta * c_c
        vx, vy, vz = ux * speed, uy * speed, uz * speed
        decel = interp_dedx(ke) * dens_c / mass_kg
        dgx = (q_m * vy * b_neg - decel * ux) / c_c
        dgy = (-q_m * vx * b_neg - decel * uy) / c_c
        dgz = (q_m * e_neg - decel * uz) / c_c
        return (vx, vy, vz), (dgx, dgy, dgz)

    def kinetic(gx, gy, gz):
        gv2 = gx * gx + gy * gy + gz * gz
        return mass * gv2 / (one + jnp.sqrt(one + gv2))

    def axpy(a, xs, ys):
        return tuple(x + a * y for x, y in zip(xs, ys))

    pos = (pos_ref[0], pos_ref[1], pos_ref[2])
    gv = (gv_ref[0], gv_ref[1], gv_ref[2])
    # alive at window start comes from the caller (chunk carry; the first
    # chunk's inclusive-bounds mask is computed in the wrapper), so dead
    # lanes never resurrect across chunk boundaries
    alive0 = alive_ref[...]
    ke0 = kinetic(*gv)

    def body(step, carry):
        px, py, pz, gx, gy, gz, ke_prev, alive = carry
        pos, gv = (px, py, pz), (gx, gy, gz)
        k1p, k1g = rhs(*pos, *gv)
        k2p, k2g = rhs(*axpy(half_dt_c, pos, k1p), *axpy(half_dt_c, gv, k1g))
        k3p, k3g = rhs(*axpy(half_dt_c, pos, k2p), *axpy(half_dt_c, gv, k2g))
        k4p, k4g = rhs(*axpy(dt_c, pos, k3p), *axpy(dt_c, gv, k3g))
        live = alive != 0
        pos_n = tuple(
            jnp.where(live, p + dt6_c * (a + two * b + two * c + d), p)
            for p, a, b, c, d in zip(pos, k1p, k2p, k3p, k4p)
        )
        gv_n = tuple(
            jnp.where(live, g + dt6_c * (a + two * b + two * c + d), g)
            for g, a, b, c, d in zip(gv, k1g, k2g, k3g, k4g)
        )
        ke_n = kinetic(*gv_n)
        rho2 = pos_n[0] * pos_n[0] + pos_n[1] * pos_n[1]
        alive_n = jnp.where(
            live
            & (ke_n > ke_lim_c)
            & (pos_n[2] > zero)
            & (pos_n[2] < zb_c)
            & (rho2 < rho2_c),
            jnp.int32(1),
            jnp.int32(0),
        )
        dke = jnp.where(alive_n != 0, jnp.abs(ke_prev - ke_n), zero)
        for axis in range(3):
            out_pos_ref[step, axis] = pos_n[axis]
        out_dke_ref[step] = dke
        out_alive_ref[step] = alive_n
        return (*pos_n, *gv_n, ke_n, alive_n)

    carry = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(n_steps), body, (*pos, *gv, ke0, alive0)
    )
    for axis in range(3):
        fin_pos_ref[axis] = carry[axis]
        fin_gv_ref[axis] = carry[3 + axis]
    fin_alive_ref[...] = carry[7]


def _prepare(init_pos, init_gv, s_idx, species, block_tracks):
    """Pad the batch to a multiple of the block and build the per-lane
    kernel inputs: axis-first state, inclusive-at-t0 alive mask (scipy
    terminal events only fire on sign changes after the start), table
    block starts, masses and charge-to-mass ratios."""
    f32 = jnp.float32
    b = init_pos.shape[0]
    b_pad = -(-b // block_tracks) * block_tracks
    pad = b_pad - b
    n_tab = species.dedx.shape[1]

    s_idx = jnp.pad(s_idx.astype(jnp.int32), (0, pad))
    mass = species.mass[s_idx].astype(f32)
    q_m = (species.charge[s_idx] * E_CHARGE / (mass * MEV_2_KG)).astype(f32)
    base = s_idx * jnp.int32(n_tab)
    pos0 = jnp.pad(init_pos.astype(f32), ((0, pad), (0, 0))).T
    gv0 = jnp.pad(init_gv.astype(f32), ((0, pad), (0, 0))).T

    gv2 = jnp.sum(gv0 * gv0, axis=0)
    ke0 = mass * gv2 / (f32(1.0) + jnp.sqrt(f32(1.0) + gv2))
    rho0 = jnp.sqrt(pos0[0] ** 2 + pos0[1] ** 2)
    alive0 = (
        (ke0 > f32(KE_LIMIT))
        & (pos0[2] >= f32(0.0))
        & (pos0[2] <= f32(_Z_FORWARD_BOUND))
        & (rho0 < f32(_RHO_BOUND))
        & (jnp.arange(b_pad) < b)
    ).astype(jnp.int32)
    return pos0, gv0, alive0, base, mass, q_m, b_pad


def _window_call(
    species, density, bfield, efield, dt, n_steps, b_pad, block_tracks,
    interpret,
):
    """The pallas_call running one ``n_steps`` window over ``b_pad``
    tracks, gridded over blocks of ``block_tracks``."""
    f32 = jnp.float32
    n_tab = species.dedx.shape[1]
    n_flat = species.dedx.size
    tb = block_tracks
    kern = partial(
        _kernel,
        n_steps=n_steps,
        dt=float(dt),
        log_ke_lo=float(species.log_ke_lo),
        dlog_ke=float(species.dlog_ke),
        n_tab=n_tab,
        density=float(density),
        bfield=float(bfield),
        efield=float(efield),
    )
    lane = pl.BlockSpec((tb,), lambda i: (i,))
    axis_first = pl.BlockSpec((3, tb), lambda i: (0, i))
    return pl.pallas_call(
        kern,
        grid=(b_pad // tb,),
        in_specs=[
            axis_first,
            axis_first,
            lane,
            lane,
            lane,
            lane,
            pl.BlockSpec((n_flat,), lambda i: (0,)),
        ],
        out_specs=[
            pl.BlockSpec((n_steps, 3, tb), lambda i: (0, 0, i)),
            pl.BlockSpec((n_steps, tb), lambda i: (0, i)),
            pl.BlockSpec((n_steps, tb), lambda i: (0, i)),
            axis_first,
            axis_first,
            lane,
        ],
        out_shape=(
            jax.ShapeDtypeStruct((n_steps, 3, b_pad), f32),
            jax.ShapeDtypeStruct((n_steps, b_pad), f32),
            jax.ShapeDtypeStruct((n_steps, b_pad), jnp.int32),
            jax.ShapeDtypeStruct((3, b_pad), f32),
            jax.ShapeDtypeStruct((3, b_pad), f32),
            jax.ShapeDtypeStruct((b_pad,), jnp.int32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, tb // 32), num_stages=1
        ),
        interpret=interpret,
        name="rk4_transport",
    )


_STATIC = ("n_steps", "density", "bfield", "efield", "dt", "block_tracks",
           "interpret")


@partial(jax.jit, static_argnames=_STATIC)
def integrate_tracks_pallas(
    init_pos: jax.Array,
    init_gv: jax.Array,
    s_idx: jax.Array,
    species: TrackSpecies,
    density: float,
    bfield: float,
    efield: float,
    dt: float = DT,
    n_steps: int = 500,
    block_tracks: int = BLOCK_TRACKS,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Drop-in for transport.integrate_tracks (same returns), one kernel
    launch for the whole ``n_steps`` window.

    ``block_tracks``: tracks per program, a power of two. ``interpret``:
    run the kernel through the Pallas interpreter (CPU tests); the default
    compiles it for the GPU."""
    b = init_pos.shape[0]
    pos0, gv0, alive0, base, mass, q_m, b_pad = _prepare(
        init_pos, init_gv, s_idx, species, block_tracks
    )
    call = _window_call(
        species, density, bfield, efield, dt, n_steps, b_pad, block_tracks,
        interpret,
    )
    table = species.dedx.reshape(-1).astype(jnp.float32)
    positions_axf, dke, alive_i, *_ = call(
        pos0, gv0, alive0, base, mass, q_m, table
    )
    return (
        positions_axf[:, :, :b].transpose(0, 2, 1),
        dke[:, :b],
        alive_i[:, :b] != 0,
    )


@partial(jax.jit, static_argnames=_STATIC + ("chunk_steps",))
def integrate_tracks_pallas_chunked(
    init_pos: jax.Array,
    init_gv: jax.Array,
    s_idx: jax.Array,
    species: TrackSpecies,
    density: float,
    bfield: float,
    efield: float,
    dt: float = DT,
    n_steps: int = 10000,
    chunk_steps: int = 500,
    block_tracks: int = BLOCK_TRACKS,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Chunked drop-in for transport.integrate_tracks over arbitrary
    windows: an outer ``lax.while_loop`` re-enters the SAME compiled
    kernel per ``chunk_steps`` window, carrying (pos, gv, alive) across
    chunks, and exits early once every lane is dead — exactly the
    early-exit semantics of the scan implementation, with no per-step
    dispatch inside each chunk.
    """
    if n_steps % chunk_steps != 0:
        raise ValueError("n_steps must be divisible by chunk_steps")
    n_chunks = n_steps // chunk_steps
    b = init_pos.shape[0]
    f32 = jnp.float32
    pos0, gv0, alive0, base, mass, q_m, b_pad = _prepare(
        init_pos, init_gv, s_idx, species, block_tracks
    )
    call = _window_call(
        species, density, bfield, efield, dt, chunk_steps, b_pad,
        block_tracks, interpret,
    )
    table = species.dedx.reshape(-1).astype(f32)

    positions = jnp.zeros((n_steps, b, 3), dtype=f32)
    dkes = jnp.zeros((n_steps, b), dtype=f32)
    alives = jnp.zeros((n_steps, b), dtype=jnp.int32)

    def chunk_body(state):
        chunk_i, pos, gv, alive, positions, dkes, alives = state
        p_c, d_c, a_c, pos_n, gv_n, alive_n = call(
            pos, gv, alive, base, mass, q_m, table
        )
        offset = chunk_i * chunk_steps
        zero = jnp.asarray(0, dtype=offset.dtype)
        positions = jax.lax.dynamic_update_slice(
            positions, p_c[:, :, :b].transpose(0, 2, 1), (offset, zero, zero)
        )
        dkes = jax.lax.dynamic_update_slice(dkes, d_c[:, :b], (offset, zero))
        alives = jax.lax.dynamic_update_slice(alives, a_c[:, :b], (offset, zero))
        return chunk_i + 1, pos_n, gv_n, alive_n, positions, dkes, alives

    def chunk_cond(state):
        chunk_i, _pos, _gv, alive, *_ = state
        return (chunk_i < n_chunks) & jnp.any(alive != 0)

    init_state = (
        jnp.asarray(0, dtype=jnp.int32),
        pos0,
        gv0,
        alive0,
        positions,
        dkes,
        alives,
    )
    _, _, _, _, positions, dkes, alives = jax.lax.while_loop(
        chunk_cond, chunk_body, init_state
    )
    return positions, dkes, alives != 0
