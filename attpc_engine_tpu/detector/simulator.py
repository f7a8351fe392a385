"""Detector-stage driver: batched event simulation.

Covers the reference's ``detector/simulator.py``
(/root/reference/src/attpc_engine/detector/simulator.py:52-210) with a
batched architecture: instead of a per-event Python loop over nuclei calling
scipy/pycatima/numba, a ``DetectorSimulator`` compiles one XLA program that
takes ``[E]`` events x ``[K]`` product nuclei and returns fixed-capacity
Spyral-formatted clouds; ``run_simulation`` streams kinematics-file batches
through it into a writer.

Pipeline inside the jitted program:
    integrate_tracks (transport.py)       [E*K] tracks, RK4 scan
 -> generate_electrons (deposition.py)    Fano-smeared counts
 -> deposit_and_merge (deposition.py)     diffusion mesh + (pad,tb) merge
 -> convert_to_spyral_batch (this file)   response, threshold, z-sort
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .. import nuclear_map
from ..constants import NUM_TB
from .deposition import (
    compact_cloud,
    deposit_and_merge,
    event_keys,
    generate_electrons,
)
from .parameters import Config
from .transport import TrackSpecies, integrate_tracks

__all__ = ["EngineParams", "DetectorSimulator", "simulate", "run_simulation"]

# single-slot memo for the simulate() compatibility shim (see its NOTE)
_SIMULATE_CACHE: dict = {}


def _config_fingerprint(config: "Config") -> tuple:
    """Value-derived key of everything a DetectorSimulator captures from a
    Config (physics scalars, electronics, gas identity, pad asset sources)."""
    dp, ep, pp = config.det_params, config.elec_params, config.pad_params
    gas = dp.gas_target
    return (
        dp.length, dp.efield, dp.bfield, dp.mpgd_gain, dp.diffusion,
        dp.fano_factor, dp.w_value,
        ep.clock_freq, ep.amp_gain, ep.shaping_time, ep.micromegas_edge,
        ep.windows_edge, ep.adc_threshold,
        tuple(gas.components), gas.pressure, getattr(gas, "temperature", None),
        str(pp.grid_path), str(pp.geometry_path), str(pp.pad_size_path),
    )


def _engine_fingerprint(engine: "EngineParams | None") -> tuple | None:
    if engine is None:
        return None
    return (
        engine.n_time_steps, engine.dt, engine.chunk_steps,
        engine.point_budget, engine.uniq_budget, engine.cloud_cap,
        engine.out_budget, engine.events_per_batch, engine.pallas_transport,
    )


def split_packed(packed: np.ndarray):
    """[P, 2] int32 packed device rows -> (q f32, tb i32, pad i32, lab i32).

    Bit-exact inverse of _convert_to_spyral's packing: column 0 is the raw
    f32 bit pattern of the gained charge, column 1 holds
    tb << 22 | pad << 8 | label (tb < 512, pad < 10240, label < 256, so
    the sign bit is clear). Kept in sync with the standalone copy in
    io/spyral_child.py (which deliberately imports no package modules) by
    tests/test_writer_proc.py.
    """
    q = np.ascontiguousarray(packed[:, 0]).view(np.float32)
    meta = packed[:, 1]
    tb = meta >> 22
    pad = (meta >> 8) & 0x3FFF
    lab = meta & 0xFF
    return q, tb, pad, lab


def wiggle_for_events(
    counts: np.ndarray, event_numbers: np.ndarray, seed: int
) -> np.ndarray:
    """U[0, 1) f64 TB wiggle (reference simulator.py:108) for a pool of
    per-event row runs, drawn from counter-based Philox streams keyed on
    (seed, event_number) — the stream each event sees is independent of
    events_per_batch and resume point, so outputs are bit-identical across
    any batching of the same run. Kept in sync with the standalone copy in
    io/spyral_child.py by tests/test_writer_proc.py."""
    out = np.empty(int(np.sum(counts)), np.float64)
    pos = 0
    for n, ev in zip(counts, event_numbers):
        n = int(n)
        if n:
            # key as an explicit uint64 array: a plain list would round
            # seeds >= 2**63 through float64 inside numpy's key conversion
            key = np.array(
                [int(seed) & 0xFFFFFFFFFFFFFFFF, int(ev)], dtype=np.uint64
            )
            gen = np.random.Generator(np.random.Philox(key=key))
            out[pos : pos + n] = gen.random(n)
            pos += n
    return out


@dataclass
class EngineParams:
    """Engine-level knobs of the batched detector simulation (no analog in
    the reference, which hardcodes these; defaults reproduce its values).

    Attributes
    ----------
    n_time_steps: int
        Deposit points per track; the reference evaluates trajectories on
        10,001 t_eval points including t=0 (solver.py:16). This is the
        PHYSICS window — the driver auto-tunes an effective window down to
        the observed track lifetimes (and retries larger on saturation),
        never past this value.
    dt: float
        Integrator step in seconds (reference: 1e-10).
    chunk_steps: int
        Scan chunk size for the early-exit outer loop.
    point_budget: int
        Per-event deposit-point window capacity; overflow is counted and
        the driver doubles + retries.
    uniq_budget: int
        Unique-(pad, tb) slots kept per event by the merge (the flagship
        config measures ~6.7k max); overflow is counted and the driver
        doubles + retries. This is the width of the merged cloud window.
    cloud_cap: int
        Per-event capacity of the COMPACTED cloud pool — only materialized
        on the reference-protocol writer path (see
        deposition.compact_cloud); the Spyral path never builds it.
    out_budget: int
        Shared output pool budget per event for the Spyral-formatted rows
        (device->host transfers scale with this).
    transfer_quantum: int
        Packed device->host slice lengths are rounded up to this many rows
        (each distinct length compiles one tiny slice program; without
        rounding EVERY batch would compile one). 65,536 rows = 512 KB of
        padding at most.
    events_per_batch: int
        Events per XLA program execution.
    pallas_transport: bool | str
        Run the RK4 transport as the Pallas kernel of transport_pallas.py
        (Triton route: one launch per window, the step loop inside the
        kernel) instead of the ``lax.scan`` integrator; multi-chunk
        windows run the chunked wrapper with the same early-exit
        semantics. ``"auto"`` (default) uses the kernel on a GPU backend
        and the scan elsewhere; ``True`` always uses the kernel (it has
        no CPU lowering, so on the CPU it fails to compile), ``False``
        never does.
    """

    n_time_steps: int = 10000
    dt: float = 1e-10
    chunk_steps: int = 500
    point_budget: int = 1024
    uniq_budget: int = 12288
    cloud_cap: int = 12288
    out_budget: int = 8192
    events_per_batch: int = 256
    pallas_transport: bool | str = "auto"
    transfer_quantum: int = 65536

    def __post_init__(self) -> None:
        # any other string is a typo that would otherwise silently fall
        # back to one of the two paths
        v = self.pallas_transport
        if isinstance(v, str) and v != "auto":
            raise ValueError(
                f"EngineParams.pallas_transport={v!r}: expected a bool or "
                "'auto'"
            )


class DetectorSimulator:
    """Compiled batched detector simulation for one (config, reaction) pair.

    Parameters
    ----------
    config: Config
        Detector/electronics/pad configuration.
    proton_numbers, mass_numbers: np.ndarray [N]
        Nucleus species per row of the kinematics arrays.
    indices: list[int] | None
        Which nuclei to simulate. None = all exit-channel nuclei, i.e.
        [2, 4, 6, ..., N-1] (reference simulator.py:153-158). Neutral
        (Z == 0) nuclei are skipped (simulator.py:97).
    engine: EngineParams
    mesh: jax.sharding.Mesh | None
        Optional 1-D device mesh: batches whose event count divides the
        mesh size are event-sharded across it (inputs are placed with
        event-axis shardings; XLA propagates the partitioning through the
        whole program — events are independent by construction). Physics is
        layout-independent.
    """

    def __init__(
        self,
        config: Config,
        proton_numbers: np.ndarray,
        mass_numbers: np.ndarray,
        indices: list[int] | None = None,
        engine: EngineParams | None = None,
        mesh=None,
    ):
        self.config = config
        self.engine = engine or EngineParams()
        self.mesh = mesh
        if indices is None:
            indices = list(range(2, len(proton_numbers), 2))
            indices.append(len(proton_numbers) - 1)
        # drop neutral nuclei statically (Z is fixed per kinematics file)
        self.sim_indices = [i for i in indices if proton_numbers[i] != 0]
        if len(self.sim_indices) == 0:
            raise ValueError("No charged nuclei to simulate")
        self.k_tracks = len(self.sim_indices)

        # species table: one row per simulated nucleus slot
        gas = config.det_params.gas_target
        masses, charges, tables = [], [], []
        log_lo = dlog = None
        for i in self.sim_indices:
            nucleus = nuclear_map.get_data(
                int(proton_numbers[i]), int(mass_numbers[i])
            )
            log_ke, dedx = gas.dedx_interp_arrays(nucleus)
            masses.append(nucleus.mass)
            charges.append(float(nucleus.Z))
            tables.append(dedx)
            log_lo = float(log_ke[0])
            dlog = float(log_ke[1] - log_ke[0])
        self.species = TrackSpecies(
            mass=jnp.asarray(np.array(masses), dtype=jnp.float32),
            charge=jnp.asarray(np.array(charges), dtype=jnp.float32),
            log_ke_lo=log_lo,
            dlog_ke=dlog,
            dedx=jnp.asarray(np.stack(tables), dtype=jnp.float32),
        )
        self.track_masses = np.array(masses)  # f64, for gv init precision
        self._labels = jnp.asarray(np.array(self.sim_indices), dtype=jnp.int32)

        dev = config.device_arrays()
        # response integral lookup (host side, f64 — reference arithmetic,
        # NOT the f32-rounded device cache): ascending response + prefix
        # sums, consumed by assemble_spyral
        from .response import get_response

        resp = np.asarray(get_response(config), dtype=np.float64)
        self._resp_asc_f64 = np.sort(resp)
        self._resp_prefix_f64 = np.concatenate(
            [[0.0], np.cumsum(self._resp_asc_f64)]
        )
        self._resp_max = float(resp.max())

        self._sim_jit = jax.jit(
            self._simulate_impl,
            static_argnames=(
                "n_events",
                "point_budget",
                "uniq_budget",
                "out_budget",
                "n_steps",
            ),
        )
        # the shard_map program is built lazily per mesh (the mesh may be
        # assigned after construction)
        self._sim_sharded_jit = None
        self._sim_sharded_mesh = None

    # ------------------------------------------------------------------ #

    def _use_transport_kernel(self) -> bool:
        """EngineParams.pallas_transport -> whether the step runs the
        Pallas transport kernel ("auto" = on a GPU backend). The kernel
        always runs on one device's tracks: the multi-device program
        calls it per shard inside shard_map, and the flat program's inputs
        are never sharded."""
        flag = self.engine.pallas_transport
        if flag == "auto":
            return jax.default_backend() == "gpu"
        return bool(flag)

    def _core_impl(
        self,
        key,
        vg,
        n_events: int,
        point_budget: int,
        uniq_budget: int,
        n_steps: int,
        event_start,
    ):
        """Transport + electron generation + deposit/merge for a batch of
        ``n_events`` events: the kernel-bearing section of the step.
        Returns (cloud dict, steps_alive). Per-event RNG keys off
        ``event_start + i`` (global event ids), so the result depends only
        on which events are in the batch — the shard_map path relies on
        this to be bit-identical to the single-device program."""
        cfg, eng = self.config, self.engine
        dev = cfg.device_arrays()
        e = n_events
        k = self.k_tracks
        b = e * k
        vertices = vg[:, :3]
        gvs = vg[:, 3:].reshape(e, k, 3)

        # one key per event from its GLOBAL id; split once into the Fano
        # stream and the raw-cloud wiggle stream
        ev_keys = event_keys(key, e, event_start)
        ksplit = jax.vmap(jax.random.split)(ev_keys)  # [E, 2, 2]
        keys_e, keys_w = ksplit[:, 0], ksplit[:, 1]

        pos0 = jnp.repeat(vertices, k, axis=0)  # [B, 3] event-major
        gv0 = gvs.reshape(b, 3)
        s_idx = jnp.tile(jnp.arange(k, dtype=jnp.int32), e)

        use_pallas = self._use_transport_kernel()
        if use_pallas and n_steps <= eng.chunk_steps:
            # single window fits one kernel launch
            from .transport_pallas import integrate_tracks_pallas

            positions, dke, alive = integrate_tracks_pallas(
                pos0,
                gv0,
                s_idx,
                self.species,
                density=float(cfg.det_params.gas_target.density),
                bfield=float(cfg.det_params.bfield),
                efield=float(cfg.det_params.efield),
                dt=float(eng.dt),
                n_steps=n_steps,
            )
        elif use_pallas:
            # chunked wrapper: same kernel per chunk, early exit outside
            from .transport_pallas import integrate_tracks_pallas_chunked

            positions, dke, alive = integrate_tracks_pallas_chunked(
                pos0,
                gv0,
                s_idx,
                self.species,
                density=float(cfg.det_params.gas_target.density),
                bfield=float(cfg.det_params.bfield),
                efield=float(cfg.det_params.efield),
                dt=float(eng.dt),
                n_steps=n_steps,
                chunk_steps=min(eng.chunk_steps, n_steps),
            )
        else:
            positions, dke, alive = integrate_tracks(
                pos0,
                gv0,
                s_idx,
                self.species,
                density=cfg.det_params.gas_target.density,
                bfield=cfg.det_params.bfield,
                efield=cfg.det_params.efield,
                dt=eng.dt,
                n_steps=n_steps,
                chunk_steps=min(eng.chunk_steps, n_steps),
            )
        # steps with any live track: if this saturates an effective window
        # shorter than the physics window, deposits were cut off and the
        # driver retries with a larger window
        steps_alive = alive.any(axis=1).sum(dtype=jnp.int32)
        electrons = generate_electrons(
            keys_e, dke, cfg.det_params.w_value, cfg.det_params.fano_factor,
            chunk_steps=min(eng.chunk_steps, n_steps),
        )
        track_labels = jnp.tile(self._labels, e)
        cloud = deposit_and_merge(
            keys_w,
            positions,
            electrons,
            alive,
            track_labels,
            dev["key_grid_mm"],
            grid_lo_mm=dev["grid_lo_mm"],
            grid_n_mm=dev["grid_n_mm"],
            diffusion=cfg.det_params.diffusion,
            efield=cfg.det_params.efield,
            drift_velocity=cfg.drift_velocity,
            micromegas_edge=float(cfg.elec_params.micromegas_edge),
            length=cfg.det_params.length,
            mpgd_gain=float(cfg.det_params.mpgd_gain),
            n_events=e,
            tracks_per_event=k,
            point_budget=point_budget,
            uniq_budget=uniq_budget,
        )
        return cloud, steps_alive

    def _finish_impl(self, cloud, steps_alive, out_budget: int, e: int):
        """Spyral conversion + per-batch metadata pack — the globally
        coupled tail of the step (the output pool packs all events'
        kept rows contiguously, so it runs OUTSIDE any shard_map and XLA
        partitions it under a mesh)."""
        window = cloud["pads"].shape[0] // e
        with jax.named_scope("spyral_convert"):
            packed, counts, out_overflow = self._convert_to_spyral(
                cloud, out_budget, e, window
            )
        # [E*out_budget, 3] i32: charge bits, tb bits, pad << 16 | label
        cloud["packed"] = packed
        cloud["spyral_counts"] = counts
        cloud["spyral_overflow"] = out_overflow
        # one small array for everything the host polls per batch (one
        # device->host round trip instead of eight): counts[E],
        # n_points[E], cloud counts[E], then the overflow/tuning scalars
        cloud["meta_i32"] = jnp.concatenate(
            [
                counts,
                cloud["n_points"],
                cloud["counts"],
                jnp.stack(
                    [
                        out_overflow,
                        cloud["uniq_overflow"],
                        cloud["pool_overflow"],
                        steps_alive,
                        cloud["uniq_max"],
                    ]
                ),
            ]
        )
        return cloud

    def _simulate_impl(
        self,
        key,
        vg,
        n_events: int,
        point_budget: int | None = None,
        uniq_budget: int | None = None,
        out_budget: int | None = None,
        n_steps: int | None = None,
        event_start=0,
    ):
        """vg [E, 3 + K*3] f32 (vertex cols 0-2, then gamma*beta per
        track) -> cloud + spyral arrays. The batch rides ONE combined
        host->device array (one transfer per batch).

        Pool budgets and the effective step window are static jit arguments
        (None = the engine defaults) so the driver can retune them between
        batches. ``event_start`` (traced scalar) is the batch's first
        GLOBAL event index: all device draws key off fold_in(key,
        event_start + i), so a batch's outputs depend only on its events'
        global ids — not on events_per_batch or the batch boundary
        (grid-independent resume)."""
        eng = self.engine
        point_budget = point_budget or eng.point_budget
        uniq_budget = uniq_budget or eng.uniq_budget
        out_budget = out_budget or eng.out_budget
        n_steps = n_steps or eng.n_time_steps
        cloud, steps_alive = self._core_impl(
            key, vg, n_events, point_budget, uniq_budget, n_steps,
            event_start,
        )
        return self._finish_impl(cloud, steps_alive, out_budget, n_events)

    def _simulate_sharded_impl(
        self,
        key,
        vg,
        n_events: int,
        point_budget: int | None = None,
        uniq_budget: int | None = None,
        out_budget: int | None = None,
        n_steps: int | None = None,
        event_start=0,
    ):
        """The multi-device program: shard_map the kernel-bearing core over
        the event mesh (each shard is a single device, so the transport
        kernel runs per shard — pallas_call itself cannot partition), then
        run the globally coupled Spyral conversion on the event-sharded
        cloud (XLA partitions the per-event work and inserts the
        output-pool collectives).

        Bit-identical to the single-device program: every device draw keys
        off the event's GLOBAL id (fold_in(key, event_start + i)), events
        are independent, and the per-shard early-exit of the chunked
        transport only skips chunks whose tracks are all dead (masked
        lanes deposit nothing either way)."""
        eng = self.engine
        point_budget = point_budget or eng.point_budget
        uniq_budget = uniq_budget or eng.uniq_budget
        out_budget = out_budget or eng.out_budget
        n_steps = n_steps or eng.n_time_steps
        mesh = self.mesh
        n_dev = mesh.size
        e_loc = n_events // n_dev
        P = jax.sharding.PartitionSpec

        def local(key, vg_loc, event_start):
            off = jax.lax.axis_index("events").astype(jnp.int32) * e_loc
            cloud, steps_alive = self._core_impl(
                key, vg_loc, e_loc, point_budget, uniq_budget, n_steps,
                event_start + off,
            )
            # globalize the event ids (invalid lanes keep the global
            # sentinel E, matching the unsharded program)
            cloud["events"] = jnp.where(
                cloud["cloud_valid"], cloud["events"] + off,
                jnp.int32(n_events),
            )
            # lift per-shard scalars to [1] so every output leaf
            # concatenates over the mesh axis
            for name in ("pool_overflow", "uniq_overflow", "uniq_max"):
                cloud[name] = cloud[name][None]
            return cloud, steps_alive[None]

        cloud, steps_alive_v = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P("events"), P()),
            out_specs=P("events"),
            # the core is collective-free; the varying-axes checker trips
            # on while_loop carries seeded from replicated zeros
            check_vma=False,
        )(key, vg, event_start)
        # combine the per-shard diagnostics exactly as the single-device
        # program would: overflow counters are sums over events; uniq_max
        # and steps_alive (prefix length over tracks) are maxima
        cloud["pool_overflow"] = cloud["pool_overflow"].sum()
        cloud["uniq_overflow"] = cloud["uniq_overflow"].sum()
        cloud["uniq_max"] = cloud["uniq_max"].max()
        steps_alive = steps_alive_v.max()
        return self._finish_impl(cloud, steps_alive, out_budget, n_events)

    def assemble_spyral(
        self,
        q: np.ndarray,
        tbs: np.ndarray,
        pads: np.ndarray,
        labels: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side assembly of the Spyral 8 columns from the packed
        device output (f64, matching the reference's writer math —
        writer.py:97-111): x/y from pad centers, z from tb, size from the
        pad table, amplitude/integral from the merged charge.

        q: [n] f32 gained charge; tbs: [n] f64 WIGGLED tb (integer tb +
        host-drawn U[0,1), see wiggle_for_events); pads/labels: [n] ints.

        The GET response application (reference response.py:35-56: per-tb
        min(response * q, 4095), amplitude = max, integral = sum) happens
        HERE in f64 — exactly the reference's arithmetic — via the sorted
        response + prefix-sum trick in O(log 512) per point. Only the
        charge is transferred; the device computes just the amplitude
        threshold mask.

        Returns (spyral [n, 8] f64, labels [n] i64)."""
        cfg = self.config
        pads = pads.astype(np.int64)
        labels = labels.astype(np.int64)
        q = q.astype(np.float64)
        tbs = np.asarray(tbs, dtype=np.float64)
        amp = np.minimum(self._resp_max * q, 4095.0)
        thr = 4095.0 / np.maximum(q, 1e-300)
        idx = np.searchsorted(self._resp_asc_f64, thr, side="right")
        integral = q * self._resp_prefix_f64[idx] + 4095.0 * (NUM_TB - idx)
        win = float(cfg.elec_params.windows_edge)
        mm = float(cfg.elec_params.micromegas_edge)
        out = np.empty((len(pads), 8), dtype=np.float64)
        out[:, 0] = cfg.pad_centers[pads, 0]
        out[:, 1] = cfg.pad_centers[pads, 1]
        out[:, 2] = (win - tbs) / (win - mm) * cfg.det_params.length * 1000.0
        out[:, 3] = amp
        out[:, 4] = integral
        out[:, 5] = pads
        out[:, 6] = tbs
        out[:, 7] = cfg.pad_sizes[pads]
        return out, labels

    def assemble_spyral_ordered(
        self,
        packed: np.ndarray,
        counts: np.ndarray,
        event_numbers: np.ndarray,
        wiggle_seed: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """split_packed + host TB wiggle + per-event exact z-ordering.

        The device sorts each event's rows by descending INTEGER tb; the
        final reference semantics (sort by z computed from the wiggled tb,
        writer.py:236-238) are completed here: wiggles are drawn per event
        (wiggle_for_events) and each event's rows are reordered by
        ascending z = descending wiggled tb. Returns the pooled
        (spyral [n, 8] f64, labels [n] i64) in event order."""
        ev = np.asarray(event_numbers)
        if len(ev) and np.array_equal(ev, np.arange(ev[0], ev[0] + len(ev))):
            # native C pipeline (wiggle + sort + assemble in one pass),
            # bit-exact to the numpy path below (tests/test_native.py);
            # restricted to contiguous event ranges (the production driver
            # always passes arange) because the C wiggle keys on
            # start_event + i
            from ..native import native_assemble_batch

            res = native_assemble_batch(
                packed, counts, int(ev[0]), wiggle_seed, self._native_tables()
            )
            if res is not None:
                return res
        q, tb, pad, lab = split_packed(packed)
        w = wiggle_for_events(counts, event_numbers, wiggle_seed)
        tbs = tb + w
        # reorder the narrow input columns, then assemble: identical values
        # (assembly is row-elementwise), ~20 bytes/row moved instead of the
        # assembled 72-byte f64 rows. Kept in sync with io/spyral_child.py.
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        for i in range(len(counts)):
            lo, hi = offsets[i], offsets[i + 1]
            if hi - lo > 1:
                order = np.argsort(-tbs[lo:hi], kind="stable")
                q[lo:hi] = q[lo:hi][order]
                tbs[lo:hi] = tbs[lo:hi][order]
                pad[lo:hi] = pad[lo:hi][order]
                lab[lo:hi] = lab[lo:hi][order]
        return self.assemble_spyral(q, tbs, pad, lab)

    def _native_tables(self) -> dict:
        """Contiguous f64 lookup tables for the native (C) Spyral
        assembler, derived once from the captured config."""
        t = getattr(self, "_nat_tables", None)
        if t is None:
            cfg = self.config
            pc = np.asarray(cfg.pad_centers, dtype=np.float64)
            t = {
                "pad_cx": np.ascontiguousarray(pc[:, 0]),
                "pad_cy": np.ascontiguousarray(pc[:, 1]),
                "pad_sizes": np.ascontiguousarray(
                    np.asarray(cfg.pad_sizes, dtype=np.float64)
                ),
                "resp_asc": np.ascontiguousarray(self._resp_asc_f64),
                "resp_prefix": np.ascontiguousarray(self._resp_prefix_f64),
                "resp_max": self._resp_max,
                "windows_edge": float(cfg.elec_params.windows_edge),
                "micromegas_edge": float(cfg.elec_params.micromegas_edge),
                "length": float(cfg.det_params.length),
            }
            self._nat_tables = t
        return t

    def _convert_to_spyral(self, cloud, out_budget: int, e: int, window: int):
        """Batched Spyral conversion + ADC threshold + z-sort (reference
        writer.py:61-112,222-238), windowed: merged entries arrive in
        per-event windows of ``window`` rows, each event's kept rows are
        z-ordered by a batched per-row sort (events never mix, so no global
        sort over the whole pool), then one small gather packs the row
        prefixes into the [E * out_budget] output pool.

        z ordering is EXACT: z_mm is a monotone decreasing function of tb
        ((win - tb) * positive const, writer.py:97-111), so ascending -tb ==
        ascending z with no quantization. Amplitude/integral are computed
        only on the packed pool (everything they need rides the sort as the
        charge)."""
        cfg = self.config
        w = window
        q = cloud["charges"]
        valid = cloud["cloud_valid"]
        tbs_i = cloud["tbs_i"]

        amp = jnp.minimum(self._resp_max * q, 4095.0)
        keep = valid & (amp > float(cfg.elec_params.adc_threshold))

        counts = keep.reshape(e, w).sum(axis=1, dtype=jnp.int32)
        total = counts.sum()
        out_pool = min(e * out_budget, e * w)
        out_overflow = jnp.maximum(total - out_pool, 0)

        # per-row sort: kept rows first, descending integer tb (= ascending
        # z up to same-tb ties; the host writer draws the f64 TB wiggle and
        # finalizes the exact z order per event — simulator.py:108 +
        # writer.py:236-238 semantics). The ENTIRE row packs into one i64
        # lane — [63] keep, [62:54] 511-tb, [53:40] pad, [39:32] label,
        # [31:0] f32 charge bits — so the sort is single-operand (8 B/lane
        # instead of 12 across three operands): ascending signed i64 puts
        # kept rows first (bit 63 set -> negative) in descending-tb order.
        # Unstable tie order among equal tb is fine: the reference's own
        # z-ordering is an unstable np.argsort (writer.py:236-238) and
        # same-tb ties are reordered by the host's wiggle sort anyway.
        i64 = jnp.int64
        qbits_u = jax.lax.bitcast_convert_type(q, jnp.int32).astype(
            jnp.uint32
        )
        key64 = (
            (keep.astype(i64) << 63)
            | ((511 - tbs_i.astype(i64)) << 54)
            | (cloud["pads"].astype(i64) << 40)
            | (cloud["labels"].astype(i64) << 32)
            | qbits_u.astype(i64)
        )
        # invalid lanes may carry garbage fields that could borrow into the
        # ordering bits — pin every dropped row to i64 max (sorts last; the
        # slot mask below never reads past the kept prefix anyway)
        key64 = jnp.where(keep, key64, jnp.int64(0x7FFFFFFFFFFFFFFF))
        k_s = jax.lax.sort(key64.reshape(e, w), dimension=1, is_stable=False)

        # pack row prefixes into the pooled output: slot -> (event, column).
        # NOT searchsorted: a binary search over [out_pool] slots lowers to
        # ~log2(e) serialized gather passes. Instead scatter each event's
        # start into the pool and take
        # cumulative sum/max: slot s belongs to event ev[s] = #{i >= 1:
        # cum[i] <= s}, whose start is the largest marked start <= s.
        cum = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
        )
        slots = jnp.arange(out_pool, dtype=jnp.int32)
        starts_i = cum[1:e]  # event boundaries inside the pool
        mark = (
            jnp.zeros(out_pool, jnp.int32)
            .at[starts_i]
            .add(1, mode="drop")
        )
        ev = jnp.cumsum(mark, dtype=jnp.int32)
        start_mark = (
            jnp.zeros(out_pool, jnp.int32)
            .at[starts_i]
            .max(starts_i, mode="drop")
        )
        start_of = jax.lax.cummax(start_mark)
        col = jnp.clip(slots - start_of, 0, w - 1)
        ok = slots < jnp.minimum(total, out_pool)

        # flat 1-D gather of ONE i64 pool (the whole row rides in the sort
        # key) instead of 2-D fancy indexing (x[ev, col]), which lowers to
        # a generalized gather
        flat_idx = ev * w + col
        g = k_s.reshape(-1)[flat_idx]

        # carry only what can't be recomputed on the host: x/y/z/size/
        # amplitude/integral (all derivable from pad id, tb and the merged
        # charge with host tables — see assemble_spyral) are NOT produced
        # or shipped, and the TB wiggle is drawn host-side, so the
        # device->host transfer stays small. Output is ONE packed i32[P, 2] —
        # (charge f32 bits, tb << 22 | pad << 8 | label) — 8 bytes/row
        # instead of 36, one transfer per batch (split_packed on the host
        # recovers the fields bit-exactly).
        tb_g = 511 - ((g >> 54) & 0x1FF)
        meta = (
            (tb_g << 22) | (((g >> 40) & 0x3FFF) << 8) | ((g >> 32) & 0xFF)
        ).astype(jnp.int32)
        qbits = (g & 0xFFFFFFFF).astype(jnp.uint32)
        packed = jnp.stack(
            [
                jax.lax.bitcast_convert_type(
                    jnp.where(ok, qbits, jnp.uint32(0)), jnp.int32
                ),
                jnp.where(ok, meta, 0),
            ],
            axis=-1,
        )
        return packed, counts, out_overflow

    # ------------------------------------------------------------------ #

    def simulate_batch(
        self,
        key,
        vertices: np.ndarray,
        momenta: np.ndarray,
        assemble: bool = True,
        point_budget: int | None = None,
        uniq_budget: int | None = None,
        out_budget: int | None = None,
        n_steps: int | None = None,
        compact: bool = False,
        cloud_cap: int | None = None,
        wiggle_seed: int = 0,
        event_start: int = 0,
    ):
        """Simulate a batch of events.

        Parameters
        ----------
        key: jax PRNG key — the run's BASE key; per-event streams fold in
            ``event_start + i``, so values depend only on an event's
            global id, never on the batch layout.
        vertices: [E, 3] float64 (m).
        momenta: [E, N, 4] float64 (MeV).
        event_start: global index of the batch's first event.

        Returns
        -------
        dict with device arrays: ``packed`` [E*out_budget, 2] int32
        (f32 bits of the gained charge, tb << 22 | pad << 8 | label —
        split on the host with ``split_packed``; amp/integral are
        recomputed on the host in f64 from the charge, the TB wiggle is
        drawn host-side from ``wiggle_seed``) — the ADC-thresholded rows
        of all events pooled in event order, each event's rows sorted by
        descending integer tb (slice event i as rows
        [cumsum(counts)[i-1] : cumsum(counts)[i]]); ``spyral_counts`` [E];
        the raw merged cloud arrays and overflow counters; and, when
        ``assemble`` is True (default), host-assembled ``spyral``
        [total, 8] float64 and ``spyral_labels`` [total] int64 covering
        exactly the kept rows.
        """
        e = len(vertices)
        # initial gamma*beta = p / m (reference solver.py:273), f64 on host
        p3 = momenta[:, self.sim_indices, :3]  # [E, K, 3]
        gvs = (p3 / self.track_masses[None, :, None]).astype(np.float32)
        vg = np.concatenate(
            [np.asarray(vertices, dtype=np.float32), gvs.reshape(e, -1)],
            axis=1,
        )
        vg_dev = jnp.asarray(vg)
        sim_fn = self._sim_jit
        if (
            self.mesh is not None
            and self.mesh.size > 1
            and e % self.mesh.size == 0
        ):
            from ..parallel.mesh import shard_events

            vg_dev = shard_events(self.mesh, vg_dev)
            if self._sim_sharded_mesh is not self.mesh:
                self._sim_sharded_jit = jax.jit(
                    self._simulate_sharded_impl,
                    static_argnames=(
                        "n_events",
                        "point_budget",
                        "uniq_budget",
                        "out_budget",
                        "n_steps",
                    ),
                )
                self._sim_sharded_mesh = self.mesh
            sim_fn = self._sim_sharded_jit
        out = sim_fn(
            key,
            vg_dev,
            e,
            point_budget=point_budget or self.engine.point_budget,
            uniq_budget=uniq_budget or self.engine.uniq_budget,
            out_budget=out_budget or self.engine.out_budget,
            n_steps=n_steps or self.engine.n_time_steps,
            event_start=np.int32(event_start),
        )
        # prefetch the per-batch metadata: enqueue its tiny D2H right
        # behind this batch's compute so the production loop's sync
        # np.asarray(meta) finds the bytes already streaming instead of
        # paying a fresh round trip at the sync point
        try:
            out["meta_i32"].copy_to_host_async()
        except (AttributeError, KeyError):
            pass
        if compact:
            # reference-protocol consumers need valid-rows-first layout
            cc = compact_cloud(
                {k: out[k] for k in (
                    "pads", "tbs", "charges", "labels", "events",
                    "cloud_valid", "counts",
                )},
                e,
                cloud_cap or self.engine.cloud_cap,
            )
            out["cloud_overflow"] = cc.pop("overflow")
            out.update(cc)
        if assemble:
            counts_np = np.asarray(out["spyral_counts"])
            total = int(counts_np.sum())
            # pull full fixed-shape arrays (fresh slice shapes would compile
            # a new device program per distinct length)
            spyral, labels = self.assemble_spyral_ordered(
                np.asarray(out["packed"])[:total],
                counts_np,
                np.arange(e),
                wiggle_seed,
            )
            out["spyral"] = spyral
            out["spyral_labels"] = labels
        return out


def simulate(
    momenta: np.ndarray,
    vertex: np.ndarray,
    proton_numbers: np.ndarray,
    mass_numbers: np.ndarray,
    config: Config,
    rng: np.random.Generator,
    indices: list[int],
    engine: EngineParams | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Single-event compatibility API (reference simulator.py:52-115).

    Returns (cloud [n, 3] = [pad, tb_float, electrons], labels [n]).

    NOTE: each distinct (config, species, indices, engine) combination
    compiles a device program (seconds to minutes). Repeat calls with
    the same setup reuse a cached ``DetectorSimulator`` — but for bulk
    work use ``run_simulation`` or ``DetectorSimulator.simulate_batch``,
    which amortize one compilation over whole event batches.

    The cache key is a content fingerprint of the config/engine values (NOT
    object identity: a garbage-collected Config could alias a new one at
    the same id, silently reusing stale device tables). Mutating a Config
    in place between calls is picked up for every fingerprinted field; pad
    assets are fingerprinted by their source paths.
    """
    cache_key = (
        _config_fingerprint(config),
        tuple(np.asarray(proton_numbers).tolist()),
        tuple(np.asarray(mass_numbers).tolist()),
        tuple(indices),
        _engine_fingerprint(engine),
    )
    cached = _SIMULATE_CACHE.get(cache_key)
    if cached is None:
        cached = DetectorSimulator(
            config, proton_numbers, mass_numbers, indices=indices, engine=engine
        )
        _SIMULATE_CACHE.clear()  # one live entry: these hold device tables
        _SIMULATE_CACHE[cache_key] = cached
    sim = cached
    key = jax.random.PRNGKey(int(rng.integers(0, 2**63 - 1)))
    out = sim.simulate_batch(key, vertex[None, :], momenta[None, :, :])
    sel = np.asarray(out["cloud_valid"]) & (np.asarray(out["events"]) == 0)
    cloud = np.stack(
        [
            np.asarray(out["pads"], dtype=np.float64),
            np.asarray(out["tbs"], dtype=np.float64),
            np.asarray(out["charges"], dtype=np.float64),
        ],
        axis=-1,
    )[sel]
    labels = np.asarray(out["labels"], dtype=np.int64)[sel]
    return cloud, labels


def run_simulation(
    config: Config,
    input_path: Path | str,
    writer,
    indices: list[int] | None = None,
    engine: EngineParams | None = None,
    seed: int | None = None,
    show_progress: bool = True,
    start_event: int = 0,
    stop_event: int | None = None,
    auto_tune: bool = True,
    use_mesh: bool = True,
    devices: list | None = None,
):
    """Run the detector simulation over a kinematics file.

    Batched analog of the reference driver (simulator.py:118-210): reads
    event batches (either kinematics schema, or an in-memory
    ``io.KinematicsArrays`` passed as ``input_path``), simulates them as single XLA
    program executions, and hands Spyral-formatted batches to the writer.
    When more than one device is visible (and events_per_batch divides
    evenly), each batch is event-sharded across the device mesh and the
    host gather feeding the writer collects from all shards. ``devices``
    restricts the mesh to a subset — the multi-host driver
    (parallel/multihost.py) passes ``jax.local_devices()`` so each
    process runs its own event range on its own chips without forming a
    global program.

    Resume/checkpointing: ALL random streams are keyed per event from the
    event's global index — device draws via fold_in(seed, event_id) with
    the Fano stream additionally chunk-keyed so the tuned step window
    cannot shift it (deposition.event_keys / generate_electrons), the TB
    wiggle via a host Philox(seed, event_id) stream. An interrupted run
    restarted with the same seed and ``start_event`` (paired with the
    writer's ``first_run_number``) therefore reproduces exactly the
    events it would have produced, bit-identically, for ANY
    ``events_per_batch`` — the resume point need not sit on the original
    run's batch grid (tests/test_end_to_end.py::
    test_resume_reproduces_one_shot). Bit-identity assumes the same
    device layout on both runs; resuming a flat single-device run on a
    >1-chip mesh (or vice versa) recompiles the XLA-partitioned
    conversion tail with reassociated f32 reductions, so rows then match
    to float tolerance rather than bit-for-bit
    (tests/test_parallel.py::test_sharded_matches_single_device). The
    reference only offers whole-run restartability (SURVEY.md section 5).
    """
    from ..io.kinematics_file import KinematicsArrays, KinematicsReader
    from ..io.spyral_child import tune_malloc
    from ..utils.profiling import PhaseTimes, phase_timer

    # serve the per-batch pull buffers (~10-40 MB numpy arrays) from the
    # reused glibc heap instead of freshly mmapped pages, which pay a
    # first-touch page fault per page EVERY batch
    tune_malloc()
    times = PhaseTimes()
    engine = engine or EngineParams()
    if isinstance(input_path, KinematicsArrays):
        reader = input_path
    else:
        reader = KinematicsReader(input_path)
    mesh = None
    mesh_devices = devices if devices is not None else jax.devices()
    eb_div = engine.events_per_batch % len(mesh_devices) == 0
    if use_mesh and len(mesh_devices) > 1 and eb_div:
        from ..parallel.mesh import event_mesh

        mesh = event_mesh(mesh_devices)
    sim = DetectorSimulator(
        config,
        reader.proton_numbers,
        reader.mass_numbers,
        indices=indices,
        engine=engine,
        mesh=mesh,
    )
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    # the base key rides into every batch program as the same tiny numpy
    # array; per-event keys are folded ON DEVICE from the batch's global
    # event ids (event_keys), so no host-side per-batch key derivation is
    # needed. Derive the key itself on the CPU backend (local_devices,
    # not devices: under jax.distributed a later process's
    # jax.devices("cpu")[0] belongs to process 0) so constructing it
    # never launches an accelerator program.
    try:
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            key_np = np.asarray(jax.random.PRNGKey(seed))
    except RuntimeError:
        key_np = np.asarray(jax.random.PRNGKey(seed))

    progress = None
    if show_progress:
        try:
            from tqdm import tqdm

            progress = tqdm(total=reader.n_events)
        except ImportError:
            pass

    eb = engine.events_per_batch

    class _PoolOverflow(RuntimeError):
        def __init__(self, kinds: dict):
            super().__init__(f"pool overflow: {kinds}")
            self.kinds = kinds

    def pull_batch(out, n, eb, cur_steps):
        """Pull one batch's results (device sync + transfer).

        Strictly ordered BEFORE the next dispatch: a pull issued after the
        next batch's dispatch would wait behind that batch's entire
        computation.

        Returns (counts, pf, pi, cloud_np, stats) where stats holds the
        per-event maxima used for budget auto-tuning."""
        with phase_timer(times, "pull-meta"):
            # layout: kept counts[E], n_points[E], cloud counts[E], then
            # [out_overflow, uniq_overflow, pool_overflow, steps_alive,
            #  uniq_max]
            meta = np.asarray(out["meta_i32"])
        counts = meta[:n]
        n_points = meta[eb : eb + n]
        merged_counts = meta[2 * eb : 2 * eb + n]  # pre-threshold entries
        out_overflow, uniq_overflow, pool_overflow, steps_alive, uniq_max = (
            meta[-5:]
        )
        overflows = {}
        if pool_overflow > 0:
            overflows["point"] = int(pool_overflow)
        if uniq_overflow > 0:
            overflows["uniq"] = int(uniq_overflow)
        if out_overflow > 0:
            overflows["out"] = int(out_overflow)
        if "cloud_overflow" in out and int(np.asarray(out["cloud_overflow"])) > 0:
            overflows["cloud"] = int(np.asarray(out["cloud_overflow"]))
        if steps_alive >= cur_steps and cur_steps < engine.n_time_steps:
            # tracks were still alive when the tuned-down window ended:
            # deposits may be missing vs the physics window — retry larger
            overflows["steps"] = int(steps_alive)
        if overflows:
            # every undersized pool is reported at once so one retry fixes
            # them all (doubling one pool per attempt may not converge)
            raise _PoolOverflow(overflows)
        stats = (
            int(n_points.max(initial=0)),
            int(uniq_max),
            int(counts.sum()),
            int(steps_alive),
        )
        # Slice lengths are quantized to a coarse grid: a fresh length every
        # batch would mean a fresh slice-program compilation every batch.
        def quantize(k, limit):
            q = engine.transfer_quantum
            return min(((k + q - 1) // q) * q, limit)

        if hasattr(writer, "write_spyral_pool"):
            total = int(counts.sum())
            total_q = quantize(total, out["packed"].shape[0])
            # BEGIN the device->host copy but do not wait: the slice is
            # enqueued on the device stream here (before the next batch's
            # compute) and streams to the host while that compute runs;
            # the caller materializes it after dispatching the next batch.
            with phase_timer(times, "pull-start"):
                p_dev = out["packed"][:total_q]
                p_dev.copy_to_host_async()
            return counts, (p_dev, total), merged_counts, None, stats
        # reference SimulationWriter protocol path: pull the raw cloud
        # (compacted on device by simulate_batch(compact=True), so the
        # counts come from the compacted layout, not the meta block)
        with phase_timer(times, "pull-cloud"):
            cl_counts = np.asarray(out["counts"])[:n]
            cl_total = int(cl_counts.sum())
            cl_q = quantize(cl_total, out["pads"].shape[0])
            raw = np.stack(
                [
                    np.asarray(out["pads"][:cl_q], dtype=np.float64)[:cl_total],
                    np.asarray(out["tbs"][:cl_q], dtype=np.float64)[:cl_total],
                    np.asarray(out["charges"][:cl_q], dtype=np.float64)[:cl_total],
                ],
                axis=-1,
            )
            labels_all = np.asarray(out["labels"][:cl_q], dtype=np.int64)[:cl_total]
        return counts, None, None, (raw, labels_all, cl_counts), stats

    def write_out(pending):
        """Assemble (host numpy) + write one batch; runs on the writer
        thread, overlapping the next batch's device work."""
        counts, packed, raw_counts, cloud_np, start, n = pending
        if cloud_np is None:
            if hasattr(writer, "write_packed"):
                # out-of-process writer: ship the packed rows, assembly +
                # TB wiggle + HDF5 happen in the child (see SpyralWriterProc)
                with phase_timer(times, "ship-to-writer"):
                    writer.write_packed(
                        packed, counts, np.arange(start, start + n),
                        raw_counts=raw_counts, wiggle_seed=seed,
                    )
            else:
                with phase_timer(times, "assemble"):
                    spyral_pool, labels_pool = sim.assemble_spyral_ordered(
                        packed, counts, np.arange(start, start + n), seed
                    )
                with phase_timer(times, "h5py-write"):
                    writer.write_spyral_pool(
                        spyral_pool, labels_pool, counts,
                        event_numbers=np.arange(start, start + n),
                        raw_counts=raw_counts,
                    )
        else:
            # reference SimulationWriter protocol: hand each event its raw
            # [N, 3] = [pad, tb, electrons] cloud (writer.py:26-44)
            raw, labels_all, cl_counts = cloud_np
            offsets = np.concatenate([[0], np.cumsum(cl_counts)])
            for i in range(n):
                lo, hi = int(offsets[i]), int(offsets[i + 1])
                if hi == lo:
                    continue
                writer.write(raw[lo:hi], labels_all[lo:hi], config, start + i)
        if progress is not None:
            progress.update(n)

    # Pipelined loop: dispatch -> pull on the main thread; assemble + HDF5
    # write on ONE background writer thread (bounded queue, strict batch
    # order). The pull stays ordered before the next dispatch, but the
    # write path touches only host memory and disk, so it overlaps the
    # next batch's dispatch/compute/transfer. The writer thread spends its
    # time in h5py/OS write calls, which release the GIL, while the main
    # thread blocks on the device.
    #
    # Budget auto-tuning: sort/merge cost scales with pool CAPACITY, not
    # content (sentinel entries ride every sorting pass), so after the first
    # batch the pools are retightened to ~1.6x the observed multiplicities
    # (one extra compilation). A later batch overflowing a pool doubles
    # every undersized budget at once and recomputes the same batch — keys
    # derive from the event range, so the retry reproduces the same physics
    # (bit-identical up to the TB wiggle stream, whose draw shape follows
    # the pool size).
    import os
    import queue as _queue
    import threading

    wq: _queue.Queue = _queue.Queue(maxsize=2)
    werr: list[BaseException] = []

    def _writer_loop():
        while True:
            pending = wq.get()
            if pending is None:
                return
            try:
                if not werr:
                    write_out(pending)
            except BaseException as exc:  # surface on the main thread
                werr.append(exc)
            finally:
                wq.task_done()

    wthread = threading.Thread(target=_writer_loop, name="spyral-writer")
    wthread.start()

    def _enqueue_write(pending):
        if werr:
            raise werr[0]
        wq.put(pending)

    def _drain_writer():
        wq.put(None)
        wthread.join()
        if werr:
            raise werr[0]

    timing = os.environ.get("ATTPC_TPU_TIMING")
    stop = reader.n_events if stop_event is None else min(stop_event, reader.n_events)

    def round_up(k, q):
        # coarse granularity keeps the tuned shapes stable across runs with
        # different seeds (every distinct shape costs a compilation)
        return max(((int(k) + q - 1) // q) * q, q)

    budgets = {
        "point": engine.point_budget,
        "uniq": engine.uniq_budget,
        "cloud": engine.cloud_cap,
        "out": engine.out_budget,
        # Probe-first window: under auto-tuning the first batch runs ONE
        # chunk; if any track is still alive at the window's end the steps
        # ladder below retries at 4x (bounded by the physics window), so a
        # config whose tracks outlive the probe pays at most 3 extra
        # compiles while typical AT-TPC configs (tracks die inside ~1
        # chunk) never compile the full-window program at all.
        "steps": engine.n_time_steps
        if not auto_tune
        else min(engine.chunk_steps, engine.n_time_steps),
    }
    raw_writer = not hasattr(writer, "write_spyral_pool")
    chunk = engine.chunk_steps
    tuned = not auto_tune
    wall_t0 = time.perf_counter()

    # one batch of packed device->host copies stays in flight: its transfer
    # (started by pull_batch via copy_to_host_async) streams to the host
    # while the NEXT batch computes, and is materialized right after
    # that batch's dispatch
    pending_dev = None  # (counts, (p_dev, total), raw_counts, start, n)

    def materialize_and_write(p):
        counts_p, (p_dev, total), raw_p, start_p, n_p = p
        with phase_timer(times, "pull-packed"):
            packed = np.asarray(p_dev)[:total]
        _enqueue_write((counts_p, packed, raw_p, None, start_p, n_p))

    try:
        for start in range(start_event, stop, eb):
            with phase_timer(times, "read"):
                vertices, momenta = reader.read_range(start, min(start + eb, stop))
            n = len(vertices)
            if n < eb:  # pad the tail batch to avoid a recompile
                pad_n = eb - n
                vertices = np.concatenate([vertices, np.zeros((pad_n, 3))])
                momenta = np.concatenate(
                    [momenta, np.zeros((pad_n,) + momenta.shape[1:])]
                )
            for _attempt in range(8):
                with phase_timer(times, "dispatch"):
                    out = sim.simulate_batch(
                        key_np, vertices, momenta, assemble=False,
                        event_start=start,
                        point_budget=budgets["point"],
                        uniq_budget=budgets["uniq"],
                        out_budget=budgets["out"],
                        n_steps=budgets["steps"],
                        compact=raw_writer,
                        cloud_cap=budgets["cloud"],
                    )
                if pending_dev is not None:
                    # previous batch: its transfer has been streaming since
                    # its pull-start; this batch's compute runs meanwhile
                    materialize_and_write(pending_dev)
                    pending_dev = None
                try:
                    counts, handles, merged_cts, cloud_np, stats = pull_batch(
                        out, n, eb, budgets["steps"]
                    )
                    break
                except _PoolOverflow as ov:
                    for kind in ov.kinds:
                        if kind == "steps":
                            budgets["steps"] = min(
                                round_up(budgets["steps"] * 4, chunk),
                                engine.n_time_steps,
                            )
                        else:
                            budgets[kind] *= 2
                            if budgets[kind] > 2**21:
                                raise
            else:
                raise RuntimeError("pool budgets failed to converge")
            if cloud_np is not None:
                _enqueue_write((counts, None, None, cloud_np, start, n))
            else:
                pending_dev = (counts, handles, merged_cts, start, n)
            if not tuned:
                # retighten to the observed first-batch multiplicities
                pts_max, uniq_max, kept, steps_alive = stats
                budgets["point"] = min(
                    budgets["point"], round_up(pts_max * 1.3, 64)
                )
                budgets["uniq"] = min(
                    budgets["uniq"], round_up(uniq_max * 1.3, 1024)
                )
                budgets["out"] = min(
                    budgets["out"], round_up(kept / eb * 1.3, 1024)
                )
                budgets["steps"] = min(
                    round_up(steps_alive * 1.3, chunk), engine.n_time_steps
                )
                tuned = True
        if pending_dev is not None:
            materialize_and_write(pending_dev)
            pending_dev = None
        _drain_writer()
        if timing:
            import sys

            print(
                f"[run_simulation] budgets={budgets}\n{times.summary()}",
                file=sys.stderr,
            )
    finally:
        if wthread.is_alive():
            wq.put(None)
            wthread.join()
        writer.close()
        reader.close()
        if progress is not None:
            progress.close()
        if hasattr(writer, "get_directory_name"):
            from ..utils.manifest import write_run_manifest

            dp = config.det_params
            ep = config.elec_params
            write_run_manifest(
                writer.get_directory_name(),
                stage="detector",
                seed=seed,
                event_range=(start_event, stop),
                config={
                    "input": str(input_path),
                    "length_m": dp.length,
                    "efield": dp.efield,
                    "bfield": dp.bfield,
                    "mpgd_gain": dp.mpgd_gain,
                    "diffusion": dp.diffusion,
                    "fano_factor": dp.fano_factor,
                    "w_value": dp.w_value,
                    "adc_threshold": ep.adc_threshold,
                    "sim_indices": sim.sim_indices,
                },
                budgets=budgets,
                phase_seconds=dict(times.seconds),
                wall_seconds=time.perf_counter() - wall_t0,
                extra={
                    "events_per_batch": eb,
                    "sharded_devices": mesh.size if mesh is not None else 1,
                },
            )
