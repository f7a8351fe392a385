"""Electron generation, diffusion transport and (pad, tb) merging.

Batched replacement for the reference's numba transport kernels
(/root/reference/src/attpc_engine/detector/transporter.py:124-318) and the
numba-Dict accumulation (simulator.py:93-104). The reference iterates
trajectory points in Python/numba, depositing each point's electrons onto a
10x10 Gaussian mesh and accumulating charge in a hash map keyed by
Szudzik(tb, pad). Here the whole batch is processed as array programs,
structured around per-event sort windows (v3):

1. ``generate_electrons`` — Fano-smeared electron counts per deposit point
   (reference solver.py:308-347) as one vectorized normal draw,
2. per-event compaction: each event's valid deposit points are packed into
   its own fixed window of ``point_budget`` slots (row cumsum + one
   scatter); overflow per event is counted,
3. mesh expansion: every pooled point emits a 10x10 pixel block. Merge
   keys pack (space_key << rank_bits) | track_rank into one int32: sorting
   the packed key groups equal-space runs AND orders each run by track
   deposition rank — so UNSTABLE 2-operand sorts suffice and the run's
   last element is the reference's dict-overwrite label writer,
4. pad ids come from one gather into the pre-keyed 1-mm lookup table
   (beam-pad veto pre-folded vs the reference's 122-element scan per
   pixel), then one per-event-window merge (``_merge_runs``: sort -> row
   cumsum -> run-end prefix differences -> compacting sort). Events never
   share keys, so there is NO ceiling on events per batch,
5. the per-point TB wiggle U[0,1) and the 0 <= tb < 512 bound
   (simulator.py:108-113) are applied to the merged entries.

The merged entries are returned in per-event windows of width
``uniq_budget`` (flattened), COMPACTED: event i's unique points occupy
slots [i*U, i*U + counts[i]) in ascending (pad, tb) order. The label is
the last writer in deposition order — exactly the reference's
dict-overwrite semantics (transporter.py:169,249) — recovered from the
packed track rank (tracks are deposited in slot order, and within one
track every pixel of a (pad, tb) run shares the label).

Per-event windows also make the event axis trivially shardable across a
device mesh: every array is event-major with no cross-event structure.

Differences from the reference, documented per SURVEY.md hard-part 5:
- (a) positions are floored to whole mm before pad lookup (quirk kept), but
  the reference's f64 division artifact that sometimes lands one 0.1 mm bin
  lower is not reproduced (we compute the bin index by rounding),
- per-pixel charges are accumulated in f32 without the reference's
  per-pixel int() truncation (sub-ppm effect at MPGD gains). Run totals
  come from differences of an f32 inclusive prefix over the event window,
  so the absolute error is ~(event total) * eps_f32 — sub-electron for any
  physical event,
- out-of-window tbs are dropped at deposit time (provably identical to the
  reference's post-hoc mask),
- capacities are bounded: the per-event point windows and the per-event
  ``uniq_budget`` unique-(pad, tb) slots report overflow counts instead of
  growing unboundedly (the driver doubles the budget and re-runs the
  batch).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "event_keys",
    "generate_electrons",
    "deposit_and_merge",
    "compact_cloud",
    "MESH_STEPS",
    "KEY_SENTINEL",
]

MESH_STEPS = 10  # reference transporter.py:8
NUM_TB = 512
# NOTE: a plain numpy scalar, NOT jnp: module-level device arrays become
# closure constants of every jitted program, and embedding one in MLIR
# forces a device->host pull at LOWERING time.
KEY_SENTINEL = np.int32(2**31 - 1)


def event_keys(key: jax.Array, n_events: int, event_start=0) -> jax.Array:
    """Per-event PRNG keys [E, 2] from a base key and global event ids.

    The device draws downstream (Fano smear, raw-cloud TB wiggle) consume
    one key per EVENT, folded from the base key with the event's GLOBAL
    index — so an event's random stream is independent of which batch it
    rides in, and ``start_event`` resume is bit-exact for any
    ``events_per_batch`` (reference analog: one numpy Generator consumed
    event-by-event, simulator.py:118-210 — also layout-invariant).
    """
    ids = jnp.asarray(event_start, dtype=jnp.int32) + jnp.arange(
        n_events, dtype=jnp.int32
    )
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, ids)


def generate_electrons(
    keys: jax.Array,
    dke: jax.Array,
    w_value: float,
    fano_factor: float,
    chunk_steps: int | None = None,
) -> jax.Array:
    """Electrons created per deposit point (reference solver.py:331-347).

    n = |dKE| * 1e6 / w, Fano-smeared with sigma = sqrt(fano * n), truncated
    to integers (toward zero, as numpy's int cast does).

    ``keys`` is one PRNG key per event ([E, 2], see ``event_keys``); the
    batch layout [T, B] must be event-major (B = E*K). The noise for step
    t of event i is drawn from fold_in(keys[i], t // chunk_steps), shape
    (chunk_steps, K) per fold — so the stream is invariant both to the
    batch layout AND to the tuned effective window length (the driver
    retunes ``n_steps`` in multiples of the engine's ``chunk_steps``;
    a longer window only appends chunks). ``chunk_steps=None`` uses a
    single chunk spanning the whole window.
    """
    t, b = dke.shape
    e = keys.shape[0]
    k = b // e
    cs = t if chunk_steps is None else min(chunk_steps, t)
    n_chunks = -(-t // cs)

    def per_event(kk):
        ck = jax.vmap(lambda c: jax.random.fold_in(kk, c))(
            jnp.arange(n_chunks, dtype=jnp.int32)
        )
        return jax.vmap(
            lambda key_c: jax.random.normal(key_c, (cs, k), dtype=jnp.float32)
        )(ck).reshape(n_chunks * cs, k)

    noise = jax.vmap(per_event)(keys)[:, :t]  # [E, T, K]
    noise = jnp.transpose(noise, (1, 0, 2)).reshape(t, b)
    n_mean = dke * (1.0e6 / w_value)
    sigma = jnp.sqrt(fano_factor * n_mean)
    n = n_mean + sigma * noise
    return n.astype(jnp.int32)


def _key_lookup(
    key_grid_flat: jax.Array,
    lo_mm: float,
    n_mm: int,
    x_m: jax.Array,
    y_m: jax.Array,
) -> jax.Array:
    """Pre-keyed pad lookup at (x, y) in meters.

    Keeps the reference's whole-mm floor quirk (transporter.py:101-120):
    coordinates are floored to integer mm, which is why a 1-mm table is
    exactly equivalent to the reference's 0.1-mm grid. The table holds
    pad_id * NUM_TB with beam pads and off-plane holes pre-folded to
    KEY_SENTINEL (see Config.device_arrays).

    Returns pad_id * NUM_TB, or KEY_SENTINEL for vetoed/out-of-plane hits.
    """
    ix = jnp.floor(x_m * 1000.0 - lo_mm).astype(jnp.int32)
    iy = jnp.floor(y_m * 1000.0 - lo_mm).astype(jnp.int32)
    inb = (ix >= 0) & (ix < n_mm) & (iy >= 0) & (iy < n_mm)
    flat = jnp.clip(ix, 0, n_mm - 1) * n_mm + jnp.clip(iy, 0, n_mm - 1)
    key = key_grid_flat[flat]
    return jnp.where(inb, key, KEY_SENTINEL)


def _run_last(keys: jax.Array) -> jax.Array:
    """Mask of the last element of each equal-key run along the last axis."""
    change = keys[..., 1:] != keys[..., :-1]
    ones = jnp.ones(keys.shape[:-1] + (1,), dtype=bool)
    return jnp.concatenate([change, ones], axis=-1)


def _merge_runs(
    packed: jax.Array,
    qv: jax.Array,
    cap: int,
    rank_bits: int,
):
    """Merge per-row entries with equal (packed >> rank_bits) keys.

    The merge primitive of this engine: one unstable window sort groups
    equal keys (deposition rank rides in the key's low bits, so the run's
    LAST element is the deposition-last writer), a plain row ``cumsum``
    forms an inclusive charge prefix, and a second sort compacts the
    run-end rows to ``cap`` slots per row; each run's total is the
    difference of the prefix at consecutive run-ends.

    packed: [E, W] int32, KEY_SENTINEL for dead lanes (their qv must be 0).
    qv: [E, W] f32 nonnegative charges.

    Returns (key2 [E, cap] ascending with SENTINEL padding, sums [E, cap],
    valid2 [E, cap], n_uniq [E] — the TOTAL unique count before capping,
    for overflow accounting).
    """
    e = packed.shape[0]
    cap = min(cap, packed.shape[1])
    f32 = jnp.float32
    i64 = jnp.int64

    def pack64(key_i32, val_f32):
        # key in the high 32 bits (keys are nonnegative i32, so the i64
        # stays positive and ascending-sorts by key first), the f32 value's
        # bit pattern in the low 32 (nonnegative floats order monotonically
        # as unsigned ints, and within equal keys the value order is
        # irrelevant here). One 8 B/lane operand instead of 12 B across
        # two — sort cost tracks bytes/lane through the sorting network.
        vb = jax.lax.bitcast_convert_type(val_f32, jnp.int32)
        return (key_i32.astype(i64) << 32) | vb.astype(jnp.uint32).astype(i64)

    def unpack64(g):
        key = (g >> 32).astype(jnp.int32)
        val = jax.lax.bitcast_convert_type(
            (g & 0xFFFFFFFF).astype(jnp.uint32), f32
        )
        return key, val

    def sort2(key_i32, val_f32):
        """(key, f32 val) -> both sorted ascending-lexicographic."""
        g = jax.lax.sort(pack64(key_i32, val_f32), dimension=1,
                         is_stable=False)
        return unpack64(g)

    packed, qq = sort2(packed, qv)
    ukey = packed >> rank_bits  # sentinel maps above every real key
    last = _run_last(ukey)
    real_last = last & (packed != KEY_SENTINEL)
    n_uniq = real_last.sum(axis=1, dtype=jnp.int32)

    # inclusive prefix of the sorted charges: invalid lanes carry q = 0,
    # so they never perturb the prefix
    c = jnp.cumsum(qq, axis=1, dtype=f32)

    # compact the run-end rows (ascending key; prefix order is preserved
    # because c is nondecreasing and run-ends are already in key order)
    k2_full, c2_full = sort2(
        jnp.where(real_last, packed, KEY_SENTINEL),
        jnp.where(real_last, c, 0.0),
    )
    key2, c2 = k2_full[:, :cap], c2_full[:, :cap]

    valid2 = key2 != KEY_SENTINEL
    prev = jnp.concatenate([jnp.zeros((e, 1), f32), c2[:, :-1]], axis=1)
    # clamp: XLA's tree cumsum is not strictly monotone in f32, and runs
    # below the prefix's epsilon (far under one electron) legitimately
    # difference to zero — matching the reference's own charge-0 dict
    # entries from per-pixel int() truncation
    sums = jnp.where(valid2, jnp.maximum(c2 - prev, 0.0), 0.0)
    return key2, sums, valid2, n_uniq


@partial(
    jax.jit,
    static_argnames=(
        "n_events", "tracks_per_event", "point_budget", "uniq_budget",
    ),
)
def deposit_and_merge(
    key: jax.Array,
    positions: jax.Array,
    electrons: jax.Array,
    valid: jax.Array,
    track_labels: jax.Array,
    key_grid_mm: jax.Array,
    grid_lo_mm: float,
    grid_n_mm: int,
    diffusion: float,
    efield: float,
    drift_velocity: float,
    micromegas_edge: float,
    length: float,
    mpgd_gain: float,
    n_events: int,
    tracks_per_event: int,
    point_budget: int = 1024,
    uniq_budget: int = 12288,
):
    """Transport deposits to the pad plane and merge to unique (pad, tb).

    Parameters
    ----------
    key: [E, 2] per-event PRNG keys (``event_keys``) — raw-cloud TB wiggle.
    positions: [T, B, 3] f32 — deposit positions (m), B = n_events * K.
        Track layout must be event-major: track b belongs to event b // K,
        nucleus slot b % K (this reproduces the reference's nucleus-outer,
        time-inner deposition order for label semantics).
    electrons: [T, B] int32 — electrons per point (pre-gain).
    valid: [T, B] bool — real deposit points.
    track_labels: [B] int32 — nucleus index written to the labels output.
    key_grid_mm: [n_mm, n_mm] int32 pre-keyed pad lookup (pad * NUM_TB,
        KEY_SENTINEL where vetoed/hole); grid_lo_mm/grid_n_mm: its edges.
    diffusion, efield, drift_velocity, micromegas_edge, length, mpgd_gain:
        physics scalars (reference meanings).
    point_budget: per-event point window capacity. Overflowing points (the
        trailing ones in deposition order) are dropped and counted in
        ``pool_overflow``.
    uniq_budget: unique-(pad, tb) slots kept per event. Overflow (the
        highest-key entries) is dropped and counted in ``uniq_overflow``.

    Returns
    -------
    dict of merged entries in flattened per-event windows of width
    U = uniq_budget (S = n_events * U rows; event i owns rows
    [i*U, (i+1)*U), valid slots compacted first, within-window order =
    ascending (pad, tb) key):
        pads [S] i32, tbs [S] f32 (wiggled), charges [S] f32 (gain
        applied), labels [S] i32, events [S] i32 (= n_events for invalid
        rows), cloud_valid [S] bool, counts [E] i32 (unique points per
        event, clipped to U), n_points [E] i32 (deposit points),
        pool_overflow [] i32, uniq_overflow [] i32, uniq_max [] i32 (max
        uniques on any event — drives budget tuning).
    """
    t_steps, b = electrons.shape
    k_tracks = tracks_per_event
    e = n_events
    pb = point_budget
    f32 = jnp.float32
    key_grid_flat = key_grid_mm.reshape(-1)
    p = e * pb

    # pack ((pad * 512 + tb) << rank_bits) | track_rank: sorting the packed
    # key orders runs of equal (pad, tb) by deposition rank. Max real key is
    # 10239 * 512 + 511 < 2^23, so up to 256 tracks/event fit in int32.
    rank_bits = max(1, int(k_tracks - 1).bit_length())
    if (10240 * NUM_TB) << rank_bits >= 2**31:
        raise ValueError(f"too many tracks per event ({k_tracks}) to pack")
    u_cap = min(uniq_budget, pb * MESH_STEPS * MESH_STEPS)

    # electrons >= 1 is part of validity (reference solver.py:387-389)
    valid = valid & (electrons >= 1)

    # z -> float TB (reference solver.py:394-398)
    tb_f = (length - positions[:, :, 2]) / drift_velocity + micromegas_edge
    tb_i = tb_f.astype(jnp.int32)  # trunc toward zero
    # tb_f in (-1, 0) truncates to tb 0 and survives the reference's final
    # 0 <= tb mask after the wiggle, so the keep-condition is tb_f > -1
    valid = valid & (tb_f > -1.0) & (tb_i < NUM_TB)

    # --- per-event point-window compaction ------------------------------- #
    # [T, B] -> [B, T] -> [E, K*T]: flat (event, nucleus, time) deposition
    # order within each event row
    kt = k_tracks * t_steps

    def ev_flat(a):
        return a.transpose(1, 0).reshape(e * kt)

    valid_r = ev_flat(valid).reshape(e, kt)
    n_points = valid_r.sum(axis=1, dtype=jnp.int32)
    pool_overflow = jnp.maximum(n_points - pb, 0).sum()

    slot = jnp.cumsum(valid_r.astype(jnp.int32), axis=1) - 1
    row = jnp.arange(e, dtype=jnp.int32)[:, None]
    dest = jnp.where(valid_r & (slot < pb), row * pb + slot, p)
    src = (
        jnp.full(p, -1, jnp.int32)
        .at[dest.reshape(-1)]
        .set(jnp.arange(e * kt, dtype=jnp.int32), mode="drop")
    )
    taken = src >= 0
    gsrc = jnp.maximum(src, 0)

    px = ev_flat(positions[:, :, 0])[gsrc]
    py = ev_flat(positions[:, :, 1])[gsrc]
    ptbf = ev_flat(tb_f)[gsrc]
    ptbi = ev_flat(tb_i)[gsrc]
    # gain is applied after the merge (keeps summed charge magnitudes small
    # for the f32 prefix sums)
    pne = ev_flat(electrons)[gsrc].astype(f32)
    prank = (gsrc // t_steps) % k_tracks  # deposition rank within the event

    # --- diffusion mesh expansion ---------------------------------------- #
    # sigma_t = sqrt(2 D dv t / E), t in (float) TBs (transporter.py:301)
    sigma = jnp.sqrt(2.0 * diffusion * drift_velocity * ptbf / efield).astype(f32)
    has_diff = sigma > 0.0
    sigma_safe = jnp.where(has_diff, sigma, 1.0)

    # 10x10 mesh offsets in units of sigma: -3s .. +3s inclusive. The
    # pixel block of one point is the OUTER PRODUCT {x_i} x {y_j}: only 10
    # distinct x and 10 distinct y coordinates per point.
    mesh_1d = jnp.linspace(-3.0, 3.0, MESH_STEPS, dtype=f32)
    step = 6.0 / (MESH_STEPS - 1)  # in sigma units

    # separable pixel coordinates [P, 10]
    x10 = px[:, None] + sigma_safe[:, None] * mesh_1d[None, :]
    y10 = py[:, None] + sigma_safe[:, None] * mesh_1d[None, :]
    # sigma == 0 (diffusion disabled) -> point transport: all electrons on
    # the point itself through pixel slot (0, 0) (transporter.py:124-169)
    x10 = jnp.where(has_diff[:, None], x10, px[:, None])
    y10 = jnp.where(has_diff[:, None], y10, py[:, None])

    # bivariate normal pdf * pixel area (sigma^2 cancels against the area)
    off_x = mesh_1d[:, None]  # [10, 1]
    off_y = mesh_1d[None, :]  # [1, 10]
    pdf_area = (step * step / (2.0 * jnp.pi)) * jnp.exp(
        -0.5 * (off_x**2 + off_y**2)
    )  # [10, 10], sigma-independent
    q_pix = pne[:, None, None] * pdf_area
    q_point = jnp.zeros((MESH_STEPS, MESH_STEPS), dtype=f32).at[0, 0].set(1.0)
    q_pix = jnp.where(has_diff[:, None, None], q_pix, pne[:, None, None] * q_point)

    n_px = MESH_STEPS * MESH_STEPS
    w = pb * n_px
    # one single-pass gather per pixel: pad*NUM_TB or sentinel, beam veto
    # and off-plane holes pre-folded into the 1-mm key grid
    with jax.named_scope("pad_lookup"):
        pkey = _key_lookup(
            key_grid_flat, grid_lo_mm, grid_n_mm,
            x10[:, :, None], y10[:, None, :],
        )
        pix_valid = (pkey != KEY_SENTINEL) & taken[:, None, None]
        packed = jnp.where(
            pix_valid,
            ((pkey + ptbi[:, None, None]) << rank_bits) | prank[:, None, None],
            KEY_SENTINEL,
        ).reshape(e, w)
        qq_in = jnp.where(pix_valid, q_pix, 0.0).reshape(e, w)

    # --- per-event-window merge to unique (pad, tb) ----------------------- #
    with jax.named_scope("merge"):
        key2, sums, valid2, n_uniq = _merge_runs(packed, qq_in, u_cap, rank_bits)
    uniq_max = n_uniq.max()
    uniq_overflow = jnp.maximum(n_uniq - u_cap, 0).sum()
    counts = jnp.minimum(n_uniq, u_cap)

    ufinal = key2 >> rank_bits
    rank2 = jnp.where(valid2, key2 & ((1 << rank_bits) - 1), 0)
    # label of the run's deposition-last track: tracks deposit in slot
    # order, so max rank in a run == last writer (reference
    # transporter.py:169,249 dict-overwrite semantics)
    lab_idx = jnp.clip(row * k_tracks + rank2, 0, b - 1).reshape(-1)
    labels = jnp.where(valid2.reshape(-1), track_labels[lab_idx], -1)

    events_out = jnp.where(valid2, row, e).reshape(-1)
    pads_out = jnp.where(valid2, ufinal // NUM_TB, -1).reshape(-1)
    tbs_int = jnp.where(valid2, ufinal % NUM_TB, 0).reshape(-1)
    charges = jnp.where(valid2, sums * f32(mpgd_gain), 0.0).reshape(-1)

    # TB wiggle U[0, 1) (simulator.py:108) — applied here for the raw
    # reference-protocol cloud; the packed Spyral wire path instead ships
    # the INTEGER tb (``tbs_i``) and wiggles on the host in f64 from
    # per-event counter-based streams (simulator._wiggle_for_events):
    # 4 fewer bytes per wire row, f64 wiggle arithmetic like the
    # reference's, and a wiggle stream independent of events_per_batch.
    # The raw draw is per EVENT (one key per row of ``key``), so it too is
    # batch-layout invariant — and since threefry is counter-based
    # (uniform(key, (n,))[i] depends only on (key, i); verified), the
    # value a given merged row sees is ALSO uniq_budget-independent.
    cap = valid2.shape[1]
    wiggle = jax.vmap(
        lambda kk: jax.random.uniform(kk, (cap,), dtype=f32)
    )(key).reshape(-1)
    tb_f = tbs_int.astype(f32)
    # f32 rounding can carry tb + U[0,1) up to the NEXT integer (eps(512)
    # = 2^-14, so draws within 2^-15 of 1 round up — p ~ 3e-5/row), which
    # would alias two distinct merged (pad, tb) keys; clamp to the largest
    # f32 strictly below tb+1 so floor(tbs) == tb always holds (the
    # reference's f64 wiggle makes this p ~ 2^-45 — effectively never)
    tbs_out = jnp.minimum(tb_f + wiggle, jnp.nextafter(tb_f + 1.0, tb_f))

    return {
        "pads": pads_out,
        "tbs": tbs_out,
        "tbs_i": tbs_int,
        "charges": charges,
        "labels": labels,
        "events": events_out,
        "cloud_valid": valid2.reshape(-1),
        "counts": counts,
        "n_points": n_points,
        "pool_overflow": pool_overflow,
        "uniq_overflow": uniq_overflow,
        "uniq_max": uniq_max,
    }


@partial(jax.jit, static_argnames=("n_events", "cap"))
def compact_cloud(cloud: dict, n_events: int, cap: int):
    """Compact merged entries into a pooled layout: valid rows first,
    ordered by (event, key), capacity ``cap`` rows per event (shared
    pool of n_events * cap). For consumers that need one contiguous pool
    across events (the reference-protocol writer path)."""
    e = n_events
    s_cap = min(e * cap, cloud["pads"].shape[0])
    evkey = jnp.where(cloud["cloud_valid"], cloud["events"], jnp.int32(2**30))
    ev, pads, tbs, charges, labels = jax.lax.sort(
        (evkey, cloud["pads"], cloud["tbs"], cloud["charges"], cloud["labels"]),
        dimension=0,
        is_stable=True,
        num_keys=1,
    )
    ev = ev[:s_cap]
    total = cloud["counts"].sum()
    overflow = jnp.maximum(total - s_cap, 0)
    ev_range = jnp.arange(e + 1, dtype=jnp.int32)
    bounds = jnp.searchsorted(ev, ev_range, side="left")
    counts = (bounds[1:] - bounds[:-1]).astype(jnp.int32)
    valid = jnp.arange(s_cap, dtype=jnp.int32) < jnp.minimum(total, s_cap)
    return {
        "pads": pads[:s_cap],
        "tbs": tbs[:s_cap],
        "charges": charges[:s_cap],
        "labels": labels[:s_cap],
        "events": jnp.where(valid, ev, e),
        "cloud_valid": valid,
        "counts": counts,
        "overflow": overflow,
    }
