"""The device engine: on-device index + scan, host event chain.

End-to-end chunk scan on the device (reference hot loop being replaced:
automaton.rs:96-201 + searcher.rs:145-180):

  1. probe stream derived on device from the text codes (stride k/2,
     N-probe skip — automaton.rs:90-102);
  2. probe equal-ranges by one row-gather into the per-position tables of
     the doubled-text :class:`~asgart_tpu.device_index.DeviceIndex` — no
     per-probe search;
  3. flat CSR gather of all match windows, filtered exactly like the
     native chain (self hit, direction predicate, appended-half cutoff),
     per-probe kept counts, cardinality skip (automaton.rs:103-117);
  4. compaction to *events* (probes with >= 1 kept match) plus the
     intervening quiet-step counts — typically 50-500x smaller than the
     probe stream;
  5. events are downloaded (a few MB) and chained by the native
     event-stream automaton, which is fuzz-pinned equal to the full
     automaton. The sequential part of the algorithm is microseconds;
     everything bandwidth-heavy stays on the device.

A counts-only pre-pass sizes the flat gather capacity before the big
step is compiled, so repeat-dense genomes (Alu-like scatter) pick a
sufficient capacity in one shot instead of retry-recompiling.
"""

from __future__ import annotations

import functools
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import native
from .device_index import DeviceIndex

I32 = jnp.int32
log = logging.getLogger("asgart")

N_CODE = 4  # 3-bit rank of 'N'


def _bucket(n: int, lo: int = 1 << 16) -> int:
    """Pow2 buckets up to B_GRAN, then B_GRAN multiples (pow2 buckets
    waste up to 50% of the stream lanes at genome scale)."""
    b = lo
    while b < n and b < B_GRAN:
        b <<= 1
    if b < n:
        b = -(-n // B_GRAN) * B_GRAN
    return b


# probe-count bucket granularity: coarse enough to bound recompiles,
# fine enough not to waste stream lanes (old pow2 buckets wasted ~30%)
B_GRAN = 1 << 20


def _cap_bucket(n: int) -> int:
    """Pow4 buckets (from the MIN_CAP floor) for flat-gather
    capacities: coarse enough that same-scale genomes land in the SAME
    compiled cap shape — a fresh genome whose raw totals fall in a new
    bucket pays a full recompile per core shape, while the ≤4x lane
    waste is a few MB of device memory. Beyond B_GRAN: pow2 multiples
    of B_GRAN."""
    b = MIN_CAP
    while b < n and b < B_GRAN:
        b <<= 2
    while b < n:
        b <<= 1
    return b

# neutral slice-end bound (every real lane index is far below int32 max)
_J_END_ALL = np.int32(2**31 - 1)


def table_pad_for(k: int, n: int | None = None) -> int:
    """Table padding so the probe-window reads of `_scan_chunk` /
    `_window_ranges` never clamp for lanes holding real probes: bucket
    slack is at most one lane bucket + shard-divisibility roundup, and
    a SLICED dispatch reads up to another b_slice - SLICE_GRAN lanes
    past the last live lane (variable-width slices share one static
    b_slice; a clamped `dynamic_slice` would shift live lanes onto
    wrong table entries). The window reshape reads up to 3 extra
    step-rows past the last lane.

    The lane bound scales with the text: no dispatch mode ever reads
    past ``_bucket(ceil(n/step))`` lanes (chunks are subsets of the
    text; slices partition a chunk's lane range and are width-capped at
    both B_GRAN and the chunk's b_pad), so small inputs don't pay the
    genome-scale ~21M-row fixed pad — the dominant cost of every
    small-genome build (and of the CPU-mesh test tier). ~90 MB at the
    256M-row scale — well inside the memory budget's reserve."""
    step = max(k // 2, 1)
    lane_bound = B_GRAN
    if n is not None:
        lane_bound = min(B_GRAN, _bucket(-(-n // step)))
    return 2 * lane_bound * step + 1028 * step + k


def table_len_for(n: int, k: int) -> int:
    """Total padded table length for an n-position text: at least
    ``table_pad_for`` slack, rounded up so the decimated layout is
    exact (divisible by step)."""
    step = max(k // 2, 1)
    base = n + table_pad_for(k, n)
    return ((base + step - 1) // step) * step


def _dec_read(tab, x0, b: int, step: int):
    """``tab[x0 : x0 + b*step : step]`` against a DECIMATED table
    (row r = every step-th entry, row stride C = L/step): one contiguous
    ``dynamic_slice`` — no gather (a direct strided slice lowers to a
    latency-bound gather) and no [b, step] reshape view."""
    C = tab.shape[0] // step
    r = x0 % step
    q0 = x0 // step
    return jax.lax.dynamic_slice(tab, (r * C + q0,), (b,))


def _probe_x0(chunk_start, chunk_len, first_len, k: int, reverse: bool,
              complement: bool):
    """Table position of probe j=0 (i = step); x is affine increasing in
    j for every transform: x = x0 + j*step (PositionIndex
    .probe_table_positions algebra)."""
    step = k // 2
    if reverse:
        # x = n1 + (n1 - 1 - (start + len - i - k) - k) = const + i
        return 2 * first_len - 1 - chunk_start - chunk_len + step
    if complement:
        return first_len + chunk_start + step
    return chunk_start + step


@functools.partial(jax.jit, static_argnames=("k", "reverse", "complement",
                                             "b_pad"))
def _raw_total(pos_lo_tab, pos_hi_tab, chunk_start, chunk_len,
               first_len, k: int, reverse: bool, complement: bool,
               b_pad: int):
    """Cheap pre-pass: the summed raw window size, to size the flat
    gather before the big step is compiled."""
    step = k // 2
    x0 = _probe_x0(chunk_start, chunk_len, first_len, k, reverse,
                   complement)
    lo_raw = _dec_read(pos_lo_tab, x0, b_pad, step)
    hi = _dec_read(pos_hi_tab, x0, b_pad, step)
    lo = lo_raw & jnp.int32(0x7FFFFFFF)  # strip the N-probe flag bit
    j = jnp.arange(b_pad, dtype=I32)
    bound = chunk_len - k - step
    mask = (j * step) < bound
    # the N-probe mask (sign bit) is not needed for an upper bound
    total = jnp.sum(jnp.where(mask, hi - lo, 0).astype(jnp.float32))
    return total


@functools.partial(jax.jit, static_argnames=("k", "reverse", "complement",
                                             "b_pad", "n_gran"))
def _raw_total_granules(pos_lo_tab, pos_hi_tab, chunk_start, chunk_len,
                        first_len, k: int, reverse: bool,
                        complement: bool, b_pad: int, n_gran: int):
    """Per-granule raw-window sums ([n_gran] f32, granule = b_pad/n_gran
    consecutive probe lanes) — the sizing input for SLICED dispatch of
    repeat-heavy chunks (upper bounds, like `_raw_total`)."""
    step = k // 2
    x0 = _probe_x0(chunk_start, chunk_len, first_len, k, reverse,
                   complement)
    lo_raw = _dec_read(pos_lo_tab, x0, b_pad, step)
    hi = _dec_read(pos_hi_tab, x0, b_pad, step)
    lo = lo_raw & jnp.int32(0x7FFFFFFF)
    j = jnp.arange(b_pad, dtype=I32)
    mask = (j * step) < (chunk_len - k - step)
    counts = jnp.where(mask, hi - lo, 0).astype(jnp.float32)
    return counts.reshape(n_gran, b_pad // n_gran).sum(axis=1)


@functools.partial(jax.jit, static_argnames=("k", "reverse",
                                             "complement", "b_pad"))
def _raw_totals_batch(pos_lo_tab, pos_hi_tab, chunk_params,
                      first_len, k: int, reverse: bool, complement: bool,
                      b_pad: int):
    """`_raw_total` over [C, 2] (start, len) chunk params in one
    dispatch (one pre-pass round trip instead of one per chunk)."""

    def one(p):
        return _raw_total(pos_lo_tab, pos_hi_tab, p[0], p[1],
                          first_len, k, reverse, complement, b_pad)

    return jax.lax.map(one, chunk_params)


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "complement", "b_pad", "cap", "ev_cap"))
def _scan_chunk(pos_lo_tab, pos_hi_tab, sa,
                chunk_start, chunk_len, first_len, max_match_pos,
                max_cardinality, j0, j_end,
                k: int, reverse: bool, complement: bool,
                b_pad: int, cap: int, ev_cap: int):
    """Fused device scan for one probe slice [j0, min(j_end, j0 + b_pad)):
    probe stream -> table equal-ranges (contiguous decimated-row reads)
    -> flat CSR match gather -> exact filters -> per-probe cardinality
    -> event compaction (sort-based: full-size drop-scatters are
    latency-bound, a payload sort streams).

    ``j_end`` (traced) bounds the live lanes for SLICED dispatch
    (`DeviceEngine._dispatch_chunk_sliced` partitions a repeat-heavy
    chunk's probe stream into bounded-raw-total slices that share one
    compiled shape); whole-range callers pass `_J_END_ALL`.

    Returns (ev_pack [3, ev_cap], m_flat [cap], scalars [4]).
    """
    step = k // 2
    jl = jnp.arange(b_pad, dtype=I32)
    j = j0 + jl
    bound = chunk_len - k - step
    # pre-increment loop, automaton.rs:90-97; slice-end bound
    mask = ((j * step) < bound) & (j < j_end)

    # equal-ranges: x is affine increasing in j for every transform, so
    # the probes' table entries form ONE contiguous run of a decimated
    # row (tables are padded via table_len_for so reads never clamp)
    x0 = _probe_x0(chunk_start, chunk_len, first_len, k, reverse,
                   complement) + j0 * step
    lo_raw = _dec_read(pos_lo_tab, x0, b_pad, step)
    hi = _dec_read(pos_hi_tab, x0, b_pad, step)
    # N-probe skip (automaton.rs:100-102): the probe's first needle
    # symbol equals the text symbol at x by doubled-text construction;
    # the build packs `codes[x] == N` into pos_lo's sign bit, so the
    # check costs no extra read
    mask = mask & (lo_raw >= 0)
    lo = lo_raw & jnp.int32(0x7FFFFFFF)
    lo = jnp.where(mask, lo, 0)
    hi = jnp.where(mask, hi, 0)
    return _core_from_ranges(
        lo, hi, mask, sa, jnp.int32(0), chunk_start,
        chunk_start + chunk_len, max_match_pos,
        max_cardinality, j0, k=k, reverse=reverse, b_pad=b_pad,
        cap=cap, ev_cap=ev_cap)


def _core_from_ranges(lo, hi, mask, sa, self_base, dir_base, rev_t0,
                      max_match_pos, max_cardinality, j0,
                      k: int, reverse: bool, b_pad: int, cap: int,
                      ev_cap: int, sa_gather=None):
    """Scan tail shared by the table engine and the windowed (trim)
    engine: CSR match expansion + exact filters + event compaction from
    already-masked per-probe equal ranges (`lo`/`hi` zeroed outside
    `mask`).

    ``sa_gather`` (optional) replaces the direct ``sa[...]`` gather —
    the rank-sharded window engine passes a psum-combining gather over
    the suffix order sharded across a mesh axis (`sa` is then None).

    The exact filters compare match position `m` (in the SA's coordinate
    frame) against the needle-relative probe position `i`:
    self-hit `m == i + self_base` (reference quirk: automaton.rs:106
    compares the absolute SA value with the needle index, so
    `self_base = 0` when `m` is absolute), direction
    `m > i + dir_base` (direct) / `m >= rev_t0 - i` (reversed). Engines
    whose `m` is window-relative (BigWindowEngine) pass host-clamped
    rebased constants; clamping into [-(chunk_len+2), W+2]-style ranges
    preserves every comparison outcome while keeping int32 arithmetic
    overflow-free."""
    step = k // 2
    jl = jnp.arange(b_pad, dtype=I32)
    counts_raw = hi - lo
    total_raw = jnp.sum(jnp.where(mask, counts_raw, 0))

    # compact the matched probes first (one sort): the CSR boundary
    # scatter below then runs from cap source lanes instead of b_pad —
    # scatters are per-source-lane latency-bound, and with
    # direct-only windows almost every probe lane is matchless
    has = mask & (counts_raw > 0)
    q_cap = min(cap, b_pad)  # matched probes can never exceed either
    qkey = jnp.where(has, jl, b_pad)
    sk_q, qlo, qc = jax.lax.sort((qkey, lo, counts_raw), num_keys=1)
    sk_q, qlo, qc = sk_q[:q_cap], qlo[:q_cap], qc[:q_cap]
    n_matched = jnp.sum(has.astype(I32))
    qlive = jnp.arange(q_cap, dtype=I32) < n_matched
    qc = jnp.where(qlive, qc, 0)
    qck = jnp.cumsum(qc)
    qstarts = qck - qc

    # flat CSR expansion; compacted-probe id via boundary scatter +
    # cumsum, the segment start position via cummax (no per-slot gathers)
    seg = jnp.zeros(cap + 1, I32).at[
        jnp.where(qlive, jnp.minimum(qstarts, cap), cap)].add(
        1, mode="drop")
    qid = jnp.clip(jnp.cumsum(seg[:cap]) - 1, 0, q_cap - 1)
    flat_pos = jnp.arange(cap, dtype=I32)
    seg_start = jax.lax.cummax(
        jnp.where(seg[:cap] > 0, flat_pos, 0))
    within = flat_pos - seg_start
    flat_valid = flat_pos < jnp.minimum(total_raw, cap)
    if sa_gather is None:
        m = sa[jnp.clip(qlo[qid] + within, 0, sa.shape[0] - 1)]
    else:
        m = sa_gather(qlo[qid] + within)
    probe_id = jnp.clip(sk_q[qid], 0, b_pad - 1)  # original probe lane

    i_of = (j0 + probe_id + 1) * step  # = is_[probe_id], no gather
    if reverse:
        dir_ok = m >= rev_t0 - i_of
    else:
        dir_ok = m > i_of + dir_base
    keep = (flat_valid & (m != i_of + self_base)
            & (m < max_match_pos) & dir_ok)

    kept = jnp.zeros(b_pad, I32).at[probe_id].add(
        keep.astype(I32), mode="drop")
    valid = mask & (kept <= max_cardinality)
    event = valid & (kept > 0)
    vz = valid & (kept == 0)

    # event compaction by sort: key pushes non-events to the back
    n_events = jnp.sum(event.astype(I32))
    A = jnp.cumsum(vz.astype(I32))
    ekey = jnp.where(event, jl, b_pad)
    sk, a_evt, ev_count = jax.lax.sort((ekey, A, kept), num_keys=1)
    # the sorted key IS the probe lane: recompute is_ instead of
    # carrying a fourth sort payload
    ev_probe = (j0 + sk[:ev_cap] + 1) * step
    a_evt = a_evt[:ev_cap]
    ev_count = ev_count[:ev_cap]
    # z_before[e] = A_evt[e] - A_evt[e-1] (A excludes the event itself)
    ev_z = jnp.concatenate([a_evt[:1], a_evt[1:] - a_evt[:-1]])
    ev_pack = jnp.stack([ev_probe, ev_z, ev_count])
    z_trail = A[b_pad - 1] - jnp.where(
        n_events > 0, a_evt[jnp.clip(n_events - 1, 0, ev_cap - 1)], 0)

    # matches compaction in (probe, SA-slot) order, event probes only
    keep_f = keep & event[probe_id]
    total_kept = jnp.sum(keep_f.astype(I32))
    mkey = jnp.where(keep_f, flat_pos, cap)
    _, m_flat = jax.lax.sort((mkey, m), num_keys=1)

    overflow = ((total_raw > cap) | (n_events > ev_cap)).astype(I32)
    scalars = jnp.stack([n_events, total_kept, z_trail, overflow])
    return ev_pack, m_flat, scalars


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "b_pad", "cap", "ev_cap"))
def _scan_core(lo, hi, mask, sa, chunk_start, chunk_len, max_match_pos,
               max_cardinality, j0,
               k: int, reverse: bool, b_pad: int, cap: int, ev_cap: int):
    """Standalone-jitted scan tail for engines that compute per-probe
    equal ranges in a separate stage (the windowed trim engine). The
    chunk-bound mask is re-applied here so lanes past the chunk's probe
    count are inert — batched stage-1 slices may overhang into the next
    chunk's lanes (`_slice_lanes`)."""
    step = k // 2
    jl = jnp.arange(b_pad, dtype=I32)
    lane_ok = ((j0 + jl) * step) < (chunk_len - k - step)
    mask = mask & lane_ok
    lo = jnp.where(mask, lo, 0)
    hi = jnp.where(mask, hi, 0)
    return _core_from_ranges(
        lo, hi, mask, sa, jnp.int32(0), chunk_start,
        chunk_start + chunk_len, max_match_pos,
        max_cardinality, j0, k=k, reverse=reverse, b_pad=b_pad,
        cap=cap, ev_cap=ev_cap)


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "complement", "b_pad", "cap", "ev_cap"))
def _scan_chunks_group(pos_lo_tab, pos_hi_tab, sa, params,
                       first_len, max_match_pos, max_cardinality,
                       k: int, reverse: bool, complement: bool,
                       b_pad: int, cap: int, ev_cap: int):
    """`_scan_chunk` over a GROUP of same-geometry chunks in one
    dispatch (``params`` [G, 2] = (chunk_start, chunk_len) rows;
    dummy rows use chunk_len = 0, whose all-false lane mask makes the
    core inert). One dispatch + one stacked download replaces G of
    each, so chunk-heavy genomes (dozens of N-run chunks) do not pay a
    fixed per-chunk dispatch overhead.
    `lax.map` (not vmap) keeps intermediate memory at 1x: only the
    [G, ...] outputs are group-sized."""

    def one(p):
        return _scan_chunk(
            pos_lo_tab, pos_hi_tab, sa, p[0], p[1], first_len,
            max_match_pos, max_cardinality, jnp.int32(0),
            jnp.int32(_J_END_ALL),
            k=k, reverse=reverse, complement=complement,
            b_pad=b_pad, cap=cap, ev_cap=ev_cap)

    return jax.lax.map(one, params)


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "b_pad", "cap", "ev_cap"))
def _scan_core_group(lo_all, hi_all, mask_all, sa, params,
                     max_match_pos, max_cardinality,
                     k: int, reverse: bool, b_pad: int, cap: int,
                     ev_cap: int):
    """`_scan_core` over a group of same-geometry chunks in one
    dispatch, reading each chunk's lanes straight from the batched
    stage-1 arrays (``params`` [G, 3] = (lane_offset, chunk_start,
    chunk_len); dummies use chunk_len = 0). Skips the per-chunk
    `_slice_lanes` dispatches entirely."""
    step = k // 2

    def one(p):
        off, cs, cl = p[0], p[1], p[2]
        lo = jax.lax.dynamic_slice(lo_all, (off,), (b_pad,))
        hi = jax.lax.dynamic_slice(hi_all, (off,), (b_pad,))
        mask = jax.lax.dynamic_slice(mask_all, (off,), (b_pad,))
        jl = jnp.arange(b_pad, dtype=I32)
        # chunk-bound re-mask: batched stage-1 slices may overhang into
        # the next chunk's lanes (`_scan_core` semantics)
        m = mask & ((jl * step) < (cl - k - step))
        return _core_from_ranges(
            jnp.where(m, lo, 0), jnp.where(m, hi, 0), m, sa,
            jnp.int32(0), cs, cs + cl, max_match_pos,
            max_cardinality, jnp.int32(0), k=k, reverse=reverse,
            b_pad=b_pad, cap=cap, ev_cap=ev_cap)

    return jax.lax.map(one, params)


# grouped-dispatch sizing: group size is static (padded with inert
# dummy rows) so ONE program per geometry serves any chunk count; the
# lane budget caps the stacked [G, cap] output footprint
GROUP_SIZE = 16
GROUP_LANE_BUDGET = 1 << 27

# flat-capacity floor: low enough that small chunks (real genomes split
# into dozens at N-runs, ~100k raw matches each) don't pay 1M-lane
# sorts, high enough to bound the distinct-cap compile count (pow4
# buckets from here — `_cap_bucket`). Env-tunable so the CPU-mesh
# test tier can run small cores (capacity only — outputs are exact at
# any floor; undersized caps retry with doubling).
MIN_CAP = int(os.environ.get("ASGART_MIN_CAP", 1 << 17))


def _group_size_for(cap: int) -> int:
    for gs in (GROUP_SIZE, 4):
        if gs * cap <= GROUP_LANE_BUDGET:
            return gs
    return 1


def _pad_group(n: int) -> int:
    """Static group size for n live chunks: the smallest of {2,4,8,16}
    that fits. Pow2 sizes bound the per-geometry compile count at 4
    while keeping dummy-row waste below one core-run per group in the
    common cases (2 chunks -> G=2: the bench genome's single N-run
    split pays zero dummies)."""
    for gs in (2, 4, 8, 16):
        if gs >= n:
            return gs
    return GROUP_SIZE


# --- sliced dispatch (repeat-heavy chunks) --------------------------------
#
# The flat CSR gather capacity scales with the chunk's summed RAW match
# windows, which explodes on low-complexity/satellite repeats left
# unmasked (default mode uppercases soft-masked regions — the reference
# scans them too, asgart.rs:291-301, just slowly). One dispatch sized to
# such a total would exhaust HBM, so chunks whose capacity crosses
# SLICE_LANES are scanned as consecutive PROBE SLICES, each with a
# bounded-raw-total capacity; slice event streams merge with the exact
# aging carry (`_merge_shard_events` — slices are probe slices, the same
# mechanism that makes mesh sharding byte-equal).

SLICE_GRAN = 4096        # planning granule (probe lanes)
SLICE_HARD_CAP = 1 << 28  # one slice's gather may never exceed this


def _slice_budget() -> int:
    env = os.environ.get("ASGART_DEVICE_SLICE_LANES")
    return int(env) if env else (1 << 26)


# The merge-join co-sort's peak device bytes per row: 3 int32 operands
# (12 B) x in + out, plus the sort's scratch.
_MJ_SORT_PEAK_PER_ROW = 35


def _local_np(x):
    """numpy view of an engine output; multi-controller safe. Engine
    outputs are REPLICATED (out_specs P()), so under `jax.distributed`
    (a mesh spanning processes) the local shard IS the full value —
    np.asarray would refuse an array spanning non-addressable devices.
    A no-op for ordinary single-process arrays."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return np.asarray(x.addressable_data(0))
    return np.asarray(x)


def _global_put(arr: np.ndarray, sharding):
    """device_put that also works when ``sharding`` spans processes
    (each process supplies the same host array and ships only its
    addressable shards)."""
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def _hbm_free_bytes() -> int:
    """Free device memory on the scan device: live allocator stats when
    exposed, else budget minus the persistent caches' tracked bytes
    (`device_index.hbm_free_estimate`)."""
    from .device_index import hbm_free_estimate

    return hbm_free_estimate()


def _plan_mj_groups(specs, b_max: int):
    """Split the batched stage-1 probe side into groups of <= ``b_max``
    lanes, at PIECE granularity: a chunk whose lane count exceeds the
    room left in the current group is split into (spec, j0) pieces —
    `_pack_batch_probe_keys` packs lanes [j0, j0+nc) of a chunk, and
    consecutive pieces of one chunk concatenate to exactly its full
    contiguous lane range, so the grouped join is lane-for-lane equal
    to the single-shot one (each lane's equal range against the window
    is independent of every other lane).

    ``specs``: [(chunk_start, chunk_len, n_lanes)]; returns a list of
    groups, each a list of (chunk_start, chunk_len, nc_piece, j0)."""
    groups: list[list[tuple]] = []
    cur: list[tuple] = []
    cur_b = 0
    for (cs, cl, nc) in specs:
        j0 = 0
        while nc > 0:
            room = b_max - cur_b
            if room <= 0:
                groups.append(cur)
                cur, cur_b = [], 0
                room = b_max
            take = min(nc, room)
            cur.append((cs, cl, take, j0))
            cur_b += take
            j0 += take
            nc -= take
    if cur:
        groups.append(cur)
    return groups


def _slice_caps(total: float, b_slice: int, ev_scale: int):
    """(cap, ev_cap) for one probe slice. Granule sums are exact raw
    totals up to f32 rounding (<= 16 absolute below the hard cap) —
    covered by the slack, so the overflow flag can only fire for event
    capacity. A slice past SLICE_HARD_CAP is a pathological
    single-k-mer repeat no gather capacity can serve."""
    need = int(float(total) * 1.001) + 32
    if need > SLICE_HARD_CAP:
        raise RuntimeError(
            f"a single probe slice needs a {need}-lane match gather "
            "(pathological low-complexity repeat); run with "
            "--skip-masked or the host engine")
    cap = _cap_bucket(need)
    return cap, _bucket(min(cap, b_slice)) // 4 * ev_scale


def _fixed_slice_width(gran_totals, gran_lanes: int, budget: int,
                       max_lanes: int, b_pad: int) -> int:
    """Largest pow2 slice width DIVIDING ``b_pad`` (aligned windows of
    the lane range) whose every window's raw total fits ``budget`` —
    the windowed engines' slicing scheme. Alignment + divisibility mean
    no slice-end masking and no `dynamic_slice` clamp (a clamped slice
    would re-read real lanes and double-count their events)."""
    w = gran_lanes
    gt = np.asarray(gran_totals, dtype=np.float64)
    while w * 2 <= max_lanes and b_pad % (w * 2) == 0:
        k2 = (w * 2) // gran_lanes
        sums = gt.reshape(-1, k2).sum(1)
        if sums.max(initial=0.0) > budget:
            break
        w *= 2
    return w


@functools.partial(jax.jit, static_argnames=("n_gran",))
def _range_granule_totals(lo, hi, n_lanes, n_gran: int):
    """Per-granule raw sums of already-masked stage-1 equal ranges.
    ``n_lanes`` re-masks the chunk's live lane count: a batched
    stage-1 slice may overhang into the NEXT chunk's live lanes
    (`_slice_lanes` semantics), which must not inflate the sizing."""
    b = lo.shape[0]
    live = jnp.arange(b, dtype=I32) < n_lanes
    counts = jnp.where(live, hi - lo, 0).astype(jnp.float32)
    return counts.reshape(n_gran, b // n_gran).sum(axis=1)


@functools.partial(jax.jit, static_argnames=("b",))
def _slice_lanes_dyn(lo, hi, mask, off, b: int):
    """Traced-offset variant of `_slice_lanes` for sliced dispatch
    (aligned offsets: off + b never exceeds the arrays)."""
    return (jax.lax.dynamic_slice(lo, (off,), (b,)),
            jax.lax.dynamic_slice(hi, (off,), (b,)),
            jax.lax.dynamic_slice(mask, (off,), (b,)))


def _plan_slices(gran_totals, gran_lanes: int, budget: int):
    """Greedy-pack consecutive granules into probe slices whose raw
    totals stay within ``budget`` (a single over-budget granule becomes
    its own slice). Slices are also capped at B_GRAN lanes so their
    table reads stay inside the `table_pad_for` slack. Returns
    [(lane0, n_lanes, total)] partitioning [0, len*gran_lanes)."""
    slices = []
    cur0 = 0
    cur_lanes = 0
    cur_tot = 0.0
    for g, t in enumerate(gran_totals):
        t = float(t)
        if cur_lanes and (cur_tot + t > budget
                          or cur_lanes + gran_lanes > B_GRAN):
            slices.append((cur0, cur_lanes, cur_tot))
            cur0 = g * gran_lanes
            cur_lanes = 0
            cur_tot = 0.0
        cur_lanes += gran_lanes
        cur_tot += t
    if cur_lanes:
        slices.append((cur0, cur_lanes, cur_tot))
    return slices


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "b_pad", "cap", "ev_cap"))
def _scan_core_based_group(lo_all, hi_all, mask_all, sa, params,
                           max_match_pos, max_cardinality,
                           k: int, reverse: bool, b_pad: int, cap: int,
                           ev_cap: int):
    """`_scan_core_based` over a group of same-geometry chunks
    (``params`` [G, 5] = (lane_offset, chunk_len, self_base, dir_base,
    rev_t0); dummies use chunk_len = 0) — the big-genome engine's
    grouped stage 2, with per-chunk host-clamped rebased filter
    constants riding in the params rows."""
    step = k // 2

    def one(p):
        off, cl = p[0], p[1]
        lo = jax.lax.dynamic_slice(lo_all, (off,), (b_pad,))
        hi = jax.lax.dynamic_slice(hi_all, (off,), (b_pad,))
        mask = jax.lax.dynamic_slice(mask_all, (off,), (b_pad,))
        jl = jnp.arange(b_pad, dtype=I32)
        m = mask & ((jl * step) < (cl - k - step))
        return _core_from_ranges(
            jnp.where(m, lo, 0), jnp.where(m, hi, 0), m, sa,
            p[2], p[3], p[4], max_match_pos, max_cardinality,
            jnp.int32(0), k=k, reverse=reverse, b_pad=b_pad,
            cap=cap, ev_cap=ev_cap)

    return jax.lax.map(one, params)


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "b_pad", "cap", "ev_cap"))
def _scan_core_based(lo, hi, mask, sa, chunk_len, self_base, dir_base,
                     rev_t0, max_match_pos, max_cardinality, j0,
                     k: int, reverse: bool, b_pad: int, cap: int,
                     ev_cap: int):
    """Scan tail with explicit (host-clamped) rebased filter constants —
    the window-relative big-genome engine's stage 2. Re-masks by the
    chunk's probe bound: batched stage-1 slices may overhang into the
    next chunk's lanes."""
    step = k // 2
    jl = jnp.arange(b_pad, dtype=I32)
    m = mask & (((j0 + jl) * step) < (chunk_len - k - step))
    return _core_from_ranges(
        jnp.where(m, lo, 0), jnp.where(m, hi, 0), m, sa, self_base,
        dir_base, rev_t0, max_match_pos,
        max_cardinality, j0, k=k, reverse=reverse, b_pad=b_pad,
        cap=cap, ev_cap=ev_cap)


@functools.partial(jax.jit, static_argnames=("k", "reverse", "complement",
                                             "b_pad"))
def _window_ranges(key_hi, key_lo, codes,
                   chunk_start, chunk_len, first_len, j0,
                   k: int, reverse: bool, complement: bool, b_pad: int):
    """Per-probe equal ranges against a windowed index by merge join.

    Probe k-mers are packed from the doubled genome codes by strided
    slices (the same affine probe→text map as the table engine), then
    co-sorted with the window's W sorted keys: with the window/probe tag
    as the last sort key, a probe entry's sorted position directly yields
    its `hi` bound (count of window keys sorting before it), and `lo`
    from the run structure of the co-sorted stream (`_mj_tail`). One
    O((W+B) log) sort
    replaces per-probe binary search — sorts stream while random
    gathers are latency-bound.

    Returns (lo [b_pad], hi [b_pad], mask [b_pad], total f32 scalar);
    lo/hi are zeroed outside the mask, total is the exact summed match
    window size (sizes the flat CSR capacity with no estimation slack).
    """
    x0 = _probe_x0(chunk_start, chunk_len, first_len, k, reverse,
                   complement) + j0 * (k // 2)
    return _merge_join_core(key_hi, key_lo, codes, x0, j0,
                            chunk_len, k=k, b_pad=b_pad)


def _pack_probe_lanes(codes_dec, x0, nc: int, k: int):
    """(phi, plo, n_mask) for `nc` probe lanes whose text positions are
    x0 + j*step. ``codes_dec`` is in DECIMATED layout (see `_dec_read`):
    probe symbol t of lane j lives at text position (x0 + t) + j*step,
    so each of the k symbol reads is one contiguous row slice."""
    from .device_index import LO_SYMS

    step = k // 2

    def sym(t):
        return _dec_read(codes_dec, x0 + t, nc, step).astype(I32)

    n_hi = max(k - LO_SYMS, 0)
    phi = jnp.zeros(nc, dtype=I32)
    plo = jnp.zeros(nc, dtype=I32)
    for t in range(n_hi):
        phi = (phi << 3) | sym(t)
    for t in range(n_hi, k):
        plo = (plo << 3) | sym(t)
    # N-probe skip (automaton.rs:100-102): first needle symbol check
    return phi, plo, sym(0) != N_CODE


def _pack_probe_lanes3(codes_dec, x0, nc: int, k: int):
    """3-plane `_pack_probe_lanes` for k = 21..30: (ptop, phi, plo,
    n_mask) with the `_pack_planes3_all` split (top = first k-20
    symbols, hi the next 10, lo the last 10)."""
    from .device_index import LO_SYMS

    step = k // 2

    def sym(t):
        return _dec_read(codes_dec, x0 + t, nc, step).astype(I32)

    n_top = k - 2 * LO_SYMS
    ptop = jnp.zeros(nc, dtype=I32)
    phi = jnp.zeros(nc, dtype=I32)
    plo = jnp.zeros(nc, dtype=I32)
    for t in range(n_top):
        ptop = (ptop << 3) | sym(t)
    for t in range(n_top, n_top + LO_SYMS):
        phi = (phi << 3) | sym(t)
    for t in range(n_top + LO_SYMS, k):
        plo = (plo << 3) | sym(t)
    return ptop, phi, plo, sym(0) != N_CODE


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "complement", "first_len", "specs", "total", "x0s"))
def _pack_batch_probe_keys3(codes_dec, j0s, k: int, reverse: bool,
                            complement: bool, first_len: int,
                            specs: tuple, total: int,
                            x0s: tuple | None = None):
    """3-plane `_pack_batch_probe_keys` (k = 21..30): every chunk's
    (ptop, phi, plo, mask) back-to-back with sentinel padding."""
    step = k // 2
    ptops, phis, plos, masks = [], [], [], []
    for i, (cs, cl, nc) in enumerate(specs):
        x0 = (x0s[i] if x0s is not None
              else _probe_x0(cs, cl, first_len, k, reverse, complement)) \
            + j0s[i] * step
        ptop, phi, plo, n_mask = _pack_probe_lanes3(codes_dec, x0, nc, k)
        lane_ok = ((j0s[i] + jnp.arange(nc, dtype=I32)) * step) \
            < (cl - k - step)
        ptops.append(ptop)
        phis.append(phi)
        plos.append(plo)
        masks.append(n_mask & lane_ok)
    pad = total - sum(nc for (_, _, nc) in specs)
    big = jnp.full(pad, np.int32(2**31 - 1), I32)
    return (jnp.concatenate(ptops + [big]),
            jnp.concatenate(phis + [big]),
            jnp.concatenate(plos + [big]),
            jnp.concatenate(masks + [jnp.zeros(pad, bool)]))


def _mj_tail(key_hi, key_lo, phi, plo, mask):
    """The merge join itself: per-lane [lo, hi) window equal-ranges of
    already-packed probe keys. The probe/window tag rides in the id
    operand's low bit (3 sort operands, not 4 — the co-sort is the peak
    memory user of the windowed path): within an equal-key run, probe
    entries sort after the run's window entries, so for a probe at
    sorted position t

      hi = #window entries at positions <= t           (one cumsum)
      lo = #window entries before t's run START        (one cummax)

    — both pure scans over the co-sorted stream (a run's window entries
    are exactly the window slots holding the probe's key, so lo lands
    on the window equal-range start; a run with no window entries gives
    lo == hi, the empty window). One O((W+B) log) sort replaces
    per-probe binary search — sorts stream while random gathers are
    latency-bound (detecting key equality by gathering key_hi/key_lo/
    run_lo at hi-1 would cost 3 x b_pad random gathers)."""
    W = key_hi.shape[0]
    b_pad = phi.shape[0]
    jl = jnp.arange(b_pad, dtype=I32)
    tot = W + b_pad
    ckhi = jnp.concatenate([key_hi, phi])
    cklo = jnp.concatenate([key_lo, plo])
    ids_tagged = jnp.concatenate(
        [jnp.zeros(W, I32), (jl << 1) | jnp.int32(1)])
    skhi, sklo, sidt = jax.lax.sort((ckhi, cklo, ids_tagged), num_keys=3)
    stag = sidt & 1
    t = jnp.arange(tot, dtype=I32)
    cw = t + 1 - jnp.cumsum(stag)  # window entries at positions <= t
    neq = jnp.concatenate([
        jnp.ones(1, bool),
        (skhi[1:] != skhi[:-1]) | (sklo[1:] != sklo[:-1])])
    # window entries strictly before each run start, spread over the
    # run by cummax (the value is monotone in t)
    wbs = jax.lax.cummax(jnp.where(neq, cw - (1 - stag), -1))
    # back to probe-lane order (sort again instead of a full-size
    # scatter); barrier: computing sort operands inline would fuse the
    # scans into the sort's comparator path
    lane_key = jnp.where(stag == 1, sidt >> 1, tot)
    lane_key, cw, wbs = jax.lax.optimization_barrier((lane_key, cw, wbs))
    # TWO 2-operand back-sorts, not one 3-operand: the split bounds the
    # transient peak at 2-operand size (a sort's scratch comes on top
    # of in+out), which `_MJ_SORT_PEAK_PER_ROW` budgets for. (An
    # i64-packed (hi, lo) single payload sort would move 12 B/row once,
    # but device x64 is off repo-wide.)
    _, hi_sorted = jax.lax.sort((lane_key, cw), num_keys=1)
    _, lo_sorted = jax.lax.sort((lane_key, wbs), num_keys=1)
    lo_lane = jnp.where(mask, lo_sorted[:b_pad], 0)
    hi_lane = jnp.where(mask, hi_sorted[:b_pad], 0)
    return lo_lane, hi_lane


def _merge_join_core(key_hi, key_lo, codes_dec, x0, j0, chunk_len,
                     k: int, b_pad: int):
    """Single-chunk merge-join equal ranges (probe pack + `_mj_tail`),
    shared by the resident windowed engine (probe codes read from the
    doubled text at `x0`) and the big-genome engine (probe codes read
    needle-locally)."""
    step = k // 2
    jl = jnp.arange(b_pad, dtype=I32)
    bound = chunk_len - k - step
    # pre-increment loop, automaton.rs:90-97
    lane_ok = ((j0 + jl) * step) < bound
    phi, plo, n_mask = _pack_probe_lanes(codes_dec, x0, b_pad, k)
    mask = lane_ok & n_mask
    lo_lane, hi_lane = _mj_tail(key_hi, key_lo, phi, plo, mask)
    total = jnp.sum((hi_lane - lo_lane).astype(jnp.float32))
    return lo_lane, hi_lane, mask, total


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "complement", "first_len", "specs", "total", "x0s"))
def _window_ranges_batch(key_hi, key_lo, codes_dec, j0s,
                         k: int, reverse: bool, complement: bool,
                         first_len: int, specs: tuple, total: int,
                         x0s: tuple | None = None):
    """ALL chunks' merge-join ranges in ONE co-sort.

    The co-sort's W side (the whole sorted window) dominates its cost,
    and chunk counts on real genomes run into the dozens (every >5000 bp
    N-run splits a chunk) — re-sorting W per chunk made stage 1 scale
    with the chunk count. Here every chunk's probe lanes are packed
    back-to-back (``specs``: one (chunk_start, chunk_len, n_lanes) per
    chunk, host ints so every read is a static slice), padded to
    ``total`` with sentinel keys that sort last and match nothing, and
    joined against the window in a single `_mj_tail`.

    ``j0s`` [n_chunks] (traced): each chunk's probe-lane origin — zero
    for single-device runs; cell p of a probe-sharded mesh passes
    ``p * b_local`` per chunk so every cell packs only its own probe
    slice. Lanes past a chunk's probe bound are masked here (exact
    per-chunk totals even when n_lanes overshoots the bound).

    ``x0s`` overrides the probe->text map per chunk (static): the
    big-genome engine packs NEEDLE-LOCAL codes laid out back-to-back in
    one buffer, so chunk i's probe j=0 reads at its base offset + step
    instead of `_probe_x0`'s doubled-text position.

    Returns (lo [total], hi [total], mask [total], totals [n_chunks]) —
    per-chunk exact raw-match sums for capacity sizing; per-chunk lanes
    start at offset sum(n_lanes of earlier chunks).
    """
    phi, plo, mask = _pack_batch_probe_keys(
        codes_dec, j0s, k, reverse, complement, first_len, specs, total,
        x0s=x0s)
    return _mj_ranges_from_keys(key_hi, key_lo, phi, plo, mask,
                                specs=specs)


@functools.partial(jax.jit, static_argnames=(
    "k", "reverse", "complement", "first_len", "specs", "total", "x0s"))
def _pack_batch_probe_keys(codes_dec, j0s, k: int, reverse: bool,
                           complement: bool, first_len: int,
                           specs: tuple, total: int,
                           x0s: tuple | None = None):
    """The probe side of `_window_ranges_batch`: every chunk's packed
    probe key planes + masks, back-to-back with sentinel padding.
    WINDOW-INDEPENDENT — a sharded run's windows all join the same
    probe keys, so `DeviceWindowEngine` caches this output across
    windows (one pack instead of one per window)."""
    step = k // 2
    phis, plos, masks = [], [], []
    for i, (cs, cl, nc) in enumerate(specs):
        x0 = (x0s[i] if x0s is not None
              else _probe_x0(cs, cl, first_len, k, reverse, complement)) \
            + j0s[i] * step
        phi, plo, n_mask = _pack_probe_lanes(codes_dec, x0, nc, k)
        lane_ok = ((j0s[i] + jnp.arange(nc, dtype=I32)) * step) \
            < (cl - k - step)
        phis.append(phi)
        plos.append(plo)
        masks.append(n_mask & lane_ok)
    pad = total - sum(nc for (_, _, nc) in specs)
    big = jnp.full(pad, np.int32(2**31 - 1), I32)
    phi = jnp.concatenate(phis + [big])
    plo = jnp.concatenate(plos + [big])
    mask = jnp.concatenate(masks + [jnp.zeros(pad, bool)])
    return phi, plo, mask


def _mj_ranges_impl(key_hi, key_lo, phi, plo, mask, specs: tuple):
    lo, hi = _mj_tail(key_hi, key_lo, phi, plo, mask)
    counts = (hi - lo).astype(jnp.float32)
    off = 0
    totals = []
    for (_, _, nc) in specs:
        totals.append(jnp.sum(jax.lax.dynamic_slice(counts, (off,),
                                                    (nc,))))
        off += nc
    return lo, hi, mask, jnp.stack(totals)


@functools.partial(jax.jit, static_argnames=("specs",))
def _mj_ranges_from_keys(key_hi, key_lo, phi, plo, mask, specs: tuple):
    """The window side: one `_mj_tail` co-sort of already-packed probe
    keys + per-chunk exact totals."""
    return _mj_ranges_impl(key_hi, key_lo, phi, plo, mask, specs)


@functools.partial(jax.jit, static_argnames=("specs",),
                   donate_argnums=(2, 3))
def _mj_ranges_from_keys_donated(key_hi, key_lo, phi, plo, mask,
                                 specs: tuple):
    """`_mj_ranges_from_keys` with the probe key planes donated — the
    HBM-projected grouped stage 1 (`DeviceWindowEngine._batch_stage1`)
    packs each group's planes afresh, so XLA may reuse their bytes
    inside the join instead of holding them beside the co-sort."""
    return _mj_ranges_impl(key_hi, key_lo, phi, plo, mask, specs)


@functools.partial(jax.jit, static_argnames=("off", "b_pad"))
def _slice_lanes(lo, hi, mask, off: int, b_pad: int):
    """One chunk's (lo, hi, mask) view out of the batched stage-1
    arrays. The slice may overhang into the next chunk's lanes —
    `_scan_core` re-masks by the chunk bound, making overhang inert."""
    return (jax.lax.dynamic_slice(lo, (off,), (b_pad,)),
            jax.lax.dynamic_slice(hi, (off,), (b_pad,)),
            jax.lax.dynamic_slice(mask, (off,), (b_pad,)))


@functools.partial(jax.jit, static_argnames=("k", "b_pad"))
def _needle_ranges(key_hi, key_lo, needle_codes, chunk_len, j0,
                   k: int, b_pad: int):
    """Per-probe equal ranges against a window index from NEEDLE-LOCAL
    codes (the big-genome path: the host transforms the chunk and
    uploads its codes, so no doubled-text residency or int32 global
    addressing is needed). Probe lane j reads
    ``needle[(j+1)*step .. +k]``."""
    step = k // 2
    return _merge_join_core(key_hi, key_lo, needle_codes,
                            (j0 + 1) * step, j0, chunk_len,
                            k=k, b_pad=b_pad)


def _sharded_scan(mesh, k: int, reverse: bool, complement: bool,
                  b_local: int, cap: int, ev_cap: int,
                  axis: str = "probes"):
    """SPMD scan: index replicated over the mesh; every device runs the
    fused `_scan_chunk` on its own probe slice (j0 from its axis index —
    no sharded inputs at all). Per-shard event streams come back stacked
    and the host concatenates them with an aging-carry fix
    (`_merge_shard_events`) — the subsequent global event chain is then
    *identical* to the single-device run: shard boundaries drop nothing.
    """
    from jax.sharding import PartitionSpec as P

    def stepf(pos_lo_tab, pos_hi_tab, sa, chunk_start, chunk_len,
              first_len, max_match_pos, max_cardinality):
        d = jax.lax.axis_index(axis).astype(I32)
        j0 = d * b_local
        ev_pack, m_flat, scalars = _scan_chunk(
            pos_lo_tab, pos_hi_tab, sa, chunk_start, chunk_len,
            first_len, max_match_pos, max_cardinality, j0,
            jnp.int32(_J_END_ALL),
            k=k, reverse=reverse, complement=complement,
            b_pad=b_local, cap=cap, ev_cap=ev_cap)
        return ev_pack[None], m_flat[None], scalars[None]

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P(),) * 8,
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False)
    return jax.jit(mapped)


def _sharded_scan_group(mesh, k: int, reverse: bool, complement: bool,
                        b_local: int, cap: int, ev_cap: int,
                        axis: str = "probes"):
    """Grouped SPMD scan (mesh parity for `_scan_chunks_group`): every
    device runs the whole chunk GROUP as one `lax.map` core over its own
    probe slice (j0 from its axis index). One dispatch serves
    G chunks x n_dev shards; outputs come back stacked [n_dev, G, ...]
    and each chunk's shard streams merge with the exact aging carry —
    the same mechanism that makes per-chunk mesh scans byte-equal."""
    from jax.sharding import PartitionSpec as P

    def stepf(pos_lo_tab, pos_hi_tab, sa, params, first_len,
              max_match_pos, max_cardinality):
        d = jax.lax.axis_index(axis).astype(I32)
        j0 = d * b_local

        def one(p):
            return _scan_chunk(
                pos_lo_tab, pos_hi_tab, sa, p[0], p[1], first_len,
                max_match_pos, max_cardinality, j0,
                jnp.int32(_J_END_ALL),
                k=k, reverse=reverse, complement=complement,
                b_pad=b_local, cap=cap, ev_cap=ev_cap)

        ev, m, sc = jax.lax.map(one, params)
        return ev[None], m[None], sc[None]

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P(),) * 7,
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False)
    return jax.jit(mapped)


def _sharded_sliced_scan(mesh, k: int, reverse: bool, complement: bool,
                         b_slice: int, cap: int, ev_cap: int,
                         axis: str = "probes"):
    """Sliced SPMD scan (mesh parity for sliced dispatch): a ROUND of up
    to n_dev probe slices of one repeat-heavy chunk runs as one
    dispatch, each device scanning its own (j0, j_end) row of the
    sharded ``sl_params`` [n_dev, 2] (dummy rows use j_end = 0, whose
    all-false lane mask makes the core inert)."""
    from jax.sharding import PartitionSpec as P

    def stepf(pos_lo_tab, pos_hi_tab, sa, sl_params, chunk_start,
              chunk_len, first_len, max_match_pos, max_cardinality):
        row = sl_params[0]
        ev, m, sc = _scan_chunk(
            pos_lo_tab, pos_hi_tab, sa, chunk_start, chunk_len,
            first_len, max_match_pos, max_cardinality, row[0], row[1],
            k=k, reverse=reverse, complement=complement,
            b_pad=b_slice, cap=cap, ev_cap=ev_cap)
        return ev[None], m[None], sc[None]

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(), P(), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False)
    return jax.jit(mapped)


def _merge_shard_events(shard_events):
    """Concatenate per-shard (probe_i, z_before, counts, m_flat, z_trail)
    into one global event stream.

    Aging carry: quiet probes trailing shard s (and whole quiet shards)
    prepend onto the first event of the next shard with events, exactly
    reproducing the unsharded stream's z_before sequence.
    """
    evs, ms = [], []
    carry = 0
    for (ev, m, z_trail) in shard_events:
        if ev.shape[1] > 0:
            ev = ev.copy()
            ev[1, 0] += carry
            evs.append(ev)
            ms.append(m)
            carry = z_trail
        else:
            carry += z_trail
    if not evs:
        return None, None, carry
    return np.concatenate(evs, axis=1), np.concatenate(ms), carry


# (geometry key) -> (cap, ev_cap): repeat runs over the same chunk
# geometry skip the raw-total pre-pass round trip
_CAP_CACHE: dict = {}


@jax.jit
def _gather_flat(arr: jax.Array, idx: jax.Array):
    """Flat gather for the packed-event download (indices are tiny —
    live events are KBs while the stacked group buffers are tens of
    MB)."""
    return arr.reshape(-1)[idx]


# past this many packed bytes the plain bulk download wins (one fetch,
# no index upload / gather dispatch)
_PACK_BYTES_MAX = 1 << 22


def _packed_group_download(ev, m, live):
    """Download only the LIVE events/matches of a dispatched group.

    ``live``: list of (sh, g, n_events, total_kept). Builds host index
    arrays into the flattened [S?, G, 3, ev_cap] / [S?, G, cap] stacks,
    gathers on device, downloads the packed result, and returns
    {(sh, g): (ev [3, n_events], m [total_kept])}.
    """
    ev_shape = ev.shape  # [..., 3, ev_cap]
    ev_cap = ev_shape[-1]
    cap = m.shape[-1]
    G = m.shape[-2]
    from .utils import pow2_ceil

    ev_idx, m_idx, ev_off, m_off = [], [], {}, {}
    e0 = m0 = 0
    for (sh, g, ne, tk) in live:
        base = (sh * G + g) if len(ev_shape) == 4 else g
        if ne:
            cols = np.arange(ne, dtype=np.int64)
            ev_idx.append(((base * 3 + np.arange(3)[:, None]) * ev_cap
                           + cols[None, :]).reshape(-1))
        ev_off[(sh, g)] = (e0, ne)
        e0 += ne
        if tk:
            m_idx.append(base * cap + np.arange(tk, dtype=np.int64))
        m_off[(sh, g)] = (m0, tk)
        m0 += tk
    out = {}
    if e0 == 0 and m0 == 0:
        for (sh, g, ne, tk) in live:
            out[(sh, g)] = (np.zeros((3, 0), np.int32),
                            np.zeros(0, np.int32))
        return out
    # pow2-padded index buffers bound the gather's compile count
    def padded(parts, total):
        idx = np.zeros(pow2_ceil(max(total, 1), 256), np.int64)
        if parts:
            idx[:total] = np.concatenate(parts)
        return idx

    ev_pack = np.asarray(_gather_flat(ev, jnp.asarray(
        padded(ev_idx, e0 * 3))))
    m_pack = np.asarray(_gather_flat(m, jnp.asarray(padded(m_idx, m0))))
    e_cursor = 0
    for (sh, g, ne, tk) in live:
        e_start = ev_off[(sh, g)][0]
        # each chunk's ev indices were laid out [3, ne] row-major
        ev_c = ev_pack[3 * e_start: 3 * e_start + 3 * ne].reshape(3, ne) \
            if ne else np.zeros((3, 0), np.int32)
        m_start, _ = m_off[(sh, g)]
        out[(sh, g)] = (ev_c, m_pack[m_start: m_start + tk])
        e_cursor += ne
    return out


class DeviceEngine:
    """On-device search over one prepared strand (the device engine's
    table path). With more than one visible device, the probe axis is
    sharded over a mesh (index replicated in every device)."""

    _m_offset = 0  # added to downloaded match positions (int64, host)

    def __init__(self, strand, settings, profile: dict | None = None,
                 mesh=None, codes_device=None):
        self.strand = strand
        self.settings = settings
        t0 = time.time()
        from .device_index import cached_build

        self.didx = cached_build(
            DeviceIndex.build, strand.data, (settings.probe_size,),
            reverse=settings.reverse, complement=settings.complement,
            codes_device=codes_device)
        if mesh is None and len(jax.devices()) > 1:
            from jax.sharding import Mesh

            mesh = Mesh(np.array(jax.devices()), ("probes",))
        self.mesh = mesh or None  # mesh=False forces the single-device path
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(self.mesh, P())
            self.didx.sa = jax.device_put(self.didx.sa, rep)
            self.didx.pos_lo = jax.device_put(self.didx.pos_lo, rep)
            self.didx.pos_hi = jax.device_put(self.didx.pos_hi, rep)
            # codes are not read by the scan (the N flag rides in
            # pos_lo's sign bit) — no replication needed
        if profile is not None:
            profile["device_index_s"] = round(time.time() - t0, 3)

    def _lap(self, t0, what, *sync):
        if not os.environ.get("ASGART_DEVICE_PROFILE"):
            return time.time()
        jax.block_until_ready(sync)
        now = time.time()
        print(f"[dscan] {what}: {now - t0:.2f}s", flush=True)
        return now

    def _chunk_geometry(self, chunk):
        s = self.settings
        start, length = chunk
        k = s.probe_size
        if length < s.min_duplication_length:
            return None
        step = k // 2
        bound = length - k - step
        if bound <= 0:
            return None
        n_probes = (bound + step - 1) // step
        n_shards = self.mesh.devices.size if self.mesh is not None else 1
        b_pad = _bucket(n_probes)
        if b_pad % n_shards:
            b_pad += n_shards - (b_pad % n_shards)
        return b_pad, b_pad // n_shards, n_shards

    def _cap_key(self, chunk):
        s = self.settings
        return (self.didx.n, self.didx.first_len, s.probe_size,
                s.reverse, s.complement, s.max_cardinality, chunk)

    def _prepass_total(self, chunk):
        """Dispatch (async) the raw-total pre-pass for one chunk."""
        geo = self._chunk_geometry(chunk)
        if geo is None:
            return None
        b_pad, _, _ = geo
        s = self.settings
        didx = self.didx
        return _raw_total(
            didx.pos_lo, didx.pos_hi, jnp.int32(chunk[0]),
            jnp.int32(chunk[1]), jnp.int32(didx.first_len),
            s.probe_size, s.reverse, s.complement, b_pad)

    def _dispatch_chunk(self, chunk, cap=None, ev_cap=None, total=None):
        """Size + dispatch the device scan for one chunk; returns a
        state dict (results still in flight) or None for empty chunks.
        Dispatching every chunk before collecting any overlaps one
        chunk's downloads with the next one's device execution."""
        geo = self._chunk_geometry(chunk)
        if geo is None:
            return None
        b_pad, b_local, n_shards = geo
        s = self.settings
        start, length = chunk
        k = s.probe_size

        t0 = time.time()
        didx = self.didx
        args = (didx.pos_lo, didx.pos_hi, didx.sa,
                jnp.int32(start), jnp.int32(length),
                jnp.int32(didx.first_len),
                jnp.int32(didx.first_len - 1),
                jnp.int32(s.max_cardinality))
        if cap is None:
            cached = _CAP_CACHE.get(self._cap_key(chunk))
            if cached == "sliced":
                return self._dispatch_chunk_sliced(chunk)
            if cached is not None:
                cap, ev_cap = cached
            else:
                if total is None:
                    total = self._prepass_total(chunk)
                total_raw = int(float(total) * 1.001) + 8
                t0 = self._lap(t0, f"raw-total pre-pass ({total_raw})")
                cap = _cap_bucket(total_raw + 1)
        if cap > _slice_budget():
            # repeat-heavy chunk: bounded-memory sliced dispatch
            # (SPMD slice rounds under a mesh)
            return self._dispatch_chunk_sliced(chunk)
        if ev_cap is None:
            ev_cap = _bucket(min(cap, b_local)) // 4

        if self.mesh is None:
            ev_pack, m_flat, scalars = _scan_chunk(
                *args, jnp.int32(0), jnp.int32(_J_END_ALL),
                k=k, reverse=s.reverse,
                complement=s.complement, b_pad=b_pad, cap=cap,
                ev_cap=ev_cap)
            shards = [(ev_pack, m_flat, scalars)]
        else:
            stepf = _sharded_scan(
                self.mesh, k, s.reverse, s.complement, b_local,
                cap, ev_cap)
            evs, mfs, scs = stepf(*args)
            shards = [(evs[i], mfs[i], scs[i])
                      for i in range(n_shards)]
        self._lap(t0, f"scan dispatch (cap={cap})")
        return {"chunk": chunk, "cap": cap, "ev_cap": ev_cap,
                "shards": shards}

    def _dispatch_chunk_sliced(self, chunk, ev_scale: int = 1):
        """Bounded-memory dispatch for a repeat-heavy chunk: partition
        the probe stream into consecutive slices whose raw match totals
        stay within the slice budget, scan each with `_scan_chunk`
        (shared static shape: one b_slice, pow2 caps) and merge the
        slice event streams with the exact aging carry downstream.
        Output is identical to the single-dispatch scan: slices are
        probe slices, the mechanism already pinned byte-equal for mesh
        shards (tests/test_device_engine.py)."""
        if self._chunk_geometry(chunk) is None:
            return None
        s = self.settings
        k = s.probe_size
        didx = self.didx
        from .utils import pow2_ceil

        # shard-independent lane geometry (the mesh roundup of
        # `_chunk_geometry` could break SLICE_GRAN divisibility)
        step = k // 2
        n_probes = (chunk[1] - k - step + step - 1) // step
        b_pad = _bucket(n_probes)

        t0 = time.time()
        n_gran = b_pad // SLICE_GRAN
        gt = np.asarray(_raw_total_granules(
            didx.pos_lo, didx.pos_hi, jnp.int32(chunk[0]),
            jnp.int32(chunk[1]), jnp.int32(didx.first_len),
            k, s.reverse, s.complement, b_pad, n_gran))
        slices = _plan_slices(gt, SLICE_GRAN, _slice_budget())
        t0 = self._lap(t0, f"granule pre-pass ({len(slices)} slices)")
        # every slice reads b_slice lanes from its lane0, overhanging a
        # short slice's end by up to b_slice - SLICE_GRAN lanes (masked
        # via j_end; table_pad_for reserves the extra B_GRAN of slack)
        b_slice = pow2_ceil(max(nl for _, nl, _ in slices), 1 << 12)
        shards = []
        if self.mesh is not None:
            # SPMD slice rounds: up to n_dev slices per dispatch, each
            # device scanning its own (j0, j_end) row; a round shares
            # one (max) capacity so all cells run one program
            n_dev = self.mesh.devices.size
            for i in range(0, len(slices), n_dev):
                batch = slices[i:i + n_dev]
                caps = [_slice_caps(t, b_slice, ev_scale)
                        for (_, _, t) in batch]
                cap = max(c for c, _ in caps)
                ev_cap = max(e for _, e in caps)
                params = np.zeros((n_dev, 2), dtype=np.int32)
                for d, (lane0, n_lanes, _) in enumerate(batch):
                    params[d] = (lane0, lane0 + n_lanes)
                stepf = _sharded_sliced_scan(
                    self.mesh, k, s.reverse, s.complement, b_slice,
                    cap, ev_cap)
                ev, mf, sc = stepf(
                    didx.pos_lo, didx.pos_hi, didx.sa,
                    jnp.asarray(params), jnp.int32(chunk[0]),
                    jnp.int32(chunk[1]), jnp.int32(didx.first_len),
                    jnp.int32(didx.first_len - 1),
                    jnp.int32(s.max_cardinality))
                for d in range(len(batch)):
                    shards.append((ev[d], mf[d], sc[d]))
        else:
            args = (didx.pos_lo, didx.pos_hi, didx.sa,
                    jnp.int32(chunk[0]), jnp.int32(chunk[1]),
                    jnp.int32(didx.first_len),
                    jnp.int32(didx.first_len - 1),
                    jnp.int32(s.max_cardinality))
            for lane0, n_lanes, total in slices:
                cap, ev_cap = _slice_caps(total, b_slice, ev_scale)
                ev_pack, m_flat, scalars = _scan_chunk(
                    *args, jnp.int32(lane0), jnp.int32(lane0 + n_lanes),
                    k=k, reverse=s.reverse, complement=s.complement,
                    b_pad=b_slice, cap=cap, ev_cap=ev_cap)
                shards.append((ev_pack, m_flat, scalars))
        self._lap(t0, f"sliced scan dispatch ({len(slices)} x "
                      f"b={b_slice})")
        return {"chunk": chunk, "sliced": True, "ev_scale": ev_scale,
                "shards": shards}

    def _sliced_windows(self, chunk, ev_scale: int):
        """Bounded-memory sliced stage 2 for a repeat-heavy chunk of a
        WINDOWED engine: the stage-1 lane range is partitioned into
        ALIGNED fixed-width windows, each scanned (via the engine's
        `_slice_core` hook) with a capacity sized to its own exact raw
        total; window event streams merge with the exact aging carry
        downstream (the same probe-slice mechanism as mesh shards)."""
        geo = self._chunk_geometry(chunk)
        if geo is None:
            return None
        b_pad, _, _ = geo
        st1 = self._stage1_for(chunk)
        lo, hi, mask, _ = st1

        t0 = time.time()
        s = self.settings
        step = s.probe_size // 2
        n_lanes = (chunk[1] - s.probe_size - step + step - 1) // step
        n_gran = b_pad // SLICE_GRAN
        gt = _local_np(_range_granule_totals(
            lo, hi, jnp.int32(n_lanes), n_gran)).astype(np.float64)
        budget = _slice_budget()
        w = _fixed_slice_width(gt, SLICE_GRAN, budget,
                               min(B_GRAN, b_pad), b_pad)
        sums = gt.reshape(b_pad // w, w // SLICE_GRAN).sum(1)
        t0 = self._lap(t0, f"granule pre-pass ({len(sums)} x {w} lanes)")
        shards = []
        for i, tot_i in enumerate(sums):
            cap, ev_cap = _slice_caps(tot_i, w, ev_scale)
            st1s = _slice_lanes_dyn(lo, hi, mask, jnp.int32(i * w), w)
            shards.append(self._slice_core(
                st1s, chunk, jnp.int32(i * w), w, cap, ev_cap))
        self._lap(t0, f"sliced scan dispatch ({len(sums)} x b={w})")
        return {"chunk": chunk, "sliced": True, "ev_scale": ev_scale,
                "shards": shards}

    def _collect_chunk(self, st):
        """Download + merge one dispatched chunk's events and chain
        them; retries the dispatch with doubled capacities on
        overflow."""
        if st is None:
            return []
        s = self.settings
        k = s.probe_size
        while True:
            t0 = time.time()
            parts = []
            overflow_any = False
            max_ev = 0
            for ev_pack, m_flat, scalars in st["shards"]:
                n_events, total_kept, z_trail, overflow = (
                    int(v) for v in _local_np(scalars))
                overflow_any |= bool(overflow)
                max_ev = max(max_ev, n_events)
                parts.append((_local_np(ev_pack[:, :n_events]),
                              _local_np(m_flat[:total_kept]), z_trail))
            t0 = self._lap(t0, "event download")
            if not overflow_any:
                break
            if st.get("sliced"):
                # slice caps are exact raw totals — only the event
                # capacity can overflow; rescan with larger ev_caps
                scale = st["ev_scale"] * 4
                log.debug("sliced scan retry: ev_scale=%d", scale)
                st = self._dispatch_chunk_sliced(st["chunk"],
                                                 ev_scale=scale)
                continue
            cap, ev_cap = st["cap"], st["ev_cap"]
            if max_ev > ev_cap:
                ev_cap = _bucket(max_ev + 1)
            else:
                # exact raw total exceeded the estimate: jump to the NEXT cap
                # bucket (an off-bucket cap*2 shape would compile
                # fresh on every genome whose totals overflow a
                # cached cap)
                cap = _cap_bucket(cap + 1)
            log.debug("device scan retry: cap=%d ev_cap=%d", cap, ev_cap)
            st = self._dispatch_chunk(st["chunk"], cap=cap, ev_cap=ev_cap)

        _CAP_CACHE[self._cap_key(st["chunk"])] = (
            "sliced" if st.get("sliced") else (st["cap"], st["ev_cap"]))
        return self._chain_merged(parts, t0)

    def _chain_merged(self, parts, t0=None):
        """Merge downloaded per-shard event parts and run the host
        event chain — the tail shared by per-chunk and grouped
        collection."""
        s = self.settings
        k = s.probe_size
        if t0 is None:
            t0 = time.time()
        ev, m_host, z_trail = _merge_shard_events(parts)
        if ev is None:
            return []
        if self._m_offset:
            # window-relative matches -> global (big-genome path)
            m_host = m_host.astype(np.int64) + self._m_offset
        n_events = ev.shape[1]
        m_offsets = np.zeros(n_events + 1, dtype=np.int64)
        np.cumsum(ev[2], out=m_offsets[1:])

        if os.environ.get("ASGART_DEVICE_CHAIN"):
            # full on-device chaining: vmap over provably-independent
            # bursts (chain_jax.chain_bursts). Exact, but the sequential
            # tail is microseconds of host work, so the host event chain
            # stays the default.
            from .chain_jax import ChainConfig, chain_events_device

            cfg = ChainConfig(
                probe_size=k, step_size=k // 2,
                max_gap_size=s.max_gap_size,
                min_duplication_length=s.min_duplication_length,
                max_cardinality=s.max_cardinality)
            raw_families = chain_events_device(
                cfg, ev[0], ev[1], m_offsets, m_host, int(z_trail))
        else:
            raw_families = native.chain_events(
                ev[0], ev[1], m_offsets, m_host,
                z_trail=z_trail,
                probe_size=k, step_size=k // 2,
                max_gap_size=s.max_gap_size,
                min_duplication_length=s.min_duplication_length,
                max_cardinality=s.max_cardinality)
        self._lap(t0, "merge+chain")
        return raw_families

    def run_chunk(self, chunk: tuple[int, int]):
        """Families for one chunk, native-engine format + coordinate
        fixup left to the caller (mirrors SearchEngine.run_chunk)."""
        return self._collect_chunk(self._dispatch_chunk(chunk))

    def _batch_totals(self, chunks):
        """Raw-total pre-passes for every chunk not in the cap cache,
        batched per lane bucket (one dispatch per b_pad instead of one
        per chunk); returns {chunk: float_total}."""
        s = self.settings
        didx = self.didx
        need = [(c, g) for c, g in
                ((c, self._chunk_geometry(c)) for c in chunks)
                if g is not None and self._cap_key(c) not in _CAP_CACHE]
        by_pad: dict = {}
        for c, g in need:
            by_pad.setdefault(g[0], []).append(c)
        totals: dict = {}
        for b_pad, cs in by_pad.items():
            if len(cs) == 1:
                totals[cs[0]] = self._prepass_total(cs[0])
                continue
            params = jnp.asarray(
                np.array([[c[0], c[1]] for c in cs], dtype=np.int32))
            batch = np.asarray(_raw_totals_batch(
                didx.pos_lo, didx.pos_hi, params,
                jnp.int32(didx.first_len), s.probe_size, s.reverse,
                s.complement, b_pad))
            for c, t in zip(cs, batch):
                totals[c] = float(t)
        return totals

    def _group_caps(self, chunks, totals, slack: bool):
        """(cap, ev_cap) per chunk — cache hit or sized from the
        pre-pass total (`slack` adds the table engine's estimation
        margin; the merge-join total is exact)."""
        caps = {}
        for c in chunks:
            geo = self._chunk_geometry(c)
            if geo is None:
                continue
            cached = _CAP_CACHE.get(self._cap_key(c))
            if cached is not None:
                caps[c] = cached  # may be the "sliced" marker
                continue
            t = totals[c]
            total_raw = (int(float(t) * 1.001) + 8) if slack \
                else int(float(t))
            cap = _cap_bucket(total_raw + 1)
            if cap > _slice_budget():
                caps[c] = "sliced"  # repeat-heavy: single sliced path
                continue
            caps[c] = (cap, _bucket(min(cap, geo[0])) // 4)
        return caps

    def _dispatch_group(self, group, b_pad, cap, ev_cap):
        """One grouped dispatch (`_scan_chunks_group`, or its SPMD
        counterpart `_sharded_scan_group` under a mesh) for
        same-geometry chunks, padded with inert dummy rows to the
        static group size."""
        s = self.settings
        didx = self.didx
        gs = _pad_group(len(group))
        params = np.zeros((gs, 2), dtype=np.int32)
        for i, c in enumerate(group):
            params[i] = c
        t0 = time.time()
        if self.mesh is None:
            ev, m, sc = _scan_chunks_group(
                didx.pos_lo, didx.pos_hi, didx.sa, jnp.asarray(params),
                jnp.int32(didx.first_len), jnp.int32(didx.first_len - 1),
                jnp.int32(s.max_cardinality), k=s.probe_size,
                reverse=s.reverse, complement=s.complement,
                b_pad=b_pad, cap=cap, ev_cap=ev_cap)
            n_shards = 1
        else:
            n_shards = self.mesh.devices.size
            stepf = _sharded_scan_group(
                self.mesh, s.probe_size, s.reverse, s.complement,
                b_pad // n_shards, cap, ev_cap)
            ev, m, sc = stepf(
                didx.pos_lo, didx.pos_hi, didx.sa, jnp.asarray(params),
                jnp.int32(didx.first_len), jnp.int32(didx.first_len - 1),
                jnp.int32(s.max_cardinality))
        self._lap(t0, f"group dispatch ({len(group)}/{gs}, cap={cap})")
        return {"chunks": list(group), "ev": ev, "m": m, "sc": sc,
                "cap": cap, "ev_cap": ev_cap, "n_shards": n_shards}

    def _collect_group(self, gst):
        """{chunk: families} for one dispatched group: ONE stacked
        scalars fetch, bulk (or per-chunk) event downloads, host
        chain; chunks that overflowed retry through the single-chunk
        path. Mesh groups arrive as [n_shards, G, ...] stacks; each
        chunk's shard streams merge with the exact aging carry."""
        t0 = time.time()
        S = gst.get("n_shards", 1)
        sc = np.asarray(gst["sc"])
        if S == 1 and sc.ndim == 2:
            sc = sc[None]  # [S, G, 4] uniformly
        t0 = self._lap(t0, "group scalars fetch")
        out = {}
        retried = set()
        live = []
        for g, chunk in enumerate(gst["chunks"]):
            if sc[:, g, 3].any():
                cap, ev_cap = gst["cap"], gst["ev_cap"]
                max_ev = int(sc[:, g, 0].max())
                if max_ev > ev_cap:
                    ev_cap = _bucket(max_ev + 1)
                else:
                    cap = _cap_bucket(cap + 1)
                log.debug("group scan retry: cap=%d ev_cap=%d",
                          cap, ev_cap)
                out[chunk] = self._collect_chunk(
                    self._dispatch_chunk(chunk, cap=cap, ev_cap=ev_cap))
                retried.add(g)
                continue
            _CAP_CACHE[self._cap_key(chunk)] = (gst["cap"],
                                                gst["ev_cap"])
            for sh in range(S):
                n_events, total_kept = (int(sc[sh, g, 0]),
                                        int(sc[sh, g, 1]))
                live.append((sh, g, n_events, total_kept))
        packed_bytes = 4 * sum(3 * ne + tk for (_, _, ne, tk) in live)
        if packed_bytes <= _PACK_BYTES_MAX:
            # live events are KBs; the stacked cap-sized buffers are
            # tens of MB — gather-pack on device and download only the
            # live bytes
            got = _packed_group_download(gst["ev"], gst["m"], live)
            ev_h = m_h = None
        else:
            got = None
            ev_h = np.asarray(gst["ev"]).reshape(
                (S,) + gst["ev"].shape[-3:])
            m_h = np.asarray(gst["m"]).reshape((S,) + gst["m"].shape[-2:])
        for g, chunk in enumerate(gst["chunks"]):
            if g in retried:
                continue
            parts = []
            for sh in range(S):
                n_events, total_kept, z_trail, _ = (
                    int(v) for v in sc[sh, g])
                if got is not None:
                    ev_c, m_c = got[(sh, g)]
                    parts.append((ev_c, m_c, z_trail))
                else:
                    parts.append((ev_h[sh, g][:, :n_events],
                                  m_h[sh, g][:total_kept], z_trail))
            out[chunk] = self._chain_merged(parts)
        self._lap(t0, f"group collect ({len(gst['chunks'])})")
        return out

    def _plan_groups(self, chunks, totals, slack: bool):
        """Partition chunks into grouped dispatches by (b_pad, cap,
        ev_cap); returns (groups, singles) where groups is a list of
        (chunk_list, b_pad, cap, ev_cap)."""
        caps = self._group_caps(chunks, totals, slack)
        by_key: dict = {}
        sliced = []
        for c in chunks:
            geo = self._chunk_geometry(c)
            if geo is None:
                continue
            if caps[c] == "sliced":
                sliced.append((c, None, None))  # dispatch auto-slices
                continue
            key = (geo[0],) + caps[c]
            by_key.setdefault(key, []).append(c)
        groups, singles = [], list(sliced)
        for (b_pad, cap, ev_cap), cs in by_key.items():
            gs = _group_size_for(cap)
            if gs < 2 or len(cs) < 2:
                singles.extend((c, cap, ev_cap) for c in cs)
                continue
            for i in range(0, len(cs), gs):
                part = cs[i:i + gs]
                if len(part) == 1:
                    singles.append((part[0], cap, ev_cap))
                else:
                    groups.append((part, b_pad, cap, ev_cap))
        return groups, singles

    def dispatch_chunks(self, chunks):
        """Device phase of :meth:`run_chunks`: plan + enqueue every
        group/single dispatch, return the in-flight state. The matching
        :meth:`collect_chunks` does the (blocking) downloads + host
        chaining — a sharded run overlaps it with the NEXT window's
        dispatch (`pipeline._run_device_windows_pipelined`)."""
        totals = self._batch_totals(chunks)
        groups, singles = self._plan_groups(chunks, totals, slack=True)
        gstates = [self._dispatch_group(part, b_pad, cap, ev_cap)
                   for part, b_pad, cap, ev_cap in groups]
        sstates = {c: self._dispatch_chunk(c, cap=cap, ev_cap=ev_cap,
                                           total=totals.get(c))
                   for c, cap, ev_cap in singles}
        return gstates, sstates

    def collect_chunks(self, state, chunks):
        """Host phase of :meth:`run_chunks`: download + chain the
        dispatched state (may re-dispatch internally on event-capacity
        overflows)."""
        gstates, sstates = state
        results: dict = {}
        for gst in gstates:
            results.update(self._collect_group(gst))
        for c, st in sstates.items():
            results[c] = self._collect_chunk(st)
        return [results.get(c, []) for c in chunks]

    def run_chunks(self, chunks):
        """All chunks with grouped dispatch: same-geometry chunks run
        as ONE `lax.map` core (one dispatch + one stacked
        scalars fetch per group of up to GROUP_SIZE) and groups
        pipeline against each other's downloads. Under a mesh the
        groups dispatch as `_sharded_scan_group` SPMD programs — the
        chunk-heavy dispatch-bound profile that motivated grouping
        does not regress when ≥ 2 devices are present."""
        return self.collect_chunks(self.dispatch_chunks(chunks), chunks)


class DeviceWindowEngine(DeviceEngine):
    """Windowed (``--trim``) variant of the device engine: the index covers
    only the trim window while the whole genome is probed against it
    (reference trim semantics, asgart.rs:142-148) — the memory-bounded
    scale-out unit, fully on-device.

    Two-stage dispatch per chunk: `_window_ranges` (merge-join equal
    ranges + the exact raw total) sizes the flat capacity, then the
    shared `_scan_core` compacts events; (lo, hi, mask) stay device-
    resident between the stages and across overflow retries.
    """

    def __init__(self, strand, settings, trim, profile: dict | None = None,
                 codes_device=None):
        from .device_index import DeviceWindowIndex, cached_build

        self.strand = strand
        self.settings = settings
        self.trim = (int(trim[0]), int(trim[1]))
        t0 = time.time()
        self.widx = cached_build(
            DeviceWindowIndex.build, strand.data,
            (settings.probe_size,), trim=self.trim,
            reverse=settings.reverse, complement=settings.complement,
            codes_device=codes_device)
        # probe-axis mesh sharding for windows comes via the composed
        # (windows x probes) mesh engine, not per-window meshes
        self.mesh = None
        self._stage1: dict = {}
        if profile is not None:
            profile["device_index_s"] = round(time.time() - t0, 3)

    def _cap_key(self, chunk):
        s = self.settings
        return ("win", self.widx.first_len, self.trim, s.probe_size,
                s.reverse, s.complement, s.max_cardinality, chunk)

    def _stage1_for(self, chunk):
        """Dispatch (or reuse) the merge-join ranges for one chunk;
        chunks covered by a batched stage 1 slice their lanes out of
        the shared arrays lazily (only the singleton/retry paths need
        per-chunk slices — grouped dispatch reads the shared arrays
        directly)."""
        st1 = self._stage1.get(chunk)
        if st1 is None:
            geo = self._chunk_geometry(chunk)
            if geo is None:
                return None
            b_pad, _, _ = geo
            goff = getattr(self, "_g_off", {}).get(chunk)
            if goff is not None:
                lo, hi, mask = self._g_full
                st1 = _slice_lanes(lo, hi, mask, goff[0], b_pad) \
                    + (goff[1],)
            else:
                s = self.settings
                w = self.widx
                st1 = _window_ranges(
                    w.key_hi, w.key_lo, w.codes,
                    jnp.int32(chunk[0]), jnp.int32(chunk[1]),
                    jnp.int32(w.first_len), jnp.int32(0),
                    k=s.probe_size, reverse=s.reverse,
                    complement=s.complement, b_pad=b_pad)
            self._stage1[chunk] = st1
        return st1

    def _prepass_total(self, chunk):
        st1 = self._stage1_for(chunk)
        return None if st1 is None else st1[3]

    def _dispatch_chunk(self, chunk, cap=None, ev_cap=None, total=None):
        geo = self._chunk_geometry(chunk)
        if geo is None:
            return None
        b_pad, b_local, _ = geo
        s = self.settings
        st1 = self._stage1_for(chunk)
        lo, hi, mask, tot = st1
        t0 = time.time()
        if cap is None:
            cached = _CAP_CACHE.get(self._cap_key(chunk))
            if cached == "sliced":
                return self._dispatch_chunk_sliced(chunk)
            if cached is not None:
                cap, ev_cap = cached
            else:
                # the merge-join total is exact, no estimation slack
                total_raw = int(float(tot if total is None else total))
                t0 = self._lap(t0, f"ranges+total ({total_raw})")
                cap = _cap_bucket(total_raw + 1)
        if cap > _slice_budget():
            return self._dispatch_chunk_sliced(chunk)
        if ev_cap is None:
            ev_cap = _bucket(min(cap, b_local)) // 4
        ev_pack, m_flat, scalars = _scan_core(
            lo, hi, mask, self.widx.sa,
            jnp.int32(chunk[0]), jnp.int32(chunk[1]),
            jnp.int32((1 << 31) - 1), jnp.int32(s.max_cardinality),
            jnp.int32(0), k=s.probe_size, reverse=s.reverse,
            b_pad=b_pad, cap=cap, ev_cap=ev_cap)
        self._lap(t0, f"window scan dispatch (cap={cap})")
        return {"chunk": chunk, "cap": cap, "ev_cap": ev_cap,
                "shards": [(ev_pack, m_flat, scalars)]}

    def _slice_core(self, st1s, chunk, j0, b, cap, ev_cap):
        """One sliced stage-2 dispatch (hook for `_sliced_windows`)."""
        s = self.settings
        lo_s, hi_s, mask_s = st1s
        return _scan_core(
            lo_s, hi_s, mask_s, self.widx.sa,
            jnp.int32(chunk[0]), jnp.int32(chunk[1]),
            jnp.int32((1 << 31) - 1), jnp.int32(s.max_cardinality),
            j0, k=s.probe_size, reverse=s.reverse,
            b_pad=b, cap=cap, ev_cap=ev_cap)

    def _dispatch_chunk_sliced(self, chunk, ev_scale: int = 1):
        return self._sliced_windows(chunk, ev_scale)

    def run_chunk(self, chunk):
        out = self._collect_chunk(self._dispatch_chunk(chunk))
        self._stage1.pop(chunk, None)
        return out

    def _batch_stage1(self, chunks):
        """Populate the per-chunk stage-1 cache from ONE batched merge
        join (`_window_ranges_batch`): the co-sort's W side dominates
        its cost, and N-run splitting gives real genomes dozens of
        chunks — per-chunk co-sorts scale stage 1 with the chunk count.

        The batched result persists ON THE (HBM-cached) WINDOW INDEX:
        a rescan of the same genome + chunk set skips the co-sort
        entirely — stage 1 depends only on (window, probe transform,
        chunks), all captured by the index cache key + the chunk tuple.
        """
        s = self.settings
        k = s.probe_size
        step = k // 2
        specs, geo_of = [], {}
        for c in chunks:
            if c in self._stage1:
                continue
            geo = self._chunk_geometry(c)
            if geo is None:
                continue
            nc = (c[1] - k - step + step - 1) // step
            specs.append((int(c[0]), int(c[1]), nc))
            geo_of[c] = geo
        if len(specs) < 2:
            return
        w = self.widx
        s1key = (tuple(sorted(geo_of)), k, s.reverse, s.complement)
        cached = getattr(w, "stage1_cache", None)
        if cached is not None and cached[0] == s1key:
            self._g_full, self._g_off = cached[1], dict(cached[2])
            return
        t0 = time.time()
        tail_pad = max(g[0] for g in geo_of.values()) + 8
        total = sum(nc for (_, _, nc) in specs) + tail_pad
        from .device_index import (_hbm_free_bytes_local,
                                   _strand_fingerprint,
                                   device_index_cache_enabled)

        # HBM projection: the co-sort peaks at ~35 B/(W + B) row next
        # to whatever is already resident (window index, codes, the
        # pipeline's shared codes). When one join + the cross-window
        # caches don't fit, fall back first to an uncached single join,
        # then to probe-side GROUPS — exact (each lane's equal range is
        # independent), costing one extra W-side sort pass per group.
        W = int(w.key_hi.shape[0])
        env_bmax = os.environ.get("ASGART_MJ_B_MAX")
        if env_bmax:  # test hook: force a probe-side group width
            b_max = int(env_bmax)
            fits_single = total <= b_max
            cacheable = device_index_cache_enabled() and fits_single
        else:
            def _avail():
                env_free = os.environ.get("ASGART_MJ_FREE_BYTES")
                free = int(env_free) if env_free else _hbm_free_bytes()
                if not env_free and not device_index_cache_enabled() \
                        and _hbm_free_bytes_local() is None:
                    # accounting fallback + cache disabled: the resident
                    # window (key planes, sa, codes) sits in NO tracked
                    # cache, so the estimate would overstate free HBM —
                    # subtract it explicitly
                    for arr in (w.key_hi, w.key_lo, w.sa, w.codes):
                        try:
                            free -= arr.nbytes
                        except Exception:
                            pass
                # the (lo, hi, mask) outputs materialize during the
                # back-sorts, after the co-sort's peak buffers free —
                # they are NOT additive with the 35 B/row peak, so the
                # margin is the only reserve
                return free - (1 << 27)

            avail = _avail()
            fits_single = avail >= _MJ_SORT_PEAK_PER_ROW * (W + total)
            # NB: no eviction here. A 2-3-group join (the total/3 width
            # floor below) costs ~one extra W-side sort pass; evicting
            # resident sibling windows would save that but destroy the
            # rescan regime's residency (an eviction at the last
            # window's join would wipe the whole cache + the codes
            # upload and turn a rescan into a full rebuild).
            # Transient-hungry BUILDS still evict via cached_build's
            # pre-build check.
            # the cross-window caches (probe key planes now + the
            # stage-1 result across windows) each hold ~9-18 B/lane
            # NEXT to later windows' joins — only keep them with that
            # much slack
            cacheable = device_index_cache_enabled() and \
                avail >= _MJ_SORT_PEAK_PER_ROW * (W + total) + 18 * total
            # floor the group width at total/3: every group re-pays the
            # full W side of the co-sort, so many narrow groups cost
            # multiples of the single-shot join — past ~3 groups it is
            # better to run closer to the projection than to multiply
            # the W-side sorts
            b_max = max(int(avail) // _MJ_SORT_PEAK_PER_ROW - W,
                        (total + 2) // 3, 1 << 24)
        if not cacheable:
            # an earlier window's cached planes would otherwise stay
            # resident next to this join
            _PROBE_KEYS_CACHE.clear()
        if fits_single:
            # the packed probe keys are WINDOW-INDEPENDENT (same
            # genome, same chunks): cache them across a sharded run's
            # windows so only the first window pays the pack
            pkey = ("probe-keys", _strand_fingerprint(self.strand.data),
                    k, s.reverse, s.complement, tuple(specs), total)
            keys = _PROBE_KEYS_CACHE.get(pkey) if cacheable else None
            if keys is None:
                keys = _pack_batch_probe_keys(
                    w.codes, jnp.zeros(len(specs), I32), k, s.reverse,
                    s.complement, int(w.first_len), tuple(specs), total)
                if cacheable:
                    _PROBE_KEYS_CACHE.clear()
                    _PROBE_KEYS_CACHE[pkey] = keys
            if cacheable:
                lo, hi, mask, totals = _mj_ranges_from_keys(
                    w.key_hi, w.key_lo, *keys, specs=tuple(specs))
            else:
                lo, hi, mask, totals = _mj_ranges_from_keys_donated(
                    w.key_hi, w.key_lo, *keys, specs=tuple(specs))
                del keys
            # ONE totals fetch (a per-chunk device scalar read would
            # cost a round trip per chunk when sizing the cores)
            tot_host = np.asarray(totals)
        else:
            groups = _plan_mj_groups(specs, b_max)
            log.info("batched stage 1 over %d probe-side groups "
                     "(%d lanes vs %d-lane HBM room)", len(groups),
                     total, b_max)
            los, his, ms, piece_tots, pieces = [], [], [], [], []
            for grp in groups:
                specs_g = tuple((cs, cl, nc) for (cs, cl, nc, _) in grp)
                j0s_g = jnp.asarray([j0 for (_, _, _, j0) in grp], I32)
                tot_g = sum(nc for (_, _, nc, _) in grp)
                phi, plo, m = _pack_batch_probe_keys(
                    w.codes, j0s_g, k, s.reverse, s.complement,
                    int(w.first_len), specs_g, tot_g)
                lo_g, hi_g, m_g, totals_g = _mj_ranges_from_keys_donated(
                    w.key_hi, w.key_lo, phi, plo, m, specs=specs_g)
                # sync per group: serializes the joins so only one
                # group's sort transients are live at a time
                piece_tots.append(np.asarray(totals_g))
                pieces.extend(grp)
                los.append(lo_g)
                his.append(hi_g)
                ms.append(m_g)
            zi = jnp.zeros(tail_pad, I32)
            lo = jnp.concatenate(los + [zi])
            hi = jnp.concatenate(his + [zi])
            mask = jnp.concatenate(ms + [jnp.zeros(tail_pad, bool)])
            del los, his, ms
            flat = np.concatenate(piece_tots)
            tot_host = np.zeros(len(specs), np.float64)
            pi = 0
            for i, (_, _, nc) in enumerate(specs):
                acc = 0
                while acc < nc:
                    tot_host[i] += float(flat[pi])
                    acc += pieces[pi][2]
                    pi += 1
        self._lap(t0, f"batched stage 1 ({len(specs)} chunks)")
        self._g_full = (lo, hi, mask)
        self._g_off = {}
        off = 0
        i = 0
        for c in chunks:
            geo = geo_of.get(c)
            if geo is None:
                continue
            nc = specs[i][2]
            self._g_off[c] = (off, float(tot_host[i]))
            off += nc
            i += 1
        if device_index_cache_enabled():
            # persisting adds NO allocation (g_full already lives for
            # this window's scans) and the index cache's live-stats LRU
            # eviction frees it with the window index under pressure
            w.stage1_cache = (s1key, self._g_full, dict(self._g_off))

    def _dispatch_group(self, group, b_pad, cap, ev_cap):
        """Grouped `_scan_core_group` dispatch reading each chunk's
        lanes straight from the batched stage-1 arrays."""
        s = self.settings
        lo, hi, mask = self._g_full
        gs = _pad_group(len(group))
        params = np.zeros((gs, 3), dtype=np.int32)
        for i, c in enumerate(group):
            params[i] = (self._g_off[c][0], c[0], c[1])
        t0 = time.time()
        ev, m, sc = _scan_core_group(
            lo, hi, mask, self.widx.sa, jnp.asarray(params),
            jnp.int32((1 << 31) - 1), jnp.int32(s.max_cardinality),
            k=s.probe_size, reverse=s.reverse, b_pad=b_pad,
            cap=cap, ev_cap=ev_cap)
        self._lap(t0, f"group dispatch ({len(group)}/{gs}, cap={cap})")
        return {"chunks": list(group), "ev": ev, "m": m, "sc": sc,
                "cap": cap, "ev_cap": ev_cap}

    def dispatch_chunks(self, chunks):
        # one batched stage-1 for every chunk, then grouped cores
        # (same-geometry chunks share one dispatch + one scalars
        # fetch); chunks outside the batch go through the per-chunk
        # path. Groups pipeline against each other's downloads.
        self._g_off = {}
        self._g_full = None
        self._batch_stage1(chunks)
        in_batch = [c for c in chunks if c in self._g_off]
        rest = [c for c in chunks if c not in self._g_off]
        totals = {c: off[1] for c, off in self._g_off.items()}
        groups, singles = self._plan_groups(in_batch, totals,
                                            slack=False)
        gstates = [self._dispatch_group(part, b_pad, cap, ev_cap)
                   for part, b_pad, cap, ev_cap in groups]
        sstates = {c: self._dispatch_chunk(c, cap=cap, ev_cap=ev_cap)
                   for c, cap, ev_cap in singles}
        for c in rest:
            sstates[c] = self._dispatch_chunk(c)
        return gstates, sstates

    def collect_chunks(self, state, chunks):
        gstates, sstates = state
        results: dict = {}
        for gst in gstates:
            results.update(self._collect_group(gst))
        for c, st in sstates.items():
            results[c] = self._collect_chunk(st)
        self._stage1.clear()
        self._g_off = {}
        self._g_full = None
        return [results.get(c, []) for c in chunks]

    def run_chunks(self, chunks):
        return self.collect_chunks(self.dispatch_chunks(chunks), chunks)


def _fused_gate(settings) -> bool | None:
    """Shared env/k/device gates of the fused predicates: None = keep
    checking fit, True/False = decided."""
    from .device_index import DEVICE_MAX_K_TABLE

    env = os.environ.get("ASGART_FUSED")
    if env == "0":
        return False
    if settings.probe_size > DEVICE_MAX_K_TABLE:
        return False
    if env == "1":
        return None
    if len(jax.devices()) != 1:
        return False
    return None


def fused_applicable(n1: int, settings) -> bool:
    """Routing predicate for the fused-probe whole-genome engine:
    k <= 30 (2-plane keys to 20, a third plane beyond), one visible
    device (the mesh paths keep the table engine's replicated
    per-position tables), HBM fit. ``ASGART_FUSED=0`` disables,
    ``=1`` forces (e.g. CPU-mesh tests)."""
    from .device_index import fused_fits

    gate = _fused_gate(settings)
    if gate is not None:
        return gate
    return fused_fits(n1, settings.probe_size)


def fused_window_applicable(n1: int, W: int, settings) -> bool:
    """Routing predicate for the fused-probe TRIM-WINDOW engine (the
    `--shards`/`--trim` build with stage 1 fused into the window sort;
    also the k = 21..30 device path for windows, which the 2-plane
    merge-join engines route to the host). Peak: the (W + B)-row sort
    transients next to the resident decimated probe source + codes."""
    from .device_index import FUSED_PEAK_BYTES_PER_ROW, hbm_budget_bytes

    gate = _fused_gate(settings)
    if gate is not None:
        return gate
    step = max(1, settings.probe_size // 2)
    M = W + n1 // step + (1 << 21)
    return M < (1 << 31) and \
        M * FUSED_PEAK_BYTES_PER_ROW + 3 * n1 <= hbm_budget_bytes()


class FusedEngine(DeviceWindowEngine):
    """Whole-genome single-device engine over the fused-probe index
    (`device_index.FusedIndex`): the probe join is fused into the index
    build, so the scan's per-lane equal ranges are contiguous slices of
    build outputs — no per-position tables, no stage-1 co-sorts, no
    key-plane residency. Byte-equal to the table engine / host engine
    (the window [lo, hi) spans exactly a k-mer group's direct entries
    in final suffix order — the same windows the doubled-table design
    reads per position). The index is built lazily at the first
    `run_chunks` (the chunk set is part of the build); a tied-set
    overflow (`FusedTiedOverflow` — hyper-repetitive inputs) falls back
    to the classic table engine, byte-equal."""

    def __init__(self, strand, settings, profile: dict | None = None,
                 codes_device=None, trim=None):
        self.strand = strand
        self.settings = settings
        self.trim = (int(trim[0]), int(trim[1])) if trim is not None \
            else None
        self.mesh = None
        self._stage1: dict = {}
        self._profile = profile
        self._codes_device = codes_device
        self.widx = None
        self._delegate = None
        self._g_full = None
        self._g_off: dict = {}

    def _specs_for(self, chunks):
        s = self.settings
        k = s.probe_size
        step = k // 2
        specs = []
        for c in chunks:
            if self._chunk_geometry(c) is None:
                continue
            nc = (c[1] - k - step + step - 1) // step
            specs.append((int(c[0]), int(c[1]), nc))
        return tuple(specs)

    def _ensure(self, chunks):
        if self._delegate is not None:
            return
        chunks = [tuple(c) for c in chunks]
        if self.widx is not None and all(
                c in self._g_off or self._chunk_geometry(c) is None
                for c in chunks):
            return
        from .device_index import (FusedIndex, FusedTiedOverflow,
                                   cached_build)

        specs = self._specs_for(chunks)
        t0 = time.time()
        try:
            self.widx = cached_build(
                FusedIndex.build, self.strand.data,
                (self.settings.probe_size,), specs=specs,
                reverse=self.settings.reverse,
                complement=self.settings.complement,
                trim=self.trim,
                codes_device=self._codes_device)
        except FusedTiedOverflow as e:
            if self.trim is not None:
                from .device_index import DEVICE_MAX_K

                if self.settings.probe_size > DEVICE_MAX_K:
                    # no 3-plane merge-join window engine exists;
                    # byte-equal host fallback
                    raise
                log.info("fused window build bailed (%s); using the "
                         "merge-join window engine", e)
                self._delegate = DeviceWindowEngine(
                    self.strand, self.settings, self.trim,
                    profile=self._profile,
                    codes_device=self._codes_device)
                return
            log.info("fused build bailed (%s); using the table engine",
                     e)
            self._delegate = DeviceEngine(
                self.strand, self.settings, profile=self._profile,
                mesh=False, codes_device=self._codes_device)
            return
        w = self.widx
        self._g_full = (w.lane_lo, w.lane_hi, w.lane_mask)
        self._g_off = dict(w.offs)
        self._stage1.clear()
        if self._profile is not None:
            self._profile["device_index_s"] = round(
                self._profile.get("device_index_s", 0.0)
                + (time.time() - t0), 3)

    def _cap_key(self, chunk):
        s = self.settings
        return ("fused", self.widx.first_len, s.probe_size, s.reverse,
                s.complement, s.max_cardinality, tuple(chunk))

    def _batch_stage1(self, chunks):  # the build IS stage 1
        raise AssertionError("FusedEngine has no separate stage 1")

    def run_chunk(self, chunk):
        chunk = tuple(chunk)
        self._ensure([chunk])
        if self._delegate is not None:
            return self._delegate.run_chunk(chunk)
        out = self._collect_chunk(self._dispatch_chunk(chunk))
        self._stage1.pop(chunk, None)
        return out

    def dispatch_chunks(self, chunks):
        chunks = [tuple(c) for c in chunks]
        self._ensure(chunks)
        if self._delegate is not None:
            # delegate split: the delegate's own dispatch/collect pair
            return ("delegate", self._delegate.dispatch_chunks(chunks))
        in_batch = [c for c in chunks if c in self._g_off]
        totals = {c: off[1] for c, off in self._g_off.items()
                  if c in in_batch}
        groups, singles = self._plan_groups(in_batch, totals,
                                            slack=False)
        gstates = [self._dispatch_group(part, b_pad, cap, ev_cap)
                   for part, b_pad, cap, ev_cap in groups]
        sstates = {c: self._dispatch_chunk(c, cap=cap, ev_cap=ev_cap)
                   for c, cap, ev_cap in singles}
        return gstates, sstates

    def collect_chunks(self, state, chunks):
        chunks = [tuple(c) for c in chunks]
        if state and state[0] == "delegate":
            return self._delegate.collect_chunks(state[1], chunks)
        gstates, sstates = state
        results: dict = {}
        for gst in gstates:
            results.update(self._collect_group(gst))
        for c, st in sstates.items():
            results[c] = self._collect_chunk(st)
        self._stage1.clear()
        return [results.get(c, []) for c in chunks]

    def run_chunks(self, chunks):
        return self.collect_chunks(self.dispatch_chunks(chunks), chunks)


# cross-window cache of batched needle-codes uploads (big-genome runs;
# see BigWindowEngine._needle_batch_codes). Byte-bounded.
_NEEDLE_CODES_CACHE: dict = {}

# one-entry cache of the batched stage-1 probe KEY planes: identical for
# every window of a sharded run (keyed by strand content + chunk specs
# + transform) — windows after the first skip the pack entirely
_PROBE_KEYS_CACHE: dict = {}
_NEEDLE_CACHE_BYTES = 4 << 30

# account the plane + needle caches in the free-HBM estimate
from .device_index import _TRACKED_CACHES  # noqa: E402

_TRACKED_CACHES.append(_PROBE_KEYS_CACHE)
_TRACKED_CACHES.append(_NEEDLE_CODES_CACHE)

# code-space complement: CODE[complemented(byte)] == _COMP_CODE[CODE
# [byte]] for every byte the pipeline can see — prepare_data normalizes
# the strand to ACGTN$ (fasta._NORM_*), and all code-0 bytes ('$', any
# stray unknown) complement to 'N' (utils._COMPLEMENT_LENIENT), rank 4.
# Lets the needle transform (pipeline.transform_needle: complement,
# then reverse) run ON DEVICE from the resident genome codes.
_COMP_CODE = np.array([4, 5, 3, 2, 4, 1, 0, 0], dtype=np.uint8)


def _device_needle_enabled(n1: int) -> bool:
    """Whether big-window runs derive window/needle codes ON DEVICE
    from the one (packed, fingerprint-cached) genome-codes upload,
    instead of uploading 1 B/bp per window + per needle batch (~2x the
    genome in wire per cold run, again per rescan for windows). Needs
    int32 strand addressing; ``ASGART_BIG_DEVCODES=0`` restores the
    host-upload path."""
    return n1 < (1 << 31) \
        and os.environ.get("ASGART_BIG_DEVCODES", "1") != "0"


@functools.partial(jax.jit, static_argnames=("off", "cap", "reverse",
                                             "complement"))
def _needle_batch_device(codes1, starts, lengths, bases, off: int,
                         cap: int, reverse: bool, complement: bool):
    """The batched needle-codes buffer (`_needle_batch_codes`' host
    layout: each chunk's transformed codes at its base, zeros between
    regions) derived from the device-resident strand codes. Exact:
    complement is the code-space LUT (`_COMP_CODE`), reverse is a
    flipped slice; bases ascend, so each region's `cap`-wide write may
    spill zeros only into regions written LATER (their data overwrites)
    or into the scratch tail."""
    n1 = codes1.shape[0]
    eff = min(cap, n1)  # chunk lengths never exceed the strand
    jpos = jnp.arange(cap, dtype=jnp.int32)
    lut = jnp.asarray(_COMP_CODE)

    def body(buf, xs):
        # eff-sized windows only (no n1-sized pads/copies): the slice
        # start clamps into [0, n1 - eff] and a roll realigns — the
        # displaced (wrapped) tail always lands in the masked j >= ln
        # region, so the valid bytes are exact
        st, ln, ba = xs
        if reverse:
            want = st + ln - eff  # ideal window [st+ln-eff, st+ln)
            start2 = jnp.maximum(want, 0)
            seg = jnp.flip(
                jax.lax.dynamic_slice(codes1, (start2,), (eff,)))
            seg = jnp.roll(seg, want - start2)
        else:
            start2 = jnp.minimum(st, jnp.int32(n1 - eff))
            seg = jax.lax.dynamic_slice(codes1, (start2,), (eff,))
            seg = jnp.roll(seg, start2 - st)
        if eff < cap:
            seg = jnp.concatenate(
                [seg, jnp.zeros(cap - eff, jnp.uint8)])
        if complement:
            seg = lut[seg]
        seg = jnp.where(jpos < ln, seg, jnp.uint8(0))
        return jax.lax.dynamic_update_slice(buf, seg, (ba,)), None

    buf0 = jnp.zeros(off + cap, dtype=jnp.uint8)
    buf, _ = jax.lax.scan(body, buf0, (starts, lengths, bases))
    return buf[:off]


class BigWindowEngine(DeviceEngine):
    """Windowed (``--trim``) device engine for genomes whose DOUBLED
    text exceeds int32 addressing (> ~1 Gbp genomes with -R/-C/-RC —
    e.g. the whole human genome), where the resident
    :class:`DeviceWindowEngine` cannot hold doubled-text codes on
    device.

    Differences from the resident engine, all coordinate-local so every
    device array stays int32-indexable:

      * the window index's suffix order stays WINDOW-RELATIVE (rebased
        to global on the host, int64, after event download —
        ``_m_offset``); window codes derive ON DEVICE from the one
        packed, fingerprint-cached strand-codes upload
        (``_device_needle_enabled`` — while the strand is int32-
        addressable; host-sliced 1 B/bp uploads otherwise);
      * each batch's needle codes likewise derive on device
        (``_needle_batch_device``: complement = code-space LUT, reverse
        = flipped slice — exact vs ``transform_needle``), so a sharded
        big-genome run's wire cost is ~n1/4 packed bytes ONCE instead
        of ~2x the genome in 1 B/bp uploads (per window + per batch);
      * the exact filters run with host-clamped rebased constants
        (see `_core_from_ranges`): clamping into
        ``[-(chunk_len+2), W+2]`` ranges preserves every comparison
        outcome while keeping device arithmetic int32-safe, given
        ``W <= 2^30`` (pick enough shards) and ``chunk_len < 2^30``
        (every N-free run in real genomes is far below 1 Gbp).

    Output is exactly the host trim engine's (reference semantics,
    asgart.rs:142-148): pinned by tests/test_device_window.py's forced
    big-mode equality tests at small scale.
    """

    def __init__(self, strand, settings, trim, profile: dict | None = None,
                 codes_device=None):
        from .index import CODE
        from .device_index import (DEVICE_MAX_K, window_arrays_from_codes)

        check = settings.probe_size
        if check > DEVICE_MAX_K:
            raise ValueError(
                f"device index supports probe_size <= {DEVICE_MAX_K} "
                "(two int32 key planes); use the host engine")
        self.strand = strand
        self.settings = settings
        self.trim = (int(trim[0]), int(trim[1]))
        ws, we = self.trim
        n1 = int(len(strand.data))
        if not (0 <= ws < we <= n1 - 1):
            raise ValueError(f"bad trim window {self.trim}")
        w_text = we - ws
        W = w_text + 1
        if W > (1 << 30):
            raise ValueError(
                "trim window exceeds 2^30 positions; use more shards")
        t0 = time.time()
        k = settings.probe_size
        self._codes1 = None
        if _device_needle_enabled(n1):
            # ONE (packed, fingerprint-cached) codes upload serves every
            # window's build AND every needle batch of a sharded run —
            # instead of ~2x the genome in 1 B/bp transfers (per window
            # + per batch)
            from .device_index import (_window_codes,
                                       upload_codes_cached)

            self._codes1 = upload_codes_cached(strand.data)
            win_codes = _window_codes(self._codes1, jnp.int32(ws),
                                      w_text, k)
        else:
            win_np = np.zeros(W + k, dtype=np.uint8)
            win_np[:w_text] = CODE[strand.data[ws:we]]
            win_codes = jax.device_put(win_np)
        self.key_hi, self.key_lo, _run_lo, self.sa = \
            window_arrays_from_codes(win_codes, k, W)
        del _run_lo  # the merge join derives lo from the co-sorted runs
        self.W = W
        self.first_len = n1
        self._m_offset = ws
        self.mesh = None
        self._stage1: dict = {}
        if profile is not None:
            profile["device_index_s"] = round(time.time() - t0, 3)

    def _cap_key(self, chunk):
        s = self.settings
        return ("big", self.first_len, self.trim, s.probe_size,
                s.reverse, s.complement, s.max_cardinality, chunk)

    def _needle_codes_host(self, chunk):
        """Transformed needle symbol codes for one chunk (host)."""
        from .index import CODE
        from .pipeline import transform_needle

        start, length = chunk
        if length >= (1 << 30):
            raise ValueError(
                "chunk exceeds 2^30 positions (unbroken N-free run "
                "> 1 Gbp); big-window filters require chunk_len "
                "< 2^30")
        s = self.settings
        return CODE[transform_needle(
            self.strand.data[start:start + length],
            s.reverse, s.complement)]

    def _stage1_for(self, chunk):
        st1 = self._stage1.get(chunk)
        if st1 is None:
            geo = self._chunk_geometry(chunk)
            if geo is None:
                return None
            b_pad, _, _ = geo
            goff = getattr(self, "_g_off", {}).get(chunk)
            if goff is not None:
                lo, hi, mask = self._g_full
                st1 = _slice_lanes(lo, hi, mask, goff[0], b_pad) \
                    + (goff[1],)
            else:
                s = self.settings
                length = chunk[1]
                k = s.probe_size
                step = k // 2
                C3 = b_pad + 7
                off = C3 * step
                if self._codes1 is not None:
                    # singleton chunk: same device derivation as the
                    # batch path (one-entry batch), zero needle wire
                    from .device_index import decimate_codes_auto

                    cap = (length + 7) & ~7
                    buf = _needle_batch_device(
                        self._codes1,
                        jnp.asarray(np.array([chunk[0]], np.int32)),
                        jnp.asarray(np.array([length], np.int32)),
                        jnp.asarray(np.array([0], np.int32)),
                        off, cap, s.reverse, s.complement)
                    needle_codes = decimate_codes_auto(buf, step,
                                                       off, off)
                else:
                    # host-side decimation (merge join reads decimated
                    # rows)
                    codes_host = np.zeros(off, dtype=np.uint8)
                    codes_host[:length] = self._needle_codes_host(chunk)
                    needle_codes = jax.device_put(
                        np.ascontiguousarray(
                            codes_host.reshape(C3, step).T).reshape(-1))
                st1 = _needle_ranges(
                    self.key_hi, self.key_lo, needle_codes,
                    jnp.int32(length), jnp.int32(0),
                    k=k, b_pad=b_pad)
            self._stage1[chunk] = st1
        return st1

    def _batch_stage1(self, chunks):
        """ONE concatenated needle-codes upload + ONE merge-join co-sort
        for a batch of chunks: the per-chunk path re-sorts the window's
        W keys per chunk (the dominant stage-1 cost at W up to 2^30) and
        pays a host->device upload round trip per chunk."""
        s = self.settings
        k = s.probe_size
        step = k // 2
        geo_of = {}
        for c in chunks:
            if c in self._stage1:
                continue
            geo = self._chunk_geometry(c)
            if geo is not None:
                geo_of[c] = geo
        if len(geo_of) < 2:
            return
        # back-to-back chunk regions in ONE plain codes buffer, each
        # padded to a step multiple with probe-window slack
        bases, specs = {}, []
        off = 0
        for c, geo in geo_of.items():
            b_pad = geo[0]
            nc = (c[1] - k - step + step - 1) // step
            bases[c] = off
            specs.append((int(c[0]), int(c[1]), nc))
            off += (b_pad + 4) * step
        codes_dec = self._needle_batch_codes(geo_of, bases, off, step)
        x0s = tuple(bases[c] + step for c in geo_of)
        total = sum(sp[2] for sp in specs) \
            + max(g[0] for g in geo_of.values()) + 8
        lo, hi, mask, totals = _window_ranges_batch(
            self.key_hi, self.key_lo, codes_dec,
            jnp.zeros(len(specs), I32),
            k, s.reverse, s.complement, int(self.first_len),
            tuple(specs), total, x0s=x0s)
        tot_host = np.asarray(totals)
        self._g_full = (lo, hi, mask)
        self._g_off = {}
        lane_off = 0
        for i, c in enumerate(geo_of):
            self._g_off[c] = (lane_off, float(tot_host[i]))
            lane_off += specs[i][2]

    def _needle_batch_codes(self, geo_of, bases, off: int, step: int):
        """Device handle of one batch's concatenated, decimated needle
        codes. The batch's content is WINDOW-INDEPENDENT (the needles
        are the transformed genome chunks), so a sharded big-genome run
        caches the uploaded buffers across its windows — per-window
        re-uploads of the whole genome's codes are the dominant wire
        cost at whole-human scale (S windows x n bytes)."""
        from .device_index import (_DEC_CODES_CACHE,  # noqa: F401
                                   _strand_fingerprint,
                                   device_index_cache_enabled)

        s = self.settings
        key = None
        if device_index_cache_enabled():
            key = ("needle", _strand_fingerprint(self.strand.data),
                   s.probe_size, s.reverse, s.complement,
                   tuple(sorted(geo_of)))
            hit = _NEEDLE_CODES_CACHE.get(key)
            if hit is not None:
                return hit
        if self._codes1 is not None:
            # derive the batch ON DEVICE from the resident strand codes
            # (zero needle wire); the decimation is bit-equal to the
            # host reshape(...).T layout (pinned)
            from .device_index import decimate_codes_auto

            cs = list(geo_of)
            starts = jnp.asarray(
                np.fromiter((c[0] for c in cs), np.int32, len(cs)))
            lengths = jnp.asarray(
                np.fromiter((c[1] for c in cs), np.int32, len(cs)))
            bvec = jnp.asarray(
                np.fromiter((bases[c] for c in cs), np.int32, len(cs)))
            cap = (max(c[1] for c in cs) + 7) & ~7
            buf = _needle_batch_device(
                self._codes1, starts, lengths, bvec, off, cap,
                s.reverse, s.complement)
            codes_dec = decimate_codes_auto(buf, step, off, off)
        else:
            codes_host = np.zeros(off, dtype=np.uint8)
            for c in geo_of:
                codes_host[bases[c]: bases[c] + c[1]] = \
                    self._needle_codes_host(c)
            # host-side decimation of the whole buffer as one matrix
            codes_dec = jax.device_put(np.ascontiguousarray(
                codes_host.reshape(off // step, step).T).reshape(-1))
        if key is not None:
            # bound the cache by bytes, not entries: batches of one run
            # are distinct keys and must all stay resident
            total = sum(v.nbytes for v in _NEEDLE_CODES_CACHE.values())
            if total + codes_dec.nbytes > _NEEDLE_CACHE_BYTES:
                _NEEDLE_CODES_CACHE.clear()
            _NEEDLE_CODES_CACHE[key] = codes_dec
        return codes_dec

    def _rebased(self, chunk):
        """Host-clamped rebased filter constants (outcome-preserving —
        see `_core_from_ranges`)."""
        start, length = chunk
        ws = self.trim[0]
        W = self.W
        lo_c, hi_c = -(length + 2), W + 2
        return (int(np.clip(-ws, lo_c, hi_c)),
                int(np.clip(start - ws, lo_c, hi_c)),
                int(np.clip(start + length - ws, -2, W + length + 2)))

    def _dispatch_group(self, group, b_pad, cap, ev_cap):
        """Grouped `_scan_core_based_group` dispatch with per-chunk
        rebased filter constants in the params rows."""
        s = self.settings
        lo, hi, mask = self._g_full
        gs = _pad_group(len(group))
        params = np.zeros((gs, 5), dtype=np.int32)
        for i, c in enumerate(group):
            params[i] = (self._g_off[c][0], c[1]) + self._rebased(c)
        t0 = time.time()
        ev, m, sc = _scan_core_based_group(
            lo, hi, mask, self.sa, jnp.asarray(params),
            jnp.int32(self.W + 1), jnp.int32(s.max_cardinality),
            k=s.probe_size, reverse=s.reverse, b_pad=b_pad,
            cap=cap, ev_cap=ev_cap)
        self._lap(t0, f"group dispatch ({len(group)}/{gs}, cap={cap})")
        return {"chunks": list(group), "ev": ev, "m": m, "sc": sc,
                "cap": cap, "ev_cap": ev_cap}

    def _prepass_total(self, chunk):
        st1 = self._stage1_for(chunk)
        return None if st1 is None else st1[3]

    def _dispatch_chunk(self, chunk, cap=None, ev_cap=None, total=None):
        geo = self._chunk_geometry(chunk)
        if geo is None:
            return None
        b_pad, b_local, _ = geo
        s = self.settings
        st1 = self._stage1_for(chunk)
        lo, hi, mask, tot = st1
        start, length = chunk
        t0 = time.time()
        if cap is None:
            cached = _CAP_CACHE.get(self._cap_key(chunk))
            if cached == "sliced":
                return self._dispatch_chunk_sliced(chunk)
            if cached is not None:
                cap, ev_cap = cached
            else:
                total_raw = int(_local_np(
                    tot if total is None else total))
                t0 = self._lap(t0, f"ranges+total ({total_raw})")
                cap = _cap_bucket(total_raw + 1)
        if cap > _slice_budget():
            return self._dispatch_chunk_sliced(chunk)
        if ev_cap is None:
            ev_cap = _bucket(min(cap, b_local)) // 4
        base_self, base_dir, rev_t0 = self._rebased(chunk)
        W = self.W
        ev_pack, m_flat, scalars = _scan_core_based(
            lo, hi, mask, self.sa, jnp.int32(length),
            jnp.int32(base_self), jnp.int32(base_dir), jnp.int32(rev_t0),
            jnp.int32(W + 1), jnp.int32(s.max_cardinality),
            jnp.int32(0), k=s.probe_size, reverse=s.reverse,
            b_pad=b_pad, cap=cap, ev_cap=ev_cap)
        self._lap(t0, f"big window scan dispatch (cap={cap})")
        return {"chunk": chunk, "cap": cap, "ev_cap": ev_cap,
                "shards": [(ev_pack, m_flat, scalars)]}

    def _slice_core(self, st1s, chunk, j0, b, cap, ev_cap):
        s = self.settings
        lo_s, hi_s, mask_s = st1s
        base_self, base_dir, rev_t0 = self._rebased(chunk)
        return _scan_core_based(
            lo_s, hi_s, mask_s, self.sa, jnp.int32(chunk[1]),
            jnp.int32(base_self), jnp.int32(base_dir),
            jnp.int32(rev_t0), jnp.int32(self.W + 1),
            jnp.int32(s.max_cardinality), j0,
            k=s.probe_size, reverse=s.reverse,
            b_pad=b, cap=cap, ev_cap=ev_cap)

    def _dispatch_chunk_sliced(self, chunk, ev_scale: int = 1):
        return self._sliced_windows(chunk, ev_scale)

    def run_chunk(self, chunk):
        out = self._collect_chunk(self._dispatch_chunk(chunk))
        self._stage1.pop(chunk, None)
        return out

    def dispatch_chunks(self, chunks):
        """No dispatch/collect split: the batch loop interleaves
        uploads, dispatches and downloads under an HBM budget, so the
        whole run happens eagerly here (window pipelining degenerates
        to the serial order for big windows)."""
        return ("eager", self.run_chunks(chunks))

    def collect_chunks(self, state, chunks):
        return state[1]

    def run_chunks(self, chunks):
        """Chunks run in budget-bounded BATCHES (one concatenated
        needle upload + one co-sort + grouped cores per batch); the
        concatenated codes buffer is the extra HBM cost, so batches cap
        at ~budget/16 bytes of needle codes."""
        s = self.settings
        k = s.probe_size
        step = k // 2
        from .device_index import hbm_budget_bytes

        budget = int(os.environ.get("ASGART_BIG_BATCH_BYTES", 0)) \
            or max(hbm_budget_bytes() // 16, 1 << 28)
        results: dict = {}
        batch: list = []
        acc = 0
        for c in chunks:
            geo = self._chunk_geometry(c)
            if geo is None:
                continue
            reg = (geo[0] + 4) * step
            if batch and acc + reg > budget:
                self._run_batch(batch, results)
                batch, acc = [], 0
            batch.append(c)
            acc += reg
        if batch:
            self._run_batch(batch, results)
        return [results.get(c, []) for c in chunks]

    def _run_batch(self, chunks, results):
        """One batched stage 1 + grouped cores for a chunk batch
        (singletons fall through to the per-chunk path)."""
        self._g_off = {}
        self._g_full = None
        self._batch_stage1(chunks)
        in_batch = [c for c in chunks if c in self._g_off]
        rest = [c for c in chunks if c not in self._g_off]
        totals = {c: off[1] for c, off in self._g_off.items()}
        groups, singles = self._plan_groups(in_batch, totals,
                                            slack=False)
        gstates = [self._dispatch_group(part, b_pad, cap, ev_cap)
                   for part, b_pad, cap, ev_cap in groups]
        sstates = {c: self._dispatch_chunk(c, cap=cap, ev_cap=ev_cap)
                   for c, cap, ev_cap in singles}
        for c in rest:
            sstates[c] = self._dispatch_chunk(c)
        for gst in gstates:
            results.update(self._collect_group(gst))
        for c, st in sstates.items():
            results[c] = self._collect_chunk(st)
        self._stage1.clear()
        self._g_off = {}
        self._g_full = None


def _mesh_window_ranges(mesh, k: int, reverse: bool, complement: bool,
                        b_local: int):
    """Stage-1 SPMD over the 2-D (windows x probes) mesh: every cell
    computes merge-join equal ranges of its probe slice against its
    window's keys. Window arrays arrive sharded over the "windows" axis
    (each device holds 1/S of the whole-genome index — the mesh-sharded
    index layout); genome codes are replicated."""
    from jax.sharding import PartitionSpec as P

    def stepf(key_hi, key_lo, codes, chunk_start, chunk_len,
              first_len):
        p = jax.lax.axis_index("probes").astype(I32)
        j0 = p * b_local
        lo, hi, mask, total = _window_ranges(
            key_hi[0], key_lo[0], codes,
            chunk_start, chunk_len, first_len, j0,
            k=k, reverse=reverse, complement=complement, b_pad=b_local)
        return (lo[None, None], hi[None, None], mask[None, None],
                total[None, None])

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P("windows"), P("windows"),
                  P(), P(), P(), P()),
        out_specs=(P("windows", "probes"),) * 4,
        check_vma=False)
    return jax.jit(mapped)


def _mesh_ranges_batch(mesh, k: int, reverse: bool, complement: bool,
                       first_len: int, specs: tuple, total: int,
                       b_locals: tuple):
    """Batched stage-1 SPMD over the (windows x probes) mesh: ONE
    dispatch computes every chunk's merge-join ranges on every cell —
    re-sorting each window's W keys per chunk made mesh stage 1 scale
    with the chunk count, exactly the single-device disease fixed by
    `_window_ranges_batch`. Cell (w, p) joins its probe slices (lane
    origin ``p * b_local`` per chunk) against window w's keys."""
    from jax.sharding import PartitionSpec as P

    bl = np.array(b_locals, dtype=np.int32)

    def stepf(key_hi, key_lo, codes):
        p = jax.lax.axis_index("probes").astype(I32)
        j0s = p * jnp.asarray(bl)
        lo, hi, mask, totals = _window_ranges_batch(
            key_hi[0], key_lo[0], codes, j0s,
            k, reverse, complement, first_len, specs, total)
        return (lo[None, None], hi[None, None], mask[None, None],
                totals[None, None])

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P("windows"), P("windows"), P()),
        out_specs=(P("windows", "probes"),) * 4,
        check_vma=False)
    return jax.jit(mapped)


def _mesh_window_core_off(mesh, k: int, reverse: bool, b_local: int,
                          cap: int, ev_cap: int):
    """Stage-2 SPMD consuming the batched stage-1 arrays: each cell
    slices its chunk's lanes at the (cell-local) offset — no per-chunk
    stage-1 dispatches, no slice dispatches."""
    from jax.sharding import PartitionSpec as P

    def stepf(lo_all, hi_all, mask_all, sa, off, chunk_start, chunk_len,
              max_cardinality):
        p = jax.lax.axis_index("probes").astype(I32)
        j0 = p * b_local
        lo = jax.lax.dynamic_slice(lo_all[0, 0], (off,), (b_local,))
        hi = jax.lax.dynamic_slice(hi_all[0, 0], (off,), (b_local,))
        mask = jax.lax.dynamic_slice(mask_all[0, 0], (off,), (b_local,))
        ev_pack, m_flat, scalars = _scan_core(
            lo, hi, mask, sa[0], chunk_start, chunk_len,
            jnp.int32((1 << 31) - 1), max_cardinality, j0,
            k=k, reverse=reverse, b_pad=b_local, cap=cap, ev_cap=ev_cap)
        return ev_pack[None, None], m_flat[None, None], scalars[None, None]

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P("windows", "probes"), P("windows", "probes"),
                  P("windows", "probes"), P("windows"), P(), P(), P(),
                  P()),
        out_specs=(P("windows", "probes"),) * 3,
        check_vma=False)
    return jax.jit(mapped)


def _mesh_window_core(mesh, k: int, reverse: bool, b_local: int,
                      cap: int, ev_cap: int):
    """Stage-2 SPMD: the shared scan tail per (window, probe-slice)
    cell, consuming the stage-1 ranges (still device-resident and
    sharded) and each window's suffix order."""
    from jax.sharding import PartitionSpec as P

    def stepf(lo, hi, mask, sa, chunk_start, chunk_len, max_cardinality):
        p = jax.lax.axis_index("probes").astype(I32)
        j0 = p * b_local
        ev_pack, m_flat, scalars = _scan_core(
            lo[0, 0], hi[0, 0], mask[0, 0], sa[0],
            chunk_start, chunk_len, jnp.int32((1 << 31) - 1),
            max_cardinality, j0, k=k, reverse=reverse, b_pad=b_local,
            cap=cap, ev_cap=ev_cap)
        return ev_pack[None, None], m_flat[None, None], scalars[None, None]

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P("windows", "probes"), P("windows", "probes"),
                  P("windows", "probes"), P("windows"), P(), P(), P()),
        out_specs=(P("windows", "probes"),) * 3,
        check_vma=False)
    return jax.jit(mapped)


class MeshWindowEngine:
    """Composed two-axis SPMD engine: the genome index lives SHARDED
    across the mesh — window w's sorted keys + suffix order occupy only
    the devices of mesh row w (no device holds more than 1/S of the
    index) — while each row's devices split the probe stream.

    This subsumes the reference's manual scale-out (`--trim` windows +
    `asgart-slice` merge, asgart.rs:142-148 + structs.rs:114-141) as a
    single-dispatch mesh program: output is byte-equal to the sequential
    trim+merge workflow. Events merge per window with the exact aging
    carry (probe axis), and windows are independent runs (families never
    span windows, per reference trim semantics).
    """

    def __init__(self, strand, settings, windows, mesh,
                 profile: dict | None = None):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .device_index import build_window_arrays, \
            _build_text_codes, decimate_codes_auto

        self.strand = strand
        self.settings = settings
        self.windows = [(int(a), int(b)) for a, b in windows]
        self.mesh = mesh
        S = mesh.shape["windows"]
        if S != len(self.windows):
            raise ValueError("mesh windows axis != window count")
        t0 = time.time()
        k = settings.probe_size
        n1 = int(len(strand.data))
        n = 2 * n1 - 1 if (settings.reverse or settings.complement) else n1
        if n >= (1 << 31):
            raise ValueError("genome too large for int32 probe addressing")
        self.first_len = n1

        from .device_index import upload_codes_cached
        # packed upload (4x less wire than 1 B/bp), fingerprint-cached
        # across runs; lands on the default device — the mesh-sharded
        # device_puts below re-place it
        codes1 = upload_codes_cached(strand.data)
        rep = NamedSharding(mesh, P())
        L2 = table_len_for(n, k)
        self.codes = jax.device_put(
            decimate_codes_auto(
                _build_text_codes(codes1, k, settings.reverse,
                                  settings.complement, L2 - k),
                k // 2, L2, n + k),
            rep)
        # per-window index arrays, padded to a common width with
        # INT32_MAX sentinel keys (sort after every real key and can
        # never equal a probe key: real keys use < 2^30 per plane)
        parts = [build_window_arrays(codes1, k, ws, we)
                 for (ws, we) in self.windows]
        w_max = max(p[4] for p in parts)
        big = jnp.int32(2**31 - 1)

        def padded(i, fill):
            return jnp.stack([
                jnp.concatenate([p[i], jnp.full(w_max - p[4], fill,
                                                jnp.int32)])
                for p in parts])

        sh = NamedSharding(mesh, P("windows"))
        self.key_hi = jax.device_put(padded(0, big), sh)
        self.key_lo = jax.device_put(padded(1, big), sh)
        # run_lo (parts[2]) is build-internal: the merge join derives
        # lo from the co-sorted run structure (_mj_tail)
        self.sa = jax.device_put(padded(3, jnp.int32(0)), sh)
        self.W = [p[4] for p in parts]
        if profile is not None:
            profile["device_index_s"] = round(time.time() - t0, 3)

    def _geometry(self, chunk):
        s = self.settings
        start, length = chunk
        k = s.probe_size
        if length < s.min_duplication_length:
            return None
        step = k // 2
        bound = length - k - step
        if bound <= 0:
            return None
        n_probes = (bound + step - 1) // step
        P_ax = self.mesh.shape["probes"]
        b_pad = _bucket(n_probes)
        if b_pad % P_ax:
            b_pad += P_ax - (b_pad % P_ax)
        return b_pad, b_pad // P_ax, P_ax

    def run_windows(self, chunks):
        """Scan every chunk for every window; returns
        ``raw[w][c]`` = the native-format families of window w on
        chunk c (needle-relative lefts, global rights).

        With >= 2 live chunks, stage 1 runs as ONE batched SPMD
        dispatch (`_mesh_ranges_batch` — per-chunk co-sorts re-sorted
        each window's W keys per chunk, scaling stage 1 with the chunk
        count) and the cores consume the batched arrays at per-chunk
        lane offsets."""
        s = self.settings
        S = self.mesh.shape["windows"]
        out = [[[] for _ in chunks] for _ in range(S)]
        live = [(ci, c, self._geometry(c)) for ci, c in enumerate(chunks)]
        live = [(ci, c, g) for ci, c, g in live if g is not None]
        if len(live) >= 2:
            self._run_batched(live, out)
        else:
            for ci, c, g in live:
                self._run_one(ci, c, g, None, None, out)
        return out

    def _run_batched(self, live, out):
        s = self.settings
        k = s.probe_size
        specs = tuple((int(c[0]), int(c[1]), g[1]) for _, c, g in live)
        b_locals = tuple(g[1] for _, c, g in live)
        total = sum(b_locals) + max(b_locals) + 8
        ranges_fn = _mesh_ranges_batch(
            self.mesh, k, s.reverse, s.complement, int(self.first_len),
            specs, total, b_locals)
        lo, hi, mask, totals = ranges_fn(
            self.key_hi, self.key_lo, self.codes)
        tot = np.asarray(totals)  # [S, P, C] — ONE fetch for all chunks
        states = []
        off = 0
        for i, (ci, chunk, geo) in enumerate(live):
            _, b_local, P_ax = geo
            cap = _cap_bucket(int(tot[:, :, i].max()) + 1)
            ev_cap = _bucket(min(cap, b_local)) // 4
            core_fn = _mesh_window_core_off(
                self.mesh, k, s.reverse, b_local, cap, ev_cap)
            ev, mf, sc = core_fn(
                lo, hi, mask, self.sa, jnp.int32(off),
                jnp.int32(chunk[0]), jnp.int32(chunk[1]),
                jnp.int32(s.max_cardinality))
            states.append((ci, chunk, geo, cap, ev_cap, ev, mf, sc))
            off += b_local
        for (ci, chunk, geo, cap, ev_cap, ev, mf, sc) in states:
            _, b_local, P_ax = geo
            sc_host = np.asarray(sc)
            if sc_host[:, :, 3].any():
                # batched totals are exact, so only ev_cap can
                # overflow; retry this chunk through the per-chunk path
                max_ev = int(sc_host[:, :, 0].max())
                if max_ev > ev_cap:
                    ev_cap = _bucket(max_ev + 1)
                else:
                    cap = _cap_bucket(cap + 1)
                log.debug("mesh batched retry: cap=%d ev_cap=%d",
                          cap, ev_cap)
                self._run_one(ci, chunk, geo, cap, ev_cap, out)
                continue
            self._chain_cells(ci, chunk, P_ax, ev, mf, sc_host, out)

    def _run_one(self, ci, chunk, geo, cap, ev_cap, out):
        """Per-chunk stage 1 + core with overflow retry (singleton and
        batched-overflow fallback path)."""
        s = self.settings
        k = s.probe_size
        _, b_local, P_ax = geo
        ranges_fn = _mesh_window_ranges(
            self.mesh, k, s.reverse, s.complement, b_local)
        lo, hi, mask, totals = ranges_fn(
            self.key_hi, self.key_lo, self.codes,
            jnp.int32(chunk[0]), jnp.int32(chunk[1]),
            jnp.int32(self.first_len))
        if cap is None:
            tot_host = np.asarray(totals)
            cap = _cap_bucket(int(tot_host.max()) + 1)
            ev_cap = _bucket(min(cap, b_local)) // 4
        while True:
            core_fn = _mesh_window_core(
                self.mesh, k, s.reverse, b_local, cap, ev_cap)
            ev, mf, sc = core_fn(
                lo, hi, mask, self.sa, jnp.int32(chunk[0]),
                jnp.int32(chunk[1]), jnp.int32(s.max_cardinality))
            sc_host = np.asarray(sc)  # [S, P, 4]
            if not sc_host[:, :, 3].any():
                break
            max_ev = int(sc_host[:, :, 0].max())
            if max_ev > ev_cap:
                ev_cap = _bucket(max_ev + 1)
            else:
                cap = _cap_bucket(cap + 1)
            log.debug("mesh scan retry: cap=%d ev_cap=%d", cap, ev_cap)
        self._chain_cells(ci, chunk, P_ax, ev, mf, sc_host, out)

    def _chain_cells(self, ci, chunk, P_ax, ev, mf, sc_host, out):
        """Download cells' events, merge the probe axis with the aging
        carry, chain per window."""
        s = self.settings
        k = s.probe_size
        S = self.mesh.shape["windows"]
        for w in range(S):
            parts = []
            for p in range(P_ax):
                n_events, total_kept, z_trail, _ = (
                    int(v) for v in sc_host[w, p])
                parts.append((np.asarray(ev[w, p][:, :n_events]),
                              np.asarray(mf[w, p][:total_kept]),
                              z_trail))
            evm, m_host, z_trail = _merge_shard_events(parts)
            if evm is None:
                continue
            m_offsets = np.zeros(evm.shape[1] + 1, dtype=np.int64)
            np.cumsum(evm[2], out=m_offsets[1:])
            out[w][ci] = native.chain_events(
                evm[0], evm[1], m_offsets, m_host, z_trail=z_trail,
                probe_size=k, step_size=k // 2,
                max_gap_size=s.max_gap_size,
                min_duplication_length=s.min_duplication_length,
                max_cardinality=s.max_cardinality)


# --- rank-sharded single window ------------------------------------------
#
# One trim window LARGER than one HBM: the window's index arrays (sorted
# key planes, run starts, suffix order) live SHARDED across a 1-D mesh
# axis — device d holds rows [d*Wl, (d+1)*Wl) of the sorted order, no
# device more than ceil(W/D). Stage 1 runs the merge join per shard
# (each shard's local [lo, hi) counts are exact for its contiguous
# sorted-key slice; a run crossing a shard boundary restarts at local 0,
# so local run starts clip to 0) and combines with `psum` across the
# mesh.
# Stage 2's flat CSR match gather combines per-shard `sa` contributions
# the same way (every global row is owned by exactly one shard); the
# rest of the scan tail computes replicated. This lifts both the 2^30
# window-row cap and the one-HBM window bound of the BigWindowEngine —
# capacity scales linearly with the mesh (HBM math: docs/sharding.md).


def _sharded_window_ranges_fn(mesh, k: int, b_pad: int,
                              axis: str = "shards"):
    """Stage-1 SPMD: per-shard merge join + psum-combined global
    equal ranges. ``needle_codes`` (decimated, chunk-local) and probe
    geometry are replicated; window arrays arrive stacked [D, Wl] and
    sharded over ``axis``."""
    from jax.sharding import PartitionSpec as P

    step = k // 2

    def stepf(key_hi_sh, key_lo_sh, needle_codes,
              chunk_len, j0):
        jl = jnp.arange(b_pad, dtype=I32)
        lane_ok = ((j0 + jl) * step) < (chunk_len - k - step)
        phi, plo, n_mask = _pack_probe_lanes(
            needle_codes, (j0 + 1) * step, b_pad, k)
        mask = lane_ok & n_mask
        # per-shard local counts are exact for a contiguous sorted-key
        # slice (a run crossing the shard boundary restarts at local
        # count 0 in _mj_tail's formulation); psum composes them
        lo_l, hi_l = _mj_tail(key_hi_sh[0], key_lo_sh[0],
                              phi, plo, mask)
        lo = jax.lax.psum(lo_l, axis)
        hi = jax.lax.psum(hi_l, axis)
        total = jnp.sum((hi - lo).astype(jnp.float32))
        return lo, hi, mask, total

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False)
    return jax.jit(mapped)


def _sharded_window_core_fn(mesh, k: int, reverse: bool, b_pad: int,
                            cap: int, ev_cap: int,
                            axis: str = "shards"):
    """Stage-2 SPMD: the shared scan tail with a psum-combining gather
    over the sharded suffix order; every other intermediate computes
    replicated, so the outputs are replicated (one download)."""
    from jax.sharding import PartitionSpec as P

    step = k // 2

    def stepf(sa_sh, lo, hi, mask, chunk_len, self_base, dir_base,
              rev_t0, max_match_pos, max_cardinality, j0):
        d = jax.lax.axis_index(axis).astype(I32)
        Wl = sa_sh.shape[-1]

        def sa_gather(idx):
            local = idx - d * Wl
            own = (local >= 0) & (local < Wl)
            v = sa_sh[0][jnp.clip(local, 0, Wl - 1)]
            return jax.lax.psum(jnp.where(own, v + 1, 0), axis) - 1

        jl = jnp.arange(b_pad, dtype=I32)
        m = mask & (((j0 + jl) * step) < (chunk_len - k - step))
        return _core_from_ranges(
            jnp.where(m, lo, 0), jnp.where(m, hi, 0), m, None,
            self_base, dir_base, rev_t0, max_match_pos,
            max_cardinality, j0, k=k, reverse=reverse, b_pad=b_pad,
            cap=cap, ev_cap=ev_cap, sa_gather=sa_gather)

    mapped = jax.shard_map(
        stepf, mesh=mesh,
        in_specs=(P(axis),) + (P(),) * 10,
        out_specs=(P(), P(), P()),
        check_vma=False)
    return jax.jit(mapped)


def host_window_arrays(strand_data: np.ndarray, k: int, ws: int,
                       we: int, n_threads: int = 0):
    """(key_hi, key_lo, run_lo, sa_rel, W) for one trim window, built on
    the HOST — the build path for windows larger than one HBM (the
    device build's sorts need the whole window in one memory; the host
    has RAM). Bit-equal to `device_index.window_arrays_from_codes` (the
    sorted-key order of equal k-mers IS the suffix order, which both
    builders produce exactly; pinned by tests/test_rank_sharded.py)."""
    from .index import CODE
    from .native import suffix_array

    w_text = we - ws
    W = w_text + 1
    sub = np.empty(W, dtype=np.uint8)
    sub[:w_text] = strand_data[ws:we]
    sub[w_text] = ord("$")
    sa = suffix_array(sub).astype(np.int32)
    codes = np.zeros(W + k, dtype=np.uint8)
    codes[:W] = CODE[sub]
    codes[W - 1] = 0  # '$' rank
    from .device_index import LO_SYMS

    n_hi = max(k - LO_SYMS, 0)
    key_hi = np.zeros(W, dtype=np.int64)
    key_lo = np.zeros(W, dtype=np.int64)
    for j in range(n_hi):
        key_hi = (key_hi << 3) | codes[sa + j]
    for j in range(n_hi, k):
        key_lo = (key_lo << 3) | codes[sa + j]
    key_hi = key_hi.astype(np.int32)
    key_lo = key_lo.astype(np.int32)
    iota = np.arange(W, dtype=np.int32)
    neq = np.empty(W, dtype=bool)
    neq[0] = True
    neq[1:] = (key_hi[1:] != key_hi[:-1]) | (key_lo[1:] != key_lo[:-1])
    run_lo = np.maximum.accumulate(np.where(neq, iota, 0))
    return key_hi, key_lo, run_lo, sa, W


class ShardedWindowEngine(BigWindowEngine):
    """Rank-sharded single-window device engine: the window index lives
    sharded across a 1-D mesh — serving capacity (and the window-row
    cap) scale linearly with the device count. Semantics are exactly
    the BigWindowEngine's (window-relative suffix order, host-clamped
    rebased filters, per-chunk needle uploads); only the index residency
    and the two SPMD stages differ. Reference analog surpassed: the
    ``--trim`` memory bound (asgart.rs:142-148) — one window is no
    longer limited to one device's memory."""

    def __init__(self, strand, settings, trim, mesh=None,
                 profile: dict | None = None, host_build: bool | None = None):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from .device_index import (DEVICE_MAX_K, device_window_fits,
                                   hbm_budget_bytes)

        if settings.probe_size > DEVICE_MAX_K:
            raise ValueError(
                f"device index supports probe_size <= {DEVICE_MAX_K}")
        self.strand = strand
        self.settings = settings
        self.trim = (int(trim[0]), int(trim[1]))
        ws, we = self.trim
        n1 = int(len(strand.data))
        if not (0 <= ws < we <= n1 - 1):
            raise ValueError(f"bad trim window {self.trim}")
        if mesh is None:
            devs = jax.devices()
            mesh = Mesh(np.array(devs), ("shards",))
        self.mesh = None  # base-class dispatch paths are overridden
        self.smesh = mesh
        D = mesh.devices.size
        k = settings.probe_size
        W = we - ws + 1
        t0 = time.time()
        if host_build is None:
            env = os.environ.get("ASGART_RSH_HOST_BUILD")
            if env is not None:
                host_build = env == "1"
            else:
                # the device build sorts the whole window on one device;
                # use it while it fits, else build on the host
                # (RAM-bounded)
                host_build = not device_window_fits(n1, W, False, k=k)
        if host_build:
            key_hi, key_lo, run_lo, sa, W = host_window_arrays(
                strand.data, k, ws, we)
            to_dev = lambda x: x  # numpy slices upload per shard below
        else:
            from .device_index import (build_window_arrays,
                                       upload_codes_cached)

            codes1 = upload_codes_cached(strand.data)
            key_hi, key_lo, run_lo, sa_g, W = build_window_arrays(
                codes1, k, ws, we)
            sa = sa_g - jnp.int32(ws)  # window-relative, like host build
            to_dev = np.asarray  # single-device arrays -> host -> shards
        # shard stacks [D, Wl] with sentinel padding: INT32_MAX keys
        # sort after every real key and can never equal a probe key
        # (probe planes use < 2^30); padded run_lo/sa rows are never
        # addressed by real ranges
        Wl = -(-W // D)
        big = np.int32(2**31 - 1)

        def stack(arr, fill):
            a = to_dev(arr)
            out = np.full((D, Wl), fill, dtype=np.int32)
            out.reshape(-1)[:W] = np.asarray(a)[:W]
            return out

        sh = NamedSharding(mesh, P("shards"))
        self.key_hi = _global_put(stack(key_hi, big), sh)
        self.key_lo = _global_put(stack(key_lo, big), sh)
        # run_lo is build-internal (doubling rank seed): the merge join
        # derives lo from the co-sorted run structure (_mj_tail), so it
        # never ships to the shards — 12 B/row per shard, not 16
        del run_lo
        self.sa = _global_put(stack(sa, 0), sh)
        self.W = W
        self.Wl = Wl
        self.first_len = n1
        self._m_offset = ws
        self._stage1: dict = {}
        if profile is not None:
            profile["device_index_s"] = round(time.time() - t0, 3)

    def _cap_key(self, chunk):
        s = self.settings
        return ("rsh", self.first_len, self.trim, s.probe_size,
                s.reverse, s.complement, s.max_cardinality, chunk)

    def _batch_stage1(self, chunks):
        return  # v1: per-chunk stage 1 (chunks are huge at this scale)

    def _stage1_for(self, chunk):
        st1 = self._stage1.get(chunk)
        if st1 is None:
            geo = self._chunk_geometry(chunk)
            if geo is None:
                return None
            b_pad, _, _ = geo
            s = self.settings
            k = s.probe_size
            step = k // 2
            length = chunk[1]
            C3 = b_pad + 7
            codes_host = np.zeros(C3 * step, dtype=np.uint8)
            codes_host[:length] = self._needle_codes_host(chunk)
            needle_np = np.ascontiguousarray(
                codes_host.reshape(C3, step).T).reshape(-1)
            needle_codes = (jax.device_put(needle_np)
                            if jax.process_count() == 1 else needle_np)
            fn = _sharded_window_ranges_fn(self.smesh, k, b_pad)
            st1 = fn(self.key_hi, self.key_lo,
                     needle_codes, jnp.int32(length), jnp.int32(0))
            self._stage1[chunk] = st1
        return st1

    def _dispatch_chunk(self, chunk, cap=None, ev_cap=None, total=None):
        geo = self._chunk_geometry(chunk)
        if geo is None:
            return None
        b_pad, b_local, _ = geo
        s = self.settings
        st1 = self._stage1_for(chunk)
        lo, hi, mask, tot = st1
        t0 = time.time()
        if cap is None:
            cached = _CAP_CACHE.get(self._cap_key(chunk))
            if cached == "sliced":
                return self._dispatch_chunk_sliced(chunk)
            if cached is not None:
                cap, ev_cap = cached
            else:
                total_raw = int(_local_np(
                    tot if total is None else total))
                t0 = self._lap(t0, f"ranges+total ({total_raw})")
                cap = _cap_bucket(total_raw + 1)
        if cap > _slice_budget():
            return self._dispatch_chunk_sliced(chunk)
        if ev_cap is None:
            ev_cap = _bucket(min(cap, b_local)) // 4
        base_self, base_dir, rev_t0 = self._rebased(chunk)
        core = _sharded_window_core_fn(self.smesh, s.probe_size,
                                       s.reverse, b_pad, cap, ev_cap)
        ev_pack, m_flat, scalars = core(
            self.sa, lo, hi, mask, jnp.int32(chunk[1]),
            jnp.int32(base_self), jnp.int32(base_dir),
            jnp.int32(rev_t0), jnp.int32(self.W + 1),
            jnp.int32(s.max_cardinality), jnp.int32(0))
        self._lap(t0, f"rank-sharded scan dispatch (cap={cap})")
        return {"chunk": chunk, "cap": cap, "ev_cap": ev_cap,
                "shards": [(ev_pack, m_flat, scalars)]}

    def _slice_core(self, st1s, chunk, j0, b, cap, ev_cap):
        s = self.settings
        lo_s, hi_s, mask_s = st1s
        base_self, base_dir, rev_t0 = self._rebased(chunk)
        core = _sharded_window_core_fn(self.smesh, s.probe_size,
                                       s.reverse, b, cap, ev_cap)
        return core(self.sa, lo_s, hi_s, mask_s, jnp.int32(chunk[1]),
                    jnp.int32(base_self), jnp.int32(base_dir),
                    jnp.int32(rev_t0), jnp.int32(self.W + 1),
                    jnp.int32(s.max_cardinality), j0)
