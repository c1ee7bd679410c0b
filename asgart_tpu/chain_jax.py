"""On-device chaining: the arm automaton as a ``lax.scan``.

The reference automaton (``src/automaton.rs:57-204``) is sequential over
probes, but each probe step is internally data-parallel: every match is
classified against the *same* pre-step arm snapshot (the reference uses
``par_iter`` for exactly this reason, automaton.rs:122-134). The device
formulation keeps the sequential probe scan (``lax.scan``) and vectorizes
the per-step work:

  * classification is an [M, A] matrix of match×arm admissibility with a
    first-true argmin along arms (greedy first-arm assignment),
  * extensions reduce per arm with a last-match-wins max (the reference
    applies them in match order),
  * new arms are compacted into free slots with a prefix-sum scatter,
  * family emission on simultaneous death writes through a fixed-capacity
    output buffer.

Shapes are static: A arms, M matches per probe, OUT emitted duplicons.
The reference's dynamic arm vector is bounded in practice by its 200-arm
prune; A=256 reproduces it except in adversarial inputs (the native host
engine stays the byte-exact reference path).

STATUS (frozen experiment): this engine is correct (pairwise fuzz +
overflow pins vs the three host engines) but NOT on the default path:
production chains
from device-COMPACTED events (a few MB per chunk), so host chaining is
microseconds-per-family and overlaps the next window's device phase in
the sharded pipeline — while the lax.scan chain pays a sequential
O(probes) device scan that cannot use the matrix units and caps live arms at
A=256 (semantically weaker under adversarial arm pressure). Promoting
it would trade an exact, overlap-hidden host stage for a slower,
capacity-capped device one. Kept as an engine for mesh experiments
(`ASGART_DEVICE_CHAIN=1`) and as executable documentation of the
automaton's data-parallel structure.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32


class ChainConfig(NamedTuple):
    probe_size: int
    step_size: int
    max_gap_size: int
    min_duplication_length: int
    max_cardinality: int
    max_arms: int = 256
    max_matches: int = 512
    out_cap: int = 4096


def prepare_probe_stream_host(
    sa: np.ndarray, probe_is: np.ndarray, lo: np.ndarray, hi: np.ndarray,
    *, needle_offset: int, needle_len: int, reverse: bool,
    max_cardinality: int, max_matches: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact host preparation of the padded per-probe match stream.

    Returns (probe_is, matches [P, M] int32 padded with -1, valid [P]).
    Probes whose filtered match count exceeds ``max_cardinality`` are
    marked invalid (the automaton skips them entirely — no gap aging).
    """
    P = len(probe_is)
    M = max_matches
    matches = np.full((P, M), -1, dtype=np.int32)
    valid = np.ones(P, dtype=bool)
    for p in range(P):
        i = int(probe_is[p])
        ms = []
        for r in range(int(lo[p]), int(hi[p])):
            m_start = int(sa[r])
            if m_start == i:
                continue
            if not reverse:
                if not (m_start > i + needle_offset):
                    continue
            else:
                if not (m_start >= needle_offset + needle_len - i):
                    continue
            ms.append(m_start)
        if len(ms) > max_cardinality:
            valid[p] = False
            continue
        if len(ms) > M:
            raise ValueError(
                f"probe match count {len(ms)} exceeds max_matches={M}; "
                "ChainConfig.max_matches must be >= max_cardinality")
        matches[p, :len(ms)] = ms
    return probe_is.astype(np.int32), matches, valid


def _d_ss(a_start, a_end, m_start, m_end):
    """Segment distance (automaton.rs:207-216), vectorized."""
    inside = ((m_start >= a_start) & (m_start <= a_end)) | \
             ((m_end >= a_start) & (m_end <= a_end))
    d = jnp.minimum(jnp.abs(a_start - m_end), jnp.abs(a_end - m_start))
    return jnp.where(inside, 0, d)


class ChainState(NamedTuple):
    l_start: jax.Array
    l_end: jax.Array
    r_start: jax.Array
    r_end: jax.Array
    gap: jax.Array
    active: jax.Array
    used: jax.Array
    out: jax.Array
    n_out: jax.Array
    n_fam: jax.Array
    n_dropped: jax.Array


def _consts(cfg: ChainConfig):
    return (cfg.max_arms, cfg.max_matches, cfg.out_cap,
            I32(cfg.probe_size), I32(cfg.step_size),
            I32(cfg.max_gap_size), I32(cfg.min_duplication_length))


def _empty_state(cfg: ChainConfig) -> ChainState:
    A, _, OUT = cfg.max_arms, cfg.max_matches, cfg.out_cap
    z = jnp.zeros(A, dtype=I32)
    return ChainState(z, z, z, z, z, jnp.zeros(A, bool),
                      jnp.zeros(A, bool), jnp.zeros((OUT, 5), dtype=I32),
                      I32(0), I32(0), I32(0))


def _age_prune_emit(consts, st: ChainState, l_start, l_end, r_start,
                    r_end, gap, active, used, dirty,
                    n_dropped) -> ChainState:
    """The per-step tail shared by matched and quiet steps: age non-dirty
    arms, prune above 200, emit on simultaneous death
    (automaton.rs:166-200)."""
    A, M, OUT, ps, step, max_gap, min_dup = consts

    age = used & ~dirty
    gap = jnp.where(age, gap + step, gap)
    active = active & ~(age & (gap >= max_gap))

    n_live = jnp.sum(used).astype(I32)
    keep_if_pruning = used & (
        active |
        ((l_end - l_start) >= min_dup) | ((r_end - r_start) >= min_dup))
    do_prune = n_live > 200
    keep = jnp.where(do_prune, keep_if_pruning, used)
    dest = jnp.cumsum(keep.astype(I32)) - 1
    dest = jnp.where(keep, dest, A)

    def compact(x, fill):
        return jnp.full(A, fill, x.dtype).at[dest].set(x, mode="drop")

    l_start = compact(l_start, 0)
    l_end = compact(l_end, 0)
    r_start = compact(r_start, 0)
    r_end = compact(r_end, 0)
    gap = compact(gap, 0)
    active = compact(active, False)
    used = compact(used, False)

    any_used = jnp.any(used)
    all_dead = any_used & ~jnp.any(active & used)
    emit = used & ((r_end - r_start) >= min_dup) & all_dead
    any_emit = jnp.any(emit)
    rank = jnp.cumsum(emit.astype(I32)) - 1
    pos = jnp.where(emit, st.n_out + rank, OUT)
    out = st.out
    out = out.at[pos, 0].set(l_start, mode="drop")
    out = out.at[pos, 1].set(r_start, mode="drop")
    out = out.at[pos, 2].set(l_end - l_start, mode="drop")
    out = out.at[pos, 3].set(r_end - r_start, mode="drop")
    out = out.at[pos, 4].set(st.n_fam, mode="drop")
    n_out = st.n_out + jnp.sum(emit).astype(I32)
    n_fam = st.n_fam + any_emit.astype(I32)
    cleared = jnp.zeros(A, bool)
    used = jnp.where(all_dead, cleared, used)
    active = jnp.where(all_dead, cleared, active)
    return ChainState(l_start, l_end, r_start, r_end, gap, active, used,
                      out, n_out, n_fam, n_dropped)


def _quiet_step(consts, st: ChainState) -> ChainState:
    """One zero-match valid probe: aging only (no arm is dirty)."""
    A = consts[0]
    return _age_prune_emit(consts, st, st.l_start, st.l_end, st.r_start,
                           st.r_end, st.gap, st.active, st.used,
                           jnp.zeros(A, bool), st.n_dropped)


def _match_step(consts, st: ChainState, i, ms) -> ChainState:
    """One probe with its match list (automaton.rs:103-200): snapshot
    classification, greedy first-arm assignment, last-writer extension,
    spawn, then the shared aging/prune/emit tail."""
    A, M, OUT, ps, step, max_gap, min_dup = consts
    m_valid = ms >= 0
    m_end = ms + ps

    l_len = st.l_end - st.l_start
    allow = jnp.maximum(max_gap,
                        (0.1 * l_len.astype(jnp.float32)).astype(I32))
    d = _d_ss(st.r_start[None, :], st.r_end[None, :],
              ms[:, None], m_end[:, None])
    adm = (st.used & st.active)[None, :] & (d < allow[None, :]) & \
        (m_end[:, None] > st.r_end[None, :])
    arm_idx = jnp.arange(A, dtype=I32)[None, :]
    first = jnp.min(jnp.where(adm, arm_idx, A), axis=1)  # [M]
    extend = m_valid & (first < A)
    target = jnp.where(extend, first, A)

    match_idx = jnp.arange(M, dtype=I32)
    hits = (target[:, None] == jnp.arange(A, dtype=I32)[None, :])
    last = jnp.max(jnp.where(hits, match_idx[:, None], -1), axis=0)
    dirty = last >= 0
    r_end = jnp.where(dirty, m_end[jnp.maximum(last, 0)], st.r_end)
    l_end = jnp.where(dirty, i + ps, st.l_end)
    gap = jnp.where(dirty, 0, st.gap)

    is_new = m_valid & ~extend
    n_used = jnp.sum(st.used).astype(I32)
    slot = n_used + jnp.cumsum(is_new.astype(I32)) - 1
    n_dropped = st.n_dropped + jnp.sum(
        (is_new & (slot >= A)).astype(I32))
    slot = jnp.where(is_new & (slot < A), slot, A)  # drop on overflow
    l_start = st.l_start.at[slot].set(i, mode="drop")
    l_end = l_end.at[slot].set(i + ps, mode="drop")
    r_start = st.r_start.at[slot].set(ms, mode="drop")
    r_end = r_end.at[slot].set(m_end, mode="drop")
    gap = gap.at[slot].set(0, mode="drop")
    used = st.used.at[slot].set(True, mode="drop")
    active = st.active.at[slot].set(True, mode="drop")
    dirty = dirty.at[slot].set(False, mode="drop")

    return _age_prune_emit(consts, st, l_start, l_end, r_start, r_end,
                           gap, active, used, dirty, n_dropped)


@functools.partial(jax.jit, static_argnames=("cfg",))
def chain_scan(cfg: ChainConfig, probe_is: jax.Array, matches: jax.Array,
               valid: jax.Array):
    """Run the automaton over the probe stream.

    Returns (out [OUT, 5] int32: left, right, left_len, right_len,
    family_id; n_out scalar; n_families scalar; n_dropped scalar).
    Needle-relative left coordinates, like the reference automaton.

    Overflow protocol (mirrors the native chain's rc=1 retry contract):
    ``n_out`` keeps counting past ``out_cap`` — callers must treat
    ``n_out > out_cap`` as truncation and retry with a larger cap; and
    ``n_dropped`` counts new arms that found no free slot (arm-capacity
    overflow) — any nonzero value means families may be missing and the
    caller must retry with more ``max_arms``.
    """
    consts = _consts(cfg)

    def step_fn(st: ChainState, inp):
        i, ms, ok = inp
        new_st = _match_step(consts, st, i, ms)
        # invalid probes (cardinality skip) are full no-ops
        merged = jax.tree.map(
            lambda new, old: jnp.where(ok, new, old), new_st, st)
        return merged, None

    final, _ = jax.lax.scan(step_fn, _empty_state(cfg),
                            (probe_is.astype(I32), matches, valid))
    return final.out, final.n_out, final.n_fam, final.n_dropped


def chain_device(
    cfg: ChainConfig, sa: np.ndarray, probe_is: np.ndarray,
    lo: np.ndarray, hi: np.ndarray, *, needle_offset: int, needle_len: int,
    reverse: bool,
) -> list[list[tuple[int, int, int, int]]]:
    """Host-convenient wrapper: exact host match prep + device scan →
    families in the native-engine format. Retries with doubled capacities
    on output/arm overflow (the native chain's rc=1 protocol)."""
    pis, matches, valid = prepare_probe_stream_host(
        sa, probe_is, lo, hi, needle_offset=needle_offset,
        needle_len=needle_len, reverse=reverse,
        max_cardinality=cfg.max_cardinality, max_matches=cfg.max_matches)
    while True:
        out, n_out, n_fam, n_dropped = chain_scan(
            cfg, jnp.asarray(pis), jnp.asarray(matches), jnp.asarray(valid))
        n_out = int(n_out)
        if n_out <= cfg.out_cap and int(n_dropped) == 0:
            break
        cfg = cfg._replace(
            out_cap=max(cfg.out_cap * 2, n_out + 1),
            max_arms=cfg.max_arms * (2 if int(n_dropped) else 1))
    out = np.asarray(out)[:n_out]
    families: list[list[tuple[int, int, int, int]]] = []
    for row in out:
        left, right, llen, rlen, fam = (int(x) for x in row)
        while len(families) <= fam:
            families.append([])
        families[fam].append((left, right, llen, rlen))
    return [f for f in families if f]


# ---------------------------------------------------------------------------
# Burst-parallel event chaining (full on-device chain)
# ---------------------------------------------------------------------------
#
# The event stream (matched probes + quiet-step counts, as produced by the
# device scan) decomposes into *bursts*: maximal runs of events separated
# by >= ceil(max_gap/step) quiet valid probes. Such a gap provably
# deactivates every arm (gap grows by step per quiet probe, deactivation
# at >= max_gap), so the family-emission reset fires between bursts and
# each burst starts from an EMPTY automaton — bursts are exactly
# independent, making a vmap over bursts an exact parallelization with no
# boundary stitching. Within a burst, quiet runs (z < threshold) are
# replayed with a bounded per-step loop, preserving intermediate
# prune/emission timing bit-for-bit.
#
# Exact output, but the automaton is irreducibly sequential within a
# burst and lane counts are small, so scan-step overhead dominates while
# the host chain finishes the same events in microseconds per thousand
# (its cost on a GPU is not measured yet). This is why the HOST event chain
# is the production default and the device chain is the opt-in
# (ASGART_DEVICE_CHAIN=1): Amdahl is on the host's side once the device
# has compacted 12.8M probes into a few thousand events.


def burst_threshold(cfg: ChainConfig) -> int:
    """Quiet valid probes after which every arm is provably dead."""
    return -(-cfg.max_gap_size // cfg.step_size)


@functools.partial(jax.jit, static_argnames=("cfg", "t_split"))
def chain_events_lane(cfg: ChainConfig, t_split: int, probe_is: jax.Array,
                      z_before: jax.Array, matches: jax.Array,
                      z_tail: jax.Array):
    """One burst lane: scan over its events (i, z quiet steps before,
    match list), then replay the trailing quiet run (z_tail, capped at
    t_split — arms alive after it are dropped, end-of-needle semantics).
    Padded events (i < 0) are no-ops."""
    consts = _consts(cfg)

    def quiet_run(st: ChainState, z):
        # traced trip count (z=0 for consecutive matched probes, the
        # common case): under vmap this is a lockstep while_loop bounded
        # by the batch maximum, not a static t_split-iteration unroll
        return jax.lax.fori_loop(
            0, jnp.minimum(z, t_split), lambda s, acc: _quiet_step(
                consts, acc), st)

    def step_fn(st: ChainState, inp):
        i, z, ms = inp
        new_st = _match_step(consts, quiet_run(st, z), i, ms)
        merged = jax.tree.map(
            lambda new, old: jnp.where(i >= 0, new, old), new_st, st)
        return merged, None

    final, _ = jax.lax.scan(
        step_fn, _empty_state(cfg),
        (probe_is.astype(I32), z_before.astype(I32), matches))
    final = quiet_run(final, jnp.minimum(z_tail, t_split))
    return final.out, final.n_out, final.n_fam, final.n_dropped


@functools.partial(jax.jit, static_argnames=("cfg", "t_split"))
def chain_bursts(cfg: ChainConfig, t_split: int, gp: jax.Array,
                 gz: jax.Array, gm: jax.Array, tz: jax.Array):
    """vmap of `chain_events_lane` over burst lanes.

    gp/gz [NB, LB] (probe index / quiet steps, -1/0 padded), gm
    [NB, LB, M] match lists (-1 padded), tz [NB] trailing quiet steps.
    Returns (out [NB, OUT, 5], n_out [NB], n_fam [NB], n_dropped [NB]).
    """
    return jax.vmap(
        lambda p, z, m, t: chain_events_lane(cfg, t_split, p, z, m, t)
    )(gp, gz, gm, tz)


def bursts_from_events_host(cfg: ChainConfig, probe_is, z_before,
                            m_offsets, m_flat, z_trail,
                            max_matches: int | None = None):
    """Host-side burst grid construction (mirrors the device builder):
    events → (gp, gz, gm, tz) padded burst grids for `chain_bursts`."""
    t_split = burst_threshold(cfg)
    E = len(probe_is)
    M = max_matches or cfg.max_matches
    if E == 0:
        return (np.full((1, 1), -1, np.int32), np.zeros((1, 1), np.int32),
                np.full((1, 1, M), -1, np.int32),
                np.asarray([min(int(z_trail), t_split)], np.int32), t_split)
    from .utils import pow2_ceil as _pow2

    new_burst = np.zeros(E, dtype=bool)
    new_burst[0] = True
    new_burst |= np.asarray(z_before) >= t_split
    burst_id = np.cumsum(new_burst) - 1
    NB = int(burst_id[-1]) + 1
    pos = np.arange(E) - np.maximum.accumulate(
        np.where(new_burst, np.arange(E), 0))
    LB = int(pos.max()) + 1
    # pow2-padded grid shapes hit the jit cache across chunks/retries
    NBp, LBp = _pow2(NB), _pow2(LB)
    if NBp * LBp * M > (1 << 28):
        raise ValueError(
            f"burst grid {NBp}x{LBp}x{M} too large for on-device "
            "chaining; use the host event chain")
    if int(lengths_check := (np.asarray(m_offsets[1:E + 1]) -
                              np.asarray(m_offsets[:E])).max(initial=0)) > M:
        raise ValueError(
            f"event match count {int(lengths_check)} exceeds "
            f"max_matches={M}")
    gp = np.full((NBp, LBp), -1, dtype=np.int32)
    gz = np.zeros((NBp, LBp), dtype=np.int32)
    gm = np.full((NBp, LBp, M), -1, dtype=np.int32)
    gp[burst_id, pos] = probe_is
    # a burst's first event starts from an empty automaton: no aging
    gz[burst_id, pos] = np.where(new_burst, 0, z_before)
    lengths = np.asarray(m_offsets[1:E + 1]) - np.asarray(m_offsets[:E])
    within = np.arange(int(lengths.sum())) - np.repeat(
        np.asarray(m_offsets[:E]), lengths)
    gm[np.repeat(burst_id, lengths), np.repeat(pos, lengths),
       within] = m_flat[: int(lengths.sum())]
    # trailing quiet runs: inter-burst gaps provably kill+emit within
    # t_split steps; the global tail is capped (leftover arms drop)
    tz = np.zeros(NBp, dtype=np.int32)
    tz[:NB] = t_split
    tz[NB - 1] = min(int(z_trail), t_split)
    return gp, gz, gm, tz, t_split


def chain_events_device(cfg: ChainConfig, probe_is, z_before, m_offsets,
                        m_flat, z_trail):
    """Exact full-on-device event chaining: burst decomposition + vmapped
    lanes; retries on capacity overflow like the other engines. Returns
    families in the native-engine format."""
    M = int(max((m_offsets[1:] - m_offsets[:-1]).max(initial=1), 1))
    from .utils import pow2_ceil

    M = pow2_ceil(M, 1)  # pow2 for the jit cache
    # start with a small per-lane output buffer (few families per burst;
    # the overflow protocol retries the rare heavy lanes)
    cfg = cfg._replace(out_cap=min(cfg.out_cap, 64))
    # the grid depends only on t_split and M — build and upload it once,
    # not per capacity retry (gm alone can be hundreds of MB)
    gp, gz, gm, tz, t_split = bursts_from_events_host(
        cfg, probe_is, z_before, m_offsets, m_flat, z_trail,
        max_matches=M)
    gp, gz, gm, tz = (jnp.asarray(gp), jnp.asarray(gz), jnp.asarray(gm),
                      jnp.asarray(tz))
    while True:
        out, n_out, n_fam, n_dropped = chain_bursts(
            cfg._replace(max_matches=M), t_split, gp, gz, gm, tz)
        n_out_h = np.asarray(n_out)
        if (int(np.asarray(n_dropped).sum()) == 0
                and int(n_out_h.max(initial=0)) <= cfg.out_cap):
            break
        cfg = cfg._replace(
            out_cap=max(cfg.out_cap * 2, int(n_out_h.max(initial=0)) + 1),
            max_arms=cfg.max_arms *
            (2 if int(np.asarray(n_dropped).sum()) else 1))
    out = np.asarray(out)
    n_fam_h = np.asarray(n_fam)
    families = []
    for b in range(out.shape[0]):
        rows = out[b, : int(n_out_h[b])]
        lane_fams: list[list] = [[] for _ in range(int(n_fam_h[b]))]
        for row in rows:
            left, right, llen, rlen, fam = (int(x) for x in row)
            lane_fams[fam].append((left, right, llen, rlen))
        families.extend(f for f in lane_fams if f)
    return families
