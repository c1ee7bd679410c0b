"""On-device suffix-array index construction.

Device replacement of the host C++ index builder for the device engine
(reference analog: libdivsufsort's ``divsufsort64``, src/divsufsort.rs:10,
driven from asgart.rs:473-479). The only upload is the 3-bit symbol
codes (1 B/bp); the doubled text (for R/C/RC runs), packed keys, suffix
order and per-position equal-range tables are all computed in device
memory, so a prebuilt ~12 B/bp index never crosses the host link:

  1. **transform + pack**: the appended half (reverse / complement /
     reverse-complement of the genome) is computed on device; every
     position packs its next k symbols into two int32 planes (hi/lo 30
     bits), identical to :mod:`asgart_tpu.seed`'s packing.
  2. **initial sort**: one ``lax.sort`` over (key_hi, key_lo, position).
  3. **prefix doubling on the tied set**: positions whose k-mers collide
     (duplicated content) are compacted into a fixed-capacity slot list
     and refined by Manber-Myers rounds — sort the tied subset by
     (group, rank[p+h]), scatter back, recompute ranks — until every
     suffix rank is distinct. Each round is one device call; the tied
     set only shrinks. This reproduces the host builder's suffix order
     bit-exactly (asgart_native.cpp bpi_codes_impl).
  4. **tables**: per-position equal-range [lo, hi) over the k-mer groups
     (one row-gather per probe at scan time — no binary search).

Equality with the host ``PositionIndex`` is pinned by
tests/test_device_index.py on fuzzed genomes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .index import CODE, check_probe_size

I32 = jnp.int32
INT32_MAX = np.int32(2**31 - 1)

# 3-bit symbol rank complement: $->$, A<->T, C<->G, N->N
COMP_CODE = np.array([0, 5, 3, 2, 4, 1], dtype=np.uint8)

# --- packed codes upload ------------------------------------------------
# ACGT (the overwhelming bulk of any genome) fits 2 bits; everything else
# ($ separators, N bases, stray IUPAC bytes) travels as a sparse
# (position, code) exception list and is scattered over the unpacked
# stream on device. 4x fewer bytes to move for the common case, bit-exact for every case (reference analog: the 1 B/bp
# `Sequence` the reference feeds libdivsufsort, src/bin/asgart.rs).
_PACK2 = np.zeros(256, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _PACK2[_ch] = _i
_IS_EXC = np.ones(256, dtype=bool)
for _ch in b"ACGT":
    _IS_EXC[_ch] = False
# 2-bit value -> 3-bit symbol rank (A,C,G,T ranks in the CODE table)
_UNPACK2 = np.array([1, 2, 3, 5], dtype=np.uint8)


def pack_codes_host(strand_data: np.ndarray):
    """2-bit-pack the strand on the host. Returns ``(packed, exc_pos,
    exc_code, n1)`` or ``None`` when exceptions are so dense that the
    packed form would not beat the plain 1 B/bp upload."""
    n1 = int(len(strand_data))
    if n1 >= 2**31:
        # exc_pos is int32 on the wire; a >=2 GB strand would wrap the
        # exception positions (the engines re-check this with an error,
        # but upload_codes is a public early-upload entry point that can
        # run first — mirror their guard by declining to pack)
        return None
    exc_pos = np.flatnonzero(_IS_EXC[strand_data]).astype(np.int32)
    # 5 B/exception on the wire; bail out past ~1/8 of the plain upload
    if exc_pos.size * 5 > max(n1 // 8, 64):
        return None
    exc_code = CODE[strand_data[exc_pos]]
    n4 = -(-n1 // 4)
    b2 = np.zeros(4 * n4, dtype=np.uint8)
    b2[:n1] = _PACK2[strand_data]
    # PLANAR packing: byte j carries strand positions j, n4+j, 2*n4+j,
    # 3*n4+j (contiguous quarters, not interleaved nibbles) — the
    # device unpack is then a [4, n4] -> flat reshape, and the host
    # folds contiguous slices instead of strided ones.
    packed = (b2[:n4] | (b2[n4: 2 * n4] << 2) | (b2[2 * n4: 3 * n4] << 4)
              | (b2[3 * n4:] << 6))
    return packed, exc_pos, exc_code, n1


@functools.partial(jax.jit, static_argnames=("n1",))
def _unpack_codes(packed: jax.Array, exc_pos: jax.Array,
                  exc_code: jax.Array, n1: int) -> jax.Array:
    shifts = jnp.array([0, 2, 4, 6], dtype=jnp.uint8)
    two = (packed[None, :] >> shifts[:, None]) & jnp.uint8(3)  # [4, n4]
    codes = jnp.asarray(_UNPACK2)[two.reshape(-1)[:n1]]
    return codes.at[exc_pos].set(exc_code, mode="drop")

LO_SYMS = 10  # symbols in the low plane (30 bits)
# two int32 planes hold 20 symbols (10 each); k=21 would push 33 bits
# into the hi plane and silently merge distinct k-mer groups. The
# TABLE engine (whole-genome per-position tables) adds a third plane
# for k = 21..30 — the windowed/merge-join engines stay 2-plane and
# route wider probes to the byte-exact host engine.
DEVICE_MAX_K = 20
DEVICE_MAX_K_TABLE = 30

# Build high-water mark per (doubled-)text row, with the donation /
# early-free structure: the flagged initial sort and the table
# inversion are 3-operand full sorts (12 B in + 12 B out) plus the
# sort's scratch, codes and padding — bounded by 42 B/row end to end.
BUILD_PEAK_BYTES_PER_ROW = 42

# Plan budget of the CPU test tier: the virtual CPU mesh has no
# allocator limit to read, and the fit predicates still need a figure.
CPU_TIER_BUDGET_BYTES = 15_000_000_000
# Share of the device allocator's limit held back from every fit
# predicate: allocator fragmentation and XLA's own workspaces.
DEVICE_RESERVE_FRACTION = 0.05


def hbm_budget_bytes() -> int:
    """Per-device memory the index builds and scans may plan for.

    ``ASGART_HBM_BYTES`` overrides. Otherwise an accelerator's own
    allocator limit (``memory_stats()["bytes_limit"]``) less
    ``DEVICE_RESERVE_FRACTION``; an accelerator that reports no limit
    is an error, not a guess. The CPU backend plans against
    ``CPU_TIER_BUDGET_BYTES``."""
    import os

    env = os.environ.get("ASGART_HBM_BYTES")
    if env:
        return int(float(env))
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return CPU_TIER_BUDGET_BYTES
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{dev.device_kind} reports no memory_stats()['bytes_limit']; "
            "set ASGART_HBM_BYTES to the device memory to plan for")
    limit = int(stats["bytes_limit"])
    return limit - int(limit * DEVICE_RESERVE_FRACTION)


def device_index_fits(n1: int, reverse: bool, complement: bool) -> bool:
    """Whether a whole-genome :class:`DeviceIndex` build for a strand of
    ``n1`` bytes (genome + '$') fits one HBM. int32 addressing is the
    other hard cap (checked again, with an error, inside :meth:`build`).
    """
    n = 2 * n1 - 1 if (reverse or complement) else n1
    return n < (1 << 31) and n * BUILD_PEAK_BYTES_PER_ROW \
        <= hbm_budget_bytes()


# Windowed (merge-join) strategy high-water mark per WINDOW row: the
# resident index arrays (sorted keys + sa, 12 B) + decimated
# doubled codes (~2 B) + the 3-operand co-sort's in+out over W + b_pad
# rows (24 B + 24 B) minus what the scheduler overlaps — bounded by
# 45 B/row (the GPU's measured peak per row, PERF.md).
WINDOW_PEAK_BYTES_PER_ROW = 45


def device_window_whole_fits(n1: int) -> bool:
    """Whether the whole-genome-as-ONE-window merge-join strategy fits
    one HBM: a W = n1 row window index (initial sort is n1 rows, not the
    table engine's 2*n1 - 1) probed by the whole genome per chunk. The
    2^30 window cap mirrors :class:`~asgart_tpu.device_engine
    .BigWindowEngine`'s bound and keeps doubled probe addressing int32.
    """
    return n1 < (1 << 30) and n1 * WINDOW_PEAK_BYTES_PER_ROW \
        <= hbm_budget_bytes()


def device_window_fits(n1: int, W: int, doubled: bool,
                       k: int = 20) -> bool:
    """Whether ONE trim window of ``W`` rows, probed by the whole
    ``n1``-byte strand, fits one HBM. Generalizes
    :func:`device_window_whole_fits` to ``--shards``/``--trim`` windows,
    where the probe side scales with the whole genome while the window
    is a fraction of it: the stage-1 merge join co-sorts W window rows
    with ~n1/(k//2) probe lanes (3 operands, in+out+scratch), next to
    the resident window arrays and the decimated (doubled) probe codes,
    both at ``WINDOW_PEAK_BYTES_PER_ROW``. Probe lanes stride k//2
    (pipeline chunk step), so smaller probes mean MORE lanes — callers
    pass the run's real ``k`` so the projection is not optimistic."""
    if W >= (1 << 30):
        return False
    step = max(1, k // 2)
    b = n1 // step + (1 << 21)
    # decimated (doubled) probe codes + the resident unpacked strand
    # codes (`upload_codes_cached` — shared across a sharded run's
    # windows)
    codes = (2 * n1 if doubled else n1) + n1
    peak = WINDOW_PEAK_BYTES_PER_ROW * (W + b) + codes
    return peak <= hbm_budget_bytes()


def big_window_fits(n1: int, W: int, k: int = 20,
                    chunks=None) -> bool:
    """HBM fit for ONE :class:`~asgart_tpu.device_engine
    .BigWindowEngine` trim window (the >int32-doubled regime, e.g.
    whole-human -RC). Unlike :func:`device_window_fits`, the probe side
    here is NOT the whole genome at once: chunks run per-batch (budget-
    capped) or as singletons, so the stage-1 co-sort's probe side is
    bounded by the LARGEST CHUNK's lane count — pass the run's real
    chunk list (the auto-shard planner runs after ``prepare_data`` and
    has it) for an exact bound; without it the batch cap stands in.
    Additive terms: co-sort in+out+scratch 35 B/(W+b) row,
    resident window arrays 12 B/row, packed probe key planes 8 B/lane,
    the needle-region bytes twice (scan buffer + decimated copy; the
    per-block decimation keeps transpose temps bounded), the n1-byte
    resident strand codes of the device derivation (int32-addressable
    strands), and a 0.75 GB margin."""
    if W >= (1 << 30):
        return False
    step = max(1, k // 2)
    if chunks:
        max_len = max((int(c[1]) for c in chunks), default=1)
        region = max_len + 8 * step
        b = max_len // step + (1 << 21)
    else:
        region = max(hbm_budget_bytes() // 16, 1 << 28)
        b = region // step + (1 << 21)
    codes_resident = n1 if n1 < (1 << 31) else 0
    peak = 35 * (W + b) + 12 * W + 8 * b + 2 * region \
        + codes_resident + (3 << 28)
    return peak <= hbm_budget_bytes()


def device_window_join_single(n1: int, W: int, doubled: bool,
                              k: int = 20) -> bool:
    """Whether a window's batched stage-1 merge join can run as ONE
    co-sort (~35 B/row in+out+scratch) next to the window index
    (12 B/row) and the resident codes. A stricter bar than
    :func:`device_window_fits` (which only guarantees the window RUNS,
    possibly with grouped joins): the auto-shard search prefers the
    smallest window count that also keeps stage 1 single-shot — at
    512 Mbp -RC this picks 3 windows over 2, whose joins would pay the
    co-sort's W side three times per window."""
    step = max(1, k // 2)
    b = n1 // step + (1 << 21)
    codes = (2 * n1 if doubled else n1) + n1
    return 35 * (W + b) + 12 * W + codes <= hbm_budget_bytes()


def _bucket_pow2(n: int) -> int:
    from .utils import pow2_ceil

    return pow2_ceil(n, 1)


@functools.partial(jax.jit, static_argnames=("k", "reverse", "complement",
                                             "pad_to"))
def _build_text_codes(codes: jax.Array, k: int, reverse: bool,
                      complement: bool, pad_to: int):
    """codes [n1] (genome + '$' ranks) → doubled/padded text codes
    [pad_to + k] with zero padding. The appended half is T(genome): the
    run transform applied on device (complement first, then reverse —
    pipeline.transform_needle order). (A nibble-packed upload was tried
    and reverted: the halved transfer lost more to the on-device unpack
    gather than it saved on the wire.)"""
    n1 = codes.shape[0]
    half = codes[: n1 - 1]
    if complement:
        half = jnp.asarray(COMP_CODE)[half]
    if reverse:
        half = half[::-1]
    if reverse or complement:
        text = jnp.concatenate([codes, half])
    else:
        text = codes
    out = jnp.zeros(pad_to + k, dtype=jnp.uint8)
    return out.at[: text.shape[0]].set(text)


@functools.partial(jax.jit, static_argnames=("k", "n"))
def _pack_planes_all(codes_padded: jax.Array, k: int, n: int):
    """(hi, lo) int32 planes of the k-mer at every position 0..n."""
    c = codes_padded.astype(I32)
    n_hi = max(k - LO_SYMS, 0)
    hi = jnp.zeros(n, dtype=I32)
    lo = jnp.zeros(n, dtype=I32)
    for j in range(n_hi):
        hi = (hi << 3) | jax.lax.dynamic_slice(c, (j,), (n,))
    for j in range(n_hi, k):
        lo = (lo << 3) | jax.lax.dynamic_slice(c, (j,), (n,))
    return hi, lo


@functools.partial(jax.jit, static_argnames=("k", "n"))
def _pack_planes3_all(codes_padded: jax.Array, k: int, n: int):
    """(top, hi, lo) int32 planes for k in 21..30 (table engine): top
    holds the first k-20 symbols, hi the next 10, lo the last 10 —
    lexicographic over the plane tuple, like the 2-plane layout."""
    c = codes_padded.astype(I32)
    n_top = k - 2 * LO_SYMS
    top = jnp.zeros(n, dtype=I32)
    hi = jnp.zeros(n, dtype=I32)
    lo = jnp.zeros(n, dtype=I32)
    for j in range(n_top):
        top = (top << 3) | jax.lax.dynamic_slice(c, (j,), (n,))
    for j in range(n_top, n_top + LO_SYMS):
        hi = (hi << 3) | jax.lax.dynamic_slice(c, (j,), (n,))
    for j in range(n_top + LO_SYMS, k):
        lo = (lo << 3) | jax.lax.dynamic_slice(c, (j,), (n,))
    return top, hi, lo


# NB (memory diet): the build-path jits donate their large dead inputs
# (key planes into the sorts, sorted keys into the bounds pass, run
# bounds into the inversions, sa/rank/slot buffers through the doubling
# rounds). Donation both lets XLA alias same-shaped outputs onto them
# and frees them at execution instead of at Python frame exit, which
# keeps the build's peak near ``BUILD_PEAK_BYTES_PER_ROW``.
@functools.partial(jax.jit, donate_argnums=(0, 1))
def _initial_sort(key_hi: jax.Array, key_lo: jax.Array):
    n = key_hi.shape[0]
    skhi, sklo, sa = jax.lax.sort(
        (key_hi, key_lo, jnp.arange(n, dtype=I32)), num_keys=2)
    return skhi, sklo, sa


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _flagged_sort(key_hi: jax.Array, key_lo: jax.Array,
                  direct_bound: jax.Array):
    """Initial sort with the appended-half flag packed into the low
    plane's spare bit (keys use 30 of 31 value bits): within every
    k-mer group, first-half ("direct") positions sort before
    appended-half ones, so a group's direct entries form a contiguous
    prefix — the matchable window under the engine's
    ``m < first_len - 1`` restriction."""
    n = key_hi.shape[0]
    iota = jnp.arange(n, dtype=I32)
    flagged = (key_lo << 1) | (iota >= direct_bound).astype(I32)
    skhi, sklo, sa = jax.lax.sort((key_hi, flagged, iota), num_keys=2)
    return skhi, sklo, sa


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _initial_sort3(key_top: jax.Array, key_hi: jax.Array,
                   key_lo: jax.Array):
    n = key_top.shape[0]
    return jax.lax.sort(
        (key_top, key_hi, key_lo, jnp.arange(n, dtype=I32)), num_keys=3)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _flagged_sort3(key_top: jax.Array, key_hi: jax.Array,
                   key_lo: jax.Array, direct_bound: jax.Array):
    """3-plane `_flagged_sort` (k = 21..30 table builds); the appended
    flag rides in the LOW plane's spare bit exactly as in the 2-plane
    layout."""
    n = key_top.shape[0]
    iota = jnp.arange(n, dtype=I32)
    flagged = (key_lo << 1) | (iota >= direct_bound).astype(I32)
    return jax.lax.sort((key_top, key_hi, flagged, iota), num_keys=3)


def _group_bounds_impl(skhi: jax.Array, sklo: jax.Array, sa: jax.Array,
                       direct_bound: jax.Array, flagged: bool = False,
                       flag_n_k: int = 0, sktop: jax.Array | None = None):
    """Equal-key run boundaries over the sorted keys.

    Returns slot-indexed (run_lo [n], run_hi [n], tied_slot [n] bool).

    With ``flag_n_k = k > 0`` (the table-engine build), each slot whose
    position STARTS with 'N' gets the sign bit set in run_lo: the first
    symbol's 3-bit rank sits in the sorted keys' top bits, so the
    engine's N-probe check (automaton.rs:100-102) is computed here
    elementwise and carried into position space by the inversion sort —
    no codes read anywhere on the scan path.

    In ``flagged`` mode (doubled text, `sklo` carries the appended flag
    in bit 0), the per-slot window [run_lo, run_hi) spans only the
    DIRECT entries of the slot's k-mer group: run_lo is the group
    (true-key) run start, run_hi the direct/appended split point. The
    tied set is restricted to direct entries — appended-half suffix
    order is never observable (matches are filtered to the first half),
    and resolving direct ties never reads an appended rank: two tied
    direct suffixes agree on h symbols only while h <= their distance
    to the unique '$', so every rank[p+h] gather lands in the first
    half.
    """
    n = skhi.shape[0]
    iota = jnp.arange(n, dtype=I32)
    top_neq = (jnp.zeros(n - 1, bool) if sktop is None
               else (sktop[1:] != sktop[:-1]))
    neq_full = jnp.concatenate([
        jnp.ones(1, bool),
        top_neq | (skhi[1:] != skhi[:-1]) | (sklo[1:] != sklo[:-1])])
    run_lo_full = jax.lax.cummax(jnp.where(neq_full, iota, 0))
    nxt = jnp.concatenate([neq_full[1:], jnp.ones(1, bool)])
    if flagged:
        tk = sklo >> 1  # true (unflagged) low plane
        neq_true = jnp.concatenate([
            jnp.ones(1, bool),
            top_neq | (skhi[1:] != skhi[:-1]) | (tk[1:] != tk[:-1])])
        run_lo = jax.lax.cummax(jnp.where(neq_true, iota, 0))
        direct = sa < direct_bound
        # every probe table read in doubled mode lands at an APPENDED
        # position (_probe_x0 maps all transforms past first_len), whose
        # window end is its own full-key run START (the direct/appended
        # split); direct positions get (lo, lo) — empty, never probed.
        # This also drops the reverse cummin run-end scan entirely.
        run_hi = jnp.where(direct, run_lo, run_lo_full)
        # tied (direct, full-key run len > 1): slot is not both a run
        # start and a run end — elementwise, no scan needed
        tied_slot = direct & ~(neq_full & nxt)
    else:
        run_lo = run_lo_full
        # run end: first boundary at or after i+1 (reverse min-scan)
        run_hi = jax.lax.cummin(jnp.where(nxt, iota + 1, n), reverse=True)
        tied_slot = (run_hi - run_lo) > 1
    if flag_n_k:
        k = flag_n_k
        if sktop is not None:  # 3-plane layout: first symbol on top
            first_sym = (sktop >> (3 * (k - 2 * LO_SYMS - 1))) & 7
        elif k > LO_SYMS:
            first_sym = (skhi >> (3 * (k - LO_SYMS - 1))) & 7
        else:
            true_lo = (sklo >> 1) if flagged else sklo
            first_sym = (true_lo >> (3 * (k - 1))) & 7
        run_lo = run_lo | jnp.where(first_sym == N_RANK, I32_SIGN, 0)
    return run_lo, run_hi, tied_slot


# build path: the sorted keys are dead after this pass — donate them
_group_bounds = jax.jit(_group_bounds_impl,
                        static_argnames=("flagged", "flag_n_k"),
                        donate_argnums=(0, 1))
# 3-plane build path (k = 21..30): skhi/sklo alias onto run_lo/run_hi;
# sktop is NOT donated — the only remaining output (tied_slot, bool[n])
# cannot alias an int32 buffer, so donating it would only emit XLA's
# "donated buffers were not usable" warning. It is freed by the
# caller's `del` at dispatch instead.
_group_bounds3 = jax.jit(_group_bounds_impl,
                         static_argnames=("flagged", "flag_n_k"),
                         donate_argnums=(0, 1))
# window path: skhi/sklo stay resident (merge-join lookups) — keep them
_group_bounds_keep = jax.jit(_group_bounds_impl,
                             static_argnames=("flagged", "flag_n_k"))


N_RANK = 4  # 3-bit symbol rank of 'N' (CODE table)
I32_SIGN = np.int32(-2**31)


def _dec_of(p, step: int, C: int):
    """The decimation permutation: plain position p → decimated index
    (p % step)*C + p//step (a bijection on [0, step*C))."""
    return (p % step) * C + p // step


def _assemble_dec(vals: list, step: int, L: int, n: int):
    """[n] streams in dec-sorted order → zero-padded [L] decimated
    arrays via ``step`` static contiguous copies: the live entries
    (p < n) occupy a contiguous PREFIX of each decimated row (row r
    holds positions p ≡ r mod step in p-order), so the dec-sorted
    stream is exactly the concatenation of the rows' live prefixes."""
    C = L // step
    outs = [jnp.zeros(L, v.dtype) for v in vals]
    off = 0
    for r in range(step):
        live = (n - r + step - 1) // step
        outs = [jax.lax.dynamic_update_slice(
                    o, jax.lax.dynamic_slice(v, (off,), (live,)),
                    (r * C,))
                for o, v in zip(outs, vals)]
        off += live
    return outs


@functools.partial(jax.jit, static_argnames=("step", "L"))
def _invert_tables_dec(sa: jax.Array, lo: jax.Array,
                       hi: jax.Array, step: int, L: int):
    """Slot-indexed run bounds → DECIMATED position-indexed tables, by
    ONE n-row payload sort keyed on the decimation permutation of `sa`
    plus ``step`` static contiguous copies into zeroed [L] buffers
    (`_assemble_dec`): full-size random scatters are latency-bound
    while `lax.sort` streams, so keying the inversion sort by dec(sa)
    gets the decimated layout without a scatter. Only the n LIVE rows
    are sorted, not the [L] padded domain.

    Probe reads then are contiguous row slices (`device_engine
    ._dec_read`), and the N-probe flag folded into run_lo's sign bit by
    `_group_bounds_impl` rides along into position space.

    Also returns the doubling loop's mutable rank seed (pos_lo stripped
    of the N-flag sign bit) — fused here so it costs one output write
    instead of a separate read+write pass."""
    n = sa.shape[0]
    C = L // step
    # materialize the computed key: an inline operand would fuse into
    # the sort's comparator data path and be recomputed per comparison
    dec = jax.lax.optimization_barrier(_dec_of(sa, step, C))
    _, lo_c, hi_c = jax.lax.sort((dec, lo, hi), num_keys=1)
    pos_lo, pos_hi = _assemble_dec([lo_c, hi_c], step, L, n)
    rank = pos_lo & jnp.int32(0x7FFFFFFF)
    return pos_lo, pos_hi, rank


# decimation block: bounds the sort transients at genome scale to
# those of one B-row block
_DECIMATE_BLOCK = 1 << 28


@functools.partial(jax.jit, static_argnames=("step", "L", "n"))
def _decimate_codes(codes: jax.Array, step: int, L: int, n: int):
    """uint8 codes (live prefix [n]) → decimated layout [L], in
    position BLOCKS: block positions [b0, b0+B) land, per residue r, in
    a contiguous column run [b0/step, (b0+B)/step) of decimated row r —
    so each block is one small payload sort keyed by its in-block
    decimation + `step` static contiguous copies. Positions ≥ n read
    as 0 in the decimated
    layout, matching the zero padding of `_build_text_codes`."""
    C = L // step
    out = jnp.zeros(L, dtype=codes.dtype)
    # block size: a multiple of step so every block starts at column
    # b0/step with residue 0
    B = (_DECIMATE_BLOCK // step) * step
    b0 = 0
    while b0 < n:
        nb = min(B, n - b0)
        blk = codes[b0: b0 + nb]
        # in-block decimation: local rows of length ceil(nb/step)
        Cb = -(-nb // step)
        # materialized: keeps the key out of the comparator fusion
        dec, blk = jax.lax.optimization_barrier(
            (_dec_of(jnp.arange(nb, dtype=I32), step, Cb), blk))
        _, blk_c = jax.lax.sort((dec, blk), num_keys=1)
        q0 = b0 // step
        off = 0
        for r in range(step):
            live = (nb - r + step - 1) // step
            out = jax.lax.dynamic_update_slice(
                out, jax.lax.dynamic_slice(blk_c, (off,), (live,)),
                (r * C + q0,))
            off += live
        b0 += nb
    return out


@functools.partial(jax.jit, static_argnames=("step", "L", "n"))
def _decimate_codes_t(codes: jax.Array, step: int, L: int, n: int):
    """`_decimate_codes` by blocked TRANSPOSE instead of block sorts:
    each [Cb, step] uint8 block view transposes to [step, Cb] (the
    in-block decimated layout) and lands in the rows via `step` static
    contiguous copies. Blocks of 2^24 bound the transpose's temps.
    Output is bit-equal to `_decimate_codes` (pinned by
    test_device_index)."""
    C = L // step
    out = jnp.zeros(L, dtype=codes.dtype)
    blk = 1 << 24
    Bb = (blk // step) * step
    b0 = 0
    while b0 < n:
        nb = min(Bb, n - b0)
        nbp = ((nb + step - 1) // step) * step
        t = jnp.zeros(nbp, codes.dtype).at[:nb].set(
            jax.lax.dynamic_slice(codes, (b0,), (nb,)))
        # [Cb, step] -> [step, Cb]: row r of the result holds positions
        # b0 + r, b0 + step + r, ... — the in-block decimation
        tt = t.reshape(nbp // step, step).T.reshape(-1)
        q0 = b0 // step
        Cb = nbp // step
        for r in range(step):
            out = jax.lax.dynamic_update_slice(
                out, jax.lax.dynamic_slice(tt, (r * Cb,), (Cb,)),
                (r * C + q0,))
        b0 += nb
    return out


@functools.partial(jax.jit, static_argnames=("step", "C", "Cb"),
                   donate_argnums=(0,))
def _dec_block_t(out: jax.Array, blk: jax.Array, b0, step: int, C: int,
                 Cb: int):
    """One `_decimate_codes_t` block as its OWN dispatch (donated
    `out`): in a single jit XLA may keep several blocks' transpose
    temps live at once; per-block dispatch bounds the live temps to
    one block."""
    tt = blk.reshape(Cb, step).T.reshape(-1)
    q0 = b0 // jnp.int32(step)
    for r in range(step):
        out = jax.lax.dynamic_update_slice(
            out, jax.lax.dynamic_slice(tt, (r * Cb,), (Cb,)),
            (jnp.int32(r * C) + q0,))
    return out


def _decimate_codes_multi(codes: jax.Array, step: int, L: int, n: int):
    """`_decimate_codes_t` for buffers too large for the single-jit
    block loop: the same blocked transpose, one dispatch per block
    (bit-equal — pinned by test_device_index). Tail positions in
    [n, L) stay 0, matching the zero-padded buffer contract."""
    C = L // step
    out = jnp.zeros(L, dtype=codes.dtype)
    Bb = ((1 << 24) // step) * step
    b0 = 0
    while b0 < n:
        nb = min(Bb, n - b0)
        nbp = ((nb + step - 1) // step) * step
        if nbp == nb:
            blk = jax.lax.dynamic_slice(codes, (b0,), (nb,))
        else:
            blk = jnp.zeros(nbp, codes.dtype).at[:nb].set(
                jax.lax.dynamic_slice(codes, (b0,), (nb,)))
        out = _dec_block_t(out, blk, jnp.int32(b0), step, C,
                           nbp // step)
        b0 += nb
    return out


def decimate_codes_auto(codes: jax.Array, step: int, L: int, n: int):
    """`_decimate_codes_t` below 2^27 rows (one dispatch), the
    per-block-dispatch `_decimate_codes_multi` above (temps bounded to
    one block)."""
    if L > (1 << 27):
        return _decimate_codes_multi(codes, step, L, n)
    return _decimate_codes_t(codes, step, L, n)


@jax.jit
def _invert_perm(sa: jax.Array, vals: jax.Array):
    """Position-indexed view of slot-indexed `vals` (windowed builds,
    where the slot arrays stay resident)."""
    _, out = jax.lax.sort((sa, vals), num_keys=1)
    return out


_EXTRACT_BLOCK = 1 << 14


@functools.partial(jax.jit, static_argnames=("cap",))
def _extract_tied(tied_slot: jax.Array, cap: int):
    """Compact the tied slot indices (ascending) into [cap]; returns
    (slots [cap] padded with n, count).

    Blocked two-level compaction: a row-wise sort over [G, B] blocks
    (sort depth over B rows instead of n) followed by a cumsum-based
    placement gather in the cap-sized output domain. Exact: block-major
    iota keys keep the global output ascending, and the caller sizes
    ``cap >= n_tied`` (pow2_ceil of the live count)."""
    n = tied_slot.shape[0]
    B = _EXTRACT_BLOCK
    G = (n + B - 1) // B
    iota = jnp.arange(n, dtype=I32)
    key = jnp.where(tied_slot, iota, n)
    key2 = jnp.concatenate([key, jnp.full(G * B - n, n, I32)]).reshape(G, B)
    skey = jax.lax.sort(key2, dimension=1)
    counts = jnp.sum((key2 < n).astype(I32), axis=1)
    total = jnp.sum(counts)
    offs = jnp.concatenate([jnp.zeros(1, I32), jnp.cumsum(counts)[:-1]])
    # block id per output lane: mark each block's start offset, cummax
    marks = jnp.zeros(cap, I32).at[offs].max(jnp.arange(G, dtype=I32),
                                             mode="drop")
    block_of = jax.lax.cummax(marks)
    jcap = jnp.arange(cap, dtype=I32)
    j = jnp.maximum(jcap - offs[block_of], 0)
    vals = skey[block_of, j]
    return jnp.where(jcap < total, vals, n), total


def _rank_ix(p, rank: jax.Array, dec_step: int):
    """Index into `rank` for plain position(s) p: identity for a
    plain-indexed rank (windowed builds), the decimation permutation
    when rank shares the tables' decimated layout (dec_step = step)."""
    if not dec_step:
        return p
    return _dec_of(p, dec_step, rank.shape[0] // dec_step)


@functools.partial(jax.jit, static_argnames=("dec_step",))
def _slot_payload(sa: jax.Array, rank: jax.Array, slots: jax.Array,
                  n_tied: jax.Array, dec_step: int = 0):
    """One-time (position, rank) gather for a fresh tied-slot list; the
    doubling rounds then carry both in slot space, saving two full-array
    latency-bound gathers per round."""
    cap = slots.shape[0]
    live = jnp.arange(cap, dtype=I32) < n_tied
    p = sa[jnp.where(live, slots, 0)]
    prim = jnp.where(live, rank[_rank_ix(p, rank, dec_step)], INT32_MAX)
    return jnp.where(live, p, 0), prim


@functools.partial(jax.jit, static_argnames=("rounds", "dec_step"),
                   donate_argnums=(0, 1, 2, 3, 4))
def _doubling_rounds(sa: jax.Array, rank: jax.Array, slots: jax.Array,
                     ps: jax.Array, prims: jax.Array,
                     n_tied: jax.Array, h0: jax.Array, rounds: int,
                     dec_step: int = 0):
    """`rounds` Manber-Myers refinement rounds on the tied subset.

    Tied slots hold positions whose suffixes agree on their first h
    symbols; each round sorts every tied group by rank[p+h] and refines
    ranks. The slot list stays ascending, so the j-th sorted element
    lands in the j-th tied slot of its group. The tied positions and
    their current ranks ride along in slot space (``ps``/``prims``,
    maintained by the round itself), so the only full-array gather per
    round is rank[p+h]; sa/rank scatters remain for the benefit of other
    groups' rank[p+h] reads and the final suffix order.
    """
    n = sa.shape[0]
    cap = slots.shape[0]
    jcap = jnp.arange(cap, dtype=I32)

    def one_round(carry, _):
        sa, rank, slots, ps, prims, n_tied, h = carry
        live = jcap < n_tied
        p = jnp.where(live, ps, 0)
        prim = jnp.where(live, prims, INT32_MAX)
        # p + h can overflow int32 near the 2^31 guard; n - h is always
        # in range (h is capped at ~n below), and the sum is only formed
        # when it provably fits
        in_text = p < (n - h)
        ph = jnp.where(in_text, p, 0) + jnp.where(in_text, h, 0)
        sec = jnp.where(live & in_text,
                        rank[_rank_ix(jnp.clip(ph, 0, n - 1), rank,
                                      dec_step)], -1)
        sp, ss, p_sorted = jax.lax.sort((prim, sec, p), num_keys=2)
        # scatter sorted positions back into the (ascending) slots
        dest = jnp.where(jcap < n_tied, slots, n)
        sa = sa.at[dest].set(p_sorted, mode="drop")
        # refined rank: start slot of each new (prim, sec) sub-run
        nb = jnp.concatenate([
            jnp.ones(1, bool),
            (sp[1:] != sp[:-1]) | (ss[1:] != ss[:-1])])
        rs = jax.lax.cummax(jnp.where(nb, dest, -1))
        rank = rank.at[jnp.where(
            jcap < n_tied, _rank_ix(p_sorted, rank, dec_step),
            rank.shape[0])].set(rs, mode="drop")
        # still tied: sub-run length > 1
        nxt_same = jnp.concatenate([rs[1:] == rs[:-1], jnp.zeros(1, bool)])
        prv_same = jnp.concatenate([jnp.zeros(1, bool), rs[1:] == rs[:-1]])
        still = (nxt_same | prv_same) & (jcap < n_tied)
        # compact the still-tied entries to the front with ONE stable
        # partition sort (dest is ascending, so slot order is preserved);
        # three cap-sized random scatters were ~10x slower here
        new_n = jnp.sum(still.astype(I32))
        _, new_slots, new_ps, new_prims = jax.lax.sort(
            ((~still).astype(jnp.int8), dest, p_sorted, rs),
            num_keys=1, is_stable=True)
        dead = jcap >= new_n
        new_slots = jnp.where(dead, n, new_slots)
        new_ps = jnp.where(dead, 0, new_ps)
        new_prims = jnp.where(dead, INT32_MAX, new_prims)
        # h doubles but is capped near n (any two distinct suffixes
        # differ within n symbols), which also keeps it in int32
        h_next = jnp.minimum(h, jnp.int32((n - 1) // 2 + 1))
        return (sa, rank, new_slots, new_ps, new_prims, new_n,
                h_next + h_next), None

    (sa, rank, slots, ps, prims, n_tied, _), _ = jax.lax.scan(
        one_round, (sa, rank, slots, ps, prims, n_tied, h0), None,
        length=rounds)
    return sa, rank, slots, ps, prims, n_tied


@functools.partial(jax.jit, static_argnames=("dec_step",),
                   donate_argnums=(0, 1))
def _full_round(sa: jax.Array, rank: jax.Array, h: jax.Array,
                direct_bound: jax.Array, dec_step: int = 0):
    """Fallback full-array doubling round for hyper-repetitive inputs
    whose tied set exceeds the subset capacity. The appended-half flag
    rides as a sort key after the group rank, preserving each group's
    direct-entries-first layout; the tied set stays direct-only
    (``direct_bound = n`` makes both a no-op for unflagged builds).
    With a dec-indexed rank, the inverse-permutation sort is keyed by
    the decimation permutation and extended over the tail rows so the
    refined ranks land positionally."""
    n = sa.shape[0]
    p = sa
    prim = rank[_rank_ix(p, rank, dec_step)]
    flagk = (p >= direct_bound).astype(I32)
    in_text = p < (n - h)
    ph = jnp.where(in_text, p, 0) + jnp.where(in_text, h, 0)
    sec = jnp.where(in_text,
                    rank[_rank_ix(jnp.clip(ph, 0, n - 1), rank,
                                  dec_step)], -1)
    sp, sf, ss, p_sorted = jax.lax.sort((prim, flagk, sec, p), num_keys=3)
    iota = jnp.arange(n, dtype=I32)
    nb = jnp.concatenate([
        jnp.ones(1, bool),
        (sp[1:] != sp[:-1]) | (sf[1:] != sf[:-1]) | (ss[1:] != ss[:-1])])
    rs = jax.lax.cummax(jnp.where(nb, iota, 0))
    if dec_step:  # n-row inverse perm + static assembly into [L]
        L = rank.shape[0]
        _, rs_c = jax.lax.sort(
            (_rank_ix(p_sorted, rank, dec_step), rs), num_keys=1)
        (rank,) = _assemble_dec([rs_c], dec_step, L, n)
    else:
        _, rank = jax.lax.sort((p_sorted, rs), num_keys=1)  # inverse perm
    nxt_same = jnp.concatenate([rs[1:] == rs[:-1], jnp.zeros(1, bool)])
    prv_same = jnp.concatenate([jnp.zeros(1, bool), rs[1:] == rs[:-1]])
    tied_slot = (nxt_same | prv_same) & (p_sorted < direct_bound)
    return p_sorted, rank, tied_slot


def _resolve_ties(sa, rank, tied_slot, n: int, k: int,
                  rounds_per_call: int, tied_cap: int | None,
                  lap=lambda *a: None, direct_bound: int | None = None,
                  dec_step: int = 0, n_tied_host: int | None = None):
    """Host-driven doubling loop until every (direct) suffix rank is
    distinct (shared by the whole-genome and windowed builds):
    full-array rounds while the tied set exceeds the subset capacity,
    then subset rounds with a shrinking slot buffer. ``dec_step``:
    nonzero when `rank` shares the tables' decimated layout (the
    whole-genome table build). ``n_tied_host``: precomputed tied count
    (the fused build already synced it for its bailout check — passing
    it here saves a host round trip)."""
    if tied_cap is None:
        tied_cap = max(1024, n // 8)
    if direct_bound is None:
        direct_bound = n
    if n_tied_host is None:
        n_tied_host = int(jnp.sum(tied_slot.astype(I32)))
    h = k
    lap(f"tied count ({n_tied_host})")
    # hyper-repetitive input: full-array rounds until the tied set
    # fits the subset capacity
    while n_tied_host > tied_cap and h < 2 * n:
        sa, rank, tied_slot = _full_round(
            sa, rank, jnp.int32(min(h, n)), jnp.int32(direct_bound),
            dec_step=dec_step)
        h = min(h * 2, 2 * n)
        n_tied_host = int(jnp.sum(tied_slot.astype(I32)))
        lap(f"full round h={h//2} ({n_tied_host} tied)")
    # subset rounds, with the slot buffer sized to the live tied set
    # (scatter cost is per-lane whether live or dropped) and shrunk
    # as ties resolve; positions/ranks ride along in slot space
    if n_tied_host > 0:
        cap = max(1024, _bucket_pow2(n_tied_host))
        slots, n_tied = _extract_tied(tied_slot, cap)
        ps, prims = _slot_payload(sa, rank, slots, n_tied,
                                  dec_step=dec_step)
        while n_tied_host > 0 and h < 2 * n:
            # small tied sets are dispatch-latency-bound: batch more
            # rounds per device call once the buffer is compact (each
            # host sync is a round trip)
            import os as _os
            big_cap = int(_os.environ.get("ASGART_ROUNDS_BIGCAP",
                                          1 << 20))
            if cap <= (1 << 17):
                rounds = max(rounds_per_call, 8)
            elif cap <= big_cap:
                # four rounds per call halve the host round trips
                # vs two. Above big_cap FEWER rounds per call: ties
                # collapse fast, so an early resync shrinks the cap
                # before most rounds run (scripts/rounds_probe.py
                # compares settings)
                rounds = max(rounds_per_call, 4)
            else:
                rounds = rounds_per_call
            sa, rank, slots, ps, prims, n_tied = _doubling_rounds(
                sa, rank, slots, ps, prims, n_tied, jnp.int32(min(h, n)),
                rounds, dec_step=dec_step)
            h = min(h << rounds, 2 * n)
            n_tied_host = int(n_tied)
            lap(f"rounds to h={h} cap={cap} ({n_tied_host} tied)")
            new_cap = max(1024, _bucket_pow2(n_tied_host))
            if n_tied_host and new_cap <= cap // 2:
                cap = new_cap
                slots = slots[:cap]
                ps = ps[:cap]
                prims = prims[:cap]
    return sa


# --- device-resident index cache ------------------------------------------
#
# A warm service rescanning a genome it has already indexed skips the
# build entirely: the index arrays stay resident in HBM between runs,
# keyed by a content fingerprint of the strand (plus every build
# parameter). MULTI-entry with MRU eviction: a sharded genome's window
# indexes (and their persisted stage-1 joins) all stay resident while
# the next build's projected transient peak still fits, so a service
# rescan of a --shards run skips every window build AND every stage-1
# co-sort. Entries are evicted (newest first — Belady's choice for the
# dominant cyclic w1..wS access pattern, see `cached_build`) BEFORE a
# new build so their buffers are freed when the build's sorts allocate.
# Free device memory comes from live allocator stats when the backend
# exposes them, else from `hbm_free_estimate`'s byte accounting over
# the tracked caches (the CPU backend exposes no memory_stats); the
# same multi-entry policy applies on both paths.
# `ASGART_DEVICE_INDEX_CACHE=0` disables.
#
# The on-disk analog is `--index-cache` (host engine); this is its
# device-memory counterpart for the device engine.

# caches whose device arrays `hbm_free_estimate` accounts for; the
# engine module registers its own (probe-key planes) at import
_TRACKED_CACHES: list = []

_DEVICE_INDEX_CACHE: dict = {}
_TRACKED_CACHES.append(_DEVICE_INDEX_CACHE)


def _strand_fingerprint(data: np.ndarray) -> tuple:
    """Content key of a strand: (blake2b over per-slice blake2b digests,
    slice size, length). hashlib releases the GIL above 2 KB, so the
    fixed-slice digests hash on every core (~0.13 s -> ~0.04 s at
    128 Mbp on this 4-core rig) — the dominant non-scan cost of a
    cache-served rescan. The slice size is part of the key, so the
    scheme stays injective per key shape."""
    import hashlib

    buf = memoryview(np.ascontiguousarray(data)).cast("B")
    n = len(buf)
    slice_bytes = 32 << 20
    if n <= slice_bytes:
        h = hashlib.blake2b(buf, digest_size=16)
        return (h.hexdigest(), int(n))
    import os
    from concurrent.futures import ThreadPoolExecutor

    starts = range(0, n, slice_bytes)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
            as ex:
        parts = list(ex.map(
            lambda s: hashlib.blake2b(buf[s:s + slice_bytes],
                                      digest_size=16).digest(),
            starts))
    h = hashlib.blake2b(b"".join(parts), digest_size=16)
    return (h.hexdigest(), slice_bytes, int(n))


def device_index_cache_enabled() -> bool:
    import os

    return os.environ.get("ASGART_DEVICE_INDEX_CACHE", "1") != "0"


# one-entry fingerprint-keyed cache of the uploaded genome codes: a
# warm service rescanning a sharded genome skips the host->device
# transfer even when window indexes had to be evicted
_CODES_CACHE: dict = {}
_TRACKED_CACHES.append(_CODES_CACHE)


def upload_codes_cached(strand_data: np.ndarray):
    """`DeviceIndex.upload_codes` behind the strand fingerprint."""
    if not device_index_cache_enabled():
        return DeviceIndex.upload_codes(strand_data)
    key = _strand_fingerprint(strand_data)
    hit = _CODES_CACHE.get(key)
    if hit is None:
        _CODES_CACHE.clear()
        hit = DeviceIndex.upload_codes(strand_data)
        _CODES_CACHE[key] = hit
    return hit


def _hbm_free_bytes_local():
    """Free device memory under :func:`hbm_budget_bytes` on the build
    device, or None without allocator stats (the CPU backend returns
    None — see :func:`hbm_free_estimate` for the accounting path)."""
    st = jax.local_devices()[0].memory_stats()
    if st and "bytes_in_use" in st:
        return hbm_budget_bytes() - int(st["bytes_in_use"])
    return None


def _tracked_cache_bytes() -> int:
    """Total device bytes reachable from the registered caches (index
    entries incl. their persisted stage-1 joins, codes uploads, probe
    planes), deduplicated by array identity — shared objects (e.g. the
    decimated doubled codes every window index references) count once."""
    seen: set = set()
    total = 0

    def walk(o, depth=0):
        nonlocal total
        if isinstance(o, jax.Array):
            if id(o) not in seen:
                seen.add(id(o))
                try:
                    total += o.nbytes
                except Exception:
                    pass
            return
        if depth > 4:
            return
        if isinstance(o, (list, tuple)):
            for v in o:
                walk(v, depth + 1)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v, depth + 1)
        elif hasattr(o, "__dict__"):
            for v in vars(o).values():
                walk(v, depth + 1)

    for cache in _TRACKED_CACHES:
        walk(cache)
    return total


def hbm_free_estimate() -> int:
    """Best available free-memory figure: live allocator stats when the
    backend exposes them (a GPU does), else budget minus the bytes the
    persistent caches are known to hold (the CPU tier) — that sees
    everything long-lived (cached indexes, stage-1 joins, codes, probe
    planes); per-run transients are the projection's own subject."""
    live = _hbm_free_bytes_local()
    if live is not None:
        return live
    return hbm_budget_bytes() - _tracked_cache_bytes()


def _build_peak_bytes(builder, strand_data, kwargs) -> int:
    """Projected transient HBM peak of one index build (used to decide
    how much cache to evict before building). Deliberately EXCLUDES the
    genome codes: they are tracked by `hbm_free_estimate` once any
    cache entry exists (the decimated doubled codes ride on cached
    window indexes, the plain codes in the upload cache), and when
    nothing is cached yet the eviction decision is vacuous — counting
    them here double-charged window builds and thrashed the rescan
    regime's residency."""
    n1 = int(len(strand_data))
    trim = kwargs.get("trim")
    specs = kwargs.get("specs")
    if specs is not None:
        # fused-probe build: (W + B)-row transients — W is the trim
        # window for FUSED WINDOW builds (checking trim first here
        # would project the window rows alone and under-evict by the
        # whole probe side)
        B = sum(nc for (_, _, nc) in specs) + (1 << 21)
        W = int(trim[1]) - int(trim[0]) + 1 if trim is not None else n1
        return FUSED_PEAK_BYTES_PER_ROW * (W + B)
    if trim is not None:
        W = int(trim[1]) - int(trim[0]) + 1
        return WINDOW_PEAK_BYTES_PER_ROW * W
    doubled = kwargs.get("reverse") or kwargs.get("complement")
    n = 2 * n1 - 1 if doubled else n1
    return BUILD_PEAK_BYTES_PER_ROW * n


def cached_build(builder, strand_data: np.ndarray, params: tuple,
                 **kwargs):
    """Build-or-reuse a device index. ``builder`` is the classmethod
    (``DeviceIndex.build`` / ``DeviceWindowIndex.build``); ``params``
    must capture every build-affecting argument; ``kwargs`` pass through
    to the builder on a miss.

    The cache is MULTI-entry with MRU eviction (see the eviction loop
    below — the cyclic w1..wS access pattern makes the most-recently-
    used entry Belady's victim): a warm service rescanning a
    ``--shards`` genome keeps every window's index (and its persisted
    stage-1 join) resident as long as the next build's projected
    transient peak still fits — window 2's build no longer
    unconditionally evicts window 1. Free-HBM checks use live allocator
    stats when available, else `hbm_free_estimate`'s byte accounting
    over the tracked caches; eviction applies on both paths."""
    if not device_index_cache_enabled():
        return builder(strand_data, *params, **kwargs)
    key = (builder.__qualname__, _strand_fingerprint(strand_data),
           params, tuple(sorted(
               (k, v) for k, v in kwargs.items()
               if k not in ("codes_device",))))
    hit = _DEVICE_INDEX_CACHE.get(key)
    if hit is not None:
        # LRU freshness: re-insert at the end
        _DEVICE_INDEX_CACHE.pop(key, None)
        _DEVICE_INDEX_CACHE[key] = hit
        return hit
    need = _build_peak_bytes(builder, strand_data, kwargs) + (1 << 29)
    while _DEVICE_INDEX_CACHE and hbm_free_estimate() < need:
        # MRU eviction: the dominant multi-entry pattern is a sharded
        # run's windows accessed CYCLICALLY (w1..wS, then again on the
        # next service scan), where LRU is the worst possible policy
        # (it evicts exactly the entry needed soonest; a 1024 Mbp
        # rescan rebuilt all 6 windows). The most-recently-used entry
        # is the one whose next cyclic access is furthest away —
        # Belady's choice for this pattern. Hits re-insert at the dict
        # end, so the victim is the LAST key.
        _DEVICE_INDEX_CACHE.pop(next(reversed(_DEVICE_INDEX_CACHE)))
    idx = builder(strand_data, *params, **kwargs)
    _DEVICE_INDEX_CACHE[key] = idx
    return idx


@dataclass
class DeviceIndex:
    """Device-resident doubled-text position index (the on-device analog
    of :class:`asgart_tpu.index.PositionIndex`)."""

    sa: jax.Array        # [n] int32, suffix order over the (doubled) text
    pos_lo: jax.Array    # [n] int32 per-position range start
    pos_hi: jax.Array    # [n] int32 per-position range end
    codes: jax.Array     # [n + k] uint8 text codes, zero padded
    k: int
    n: int               # doubled text length
    first_len: int       # genome + '$' length
    reverse: bool
    complement: bool

    @staticmethod
    def upload_codes(strand_data: np.ndarray) -> jax.Array:
        """Start the (async) upload of the strand's symbol codes. A
        caller that knows the strand early — e.g. while input parsing or
        other host-side work is still running — can overlap the
        host->device transfer and pass the handle to
        :meth:`build` via ``codes_device``. ACGT travels 2-bit packed
        (4x fewer bytes) with a sparse exception scatter for $/N/other;
        the returned array is the exact 1 B/bp code stream either way."""
        packed = pack_codes_host(strand_data)
        if packed is None:  # exception-dense: plain upload wins
            return jax.device_put(CODE[strand_data])
        p, exc_pos, exc_code, n1 = packed
        return _unpack_codes(jax.device_put(p), jax.device_put(exc_pos),
                             jax.device_put(exc_code), n1)

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int, reverse: bool = False,
              complement: bool = False, rounds_per_call: int = 2,
              tied_cap: int | None = None,
              codes_device: jax.Array | None = None) -> "DeviceIndex":
        """Build from the host strand bytes (genome + '$'). Only the
        symbol codes (1 B/bp) cross the host->device boundary
        (pre-uploadable via :meth:`upload_codes`)."""
        import os
        import time

        prof = os.environ.get("ASGART_DEVICE_PROFILE")
        t0 = time.time()

        def lap(what, *sync):
            nonlocal t0
            if not prof:
                return
            jax.block_until_ready(sync)
            now = time.time()
            print(f"[didx] {what}: {now - t0:.2f}s", flush=True)
            t0 = now

        if not (1 <= k <= DEVICE_MAX_K_TABLE):
            raise ValueError(
                f"device table index supports probe_size 1.."
                f"{DEVICE_MAX_K_TABLE} (three int32 key planes); use "
                "the host engine for wider probes")
        n1 = int(len(strand_data))
        n = 2 * n1 - 1 if (reverse or complement) else n1
        if n >= (1 << 31):
            raise ValueError(
                "device index shard too large for int32; shard the index")
        if codes_device is not None:
            codes1 = codes_device
        else:
            codes1 = cls.upload_codes(strand_data)  # the bulk upload
        lap("upload", codes1)

        from .device_engine import table_len_for

        L = table_len_for(n, k)  # padded table length, step*SLABS-exact
        text_codes = _build_text_codes(codes1, k, reverse, complement, L)
        lap("text", text_codes)
        doubled = n != n1
        if k > DEVICE_MAX_K:
            # k = 21..30: third key plane; tables/doubling/scan are
            # k-generic past the grouping
            key_top, key_hi, key_lo = _pack_planes3_all(text_codes, k, n)
            lap("pack", key_hi)
            if doubled:
                sktop, skhi, sklo, sa = _flagged_sort3(
                    key_top, key_hi, key_lo, jnp.int32(n1))
            else:
                sktop, skhi, sklo, sa = _initial_sort3(
                    key_top, key_hi, key_lo)
            del key_top, key_hi, key_lo  # donated into the sort
            lap("sort", sa)
            run_lo, run_hi, tied_slot = _group_bounds3(
                skhi, sklo, sa, jnp.int32(n1), flagged=doubled,
                flag_n_k=k, sktop=sktop)
            # skhi/sklo donated into the bounds pass; sktop freed here
            del sktop, skhi, sklo
        else:
            key_hi, key_lo = _pack_planes_all(text_codes, k, n)
            lap("pack", key_hi)
            if doubled:
                # appended-half flag in the low plane's spare bit:
                # windows cover only matchable (first-half) entries and
                # ties resolve only among them (see _group_bounds_impl)
                skhi, sklo, sa = _flagged_sort(key_hi, key_lo,
                                               jnp.int32(n1))
            else:
                skhi, sklo, sa = _initial_sort(key_hi, key_lo)
            del key_hi, key_lo  # donated into the sort
            lap("sort", sa)
            run_lo, run_hi, tied_slot = _group_bounds(
                skhi, sklo, sa, jnp.int32(n1), flagged=doubled,
                flag_n_k=k)
            del skhi, sklo  # donated into the bounds pass
        # decimated tables, padded so the engine's contiguous probe-row
        # reads never clamp (padded lanes read zero ranges,
        # probe-masked away), with the N-probe flag in pos_lo's sign bit
        pos_lo, pos_hi, rank = _invert_tables_dec(sa, run_lo, run_hi,
                                                  k // 2, L)
        # NOT donated into the inversion: its [L]-padded outputs can
        # never alias the [n] inputs (XLA would warn on every build);
        # the del frees them once the dispatched sort completes
        del run_lo, run_hi
        lap("tables", rank, pos_hi)

        sa = _resolve_ties(sa, rank, tied_slot, n, k, rounds_per_call,
                           tied_cap, lap, direct_bound=n1,
                           dec_step=k // 2)

        return cls(sa=sa, pos_lo=pos_lo, pos_hi=pos_hi, codes=text_codes,
                   k=k, n=n, first_len=n1, reverse=reverse,
                   complement=complement)

    def to_host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(sa, ranges[n,2]) as numpy — test/diagnostic use only (bulk
        device->host downloads are slow on this rig). Un-decimates the
        tables and strips the N-flag sign bit, so the result is directly
        comparable to the host ``PositionIndex``."""
        step = self.k // 2
        lo_dec = np.asarray(self.pos_lo)
        hi_dec = np.asarray(self.pos_hi)
        C = lo_dec.shape[0] // step
        lo = lo_dec.reshape(step, C).T.ravel()[: self.n] & 0x7FFFFFFF
        hi = hi_dec.reshape(step, C).T.ravel()[: self.n]
        return np.asarray(self.sa), np.stack([lo, hi], axis=1)


# one-entry cache of the decimated doubled probe codes: identical for
# every window of a sharded run (keyed by strand content + transform),
# and its n-row decimation sort is the window build's largest pass
_DEC_CODES_CACHE: dict = {}


def _shared_decimated_codes(codes1: jax.Array, strand_data: np.ndarray,
                            k: int, reverse: bool, complement: bool,
                            n: int) -> jax.Array:
    from .device_engine import table_len_for

    L2 = table_len_for(n, k)
    key = None
    if device_index_cache_enabled():
        key = (_strand_fingerprint(strand_data), k, reverse, complement)
        hit = _DEC_CODES_CACHE.get(key)
        if hit is not None:
            return hit
    out = decimate_codes_auto(
        _build_text_codes(codes1, k, reverse, complement, L2 - k),
        k // 2, L2, n + k)
    if key is not None:
        _DEC_CODES_CACHE.clear()
        _DEC_CODES_CACHE[key] = out
    return out


@functools.partial(jax.jit, static_argnames=("w_text", "k"))
def _window_codes(codes1: jax.Array, win_start, w_text: int, k: int):
    """Symbol codes of the window text ``strand[ws:we] + '$'`` with k
    zero padding (the '$' rank and the padding are both 0, reproducing
    the host GenomeIndex's window-truncated packing)."""
    out = jnp.zeros(w_text + 1 + k, dtype=jnp.uint8)
    return out.at[:w_text].set(
        jax.lax.dynamic_slice(codes1, (win_start,), (w_text,)))


def window_arrays_from_codes(win_codes: jax.Array, k: int, W: int,
                             rounds_per_call: int = 2,
                             tied_cap: int | None = None,
                             lap=lambda *a: None):
    """Index-side arrays for one window text of length ``W`` (incl. its
    '$') from already-device-resident window codes: (key_hi, key_lo,
    run_lo, sa_rel) — sorted two-plane keys, slot-indexed run starts,
    and the WINDOW-RELATIVE suffix order."""
    key_hi, key_lo = _pack_planes_all(win_codes, k, W)
    lap("pack", key_hi)
    skhi, sklo, sa = _initial_sort(key_hi, key_lo)
    del key_hi, key_lo  # donated into the sort
    # skhi/sklo stay resident (merge-join lookups read them), so the
    # keep-variant; the unflagged run_lo doubles as the slot-indexed
    # lo-bound table
    run_lo, _, tied_slot = _group_bounds_keep(skhi, sklo, sa,
                                              jnp.int32(W))
    rank = _invert_perm(sa, run_lo)
    lap("sort+groups", sa, run_lo)

    sa = _resolve_ties(sa, rank, tied_slot, W, k, rounds_per_call,
                       tied_cap, lap)
    return skhi, sklo, run_lo, sa


def build_window_arrays(codes1: jax.Array, k: int, ws: int, we: int,
                        rounds_per_call: int = 2,
                        tied_cap: int | None = None,
                        lap=lambda *a: None):
    """Index-side arrays for one trim window ``strand[ws:we] + '$'``:
    (key_hi, key_lo, run_lo, sa_global, W) — sorted two-plane keys,
    slot-indexed run starts, and the window suffix order with positions
    already globalized. Shared by :class:`DeviceWindowIndex` and the
    composed (windows x probes) mesh engine."""
    w_text = we - ws
    W = w_text + 1
    win_codes = _window_codes(codes1, jnp.int32(ws), w_text, k)
    skhi, sklo, run_lo, sa = window_arrays_from_codes(
        win_codes, k, W, rounds_per_call=rounds_per_call,
        tied_cap=tied_cap, lap=lap)
    return skhi, sklo, run_lo, sa + jnp.int32(ws), W


@dataclass
class DeviceWindowIndex:
    """Device-resident *windowed* index for ``--trim`` runs (reference
    trim semantics, asgart.rs:142-148: SA over the window only, the whole
    genome probed against it — the memory-bounded scale-out unit).

    Unlike :class:`DeviceIndex`, probe k-mers are not positions of the
    indexed text, so lookups are by value: the engine co-sorts probe keys
    with the window's sorted keys (a merge join — one ``lax.sort`` per
    probe batch instead of per-probe binary search, which would be
    latency-bound on random HBM gathers). Held device-side:

      * ``key_hi``/``key_lo`` [W]: sorted two-plane k-mer keys of every
        window position (aligned with ``sa`` — doubling permutes only
        within equal-key runs);
      * ``sa`` [W]: suffix order, positions already global;
      * ``codes``: the needle-addressable (doubled) genome codes in
        decimated layout, used to pack probe keys by contiguous row
        reads (`device_engine._dec_read`).
    """

    key_hi: jax.Array
    key_lo: jax.Array
    sa: jax.Array        # [W] int32 global positions, suffix order
    codes: jax.Array     # [n + pad] uint8 doubled text codes
    k: int
    n: int               # doubled text length (probe-addressable)
    first_len: int       # genome + '$' length
    W: int               # window text length incl. its own '$'
    win_start: int
    win_end: int
    reverse: bool
    complement: bool

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int,
              trim: tuple[int, int], reverse: bool = False,
              complement: bool = False, rounds_per_call: int = 2,
              tied_cap: int | None = None,
              codes_device: jax.Array | None = None
              ) -> "DeviceWindowIndex":
        import os
        import time

        prof = os.environ.get("ASGART_DEVICE_PROFILE")
        t0 = time.time()

        def lap(what, *sync):
            nonlocal t0
            if not prof:
                return
            jax.block_until_ready(sync)
            now = time.time()
            print(f"[widx] {what}: {now - t0:.2f}s", flush=True)
            t0 = now

        check_probe_size(k)
        if k > DEVICE_MAX_K:
            raise ValueError(
                f"device index supports probe_size <= {DEVICE_MAX_K} "
                "(two int32 key planes); use the host engine")
        ws, we = int(trim[0]), int(trim[1])
        n1 = int(len(strand_data))
        if not (0 <= ws < we <= n1 - 1):
            raise ValueError(f"bad trim window {trim}")
        n = 2 * n1 - 1 if (reverse or complement) else n1
        if n >= (1 << 31):
            raise ValueError(
                "genome too large for int32 probe addressing; "
                "use more trim windows per host")
        if codes_device is not None:
            codes1 = codes_device
        else:
            codes1 = DeviceIndex.upload_codes(strand_data)
        lap("upload", codes1)

        # probe-side: the needle-addressable doubled text in DECIMATED
        # layout (probes pack by k contiguous row reads — `_dec_read`).
        # IDENTICAL for every window of a sharded run, and its n-row
        # decimation sort costs ~5.6 s at 1G rows (512 Mbp -RC) — so it
        # is cached once per (content, k, transform) and SHARED across
        # the windows' builds (HBM: one copy instead of one per window)
        text_codes = _shared_decimated_codes(
            codes1, strand_data, k, reverse, complement, n)
        lap("decimated codes", text_codes)
        skhi, sklo, run_lo, sa, W = build_window_arrays(
            codes1, k, ws, we, rounds_per_call=rounds_per_call,
            tied_cap=tied_cap, lap=lap)
        del run_lo  # build-internal (doubling rank seed); the merge
        # join derives lo from the co-sorted run structure (_mj_tail)
        return cls(key_hi=skhi, key_lo=sklo, sa=sa,
                   codes=text_codes, k=k, n=n, first_len=n1, W=W,
                   win_start=ws, win_end=we, reverse=reverse,
                   complement=complement)


# --- fused-probe index ----------------------------------------------------
#
# The whole-genome build and the probe join FUSED into one sort: the
# direct text's n1 key rows co-sort with the ~n1/step probe-lane keys
# (flagged, exactly as the doubled build flags its appended half), so
# per-lane equal-ranges fall out of the same sort + inversion that
# builds the SA. Replaces the doubled-text design's two 2*n1-row sorts
# (the appended half existed only to be probed — but only every step-th
# appended position ever IS a probe) with two (n1 + B)-row sorts,
# B = sum of chunk lane counts ~ n1/step, and no separate stage 1.
# Reference analog: one SA + per-probe equal-range search
# (searcher.rs:99-171); same output, one-pass device formulation.


class FusedTiedOverflow(RuntimeError):
    """The tied set is too large for subset-only doubling (the fused
    slot layout cannot run `_full_round` — probe rows carry lane ids,
    not text positions, so a full-array re-sort would scramble them).
    Callers fall back to the classic doubled-table build."""


@functools.partial(jax.jit, static_argnames=("k", "reverse", "complement",
                                             "pad_to"))
def _transformed_codes(codes: jax.Array, k: int, reverse: bool,
                       complement: bool, pad_to: int) -> jax.Array:
    """The APPENDED-half codes alone, zero padded to [pad_to + k]:
    position q here = doubled-text position first_len + q
    (`_build_text_codes` transform order: complement, then reverse)."""
    n1 = codes.shape[0]
    half = codes[: n1 - 1]
    if complement:
        half = jnp.asarray(COMP_CODE)[half]
    if reverse:
        half = half[::-1]
    return jnp.zeros(pad_to + k, dtype=jnp.uint8).at[: n1 - 1].set(half)


@jax.jit
def _fused_cat_planes(key_hi: jax.Array, key_lo: jax.Array,
                      phi: jax.Array, plo: jax.Array):
    """Concatenate direct-row and probe-row key planes for the fused
    flagged sort (no donation: a [n1 + B] output can never alias the
    [n1]/[B] inputs — the caller's `del` frees them at dispatch). Probe sentinel pads arrive as INT32_MAX on both
    planes; the low plane is clamped to the 30-bit key ceiling (symbol
    ranks are <= 5, so the all-sevens value can never collide with a
    real key) to keep `_flagged_sort`'s flag shift overflow-free. The
    fused sort itself IS `_flagged_sort` with direct_bound = n1: probe
    rows sit at iota >= n1 by this concatenation order, exactly where
    the doubled build's appended half sat — a probe row's payload
    n1 + lane carries its lane id through the sort."""
    return (jnp.concatenate([key_hi, phi]),
            jnp.concatenate([key_lo,
                             jnp.minimum(plo,
                                         jnp.int32((1 << 30) - 1))]))


@jax.jit
def _fused_cat_planes3(key_top, key_hi, key_lo, ptop, phi, plo):
    """3-plane `_fused_cat_planes` (k = 21..30)."""
    return (jnp.concatenate([key_top, ptop]),
            jnp.concatenate([key_hi, phi]),
            jnp.concatenate([key_lo,
                             jnp.minimum(plo,
                                         jnp.int32((1 << 30) - 1))]))


@functools.partial(jax.jit, donate_argnums=(0,))
def _offset_i32(x: jax.Array, off) -> jax.Array:
    return x + off


# one-entry cache of the fused builds' decimated probe-source codes
# (appended half for transformed runs): identical for every window of
# a sharded run, keyed by (content, k, transform)
_FUSED_DEC_CACHE: dict = {}
_TRACKED_CACHES.append(_FUSED_DEC_CACHE)


@functools.partial(jax.jit, static_argnames=("step", "L1", "n1",
                                             "specs"))
def _invert_fused(sa: jax.Array, lo: jax.Array, hi: jax.Array,
                  lane_mask: jax.Array, step: int, L1: int, n1: int,
                  specs: tuple = ()):
    """ONE inversion sort delivers both build outputs: direct rows
    (sa < n1) key by their decimated position — the first n1 sorted
    entries are the dec-sorted rank stream (assembled into the [L1]
    decimated rank array the doubling reads) — and probe rows key by
    L1 + lane, so the tail is the per-lane (lo, hi) windows already in
    lane order. The doubled design needed a 2*n1-row inversion plus the
    windowed engines' separate back-sorts for the same information.
    The per-chunk raw totals (cap sizing) are fused in as well — one
    dispatch instead of two."""
    M = sa.shape[0]
    C1 = L1 // step
    ikey = jax.lax.optimization_barrier(
        jnp.where(sa < n1, _dec_of(sa, step, C1), L1 + (sa - n1)))
    _, lo_c, hi_c = jax.lax.sort((ikey, lo, hi), num_keys=1)
    (rank,) = _assemble_dec([jax.lax.slice(lo_c, (0,), (n1,))],
                            step, L1, n1)
    lane_lo = jax.lax.slice(lo_c, (n1,), (M,))
    lane_hi = jax.lax.slice(hi_c, (n1,), (M,))
    totals = _fused_lane_totals(lane_lo, lane_hi, lane_mask, specs)
    return rank, lane_lo, lane_hi, totals


@functools.partial(jax.jit, static_argnames=("specs",))
def _fused_lane_totals(lane_lo, lane_hi, lane_mask, specs: tuple):
    """Per-chunk exact raw-match sums over the fused lane windows
    (the cap-sizing input, `_mj_ranges_impl` semantics)."""
    if not specs:
        return jnp.zeros(0, dtype=jnp.float32)
    counts = jnp.where(lane_mask, lane_hi - lane_lo, 0) \
        .astype(jnp.float32)
    off = 0
    totals = []
    for (_, _, nc) in specs:
        totals.append(jnp.sum(jax.lax.dynamic_slice(counts, (off,),
                                                    (nc,))))
        off += nc
    return jnp.stack(totals)


# fused transient high-water per (n1 + B) row: the 3-operand sorts'
# in + out + scratch (35 B) next to the resident sa/lane outputs and
# the decimated probe source + codes (~2.2 B/row equivalent)
FUSED_PEAK_BYTES_PER_ROW = 46

# tied sets above max(M // 4, this) bail out of the fused build (see
# FusedTiedOverflow); module-level so tests can exercise the fallback
FUSED_TIED_BAILOUT_MIN = 1 << 20


def fused_fits(n1: int, k: int = 20) -> bool:
    """Whether a fused-probe whole-genome build fits one device (routing
    estimate: B ~ n1/(k//2) probe lanes plus bucket slack)."""
    step = max(1, k // 2)
    M = n1 + n1 // step + (1 << 21)
    return M < (1 << 31) and \
        M * FUSED_PEAK_BYTES_PER_ROW <= hbm_budget_bytes()


@dataclass
class FusedIndex:
    """Device-resident fused-probe index: the suffix order over the
    DIRECT text (probe rows interleaved as flagged slots) plus the
    per-probe-lane equal-range windows for a fixed chunk set, all from
    one build. The scan consumes (lane_lo, lane_hi, lane_mask) as
    contiguous lane slices — no per-position tables, no key-plane
    residency, no stage-1 join."""

    sa: jax.Array         # [W + B] int32; indexed (direct) slots hold
    #                       GLOBAL positions, probe slots hold W + lane
    #                       (never gathered — windows span direct runs)
    lane_lo: jax.Array    # [B] int32 window starts, lane order
    lane_hi: jax.Array    # [B] int32 window ends
    lane_mask: jax.Array  # [B] bool live-probe mask (N-skip + bound)
    specs: tuple          # ((chunk_start, chunk_len, n_lanes), ...)
    offs: dict            # chunk -> (lane_offset, float_raw_total)
    k: int
    n: int                # doubled text length (probe addressing)
    first_len: int        # genome + '$' length
    reverse: bool
    complement: bool
    trim: tuple | None = None  # (ws, we) for windowed builds

    @classmethod
    def build(cls, strand_data: np.ndarray, k: int, specs: tuple = (),
              reverse: bool = False, complement: bool = False,
              trim: tuple | None = None,
              rounds_per_call: int = 2, tied_cap: int | None = None,
              codes_device: jax.Array | None = None) -> "FusedIndex":
        import os
        import time

        prof = os.environ.get("ASGART_DEVICE_PROFILE")
        t0 = time.time()

        def lap(what, *sync):
            nonlocal t0
            if not prof:
                return
            jax.block_until_ready(sync)
            now = time.time()
            print(f"[fidx] {what}: {now - t0:.2f}s", flush=True)
            t0 = now

        if not (1 <= k <= DEVICE_MAX_K_TABLE):
            raise ValueError(
                f"fused index supports probe_size 1.."
                f"{DEVICE_MAX_K_TABLE} (three int32 key planes); use "
                "the host engine for wider probes")
        n1 = int(len(strand_data))
        doubled = reverse or complement
        n = 2 * n1 - 1 if doubled else n1
        if n >= (1 << 31):
            raise ValueError(
                "genome too large for int32 probe addressing; shard")
        from .device_engine import (_bucket, _pack_batch_probe_keys,
                                    _pack_batch_probe_keys3, _probe_x0,
                                    table_len_for)

        if trim is not None:
            ws, we = int(trim[0]), int(trim[1])
            if not (0 <= ws < we <= n1 - 1):
                raise ValueError(f"bad trim window {trim}")
            W = we - ws + 1  # window text + its own '$'
        else:
            ws = 0
            W = n1
        step = k // 2
        sum_nc = sum(nc for (_, _, nc) in specs)
        # lane-array slack: any scan read is (off_c, b_pad_c) with
        # b_pad_c the chunk's lane bucket, so the worst overhang past
        # sum_nc is the largest single (bucket - nc) gap — NOT a whole
        # bucket (which would add millions of dead sort rows at
        # chromosome scale)
        tail_pad = (max((_bucket(nc) - nc for (_, _, nc) in specs),
                        default=1 << 16)) + 8
        total = sum_nc + tail_pad
        if W + total >= (1 << 31):
            raise ValueError("fused index too large for int32 slots")

        if codes_device is not None:
            codes1 = codes_device
        else:
            codes1 = DeviceIndex.upload_codes(strand_data)
        lap("upload", codes1)

        # probe-source codes in decimated layout: the appended half
        # alone for transformed runs (probes never read the direct
        # half), the direct text itself otherwise. IDENTICAL for every
        # window of a sharded run — cached per (content, k, transform)
        base = n1 if doubled else 0
        n_src = n - base
        Lp = table_len_for(n_src, k)
        dkey = None
        dec_src = None
        if device_index_cache_enabled():
            dkey = (_strand_fingerprint(strand_data), k, reverse,
                    complement)
            dec_src = _FUSED_DEC_CACHE.get(dkey)
        if dec_src is None:
            if doubled:
                src = _transformed_codes(codes1, k, reverse, complement,
                                         Lp)
            else:
                src = _build_text_codes(codes1, k, False, False, Lp)
            dec_src = decimate_codes_auto(src, step=step, L=Lp,
                                          n=n_src)
            del src
            if dkey is not None:
                _FUSED_DEC_CACHE.clear()
                _FUSED_DEC_CACHE[dkey] = dec_src
        lap("decimate", dec_src)

        x0s = tuple(
            int(_probe_x0(cs, cl, n1, k, reverse, complement)) - base
            for (cs, cl, _) in specs)
        j0s = jnp.zeros(max(len(specs), 1), I32)
        planes3 = k > DEVICE_MAX_K
        if planes3:
            ptop, phi, plo, lane_mask = _pack_batch_probe_keys3(
                dec_src, j0s, k, reverse, complement, n1, specs, total,
                x0s=x0s)
        else:
            phi, plo, lane_mask = _pack_batch_probe_keys(
                dec_src, j0s, k, reverse, complement, n1, specs, total,
                x0s=x0s)
        del dec_src

        # indexed-text key planes (elementwise shifted reads): the
        # whole direct text, or the trim window's own text + '$'
        if trim is not None:
            text_codes = _window_codes(codes1, jnp.int32(ws), W - 1, k)
        else:
            text_codes = _build_text_codes(codes1, k, False, False, W)
        if planes3:
            key_top, key_hi, key_lo = _pack_planes3_all(text_codes, k, W)
        else:
            key_hi, key_lo = _pack_planes_all(text_codes, k, W)
        del text_codes
        lap("pack", key_hi)

        if planes3:
            cktop, ckhi, cklo = _fused_cat_planes3(key_top, key_hi,
                                                   key_lo, ptop, phi,
                                                   plo)
            del key_top, key_hi, key_lo, ptop, phi, plo
            sktop, skhi, sklo, sa = _flagged_sort3(cktop, ckhi, cklo,
                                                   jnp.int32(W))
            del cktop, ckhi, cklo  # donated into the sort
            lap("sort", sa)
            run_lo, run_hi, tied_slot = _group_bounds3(
                skhi, sklo, sa, jnp.int32(W), flagged=True, sktop=sktop)
            del sktop, skhi, sklo
        else:
            ckhi, cklo = _fused_cat_planes(key_hi, key_lo, phi, plo)
            del key_hi, key_lo, phi, plo  # freed at concat dispatch
            skhi, sklo, sa = _flagged_sort(ckhi, cklo, jnp.int32(W))
            del ckhi, cklo  # donated into the sort
            lap("sort", sa)
            run_lo, run_hi, tied_slot = _group_bounds(
                skhi, sklo, sa, jnp.int32(W), flagged=True)
            del skhi, sklo  # donated into the bounds pass
        L1 = table_len_for(W, k)
        rank, lane_lo, lane_hi, totals_dev = _invert_fused(
            sa, run_lo, run_hi, lane_mask, step, L1, W, specs=specs)
        del run_lo, run_hi
        lap("tables", rank, lane_hi)

        M = W + total
        n_tied = int(jnp.sum(tied_slot.astype(I32)))
        lap(f"tied count ({n_tied})")
        if n_tied > max(M // 4, FUSED_TIED_BAILOUT_MIN):
            # subset-only doubling would thrash at this tied density
            # and `_full_round` is unsafe in the fused layout
            raise FusedTiedOverflow(
                f"{n_tied} tied slots of {M}")
        # tied_cap >= the live count forbids full-array rounds (see
        # FusedTiedOverflow): subset rounds handle any count exactly
        sa = _resolve_ties(sa, rank, tied_slot, M, k, rounds_per_call,
                           max(1024, n_tied) if tied_cap is None
                           else tied_cap,
                           lap, direct_bound=W, dec_step=step,
                           n_tied_host=n_tied)
        if ws:
            # globalize window positions (probe slots shift too —
            # harmless, they are never gathered)
            sa = _offset_i32(sa, jnp.int32(ws))

        totals = np.asarray(totals_dev, dtype=np.float64)
        offs = {}
        off = 0
        for i, (cs, cl, nc) in enumerate(specs):
            offs[(cs, cl)] = (off, float(totals[i]))
            off += nc
        lap("totals")
        return cls(sa=sa, lane_lo=lane_lo, lane_hi=lane_hi,
                   lane_mask=lane_mask, specs=specs, offs=offs, k=k,
                   n=n, first_len=n1, reverse=reverse,
                   complement=complement,
                   trim=(ws, we) if trim is not None else None)
