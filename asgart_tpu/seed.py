"""On-device seed lookup: batched probe k-mer search on the device.

Data-parallel redesign of the reference's probe loop (``src/searcher.rs``):
instead of byte-compare binary search per probe on a CPU thread, probes are
processed in large data-parallel batches:

  * packed k-mers are split into two int32 *planes* (high/low 30 bits) so
    the whole search runs in native 32-bit integer ops — x64 stays off
    (requires k ≤ 20 symbols · 3 bits = 60 bits; larger k falls
    back to the host engine),
  * a dense prefix-bucket table (the device analog of the reference's 5^8
    8-mer cache, searcher.rs:99-143) narrows each probe to a small SA
    interval with one gather,
  * a branchless fixed-depth binary search (lexicographic two-plane
    compare) finds the exact equal-range; every step is one gather over
    the batch — bandwidth-bound, massively parallel,
  * probe k-mers themselves are packed on device from the needle codes.

Positions are int32: one index shard must stay < 2^31 entries (whole-genome
scale is reached by sharding the index across devices/hosts, not by wider
indices).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .index import GenomeIndex

LO_BITS = 30
LO_MASK = (1 << LO_BITS) - 1
DEFAULT_BATCH = 1 << 20


def split_planes(kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 packed k-mers → (hi, lo) int32 planes."""
    hi = (kmers >> LO_BITS).astype(np.int32)
    lo = (kmers & LO_MASK).astype(np.int32)
    return hi, lo


@functools.partial(jax.jit, static_argnames=("k",))
def pack_probe_planes(codes: jax.Array, positions: jax.Array, k: int):
    """Pack k 3-bit symbols starting at each position into (hi, lo) planes.

    ``codes`` is the needle symbol array (int8/uint8 ranks, zero-padded by
    at least k), ``positions`` the probe indices.
    """
    n_hi = max(k - 10, 0)  # symbols in the high plane
    hi = jnp.zeros(positions.shape, dtype=jnp.int32)
    lo = jnp.zeros(positions.shape, dtype=jnp.int32)
    c = codes.astype(jnp.int32)
    for j in range(n_hi):
        hi = (hi << 3) | c[positions + j]
    for j in range(n_hi, k):
        lo = (lo << 3) | c[positions + j]
    return hi, lo


def _lex_lt(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def _lex_le(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


@functools.partial(jax.jit, static_argnames=("steps", "prefix_shift"))
def equal_range(
    key_hi: jax.Array, key_lo: jax.Array,       # [N] sorted two-plane keys
    bucket_starts: jax.Array,                   # [2^pb + 1] int32
    probe_hi: jax.Array, probe_lo: jax.Array,   # [B]
    steps: int, prefix_shift: int,
):
    """Vectorized equal-range: per probe, the SA interval [lo, hi) whose
    packed k-mers equal the probe's. Fixed-depth branchless binary search
    seeded by the prefix buckets."""
    if prefix_shift >= 0:
        prefix = (probe_hi >> prefix_shift).astype(jnp.int32)
        lo0 = bucket_starts[prefix]
        hi0 = bucket_starts[prefix + 1]
    else:
        n = key_hi.shape[0]
        lo0 = jnp.zeros(probe_hi.shape, dtype=jnp.int32)
        hi0 = jnp.full(probe_hi.shape, n, dtype=jnp.int32)

    def search(le, lo, hi):
        # invariant: keys[lo-1] ⟨cmp⟩ probe ≤/< keys[hi].
        # fori_loop (not Python unrolling): compile time must not scale
        # with the search depth, which an unrolled gather chain would.
        def body(_, carry):
            lo, hi = carry
            live = lo < hi  # converged lanes must not move (and their
            # clamped OOB gathers must be ignored)
            mid = (lo + hi) >> 1
            khi = key_hi[mid]
            klo = key_lo[mid]
            if le:
                go_right = _lex_le(khi, klo, probe_hi, probe_lo)
            else:
                go_right = _lex_lt(khi, klo, probe_hi, probe_lo)
            lo = jnp.where(live & go_right, mid + 1, lo)
            hi = jnp.where(live & ~go_right, mid, hi)
            return (lo, hi)

        lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
        return lo

    left = search(False, lo0, hi0)
    right = search(True, lo0, hi0)
    return left, right


@jax.jit
def _gather_tables(pos_lo: jax.Array, pos_hi: jax.Array, x: jax.Array):
    return pos_lo[x], pos_hi[x]


@jax.jit
def _gather_range_rows(ranges: jax.Array, x: jax.Array):
    return ranges[x]


class DevicePositionTables:
    """Device-resident per-position equal-range tables (doubled-text
    index): a probe lookup is one gather — no search, tiny executable,
    trivially shardable across a mesh."""

    def __init__(self, pidx, batch: int = DEFAULT_BATCH):
        n = len(pidx.ranges)
        if n >= (1 << 31):
            raise ValueError(
                "device table shard too large for int32; shard the index")
        self.batch = batch
        # interleaved [n, 2] table: one row gather returns [lo, hi)
        self.ranges = jax.device_put(
            np.ascontiguousarray(pidx.ranges, dtype=np.int32))

    def gather_ranges(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        B = len(x)
        lo_out = np.empty(B, dtype=np.int64)
        hi_out = np.empty(B, dtype=np.int64)
        for b0 in range(0, B, self.batch):
            part = x[b0: b0 + self.batch].astype(np.int32)
            pad = self.batch - len(part)
            if pad:
                part = np.concatenate(
                    [part, np.zeros(pad, dtype=np.int32)])
            r = _gather_range_rows(self.ranges, jnp.asarray(part))
            r = np.asarray(r)
            nreal = min(self.batch, B - b0)
            lo_out[b0: b0 + nreal] = r[:nreal, 0]
            hi_out[b0: b0 + nreal] = r[:nreal, 1]
        return lo_out, hi_out


class DeviceSeedIndex:
    """Device-resident seed index built from a host ``GenomeIndex``."""

    def __init__(self, index: GenomeIndex, prefix_bits: Optional[int] = None,
                 batch: int = DEFAULT_BATCH):
        k = index.k
        if 3 * k > 60:
            raise ValueError("device seed index requires probe_size <= 20")
        if len(index.sa) >= (1 << 31):
            raise ValueError(
                "device index shard too large for int32 positions; "
                "shard the index across devices")
        self.k = k
        self.batch = batch

        if prefix_bits is None:
            prefix_bits = min(24, max(3 * k - LO_BITS, 0))
        if prefix_bits > 0 and 3 * k - prefix_bits < LO_BITS:
            prefix_bits = max(3 * k - LO_BITS, 0)
        self.prefix_bits = prefix_bits
        # shift applied to the HI plane to get the bucket id
        self.prefix_shift = (3 * k - prefix_bits) - LO_BITS \
            if prefix_bits > 0 else -1

        hi, lo = split_planes(index.sa_kmers)
        if prefix_bits > 0:
            prefixes = (index.sa_kmers >> (3 * k - prefix_bits))
            starts = np.searchsorted(
                prefixes, np.arange(1 << prefix_bits), side="left")
            bucket_starts = np.concatenate(
                [starts, [len(index.sa_kmers)]]).astype(np.int32)
            max_bucket = int(np.max(np.diff(bucket_starts))) \
                if len(bucket_starts) > 1 else len(index.sa_kmers)
        else:
            bucket_starts = np.array([0, len(index.sa_kmers)], dtype=np.int32)
            max_bucket = len(index.sa_kmers)
        self.steps = max(1, int(np.ceil(np.log2(max(max_bucket, 1) + 1))))

        self.key_hi = jax.device_put(hi)
        self.key_lo = jax.device_put(lo)
        self.bucket_starts = jax.device_put(bucket_starts)

    def lookup_planes(self, probe_hi: jax.Array, probe_lo: jax.Array):
        return equal_range(
            self.key_hi, self.key_lo, self.bucket_starts,
            probe_hi, probe_lo,
            steps=self.steps, prefix_shift=self.prefix_shift)

    def lookup(self, probe_kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host-convenient API: packed int64 probes → (lo, hi) int64."""
        B = len(probe_kmers)
        lo_out = np.empty(B, dtype=np.int64)
        hi_out = np.empty(B, dtype=np.int64)
        for b0 in range(0, B, self.batch):
            chunk = probe_kmers[b0: b0 + self.batch]
            # pad to the fixed batch size to avoid recompiles
            pad = self.batch - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros(pad, dtype=np.int64)])
            phi, plo = split_planes(chunk)
            left, right = self.lookup_planes(
                jnp.asarray(phi), jnp.asarray(plo))
            left = np.asarray(left)
            right = np.asarray(right)
            n = min(self.batch, B - b0)
            lo_out[b0: b0 + n] = left[:n]
            hi_out[b0: b0 + n] = right[:n]
        return lo_out, hi_out
