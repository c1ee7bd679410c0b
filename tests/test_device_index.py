"""On-device index construction vs the host builder (CPU backend)."""

import numpy as np
import pytest

from asgart_tpu.device_index import DeviceIndex
from asgart_tpu.index import PositionIndex
from tests.util import plant_duplication, random_dna, revcomp


def assert_index_equal(didx: DeviceIndex, pidx: PositionIndex):
    sa, ranges = didx.to_host_arrays()
    np.testing.assert_array_equal(sa, pidx.sa.astype(np.int32))
    np.testing.assert_array_equal(ranges, pidx.ranges)
    assert didx.first_len == pidx.first_len


def assert_index_equal_direct(didx: DeviceIndex, pidx: PositionIndex):
    """Doubled-text mode: the device window [lo, hi) spans only the
    first-half ("direct") entries of the position's k-mer group — the
    matchable set under the engine's ``m < first_len - 1`` filter. At
    every appended position (the only positions probes read in doubled
    mode, see _probe_x0) it must equal the host window filtered to
    direct entries, element-wise in SA order; direct positions carry
    empty windows by construction."""
    sa_d, ranges_d = didx.to_host_arrays()
    sa_h, ranges_h = pidx.sa, pidx.ranges
    first = pidx.first_len
    assert didx.first_len == first
    for p in range(didx.n):
        lo_d, hi_d = ranges_d[p]
        if p < first:
            assert lo_d == hi_d, f"direct position {p} window not empty"
            continue
        lo_h, hi_h = ranges_h[p]
        wh = sa_h[lo_h:hi_h]
        np.testing.assert_array_equal(
            sa_d[lo_d:hi_d], wh[wh < first].astype(np.int32),
            err_msg=f"direct window mismatch at position {p}")


@pytest.mark.parametrize("seed,alpha", [(0, b"ACGT"), (1, b"ACG"),
                                        (2, b"ACGTN"), (3, b"AC")])
def test_device_index_random(seed, alpha):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(500, 3000))
    data = np.frombuffer(random_dna(rng, n, alpha) + b"$", dtype=np.uint8)
    k = int(rng.choice([4, 8, 12, 20]))
    didx = DeviceIndex.build(data, k)
    pidx = PositionIndex.build(data, k)
    assert_index_equal(didx, pidx)


@pytest.mark.parametrize("reverse,complement", [(True, True), (True, False),
                                                (False, True)])
def test_device_index_doubled(reverse, complement):
    rng = np.random.default_rng(11)
    text = plant_duplication(rng, 5000, 700, 600, 3200,
                             transform=revcomp) + b"$"
    data = np.frombuffer(text, dtype=np.uint8)
    didx = DeviceIndex.build(data, 14, reverse=reverse,
                             complement=complement)
    pidx = PositionIndex.build(data, 14, reverse=reverse,
                               complement=complement)
    assert_index_equal_direct(didx, pidx)


def test_device_index_doubled_deep_ties():
    """Identical copies in a doubled text: direct-only tie resolution
    must still reproduce the host's direct-entry SA order through many
    doubling rounds (and through the full-round fallback)."""
    rng = np.random.default_rng(21)
    g = bytearray(random_dna(rng, 6000, b"ACGT"))
    g[2500:3700] = bytes(g[200:1400])      # identical direct copy
    g[4500:5700] = revcomp(bytes(g[200:1400]))  # identical RC copy
    data = np.frombuffer(bytes(g) + b"$", dtype=np.uint8)
    pidx = PositionIndex.build(data, 12, reverse=True, complement=True)
    didx = DeviceIndex.build(data, 12, reverse=True, complement=True)
    assert_index_equal_direct(didx, pidx)
    # tiny tied_cap forces the flagged full-round fallback path
    didx2 = DeviceIndex.build(data, 12, reverse=True, complement=True,
                              tied_cap=64)
    assert_index_equal_direct(didx2, pidx)


def test_device_index_long_identical_duplications():
    """Deep ties: identical copies force many doubling rounds."""
    rng = np.random.default_rng(5)
    g = bytearray(random_dna(rng, 9000, b"ACGT"))
    g[4000:5500] = bytes(g[100:1600])    # 1.5 kbp identical copy
    g[7000:8500] = bytes(g[100:1600])    # three-way tie
    data = np.frombuffer(bytes(g) + b"$", dtype=np.uint8)
    didx = DeviceIndex.build(data, 12)
    pidx = PositionIndex.build(data, 12)
    assert_index_equal(didx, pidx)


@pytest.mark.soak
def test_device_index_hyper_repetitive_full_rounds():
    """Tiny tied_cap forces the full-array fallback rounds."""
    rng = np.random.default_rng(6)
    base = random_dna(rng, 40, b"ACGT")
    text = base * 50 + random_dna(rng, 500, b"ACGT") + b"$"
    data = np.frombuffer(text, dtype=np.uint8)
    didx = DeviceIndex.build(data, 8, tied_cap=64)
    pidx = PositionIndex.build(data, 8)
    assert_index_equal(didx, pidx)


def test_device_index_all_same_symbol():
    data = np.frombuffer(b"A" * 2000 + b"$", dtype=np.uint8)
    didx = DeviceIndex.build(data, 10, tied_cap=128)
    pidx = PositionIndex.build(data, 10)
    assert_index_equal(didx, pidx)


@pytest.mark.parametrize("pattern", ["sparse", "dense", "runs", "none",
                                     "all", "tail_block"])
def test_extract_tied_blocked(pattern):
    """The blocked two-level compaction in `_extract_tied` is exact:
    ascending tied slot indices, padded with n, count right — across
    block-boundary/density edge cases (block size is 2^14)."""
    import jax.numpy as jnp

    from asgart_tpu.device_index import _EXTRACT_BLOCK, _extract_tied
    from asgart_tpu.utils import pow2_ceil

    rng = np.random.default_rng(hash(pattern) % 2**31)
    n = 3 * _EXTRACT_BLOCK + 777  # non-multiple of the block size
    tied = np.zeros(n, dtype=bool)
    if pattern == "sparse":
        tied[rng.choice(n, 97, replace=False)] = True
    elif pattern == "dense":
        tied[rng.random(n) < 0.7] = True
    elif pattern == "runs":  # whole blocks tied, straddling boundaries
        tied[_EXTRACT_BLOCK - 5:_EXTRACT_BLOCK + 5] = True
        tied[2 * _EXTRACT_BLOCK:3 * _EXTRACT_BLOCK] = True
        tied[n - 3:] = True
    elif pattern == "all":
        tied[:] = True
    elif pattern == "tail_block":  # only the ragged last block
        tied[3 * _EXTRACT_BLOCK:] = True
    expect = np.flatnonzero(tied)
    cap = max(1024, pow2_ceil(max(len(expect), 1), 1))
    slots, total = _extract_tied(jnp.asarray(tied), cap)
    slots = np.asarray(slots)
    assert int(total) == len(expect)
    assert np.array_equal(slots[: len(expect)], expect)
    assert np.all(slots[len(expect):] == n)


def test_device_index_cache(monkeypatch):
    """HBM-resident index cache: same strand + params reuses the built
    index (a warm service skips the build); any param or content change
    rebuilds. Entries are retained while the next build's projected
    peak fits the free-HBM estimate (budget minus tracked cache bytes —
    tiny test indexes all fit) and evicted oldest-first otherwise;
    ASGART_DEVICE_INDEX_CACHE=0 disables."""
    from asgart_tpu import device_index as di

    rng = np.random.default_rng(21)
    data = np.frombuffer(random_dna(rng, 3000, b"ACGT") + b"$", np.uint8)
    data2 = np.frombuffer(random_dna(rng, 3000, b"ACGT") + b"$", np.uint8)

    di._DEVICE_INDEX_CACHE.clear()
    a = di.cached_build(di.DeviceIndex.build, data, (10,),
                        reverse=True, complement=True)
    b = di.cached_build(di.DeviceIndex.build, data, (10,),
                        reverse=True, complement=True)
    assert b is a, "cache hit must reuse the resident index"
    c = di.cached_build(di.DeviceIndex.build, data, (10,),
                        reverse=False, complement=False)
    assert c is not a
    assert len(di._DEVICE_INDEX_CACHE) == 2, \
        "tiny entries are retained under byte accounting"
    assert di.cached_build(di.DeviceIndex.build, data, (10,),
                           reverse=True, complement=True) is a, \
        "the earlier entry is still served"
    d = di.cached_build(di.DeviceIndex.build, data2, (10,),
                        reverse=False, complement=False)
    assert d is not c, "content change must rebuild"
    # the cached index is exact (not just reused blindly)
    assert_index_equal(d, PositionIndex.build(data2, 10))

    monkeypatch.setenv("ASGART_DEVICE_INDEX_CACHE", "0")
    e = di.cached_build(di.DeviceIndex.build, data2, (10,),
                        reverse=False, complement=False)
    assert e is not d
    di._DEVICE_INDEX_CACHE.clear()


def test_strand_fingerprint_sliced():
    """The cache key's content hash runs the per-slice threaded path
    above 32 MB: deterministic across calls, sensitive to single-byte
    changes anywhere (incl. inside a non-first slice), and distinct
    between the small (single-hash) and sliced key shapes."""
    from asgart_tpu.device_index import _strand_fingerprint

    rng = np.random.default_rng(5)
    big = rng.integers(0, 5, 70 << 20, dtype=np.uint8)  # 3 slices
    f = _strand_fingerprint(big)
    assert f == _strand_fingerprint(big.copy())
    flip = big.copy()
    flip[40 << 20] ^= 1  # second slice
    assert _strand_fingerprint(flip) != f
    tail = big.copy()
    tail[-1] ^= 1  # ragged last slice
    assert _strand_fingerprint(tail) != f
    small = big[:1000]
    fs = _strand_fingerprint(small)
    assert fs == _strand_fingerprint(np.ascontiguousarray(small))
    assert len(fs) != len(f), "small and sliced key shapes must differ"


def test_device_index_cache_pipeline_rescan(tmp_path):
    """engine=device rescan of the same genome through the public pipeline:
    identical JSON with the index served from the HBM cache."""
    import io

    from asgart_tpu import device_index as di
    from asgart_tpu.exporters import JSONExporter
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings
    from tests.util import write_fasta

    rng = np.random.default_rng(22)
    text = plant_duplication(rng, 16000, 1200, 2000, 9000,
                             transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", text)])
    kw = dict(reverse=True, complement=True)

    di._DEVICE_INDEX_CACHE.clear()
    r1 = search_duplications([str(fa)], RunSettings(**kw), engine="tpu")
    assert len(di._DEVICE_INDEX_CACHE) == 1
    cached = next(iter(di._DEVICE_INDEX_CACHE.values()))
    r2 = search_duplications([str(fa)], RunSettings(**kw), engine="tpu")
    assert next(iter(di._DEVICE_INDEX_CACHE.values())) is cached
    b1, b2 = io.StringIO(), io.StringIO()
    JSONExporter().save(r1, b1)
    JSONExporter().save(r2, b2)
    assert b1.getvalue() == b2.getvalue()
    assert r1.families
    di._DEVICE_INDEX_CACHE.clear()


def test_decimate_codes_blocked(monkeypatch):
    """The blocked decimation (bounds sort transients at genome scale)
    is exact across block boundaries, non-multiple tails, and pad
    zeros."""
    import jax

    from asgart_tpu import device_index as di
    from asgart_tpu.device_engine import table_len_for

    # force several blocks (unique (step, L, n) statics per case, so
    # the jit retraces under the patched block size)
    monkeypatch.setattr(di, "_DECIMATE_BLOCK", 1 << 10)
    rng = np.random.default_rng(55)
    for k, n in [(20, 10237), (8, 4096), (14, 777)]:
        step = k // 2
        L = table_len_for(n, k)
        codes = np.zeros(L, dtype=np.uint8)
        codes[:n] = rng.integers(1, 6, n, dtype=np.uint8)
        out = np.asarray(di._decimate_codes(
            jax.device_put(codes), step, L, n))
        C = L // step
        expect = np.zeros(L, dtype=np.uint8)
        p = np.arange(n)
        expect[(p % step) * C + p // step] = codes[:n]
        np.testing.assert_array_equal(out, expect, err_msg=f"k={k} n={n}")


def test_packed_codes_upload_exact():
    """The 2-bit packed upload (+ sparse exception scatter) reproduces
    CODE[strand] bit-exactly across mixed alphabets, N runs, '$'
    separators and non-multiple-of-4 tails; exception-dense strands
    fall back to the plain 1 B/bp path."""
    from asgart_tpu.device_index import pack_codes_host
    from asgart_tpu.index import CODE

    rng = np.random.default_rng(77)
    alphabet = np.frombuffer(b"ACGTN$acgtXW-", dtype=np.uint8)
    w = np.array([10, 10, 10, 10, 1.0, 0.2, 0.1, 0.1, 0.1,
                  0.05, 0.02, 0.02, 0.02])
    for _ in range(10):
        n = int(rng.integers(1, 5000))
        s = rng.choice(alphabet, n, p=w / w.sum())
        np.testing.assert_array_equal(
            np.asarray(DeviceIndex.upload_codes(s)), CODE[s])
    # N-run heavy strand (chunk-boundary shape) stays exact
    s = np.frombuffer(random_dna(rng, 3000), dtype=np.uint8).copy()
    s[500:1200] = ord("N")
    s[2000] = ord("$")
    np.testing.assert_array_equal(
        np.asarray(DeviceIndex.upload_codes(s)), CODE[s])
    # all-N: packing refuses (exceptions would exceed the plain upload)
    s = np.full(999, ord("N"), np.uint8)
    assert pack_codes_host(s) is None
    np.testing.assert_array_equal(
        np.asarray(DeviceIndex.upload_codes(s)), CODE[s])
    # tail sizes around the 4-lane packing
    for n in (1, 2, 3, 4, 5, 7, 8):
        s = np.frombuffer(random_dna(rng, n), dtype=np.uint8).copy()
        np.testing.assert_array_equal(
            np.asarray(DeviceIndex.upload_codes(s)), CODE[s])


def test_device_index_cache_multi_entry(monkeypatch):
    """With live allocator stats, the cache is MULTI-entry LRU: windows
    of a sharded rescan stay resident while the next build's projected
    peak fits, and evict oldest-first when it doesn't."""
    from asgart_tpu import device_index as di

    rng = np.random.default_rng(22)
    data = np.frombuffer(random_dna(rng, 3000, b"ACGT") + b"$", np.uint8)
    data2 = np.frombuffer(random_dna(rng, 3000, b"ACGT") + b"$", np.uint8)
    data3 = np.frombuffer(random_dna(rng, 3000, b"ACGT") + b"$", np.uint8)

    di._DEVICE_INDEX_CACHE.clear()
    monkeypatch.setattr(di, "_hbm_free_bytes_local", lambda: 1 << 40)
    a = di.cached_build(di.DeviceIndex.build, data, (10,))
    b = di.cached_build(di.DeviceIndex.build, data2, (10,))
    assert len(di._DEVICE_INDEX_CACHE) == 2, "roomy stats keep both"
    assert di.cached_build(di.DeviceIndex.build, data, (10,)) is a
    assert di.cached_build(di.DeviceIndex.build, data2, (10,)) is b

    # tight stats: MRU eviction pops most-recent-first until the build
    # fits (here: never — everything goes)
    monkeypatch.setattr(di, "_hbm_free_bytes_local", lambda: 1 << 10)
    c = di.cached_build(di.DeviceIndex.build, data3, (10,))
    assert c is not None
    assert len(di._DEVICE_INDEX_CACHE) == 1, "tight stats evict all"

    di._DEVICE_INDEX_CACHE.clear()


def test_tracked_cache_bytes_dedups_shared_arrays():
    """`hbm_free_estimate`'s accounting counts an array shared between
    cache entries (e.g. the decimated doubled codes every window index
    references) exactly once."""
    import jax.numpy as jnp

    from asgart_tpu import device_index as di

    class Holder:
        def __init__(self, a, b):
            self.a = a
            self.b = b

    shared = jnp.zeros(1024, jnp.int32)
    own1 = jnp.zeros(256, jnp.int32)
    own2 = jnp.zeros(512, jnp.int32)
    di._DEVICE_INDEX_CACHE.clear()
    base = di._tracked_cache_bytes()
    di._DEVICE_INDEX_CACHE["x"] = Holder(shared, own1)
    di._DEVICE_INDEX_CACHE["y"] = Holder(shared, (own2, {"k": shared}))
    got = di._tracked_cache_bytes() - base
    assert got == (1024 + 256 + 512) * 4, got
    di._DEVICE_INDEX_CACHE.clear()


def test_big_window_fits_admits_whole_human_scale():
    """The big-window fit predicate (stage-1 batched by design) must
    admit whole-human -RC windows at realistic shard counts — the
    auto-shard planner uses it past int32 doubled addressing, where
    `device_window_fits`'s whole-probe-side projection admits nothing
    at any S <= 256 (the r4 gap: 3 Gbp auto-shard fell to host)."""
    from asgart_tpu.device_index import big_window_fits

    for mbp in (2048, 3100, 6200):
        n1 = int(mbp * 1e6) + 1
        total = n1 - 1
        S = 2
        while S <= 256 and not big_window_fits(
                n1, (total + S - 1) // S + 1, k=20):
            S += 1
        assert S <= 40, f"{mbp} Mbp needs S={S}"
        # monotone: more shards keep fitting
        assert big_window_fits(n1, (total + 2 * S - 1) // (2 * S) + 1,
                               k=20)
    # the 2^30 row cap still rejects giant windows outright
    assert not big_window_fits(10**10, 1 << 30, k=20)


def test_decimate_codes_multi_bit_equal():
    """Per-block-dispatch decimation (`_decimate_codes_multi`, the
    >=2^27-row HBM-safe route) is bit-equal to the single-jit
    `_decimate_codes_t` across uneven tails and several steps."""
    import jax.numpy as jnp

    from asgart_tpu.device_index import (_decimate_codes_multi,
                                         _decimate_codes_t)

    rng = np.random.default_rng(614)
    for step, n, L in ((10, 100_000, 100_000), (10, 99_991, 100_000),
                       (7, 70_007, 70_014), (15, 30_001, 30_015)):
        codes = jnp.asarray(
            rng.integers(0, 6, n).astype(np.uint8))
        a = np.asarray(_decimate_codes_t(codes, step, L, n))
        b = np.asarray(_decimate_codes_multi(codes, step, L, n))
        assert np.array_equal(a, b), (step, n, L)


class _StubDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"stub {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_hbm_budget_env_override(monkeypatch):
    import asgart_tpu.device_index as di

    monkeypatch.setenv("ASGART_HBM_BYTES", "2.5e9")
    monkeypatch.setattr(di.jax, "local_devices", lambda: [_StubDevice(
        "gpu", {"bytes_limit": 60 << 30})])
    assert di.hbm_budget_bytes() == 2_500_000_000


def test_hbm_budget_reads_device_limit(monkeypatch):
    """On an accelerator the budget is the allocator's bytes_limit less
    the stated reserve; the live free-memory figure follows it."""
    import asgart_tpu.device_index as di

    monkeypatch.delenv("ASGART_HBM_BYTES", raising=False)
    limit = 60_000_000_000
    monkeypatch.setattr(di.jax, "local_devices", lambda: [_StubDevice(
        "gpu", {"bytes_limit": limit, "bytes_in_use": 4_000_000_000})])
    budget = limit - int(limit * di.DEVICE_RESERVE_FRACTION)
    assert di.hbm_budget_bytes() == budget
    assert di.hbm_free_estimate() == budget - 4_000_000_000
    # the fit predicates plan against it: a 512 Mbp fused build
    # (~26 GB) fits this card, a 1.2 Gbp one (~61 GB) does not
    assert di.fused_fits(512_000_001)
    assert not di.fused_fits(1_200_000_001)


def test_hbm_budget_requires_device_limit(monkeypatch):
    import pytest

    import asgart_tpu.device_index as di

    monkeypatch.delenv("ASGART_HBM_BYTES", raising=False)
    for stats in (None, {"bytes_in_use": 1}):
        monkeypatch.setattr(di.jax, "local_devices",
                            lambda s=stats: [_StubDevice("gpu", s)])
        with pytest.raises(RuntimeError, match="bytes_limit"):
            di.hbm_budget_bytes()


def test_hbm_budget_cpu_tier_default(monkeypatch):
    import asgart_tpu.device_index as di

    monkeypatch.delenv("ASGART_HBM_BYTES", raising=False)
    assert di.hbm_budget_bytes() == di.CPU_TIER_BUDGET_BYTES
    # no allocator stats on the CPU backend: the tracked-cache
    # accounting stands in for live free memory
    assert di._hbm_free_bytes_local() is None
    assert di.hbm_free_estimate() <= di.CPU_TIER_BUDGET_BYTES
